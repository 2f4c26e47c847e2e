"""Checkpoint save/restore — ``probunet_tpu/train/checkpoint.py`` in the
port's own format: ``torch.save`` of the parameters (the model's
``state_dict``), the optimizer state (``Optimizer.state_dict``) and the
step, all on the CPU, in ``<directory>/<name>/state.pt``. A state without an
optimizer (serving) saves and restores the parameters and step alone, the
format of the port's first checkpoints, which serving still reads. JAX
checkpoints (orbax) carry across through
:func:`probunet_torch.utils.transplant.flax_train_state_to_torch`.

Under a process group every rank calls :func:`save_checkpoint`: rank 0
writes (the ranks hold the same state), then all wait for the file, so a
rank that goes on to read it finds it whole. Every rank restores."""

from __future__ import annotations

import os

import torch

from probunet_torch.parallel import mesh
from probunet_torch.train.state import TrainState


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name, "state.pt")


def _to_cpu(obj):
    """Every tensor of nested dicts and lists as a CPU copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str, state: TrainState, name: str = "state") -> str:
    """Write ``state`` (under a process group: rank 0 writes, then a barrier);
    returns the checkpoint's directory."""
    path = _path(directory, name)
    group = mesh.is_initialized()
    if not group or torch.distributed.get_rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"params": _to_cpu(state.model.state_dict()), "step": int(state.step)}
        if state.optimizer is not None:
            payload["optimizer"] = _to_cpu(state.optimizer.state_dict())
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)  # a run cut mid-write leaves the last checkpoint whole
    if group:
        mesh.barrier()
    return os.path.dirname(path)


def restore_checkpoint(directory: str, state: TrainState, name: str = "state") -> TrainState:
    """Load a checkpoint into ``state`` in place, on its model's device and
    in its memory format, and return it: the parameters, the step and, when
    ``state`` has an optimizer, the optimizer state, which the checkpoint
    must then hold (a parameters-only checkpoint cannot resume a run
    exactly)."""
    payload = torch.load(_path(directory, name), map_location="cpu", weights_only=True)
    if state.optimizer is not None and "optimizer" not in payload:
        raise ValueError(f"{directory} holds parameters only, no optimizer state to resume from")
    return load_payload(state, payload)


def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Load a checkpoint's contents (as :func:`save_checkpoint` writes them,
    or as ``utils.transplant.flax_train_state_to_torch`` makes them from a
    JAX ``TrainState``) into ``state`` in place; returns it."""
    state.model.load_state_dict(payload["params"])
    if state.optimizer is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
