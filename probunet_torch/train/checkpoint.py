"""Checkpoint save/restore in the port's own format: ``torch.save`` of the
model's ``state_dict`` and the step, in ``<directory>/<name>/state.pt``.
JAX checkpoints (orbax) carry across through
:func:`probunet_torch.utils.transplant.flax_probunet_to_torch`."""

from __future__ import annotations

import os

import torch
from torch import nn


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), name, "state.pt")


def save_checkpoint(directory: str, model: nn.Module, step: int = 0, name: str = "state") -> str:
    path = _path(directory, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    params = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    torch.save({"params": params, "step": int(step)}, path)
    return os.path.dirname(path)


def restore_checkpoint(directory: str, model: nn.Module, name: str = "state") -> int:
    """Load the parameters into ``model`` in place (on its device, keeping its
    memory format); returns the saved step."""
    state = torch.load(_path(directory, name), map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"])
    return state["step"]
