"""The bf16-state AdamW update (``train/state.py::AdamWBf16State``) in one
launch.

:func:`update` runs one step of the update over a parameter group. On the
CPU it runs :func:`_plain_update`, the same roundings as
``torch._foreach_*`` ops. On the card every parameter with a gradient has
to be a dense fp32 tensor with a dense fp32 gradient, and its state a bf16
``mu`` and an fp32 ``nu`` of its length on its card, all four in one
memory format (contiguous, or channels_last as the models' convolution
weights are); it launches the hand-written CUDA kernel
``csrc/adamw_bf16.cu`` once for the whole group, and raises a
``ValueError`` that names a tensor that does not fit. The kernel replaces
no TPU kernel (XLA fuses the JAX package's ``_scale_by_adam_bf16_state``);
the plain version takes five launches a tensor for its bf16 roundings,
which made the optimizer a third of a fast training step's launches. The
kernel rounds where the plain version rounds, so the two give equal bits;
it updates ``mu`` and ``nu`` in place, so each parameter keeps its own
state tensors.

The launch reads a table in device memory: each tensor's pointers (p,
grad, mu, nu) and length, then chunks of at most :data:`CHUNK` elements.
The gradients are new tensors every step, so the host builds the table
every call and writes it into one device buffer (:class:`Table`), ~2 host
ms a call for the mc128 model's 416 tensors.

Counted in :data:`_build.LAUNCHES`: ``("adamw_bf16", "fused")`` a launch,
``("adamw_bf16", "foreach")`` an update on the plain path (the CPU).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from probunet_torch.ops import _build

#: elements of one chunk, the block's share (``kAdamChunk`` in the kernel)
CHUNK = 65536


def _plain_update(params: List[torch.Tensor], states: List[dict], b1: float, b2: float,
                  bc1: float, bc2: float, eps: float, weight_decay: float, lr: float) -> None:
    """The update in multi-tensor (``torch._foreach_*``) ops, with the bf16
    roundings tensor by tensor: gradients cast to bf16, mu = b1 mu + (1 -
    b1) g rounded to bf16 (a new tensor in ``st["mu"]``), nu = b2 nu + (1 -
    b2) g^2 in fp32 in place, the bias-corrected ratio in fp32, then
    decoupled weight decay, then -lr, added to the parameters in place."""
    bf16 = torch.bfloat16
    g = [p.grad.to(bf16).float() for p in params]
    mu = torch._foreach_mul([st["mu"].float() for st in states], b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    nu = [st["nu"] for st in states]
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    for st, m in zip(states, mu):
        st["mu"] = m.to(bf16)
    upd = torch._foreach_div([st["mu"].float() for st in states], bc1)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


def _rows(params: Sequence[torch.Tensor], states: Sequence[dict]) -> Optional[List[int]]:
    """The table's rows (p, grad, mu, nu pointers and length of each tensor)
    of a group on the card, None for a group on the CPU. A tensor fits where
    p, grad, mu and nu are fp32, fp32, bf16 and fp32 on one card, of one
    length and dense in one memory format, contiguous or channels_last (the
    models' convolution weights), so that element i of each is the i-th in
    memory; a ValueError names the first that does not."""
    card = params[0].get_device()
    if card < 0:
        if not any(p.is_cuda for p in params):
            return None
        card = next(p.get_device() for p in params if p.is_cuda)
    f32, bf16 = torch.float32, torch.bfloat16
    dense, cl = torch.contiguous_format, torch.channels_last
    rows = []
    for i, (p, st) in enumerate(zip(params, states)):
        g, mu, nu = p.grad, st["mu"], st["nu"]
        n = p.numel()
        fmt = dense if p.is_contiguous() else cl if p.is_contiguous(memory_format=cl) else None
        if not (fmt and p.dtype is f32 and g.dtype is f32 and mu.dtype is bf16
                and nu.dtype is f32 and g.is_contiguous(memory_format=fmt)
                and mu.is_contiguous(memory_format=fmt) and nu.is_contiguous(memory_format=fmt)
                and p.get_device() == g.get_device() == mu.get_device() == nu.get_device() == card
                and g.numel() == mu.numel() == nu.numel() == n):
            found = ", ".join(f"{name} {tuple(t.shape)} {t.dtype} strides {t.stride()} on "
                              f"{t.device}" for name, t in (("p", p), ("grad", g), ("mu", mu),
                                                            ("nu", nu)))
            raise ValueError(f"adamw_bf16 kernel takes p, grad, mu, nu fp32, fp32, bf16, fp32 "
                             f"on cuda:{card}, of one length, dense in one memory format "
                             f"(contiguous or channels_last); parameter {i} of the group has "
                             f"{found}")
        rows += (p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), n)
    return rows


def table_words(rows: Sequence[int]) -> Tuple[np.ndarray, int, int]:
    """The table of ``rows`` (five words a tensor) as int64 words: the rows,
    then one word a chunk (tensor | chunk << 32); with its tensor and chunk
    counts."""
    rows = np.array(rows, dtype=np.int64).reshape(-1, 5)
    counts = -(-rows[:, 4] // CHUNK)
    first = np.cumsum(counts) - counts
    tensor = np.repeat(np.arange(len(rows), dtype=np.int64), counts)
    chunk = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(first, counts)
    return np.concatenate([rows.ravel(), tensor | (chunk << 32)]), len(rows), len(chunk)


class Table:
    """The fused launch's table: one device buffer, written every call and
    reallocated only when its length or card changes, so the steps allocate
    no device memory that would move the next step's gradients."""

    def __init__(self):
        self.words: Optional[torch.Tensor] = None

    def _write(self, words: np.ndarray, card: int) -> None:
        """From a pinned buffer, on the current stream (after the launches
        that read the last table), the buffer kept by PyTorch's
        pinned-memory allocator until the copy is done."""
        if self.words is None or len(self.words) != len(words) or \
                self.words.get_device() != card:
            self.words = torch.empty(len(words), dtype=torch.int64,
                                     device=torch.device("cuda", card))
        self.words.copy_(torch.from_numpy(words).pin_memory(), non_blocking=True)

    def launch(self, rows: Sequence[int], card: int, b1: float, b2: float, bc1: float,
               bc2: float, eps: float, weight_decay: float, lr: float) -> None:
        """Write ``rows``' table, then one launch over it. The bias
        corrections go as reciprocals: ``_foreach_div(list, s)`` multiplies
        by 1 / s taken in double, rounded to fp32 (the kernel's source
        note)."""
        words, ntensors, nchunks = table_words(rows)
        self._write(words, card)
        code = _build.lib().probunet_adamw_bf16(
            ctypes.c_void_p(self.words.data_ptr()), ntensors, nchunks, b1, 1 - b1, b2, 1 - b2,
            1 / bc1, 1 / bc2, eps, weight_decay, -lr, _build.stream_handle(self.words.device))
        _build.check(code, "adamw_bf16 kernel")
        _build.LAUNCHES["adamw_bf16", "fused"] += 1


def update(params: List[torch.Tensor], states: List[dict], *, betas: Tuple[float, float],
           count: int, lr: float, eps: float, weight_decay: float, table: Table) -> None:
    """One update of ``params`` (each with a gradient) and their ``states``
    (``mu`` bf16, ``nu`` fp32) at step ``count`` (from 1) of the bias
    correction. ``table`` is the caller's, kept across calls."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    rows = _rows(params, states)
    if rows is None:
        _plain_update(params, states, b1, b2, bc1, bc2, eps, weight_decay, lr)
        _build.LAUNCHES["adamw_bf16", "foreach"] += 1
    else:
        table.launch(rows, params[0].get_device(), b1, b2, bc1, bc2, eps, weight_decay, lr)
