"""Fused self-attention forward — kernel K2 of the port.

``fused_attention`` launches the hand-written CUDA kernel
``csrc/attention_fwd.cu`` for CUDA tensors and runs :func:`_plain_attention`,
the math of ``probunet_tpu/ops/pallas_attn.py::_xla_attention``, for CPU
tensors. It replaces ``probunet_tpu/ops/pallas_attn.py::_fwd_kernel``; the
source note in the ``.cu`` file gives its bound and design. Forward only:
the backward kernel comes with the training path.
"""

from __future__ import annotations

import math

import torch

from probunet_torch.ops import _build

HEAD_DIM = 64


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fast: bool) -> torch.Tensor:
    """softmax(Q (K/sqrt(c))^T) V on (B, L, heads, c), unfused. Strict: fp32
    logits and softmax (run it with TF32 off); fast: logits in q's dtype,
    fp32 softmax. The weights are cast to q's dtype before PV."""
    c = k.shape[-1]
    if fast:
        w = torch.einsum("bqhc,bkhc->bhqk", q, (k / math.sqrt(c)).to(q.dtype))
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
    else:
        w = torch.einsum("bqhc,bkhc->bhqk", q.float(), (k / math.sqrt(c)).float())
        w = torch.softmax(w, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", w, v)


def _to_bh(a: torch.Tensor) -> torch.Tensor:
    """(B, L, H, 64), any strides -> contiguous (B*H, L, 64)."""
    b, L, h, c = a.shape
    return a.permute(0, 2, 1, 3).contiguous().view(b * h, L, c)


@torch.no_grad()
def _launch(q, k, v):
    b, L, h, c = q.shape
    out = torch.empty(b, L, h, c, device=q.device, dtype=q.dtype)
    q3, k3, v3 = _to_bh(q), _to_bh(k), _to_bh(v)
    lib = _build.lib()
    code = lib.probunet_attention_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), b, h, L,
        1.0 / math.sqrt(c), int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(code, "attention kernel")
    fused_attention.launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    fast: bool = False) -> torch.Tensor:
    """softmax(Q K^T / sqrt(64)) V without materializing the weights.

    q, k, v: (B, L, heads, 64), the U-Net block's layout (the stride-3 views
    of the interleaved qkv conv output are fine). Returns a contiguous
    (B, L, heads, 64) tensor in q's dtype: fp32 in strict mode, bf16 with
    ``fast``. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.shape[-1] != HEAD_DIM or q.ndim != 4:
        raise ValueError(f"fused_attention takes (B, L, heads, {HEAD_DIM}), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have the same shape")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("fused_attention is forward-only: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if q.device.type == "cpu":
        return _plain_attention(q, k, v, fast)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention has no path for device {q.device}")
    # The kernel's numerics follow the dtype: fp32 operands give the strict
    # math, bf16 operands the fast math (in strict mode with bf16 activations
    # both agree, since K * 1/8 is exact in bf16).
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    return _launch(q, k, v)


fused_attention.launches = 0  # kernel launches; CPU calls of the plain version do not count
