"""Device selection and fp32 numerics shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and absent:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Keep fp32 work out of plain TF32.

    cuDNN convolutions default to TF32 (``cudnn.allow_tf32`` is True), which
    keeps about three decimal digits; the JAX package runs its strict mode at
    ``Precision.HIGHEST``. This context turns both flags off, so that every
    cuDNN call and every fp32 matmul runs in IEEE fp32. The port's fp32
    convolutions on the card (``ops/conv.py``) set the cuDNN flag around
    each of their own calls: on for the 3xTF32 ones (a sampler's forward, a
    training step's input gradient), off for the rest. Both flags are
    restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
