"""probunet_torch — the PyTorch + CUDA port of ``probunet_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each module's counterpart is easy to find. The hot normalization and
attention paths run hand-written Hopper kernels (``probunet_torch/csrc``),
built with ``nvcc`` at first use; every kernel keeps a plain PyTorch version
beside it that runs for CPU tensors.

Entry points take ``device=None``, which means ``"cuda"``; they raise when no
CUDA device exists, and run on the CPU only when asked (``device="cpu"``).
"""

__version__ = "0.1.0"

from probunet_torch.config import Config, get_config  # noqa: F401

__all__ = ["Config", "get_config"]


def __getattr__(name):
    """Lazy top-level API (config-only use imports no model code)."""
    if name in ("ProbabilisticUNet", "UNet"):
        import probunet_torch.models as m
        return getattr(m, name)
    if name == "ClimexDataset":
        from probunet_torch.data.dataset import ClimexDataset
        return ClimexDataset
    if name == "downscale":
        from probunet_torch.serve import downscale
        return downscale
    raise AttributeError(f"module 'probunet_torch' has no attribute {name!r}")
