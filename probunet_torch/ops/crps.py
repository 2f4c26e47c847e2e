"""Continuous Ranked Probability Score (empirical estimator) —
``probunet_tpu/ops/crps.py``.

    CRPS = E|pred - truth| - (1/2) E|pred - pred'|

with the sorted-spacings form of the second term: for sorted samples
x_(1) <= ... <= x_(n), E|X - X'| = (2 / n^2) sum_i (x_(i+1) - x_(i)) i (n - i).
``crps_naive`` is the quadratic-time oracle the tests use.
"""

from __future__ import annotations

import torch


def crps_empirical(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """CRPS per element. pred: (num_samples,) + truth.shape, the ensemble on
    the leading axis. Returns a tensor of ``truth.shape``."""
    if pred.shape[1:] != truth.shape:
        raise ValueError(f"pred must be (S,)+truth.shape; got {tuple(pred.shape)} vs "
                         f"{tuple(truth.shape)}")
    n = pred.shape[0]
    if n == 1:
        return (pred[0] - truth).abs()
    mae = (pred - truth).abs().mean(dim=0)
    srt = torch.sort(pred, dim=0).values
    diff = srt[1:] - srt[:-1]                                  # (n-1, ...)
    i = torch.arange(1, n, dtype=pred.dtype, device=pred.device)
    weight = (i * i.flip(0)).reshape((n - 1,) + (1,) * truth.ndim)
    return mae - (diff * weight).sum(dim=0) / (n * n)


def crps_naive(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """O(n^2) direct evaluation of the CRPS identity (test oracle)."""
    mae = (pred - truth).abs().mean(dim=0)
    pairwise = (pred[None, :] - pred[:, None]).abs().mean(dim=(0, 1))
    return mae - 0.5 * pairwise
