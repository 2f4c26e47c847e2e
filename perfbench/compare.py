"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference works out from the same inputs.

Training (readings of the first three steps: each step's loss, each leaf's
norm of the first gradient, each leaf's norm of the parameter change):

- ``loss_gap``: |loss - reference loss| / |reference loss| of the first
  step. The later steps' losses are not compared: from random weights the
  first Adam steps swing the loss by up to four orders of magnitude, and
  two fp32 references that differ only in their cuDNN algorithms part by
  up to 30 % there;
- ``grad_gap``: over the leaves, the largest gap between the two norms of
  the first gradient, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same of the parameter change over three steps. A
  row (a slice along a leaf's first axis: an output channel, a bias
  element) whose reference gradient is nought to rounding moves under Adam
  by round-off alone, as a key's bias does under the softmax, and is left
  out: a row counts where its reference gradient norm is at least a
  thousandth of the median leaf's per-row root mean square. The key biases
  share their leaf with the query and value biases, so the rule is by row.

Sampling: ``residual_gap``, over the answers of a call (one member of one
input: an (H, W, C) field, in standardized units (hr - lrinterp) / (std +
eps)), the largest root mean square of (answer - reference answer), over
the root mean square of all the call's reference answers. Each answer is
judged whole: the largest single element's gap swings with the seed by its
nature (0.021 to 0.094 over fifteen seeds in bf16, three seeds at one
value), and an answer measured against its own size swings where a draw
makes it small (0.051 against at most 0.014 over twelve seeds).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float], names) -> float:
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-300) for n in names)


def moved_rows(ref: Dict) -> Dict[str, torch.Tensor]:
    """Each leaf's rows that the rule above keeps (a boolean mask)."""
    rms = [ref["grad_norms"][n] / math.sqrt(len(r)) for n, r in ref["grad_rows"].items()]
    floor = NEGLIGIBLE_GRAD * statistics.median(rms)
    return {n: r >= floor for n, r in ref["grad_rows"].items()}


def training_gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """``got`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_rows": {leaf: row norms}}; ``ref`` also "grad_rows"."""
    loss = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    if set(got["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    grad = _leaf_gap(got["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    got_c, ref_c = {}, {}
    for n, keep in moved_rows(ref).items():
        if keep.any():
            got_c[n] = float(got["change_rows"][n][keep].norm())
            ref_c[n] = float(ref["change_rows"][n][keep].norm())
    change = _leaf_gap(got_c, ref_c, ref_c)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def row_norms(t: torch.Tensor) -> torch.Tensor:
    """fp64 norms of ``t``'s slices along its first axis, on the CPU."""
    return torch.linalg.vector_norm(t.detach().double().reshape(t.shape[0], -1), dim=1).cpu()


def residual_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``got``, ``ref``: (B, K, H, W, C), the answers of one call."""
    ref = ref.double().flatten(2)
    gap = (got.double().flatten(2) - ref).square().mean(-1).sqrt()
    return float(gap.max() / ref.square().mean().sqrt())
