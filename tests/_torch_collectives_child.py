"""Child process of tests/test_torch_multihost_e2e.py: one rank of a gloo
process group from the environment (the JAX package's names), which sums
half a Kelvin-scale century of LR moments per rank through
``allreduce_moments``, gathers counts above 2**24, runs ``run_bcsd`` on its
shard of the train years, and one prob-U-Net training step with dropout
on its rows of a global batch (weights filled, so every dropout mask
reaches the loss); it saves what it got for the parent.
Argv: <output prefix> [config flags...]."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from probunet_torch.config import Config, get_config  # noqa: E402
from probunet_torch.parallel.multihost import (  # noqa: E402
    allgather_counts,
    allreduce_moments,
    maybe_initialize_distributed,
    merge_moment_stats,
    process_info,
)
from probunet_torch.parallel.mesh import data_parallel  # noqa: E402
from probunet_torch.train.engine import load_datasets  # noqa: E402
from probunet_torch.train.loop import build_probunet, init_probunet_state, run_bcsd  # noqa: E402
from probunet_torch.train.state import make_optimizer  # noqa: E402
from probunet_torch.train.steps import make_probunet_train_step  # noqa: E402

STEP_ROWS = 2   # per process
STEP_CFG = Config(resolution=(16, 16), lowres_scale=4, latent_dim=4, num_filters=(8,),
                  model_channels=8, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
                  dropout=0.1, standardization="pertimestep")


def local_moments(pid: int):
    """Half a century of Kelvin-scale LR pixels of process ``pid``: keep in
    sync with tests/test_torch_multihost_e2e.py::_kelvin_half_century."""
    x = 273.0 + 5.0 * np.random.default_rng(1234 + pid).standard_normal((18250, 4, 4, 3))
    return x.sum(axis=0, dtype=np.float64), np.square(x).sum(axis=0, dtype=np.float64), len(x)


def step_state():
    """The step's model with every parameter ~ N(0, 1) / sqrt(fan_in): the
    zero-initialized convolutions after each block's dropout would hide
    the masks from the loss."""
    state = init_probunet_state(STEP_CFG, build_probunet(STEP_CFG, device="meta"),
                                make_optimizer(), device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in state.model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / max(1, p[0].numel()) ** 0.5)
    return state


def step_batch(n):
    """The global batch of ``n`` days and its per-sample statistics."""
    from probunet_torch.data import transforms

    hr = torch.from_numpy(np.random.default_rng(5).gamma(2.0, 1.0, (n, 16, 16, 3)).astype(
        np.float32))
    return hr, transforms.compute_lr_stats(hr, 4, "pertimestep")


def one_step(state, hr, stats, dp):
    step = make_probunet_train_step(state.model, 4, "pertimestep", dp=dp)
    m = step(state, hr, stats, torch.arange(hr.shape[0]), 17)
    grads = {f"grad/{k}": p.grad.numpy() for k, p in state.model.named_parameters()}
    return {"loss": float(m["train_loss"]), "grad_norm": float(m["grad_norm"]), **grads}


def main():
    torch.set_num_threads(1)
    out = sys.argv[1]
    maybe_initialize_distributed("cpu")
    pid = process_info()[0]
    rs1, rs2, rn = allreduce_moments(*local_moments(pid))
    mean, std = merge_moment_stats([(rs1, rs2, rn)])
    counts = allgather_counts(16_777_217 + pid)
    cfg = get_config(sys.argv[2:])
    datasets = load_datasets(cfg, "cpu")
    res = run_bcsd(cfg, datasets, chunk=7, device="cpu")
    world = process_info()[1]
    hr, stats = step_batch(STEP_ROWS * world)
    rows = slice(pid * STEP_ROWS, (pid + 1) * STEP_ROWS)
    step = one_step(step_state(), hr[rows], tuple(s[rows] for s in stats), data_parallel())
    np.savez(f"{out}.p{pid}.npz", rs1=rs1, rs2=rs2, rn=rn, std=std, counts=counts, **step,
             train_years=np.asarray(datasets["train"].years),
             **{f"{s}_preds": r["preds"] for s, r in res.items()},
             **{f"{s}_mae": np.asarray(list(r["mae"].values())) for s, r in res.items()})


if __name__ == "__main__":
    main()
