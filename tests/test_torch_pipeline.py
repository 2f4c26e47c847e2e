"""The port's streaming ingest and observability on the CPU:
``data/pipeline.py`` against the JAX package's (streaming statistics in
every mode, prefetcher order, completion and errors, epoch order and
mid-epoch start), ``utils/logging.py`` and ``viz/plots.py``."""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch.data import pipeline as tp
from probunet_torch.data import transforms as tt
from probunet_torch.data.dataset import ClimexDataset
from probunet_torch.utils import logging as tlog
from probunet_tpu.data import transforms as jt
from probunet_tpu.data.pipeline import compute_lr_stats_streaming as jax_stats_streaming


def _hr(t=40, hw=16, c=3, seed=0):
    return (np.random.default_rng(seed).standard_normal((t, hw, hw, c)) + 4).astype(np.float32)


@pytest.mark.parametrize("mode", ["perpixel", "pertimestep", "minmax"])
def test_lr_stats_streaming_matches_jax(mode):
    """Chunks of 7 (a ragged tail of 5): the port's streaming statistics
    against the JAX package's streaming ones and against the port's
    one-pass statistics; float64 host sums on both streaming sides, fp32
    pooling: 1e-4 relative, 1e-5 absolute (tests/test_pipeline.py's)."""
    hr = _hr()
    got = tp.compute_lr_stats_streaming(hr, 4, mode, chunk=7, device="cpu")
    ref = jax_stats_streaming(hr, 4, mode, chunk=7)
    one_pass = tt.compute_lr_stats(torch.from_numpy(hr), 4, mode)
    for g, r, o in zip(got, ref, one_pass):
        assert isinstance(g, np.ndarray) and g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, o.numpy(), rtol=1e-4, atol=1e-5)
    # and the JAX one-pass statistics, which the JAX engine's resident mode uses
    np.testing.assert_allclose(got[1], np.asarray(jt.compute_lr_stats(jnp.asarray(hr), 4, mode)[1]),
                               rtol=1e-4, atol=1e-5)


def test_lr_stats_streaming_none_and_moments():
    hr = _hr(t=9)
    assert tp.compute_lr_stats_streaming(hr, 4, "none", device="cpu") is None
    s1, s2, n = tp.lr_moments_streaming(hr, 4, chunk=4, device="cpu")
    assert n == 9 and s1.dtype == s2.dtype == np.float64 and s1.shape == (4, 4, 3)
    lr = hr.reshape(9, 4, 4, 4, 4, 3).mean(axis=(2, 4)).astype(np.float64)
    np.testing.assert_allclose(s1, lr.sum(0), rtol=1e-6)


def test_device_prefetcher_order_and_completion():
    items = [{"a": np.full((4,), i, np.float32), "s": (np.arange(2) + i,)} for i in range(10)]
    out = list(tp.DevicePrefetcher(iter(items), buffer_size=3, device="cpu"))
    assert len(out) == 10
    for i, item in enumerate(out):
        assert isinstance(item["a"], torch.Tensor) and float(item["a"][0]) == i
        assert isinstance(item["s"], tuple) and item["s"][0].tolist() == [i, i + 1]


def test_device_prefetcher_error_propagation():
    def bad():
        yield {"a": np.zeros(2)}
        raise RuntimeError("boom")

    it = iter(tp.DevicePrefetcher(bad(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetcher_close_stops_a_blocked_worker():
    """A consumer that leaves early (a max_steps stop) closes the
    prefetcher: its worker, blocked on a full queue, exits."""
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"a": np.full((2,), i)}
            i += 1

    pf = tp.DevicePrefetcher(endless(), buffer_size=2, device="cpu")
    first = next(iter(pf))
    assert float(first["a"][0]) == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(produced) < 10
    assert threading.active_count() < 50


@pytest.mark.parametrize("mode", ["perpixel", "pertimestep"])
def test_stream_batches_follow_epoch_indices(mode):
    """Batches come in ``ClimexDataset.epoch_indices`` order (the resident
    mode's), the remainder dropped, from ``start_batch`` on; per-sample
    stats ride along, global stats are shared."""
    hr = _hr(t=26)
    ds = ClimexDataset(hr=hr, standardization=mode, lowres_scale=4, device="cpu")
    stats = tp.compute_lr_stats_streaming(hr, 4, mode, device="cpu")
    order = ds.epoch_indices(3, 6)
    for start in (0, 2):
        it = tp.stream_batches(hr, 6, 3, stats, mode, device="cpu", start_batch=start)
        got = list(it)
        assert len(got) == order.shape[0] - start == 4 - start
        for item, idx in zip(got, order[start:]):
            np.testing.assert_array_equal(item["hr"].numpy(), hr[idx])
            if mode == "pertimestep":
                np.testing.assert_array_equal(item["stats"][0].numpy(), stats[0][idx])
            else:
                assert item["stats"] is got[0]["stats"]
    it = tp.stream_batches(hr, 6, 3, stats, mode, device="cpu")
    next(it)
    it.close()   # stops the worker mid-epoch


def test_metric_logger_jsonl_and_param_norms(tmp_path):
    path = os.path.join(str(tmp_path), "m", "metrics.jsonl")
    logger = tlog.MetricLogger(path, use_wandb=True)   # wandb absent: JSONL only
    logger.log({"val_loss": torch.tensor(2.5), "x": 1}, step=3)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.ReLU(), torch.nn.Linear(2, 1))
    logger.log_param_histograms(model, step=4)
    logger.close()
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["val-loss"] == recs[0]["val_loss"] == 2.5 and recs[0]["step"] == 3
    assert sorted(recs[1]) == sorted([f"paramnorm/{n}" for n, _ in model.named_parameters()]
                                     + ["step", "time"])
    np.testing.assert_allclose(recs[1]["paramnorm/0.weight"],
                               np.linalg.norm(model[0].weight.detach().double().numpy()))


def test_step_timer_and_trace(tmp_path):
    timer = tlog.StepTimer(str(tmp_path / "prof"), device="cpu")
    timer.start_trace()
    timer.reset()
    torch.ones(8).sum()
    timer.tick(4)
    assert timer.rate() > 0 and timer.count == 4
    timer.stop_trace()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert list(tlog.progress(range(3), desc="x", total=3)) == [0, 1, 2]


def test_plots_render(tmp_path):
    """``plot_batch``, ``plot_sample_batch`` and ``plot_loss_curves`` draw
    and save their figures (matplotlib imported when a figure is drawn)."""
    import matplotlib.pyplot as plt

    from probunet_torch.viz import plot_batch, plot_loss_curves, plot_sample_batch

    hr = _hr(t=2, hw=8)
    hr[..., 0] = np.abs(hr[..., 0]) * 1e-4      # precipitation in kg m-2 s-1
    hr[..., 1:] += 270.0                        # temperatures in K
    ts = np.array([0.0, 86400e9])
    variables = ("pr", "tasmin", "tasmax")
    fig, axs = plot_batch(hr, hr * 1.01, hr, ts, 3, variables, N=2)
    assert len(axs) == 2 and axs[0].shape == (3, 4)
    fig.savefig(tmp_path / "batch.png")
    plt.close(fig)
    fig, axs = plot_sample_batch(hr, np.stack([hr, hr * 0.99], axis=1), hr, ts, 2, variables,
                                 N=2, num_samples=2)
    assert axs.shape == (3, 4)
    plt.close(fig)
    plot_loss_curves([3.0, 2.0], [3.5, 2.5], str(tmp_path / "loss.png"))
    assert os.path.getsize(tmp_path / "batch.png") > 0 and os.path.getsize(tmp_path / "loss.png") > 0
