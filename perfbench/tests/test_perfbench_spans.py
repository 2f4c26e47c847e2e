"""The span readers (``perfbench/spans.py`` and the metrics that use it) on
a hand-made Chrome trace, and the phase table on a real CPU trace of the
program (CPU only).

Per call, from host time ``t`` (us): the benchmark's feed draw outside the
root, then the root span ``[t+5, t+95]`` on thread 1 holding ``pair``,
``forward``, ``backward`` (whose kernel thread 2 launches, as the autograd
engine does), a gradient norm outside every phase, and ``optimizer`` with
two launches. Two calls make a window of 200 us.
"""

import json

import pytest

from perfbench import harness, spans, trace

#: (name, launch at t + us, launching thread, device start, device end)
LAUNCHES = [("draw", 1, 1, 2, 3), ("pool", 6, 1, 8, 12), ("conv_f", 16, 1, 20, 40),
            ("conv_b", 45, 2, 48, 78), ("norm", 62, 1, 78, 80),
            ("adam_a", 66, 1, 85, 90), ("adam_b", 70, 1, 90, 95)]
PHASES = [("probunet.pair", 5, 15), ("probunet.forward", 15, 40),
          ("probunet.backward", 40, 60), ("probunet.optimizer", 65, 90)]


def _call(events, t, corr, root, with_spans):
    if with_spans:
        events.append({"ph": "X", "cat": "user_annotation", "name": root, "ts": t + 5,
                       "dur": 90, "tid": 1})
        for name, a, b in PHASES:
            events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": t + a,
                           "dur": b - a, "tid": 1})
    for j, (name, at, tid, d0, d1) in enumerate(LAUNCHES):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": t + at, "dur": 1, "tid": tid, "args": {"correlation": corr + j}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t + d0, "dur": d1 - d0,
                       "tid": 7, "args": {"correlation": corr + j}})


def _events(root="probunet.train_step", with_spans=True):
    events = []
    for c in range(2):
        _call(events, 1000.0 + 100 * c, 100 * (c + 1), root, with_spans)
    events.append({"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 1000.0,
                   "dur": 200.0, "tid": 1})
    return events


def _ctx(**kw):
    segs = [trace.Segment(_events(**kw), calls=2) for _ in range(2)]
    return harness.TraceContext(segs, {}, peak_flops=1e12, hbm=1e9)


def test_a_kernel_launched_on_another_thread_belongs_to_the_span_it_ran_in():
    seg = _ctx().segments[0]
    conv_b = next(d for d in seg.kernels() if d[2] == "conv_b")
    assert seg.launch[conv_b[3]][0] == 2
    assert spans.in_span("probunet.backward")(seg, conv_b)
    assert not spans.in_span("probunet.forward")(seg, conv_b)
    assert spans.device_ms(_ctx().segments, "probunet.backward") == pytest.approx(0.030)


@pytest.mark.parametrize("root, metric", [("probunet.train_step", "host_ms.train"),
                                          ("probunet.sample", "host_ms.serve")])
def test_host_ms_reads_the_root(root, metric):
    assert harness.reader(metric)(_ctx(root=root)) == pytest.approx(0.090)


def test_each_reader_returns_the_hand_computed_value():
    ctx = _ctx()
    got = {m: harness.reader(m)(ctx) for m in
           ("optimizer_ms.train", "optimizer_host_ms.train", "optimizer_launches.train",
            "optimizer_idle_pct.train", "pair_ms.train", "pair_ms.serve")}
    assert got["optimizer_ms.train"] == pytest.approx(0.010)        # adam_a + adam_b, 5 us each
    assert got["optimizer_host_ms.train"] == pytest.approx(0.025)   # [t+65, t+90]
    assert got["optimizer_launches.train"] == 2
    # the gaps before adam_a (t+80 -> t+85) of both calls: 10 us of 200
    assert got["optimizer_idle_pct.train"] == pytest.approx(5.0)
    assert got["pair_ms.train"] == got["pair_ms.serve"] == pytest.approx(0.004)
    # the gaps, as Segment.idle_gaps cuts them: 66 us, the window's end 5
    gaps = spans.gaps(ctx.segments[0])
    assert sum(s for _, s in gaps) == pytest.approx(66e-6)
    assert [s for d, s in gaps if d is None] == [pytest.approx(5e-6)]
    assert sum(s for _, s in gaps) == pytest.approx(sum(s for _, s in
                                                        ctx.segments[0].idle_gaps()))


@pytest.mark.parametrize("metric", ["host_ms.train", "host_ms.serve", "optimizer_ms.train",
                                    "optimizer_host_ms.train", "optimizer_launches.train",
                                    "optimizer_idle_pct.train", "pair_ms.train",
                                    "pair_ms.serve"])
def test_a_trace_without_the_spans_reads_none(metric):
    assert harness.reader(metric)(_ctx(with_spans=False)) is None


def test_the_phase_table_splits_the_root():
    rows = {r["span"]: r for r in spans.table([_events(), _events()])}
    root = rows["probunet.train_step"]
    assert root["calls"] == 4 and root["host_ms"] == pytest.approx(0.090)
    # everything launched in the root but the draw: 4 + 20 + 30 + 2 + 10 us
    assert root["device_ms"] == pytest.approx(0.066)
    assert root["launches"] == 6
    assert rows[spans.OUTSIDE]["device_ms"] == pytest.approx(0.002)   # the norm
    assert rows[spans.OUTSIDE]["host_ms"] == pytest.approx(0.090 - 0.080)
    assert rows["probunet.forward"]["idle_ms"] == pytest.approx(0.008)
    assert rows["probunet.optimizer"]["launches"] == 2
    assert "probunet.output" not in rows


def test_the_phase_table_reads_a_profiled_training_step(tmp_path, capsys):
    """A trace as the trainer's ``--profile_dir`` writes it (no window):
    one step of a tiny prob-U-Net on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step

    cfg = Config(latent_dim=4, resolution=(16, 16), num_filters=(8, 16), model_channels=16,
                 channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,))
    model = build_probunet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer())
    step = make_probunet_train_step(model, 4, "perpixel")
    hr = torch.randn(4, 16, 16, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            step(state, hr, (hr.mean(0), hr.std(0)), torch.tensor([i, 3]), 5)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    rows = {r["span"]: r for r in spans.table([spans.load(path)])}
    assert rows["probunet.train_step"]["calls"] == 2
    for name in ("probunet.pair", "probunet.forward", "probunet.backward",
                 "probunet.optimizer"):
        assert 0 < rows[name]["host_ms"] < rows["probunet.train_step"]["host_ms"]
    assert spans.main([path]) == 0
    assert "optimizer" in capsys.readouterr().out
    with open(path, "w") as f:
        json.dump({"traceEvents": _events(with_spans=False)}, f)
    assert spans.main([path]) == 1
