"""The trace readers on a hand-made Chrome trace (CPU only).

Two segments of two calls each. Per call: a conv op launching two conv
kernels, the port's attention forward kernel, K1, and a copy; the second
segment lost one record of ``conv_b`` (the profiler drops records late in
long traces) and holds a stray kernel of earlier work.
"""

import json

import pytest

from perfbench import harness, trace


def _call(events, t, corr, tid=1, lose_b=False):
    """One call from host time ``t`` (us): returns the time after it."""
    # host ops: aten::convolution encloses two launches
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "ts": t, "dur": 20,
                   "tid": tid})
    kernels = [("conv_a", 10), ("conv_b", 30), ("attention_fwd_f32<64>", 40),
               ("gn_silu_fused", 10)]
    dev = t + 5
    for j, (name, dur) in enumerate(kernels):
        c = corr + j
        ts_launch = t + 2 + 5 * j if j < 2 else t + 25 + 5 * j
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": ts_launch, "dur": 1, "tid": tid, "args": {"correlation": c}})
        if not (lose_b and name == "conv_b"):
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": dev, "dur": dur,
                           "tid": 7, "args": {"correlation": c}})
        dev += dur
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": t + 50, "dur": 5,
                   "tid": tid})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": t + 51,
                   "dur": 1, "tid": tid, "args": {"correlation": corr + 10}})
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": dev + 10,
                   "dur": 10, "tid": 7, "args": {"correlation": corr + 10}})
    return dev + 20


def _segment(lose_b=False, stray=False):
    events, t = [], 1000.0
    start = t
    for c in range(2):
        t = _call(events, t, corr=100 * (c + 1), lose_b=lose_b and c == 1)
    if stray:
        events.append({"ph": "X", "cat": "kernel", "name": "old_work", "ts": start + 1, "dur": 2,
                       "tid": 7, "args": {"correlation": 1}})
    events.append({"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": start,
                   "dur": t - start, "tid": 1})
    return trace.Segment(events, calls=2)


@pytest.fixture
def segments():
    return [_segment(), _segment(lose_b=True, stray=True)]


def test_window_and_busy(segments):
    s = segments[0]
    # per call: kernels 5..95 (90 us of busy), copy 100..110; next call starts at 115
    assert s.window_s == pytest.approx(230e-6)
    assert s.busy_s() == pytest.approx(2 * 100e-6)
    gaps = dict(s.idle_gaps())
    assert sum(g for _, g in s.idle_gaps()) == pytest.approx(30e-6)
    assert "aten::convolution" in gaps   # the first kernel of each call was launched in it


def test_pooled_estimator_and_launches(segments):
    conv = trace.kernel_filter({"ops": ["aten::convolution"]})
    # conv_a 10 us a launch; conv_b 30 us (the lost record thins the count,
    # not the mean), one launch per call each: 40 us = 0.04 ms per call
    assert trace.pooled_ms(segments, conv) == pytest.approx(0.04)
    attn = trace.kernel_filter({"names": ["attention_fwd_"]})
    assert trace.pooled_ms(segments, attn) == pytest.approx(0.04)
    # conv_a, conv_b, attention, K1 once per call; the stray kernel rounds to 0
    assert trace.launches_per_call(segments) == 4


def test_shares_stay_under_100_for_kernels_that_meet_their_bounds(segments):
    # a cell whose sites' bounds equal the kernels' measured times reads 100 %
    counts = {"flops": 2 * 0.5e-6 * 1e12 * 2, "conv": [{"flops": 40e-6 * 1e12, "bytes": 0}],
              "attn": [{"flops": 40e-6 * 1e12, "bytes": 0}],
              "gn": [{"flops": 0, "bytes": 10e-6 * 1e9}]}
    ctx = harness.TraceContext(segments, counts, peak_flops=1e12, hbm=1e9)
    got = {m: harness.reader(m)(ctx) for m in
           ("conv_roofline_pct.train", "attn_roofline_pct.serve", "gn_silu_roofline_pct.train",
            "mfu.train", "device_idle_pct.train", "launches_per_step.serve")}
    assert got["conv_roofline_pct.train"] == pytest.approx(100.0)
    assert got["attn_roofline_pct.serve"] == pytest.approx(100.0)
    assert got["gn_silu_roofline_pct.train"] == pytest.approx(100.0)
    for m in ("conv_roofline_pct.train", "attn_roofline_pct.serve",
              "gn_silu_roofline_pct.train", "mfu.train"):
        assert 0 < got[m] <= 100.0 + 1e-9
    # idle: 30 us of 230 in the first segment; in the second the lost conv_b
    # leaves 30 us more idle and the stray kernel fills 2 us of a gap
    assert got["device_idle_pct.train"] == pytest.approx(100 * 88 / 460, rel=1e-6)
    assert got["launches_per_step.serve"] == 4
    # mfu: 2 us of peak work a call over 115 us of wall a call
    calls = sum(s.calls for s in segments)
    wall = sum(s.window_s for s in segments) / calls
    assert got["mfu.train"] == pytest.approx(100 * counts["flops"] / wall / 1e12)


def test_a_reader_that_finds_nothing_returns_none(segments):
    ctx = harness.TraceContext(segments, {"flops": 1.0, "conv": [], "attn": [], "gn": []},
                               peak_flops=1e12, hbm=1e9)
    ctx.kernels["attention"] = {"names": ["no_such_kernel"]}
    assert harness.reader("attn_roofline_pct.train")(ctx) is None


def test_loads_an_exported_trace(tmp_path):
    events = []
    _call(events, 1000.0, 100)
    path = tmp_path / "t.json"
    events.append({"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 1000.0,
                   "dur": 115.0, "tid": 1})
    path.write_text(json.dumps({"traceEvents": events}))
    loaded = trace.load_segment(str(path), 1)
    assert loaded.window_s == pytest.approx(115e-6)
    assert len(loaded.kernels()) == 4 and loaded.calls == 1
