"""The all-reduce readers (``allreduce_ms``, ``allreduce_exposed_ms``) on a
hand-made Chrome trace of a data-parallel step (CPU only).

Per call, from host time ``t`` (us): the root span ``[t+5, t+95]`` on
thread 1 holding ``backward`` (whose kernels thread 2 launches, as the
autograd engine does), ``allreduce`` (the flattening ``cat``, NCCL's
all-reduce, the copy back) and ``optimizer``. A late backward kernel on
another stream overlaps the start of the NCCL kernel, and the flattening
and the copy touch its ends. Two calls make a window of 200 us.
"""

import pytest

from perfbench import harness, trace

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
#: (name, launch at t + us, launching thread, device start, device end)
LAUNCHES = [("conv_b", 12, 2, 14, 40), ("late_b", 38, 2, 44, 50), ("cat", 41, 1, 41, 43),
            ("nccl", 42, 1, 43, 70), ("copy", 55, 1, 70, 72), ("adam", 62, 1, 72, 80)]
PHASES = [("probunet.backward", 10, 40), ("probunet.allreduce", 40, 60),
          ("probunet.optimizer", 60, 90)]


def _events(with_nccl=True, with_spans=True):
    events = []
    for c in range(2):
        t, corr = 1000.0 + 100 * c, 100 * (c + 1)
        if with_spans:
            events.append({"ph": "X", "cat": "user_annotation", "name": "probunet.train_step",
                           "ts": t + 5, "dur": 90, "tid": 1})
            for name, a, b in PHASES:
                events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": t + a,
                               "dur": b - a, "tid": 1})
        for j, (name, at, tid, d0, d1) in enumerate(LAUNCHES):
            if name == "nccl" and not with_nccl:
                continue
            events.append({"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
                           "ts": t + at, "dur": 1, "tid": tid, "args": {"correlation": corr + j}})
            events.append({"ph": "X", "cat": "kernel", "name": NCCL if name == "nccl" else name,
                           "ts": t + d0, "dur": d1 - d0, "tid": 7,
                           "args": {"correlation": corr + j}})
    events.append({"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 1000.0,
                   "dur": 200.0, "tid": 1})
    return events


def _ctx(**kw):
    segs = [trace.Segment(_events(**kw), calls=2) for _ in range(2)]
    return harness.TraceContext(segs, {}, peak_flops=1e12, hbm=1e9)


def test_allreduce_ms_reads_what_the_span_launched():
    # cat 2 + NCCL 27 + copy 2 us a call; late_b ran in it but was launched in backward
    assert harness.reader("allreduce_ms.train")(_ctx()) == pytest.approx(0.031)


def test_allreduce_exposed_ms_reads_the_nccl_kernel_alone():
    # NCCL [43, 70] less late_b [44, 50]; cat and copy only touch its ends
    assert harness.reader("allreduce_exposed_ms.train")(_ctx()) == pytest.approx(0.021)


def test_alone_s_clips_to_the_window():
    events = _events()
    win = next(e for e in events if e["name"] == trace.WINDOW)
    win["dur"] = 160.0   # the window ends at t + 60 of the second call
    seg = trace.Segment(events, calls=2)
    nccl = trace.kernel_filter({"names": ["nccl"]})
    # call 1: 21 us; call 2: [43, 60] less [44, 50] = 11 us
    assert trace.alone_s(seg, nccl) == pytest.approx(32e-6)


@pytest.mark.parametrize("metric", ["allreduce_ms.train", "allreduce_exposed_ms.train"])
def test_a_trace_without_the_collective_reads_none(metric):
    """One card: no span around an all-reduce and no NCCL kernel."""
    assert harness.reader(metric)(_ctx(with_nccl=False, with_spans=False)) is None


def test_a_span_without_its_nccl_kernel_reads_its_other_operations():
    ctx = _ctx(with_nccl=False)
    assert harness.reader("allreduce_ms.train")(ctx) == pytest.approx(0.004)
    assert harness.reader("allreduce_exposed_ms.train")(ctx) is None
