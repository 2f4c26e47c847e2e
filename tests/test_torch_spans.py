"""The port's phase spans (``utils/logging.py::span``) and the trainer's
bounded trace window, on the CPU at a tiny size.

Under ``torch.profiler`` each training step is one ``probunet.train_step``
holding ``probunet.pair`` < ``.forward`` < ``.backward`` < ``.optimizer``,
each sampler call one ``probunet.sample`` holding ``.pair`` < ``.forward``
< ``.output``, as ``user_annotation`` events of the exported Chrome trace.
With no profiler recording a span enters no ``record_function``, and the
answers are bit-equal with and without one.
"""

import json
import os

import pytest
import torch

from probunet_torch.config import Config
from probunet_torch.train import steps as tsteps
from probunet_torch.train.loop import build_baseline_model, build_edm_model, build_probunet
from probunet_torch.train.state import create_train_state, make_optimizer
from probunet_torch.utils import logging as tlog

RES, LOWRES, K = 16, 4, 2
NET = dict(latent_dim=4, resolution=(RES, RES), num_filters=(8, 16), model_channels=16,
           channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,))
TRAIN = ["probunet.pair", "probunet.forward", "probunet.backward", "probunet.optimizer"]
SAMPLE = ["probunet.pair", "probunet.forward", "probunet.output"]


def _data():
    g = torch.Generator().manual_seed(3)
    hr = torch.randn(6, RES, RES, 3, generator=g)
    stats = (hr.mean(0), hr.std(0))
    return hr, stats, torch.tensor([4, 1]), g


def _train_call():
    """A fresh tiny prob-U-Net state and its first step's call."""
    cfg = Config(dropout=0.1, **NET)
    model = build_probunet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(1e-3, 0.01))
    step = tsteps.make_probunet_train_step(model, LOWRES, "perpixel")
    hr, stats, idx, _ = _data()
    return state, lambda: step(state, hr, stats, idx, 7)


def _deterministic_train_call():
    cfg = Config(ds_model="deterministic_unet", baseline_channels=8, dropout=0.1, **NET)
    model = build_baseline_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    state = create_train_state(model, make_optimizer(1e-3, 0.01))
    step = tsteps.make_deterministic_train_step(model, LOWRES, "perpixel")
    hr, stats, idx, _ = _data()
    return lambda: step(state, hr, stats, idx, torch.tensor([0.0, 86400e9]), 7)


def _edm_train_call():
    model = build_edm_model(Config(ds_model="edm", **NET), device="cpu",
                            generator=torch.Generator().manual_seed(5))
    state = create_train_state(model, make_optimizer(1e-3, 0.01))
    step = tsteps.make_edm_train_step(model, LOWRES, "perpixel")
    hr, stats, idx, _ = _data()
    return lambda: step(state, hr, stats, idx, 7)


def _sample_call():
    model = build_probunet(Config(**NET), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    fn = tsteps.make_sample_fn(model, LOWRES, "perpixel", K)
    hr, stats, idx, g = _data()
    eps = torch.randn(K, len(idx), NET["latent_dim"], generator=g)
    return lambda: fn(hr, stats, idx, eps=eps)[0]


def _edm_sample_call():
    model = build_edm_model(Config(ds_model="edm", **NET), device="cpu",
                            generator=torch.Generator().manual_seed(2))
    fn = tsteps.make_edm_sample_fn(model, LOWRES, "perpixel", K, num_steps=3)
    hr, stats, idx, g = _data()
    noise = torch.randn(K * len(idx), RES, RES, 3, generator=g)
    return lambda: fn(hr, stats, idx, noise=noise)[0]


def _traced(call, tmp_path):
    """(the call's result, the probunet.* user annotations of its trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("probunet.")), key=lambda s: (s[0], -s[1]))
    return out, spans


@pytest.mark.parametrize("call, root, phases", [
    (lambda: _train_call()[1], "probunet.train_step", TRAIN),
    (_deterministic_train_call, "probunet.train_step", TRAIN),
    (_edm_train_call, "probunet.train_step", TRAIN),
    (_sample_call, "probunet.sample", SAMPLE),
    (_edm_sample_call, "probunet.sample", SAMPLE),
], ids=["train_step", "deterministic_train_step", "edm_train_step", "sample", "edm_sample"])
def test_one_root_holds_its_phases_in_order(call, root, phases, tmp_path):
    _, spans = _traced(call(), tmp_path)
    roots = [s for s in spans if s[2] == root]
    assert len(roots) == 1, spans
    t0, t1, _ = roots[0]
    inner = [s for s in spans if s[2] != root]
    assert [s[2] for s in inner] == phases
    assert t0 <= inner[0][0] and inner[-1][1] <= t1
    for (_, end, _), (start, _, _) in zip(inner, inner[1:]):
        assert end <= start   # siblings, in order, without overlap


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    assert tlog.span("probunet.a") is tlog.span("probunet.b")
    with profile(activities=[ProfilerActivity.CPU]):
        live = tlog.span("probunet.a")
        assert isinstance(live, torch.profiler.record_function)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, step = _train_call()
    assert torch.isfinite(step()["train_loss"])
    assert torch.isfinite(_sample_call()()).all()
    assert torch.isfinite(_edm_sample_call()()).all()


def test_answers_are_bit_equal_with_and_without_a_profiler(tmp_path):
    plain_state, plain_step = _train_call()
    traced_state, traced_step = _train_call()
    a = plain_step()
    b, _ = _traced(traced_step, tmp_path)
    for key in ("train_loss", "recon_loss", "kl_div", "grad_norm"):
        assert torch.equal(a[key], b[key]), key
    for p, q in zip(plain_state.model.parameters(), traced_state.model.parameters()):
        assert torch.equal(p, q)
    for call in (_sample_call, _edm_sample_call):
        assert torch.equal(call()(), _traced(call(), tmp_path)[0])


def test_step_timer_traces_a_bounded_window(tmp_path):
    """The trace skips the first step, records the next ones and is written
    when its window closes; later steps run with no profiler."""
    import torch.autograd.profiler as autograd_profiler

    timer = tlog.StepTimer(str(tmp_path / "prof"), device="cpu")
    timer.start_trace()
    steps = tlog.TRACE_WARMUP_STEPS + tlog.TRACE_ACTIVE_STEPS
    for i in range(steps + 3):
        with tlog.span("probunet.train_step"):
            torch.ones(8).sum()
        timer.tick(4)
        if i == steps - 1:
            path = tmp_path / "prof" / "trace.json"
            assert path.exists() and timer._prof is None
            assert not autograd_profiler._is_profiler_enabled
    timer.stop_trace()
    assert timer.count == 4 * (steps + 3)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("probunet.train_step") == tlog.TRACE_ACTIVE_STEPS
