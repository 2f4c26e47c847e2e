"""The port's trainer (``train/engine.py``, ``train/loop.py``) on the CPU
against the JAX package's: one JAX loop run at a tiny config gives the
(epoch, batch indices) sequence of its training steps and eval batches, its
metrics JSONL and a real orbax checkpoint at step 2; the port's loop must
feed its step the same sequence, write records with the same keys, and,
resumed from that checkpoint carried across by ``flax_train_state_to_torch``,
continue with the JAX run's steps 3 and 4. Also: one training step after a
transplanted two-step JAX state (parameters and optax state) for fp32 AdamW,
bf16-mu AdamW and accum=2 with clipping; the port's own exact resume,
finished-run and added-epoch semantics and checkpoint cadence (as
tests/test_round3_fixes.py::TestExactResume holds the JAX loop); remat; and
``python -m probunet_torch.train --synthetic``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import LATENT, LR, _data, _flat, _torch_model, models  # noqa: F401

import probunet_torch.train.engine as TE
from probunet_torch.config import Config as TConfig
from probunet_torch.data.dataset import ClimexDataset as TDataset
from probunet_torch.models import ProbabilisticUNet as TProbUNet
from probunet_torch.train import steps as tsteps
from probunet_torch.train.checkpoint import load_payload, save_checkpoint
from probunet_torch.train.loop import build_probunet as t_build
from probunet_torch.train.loop import init_probunet_state as t_init
from probunet_torch.train.loop import moving_average as t_moving_average
from probunet_torch.train.loop import train_probunet as t_train
from probunet_torch.train.state import create_train_state as t_create
from probunet_torch.train.state import make_optimizer as t_make_optimizer
from probunet_torch.utils.transplant import flax_train_state_to_torch
from probunet_tpu.config import Config as JConfig
from probunet_tpu.data.dataset import ClimexDataset as JDataset
from probunet_tpu.data import transforms as jt
from probunet_tpu.train import engine as JE
from probunet_tpu.train.checkpoint import restore_checkpoint as j_restore
from probunet_tpu.train.loop import abstract_probunet_state, build_probunet as j_build
from probunet_tpu.train.loop import moving_average as j_moving_average
from probunet_tpu.train.loop import train_probunet as j_train
from probunet_tpu.train.state import TrainState as JTrainState
from probunet_tpu.train.state import make_optimizer as j_make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These tests run tiny models, which many threads only slow down when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# 12 train days at batch 4: 3 steps per epoch, so max_steps=4 crosses into
# epoch 2 after the epoch-1 eval; 8 val days: 2 eval batches
TINY = dict(resolution=(16, 16), lowres_scale=4, batch_size=4, num_epochs=2, latent_dim=4,
            num_filters=(8,), model_channels=8, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), dropout=0.1, log_every=1, standardization="pertimestep")


def _hr(t, seed):
    return np.random.default_rng(seed).gamma(2.0, 1.0, (t, 16, 16, 3)).astype(np.float32)


SPLITS = {"train": (12, 1), "val": (8, 2), "test": (4, 3)}


def _t_datasets(train_days=12):
    sizes = dict(SPLITS, train=(train_days, 1))
    return {k: TDataset(hr=_hr(t, s), standardization="pertimestep", lowres_scale=4,
                        device="cpu") for k, (t, s) in sizes.items()}


def _dirs(tmp, tag):
    return dict(plotdir=os.path.join(str(tmp), f"plots_{tag}"),
                checkpoints_dir=os.path.join(str(tmp), f"ckpt_{tag}"))


def _record(monkeypatch, engine, log, to_list):
    """Record the (epoch, batch indices) of every item each side's loop
    feeds its step, and the indices of every val item, by wrapping the
    engine's item generators."""
    train_items, val_item = engine.EngineCtx.train_items, engine.EngineCtx.val_item

    def rec_train_items(self, epoch, offset):
        it, total = train_items(self, epoch, offset)

        def gen():
            try:
                for item in it:
                    log.append(("train", epoch, to_list(item["idx"])))
                    yield item
            finally:
                getattr(it, "close", lambda: None)()

        return gen(), total

    def rec_val_item(self, gids):
        log.append(("val", None, np.asarray(gids).tolist()))
        return val_item(self, gids)

    monkeypatch.setattr(engine.EngineCtx, "train_items", rec_train_items)
    monkeypatch.setattr(engine.EngineCtx, "val_item", rec_val_item)


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX loop once: max_steps=4, a checkpoint every 2 steps (each
    into its own directory), eval and CRPS after epoch 1. Returns its
    config, recorded sequence, metrics records and the step-2 checkpoint."""
    tmp = tmp_path_factory.mktemp("jax_loop")
    mp = pytest.MonkeyPatch()
    log = []
    _record(mp, JE, log, lambda a: np.asarray(a).tolist())
    save = JE.save_checkpoint
    mp.setattr(JE, "save_checkpoint",
               lambda d, s: save(os.path.join(d, f"step{int(s.step)}"), s))
    cfg = JConfig(max_steps=4, checkpoint_every=2, eval_crps=True, crps_samples=2,
                  **TINY, **_dirs(tmp, "jax"))
    datasets = {k: JDataset(hr=_hr(t, s), standardization="pertimestep", lowres_scale=4)
                for k, (t, s) in SPLITS.items()}
    try:
        res = j_train(cfg, datasets=datasets, make_plots=False)
    finally:
        mp.undo()
    assert int(res["state"].step) == 4
    return {"cfg": cfg, "log": log, "records": _records(os.path.join(cfg.plotdir, "metrics.jsonl")),
            "ckpt2": os.path.join(cfg.checkpoints_dir, "probunet", "step2")}


def test_loop_feeds_the_jax_sequence_and_writes_its_keys(jax_run, tmp_path, monkeypatch):
    """The port's loop at the JAX run's config: the same (epoch, indices) of
    every training step, the same val and CRPS batches, and metrics records
    with the same keys in the same order of records."""
    log = []
    _record(monkeypatch, TE, log, lambda t: t.tolist())
    cfg = TConfig(**{**vars(jax_run["cfg"]), **_dirs(tmp_path, "port"), "checkpoint_every": 0})
    res = t_train(cfg, datasets=_t_datasets(), make_plots=False, device="cpu")
    assert res["state"].step == 4
    assert [e for e in log if e[0] == "train"] == [e for e in jax_run["log"] if e[0] == "train"]
    assert log == jax_run["log"]
    assert [e[1] for e in log if e[0] == "train"] == [1, 1, 1, 2]
    recs = _records(os.path.join(cfg.plotdir, "metrics.jsonl"))
    assert [sorted(r) for r in recs] == [sorted(r) for r in jax_run["records"]]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    crps = [r for r in recs if "crps_batches_evaluated" in r]
    assert len(crps) == 1 and crps[0]["crps_batches_evaluated"] == 2


def test_resume_from_a_transplanted_jax_checkpoint(jax_run, tmp_path, monkeypatch):
    """The JAX run's orbax checkpoint at step 2 (parameters, optax state,
    step) -> ``flax_train_state_to_torch`` -> a port checkpoint; the port's
    loop resumed from it runs the JAX run's steps 3 and 4 (and the epoch-1
    eval between them), with the JAX moments and step count in its AdamW."""
    jcfg = jax_run["cfg"]
    tx = j_make_optimizer(jcfg.lr, jcfg.weight_decay, jcfg.accum, jcfg.optimizer,
                          state_dtype=jcfg.opt_state_dtype)
    template = abstract_probunet_state(jcfg, j_build(jcfg), tx)
    jstate = jax.device_get(j_restore(jax_run["ckpt2"], template))
    assert int(jstate.step) == 2

    cfg = TConfig(**{**vars(jcfg), **_dirs(tmp_path, "resumed"), "checkpoint_every": 0})
    state = t_init(cfg, t_build(cfg, device="meta"), t_make_optimizer(), device="cpu")
    names = [n for n, _ in state.model.named_parameters()]
    load_payload(state, flax_train_state_to_torch(jstate, names))
    assert state.step == 2
    inner = state.optimizer.inner
    mu = _flat(jstate.opt_state[0].mu)
    for name, p in state.model.named_parameters():
        st = inner.state[p]
        assert st["step"].item() == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])
    ckpt = save_checkpoint(os.path.join(str(tmp_path), "from_jax"), state)

    log = []
    _record(monkeypatch, TE, log, lambda t: t.tolist())
    res = t_train(cfg.replace(resume=os.path.dirname(ckpt)), datasets=_t_datasets(),
                  make_plots=False, device="cpu")
    assert res["state"].step == 4
    jax_after_2 = jax_run["log"][[i for i, e in enumerate(jax_run["log"])
                                  if e[0] == "train"][2]:]
    assert log == jax_after_2


# ---- one step after a transplanted JAX state ------------------------------------------

# (optimizer kwargs, accum, JAX steps before the transplant): fp32 AdamW,
# the bf16-mu variant, accum=2 with clipping after a whole window and
# inside one (mini_step 1, a running mean in acc_grads)
TRANSPLANT = {
    "adamw": (dict(), 1, 2),
    "adamw_bf16": (dict(state_dtype="bfloat16"), 1, 2),
    "accum2_clip": (dict(accum=2, grad_clip=50.0), 2, 2),
    "accum2_clip_mid_window": (dict(accum=2, grad_clip=50.0), 2, 1),
}


@pytest.mark.parametrize("variant", list(TRANSPLANT))
def test_step_after_transplanted_state_matches_jax(models, variant):  # noqa: F811
    jm, params, grad_fn = models
    opt_kw, accum, jax_steps = TRANSPLANT[variant]
    t_hr, t_stats, j_hr, j_stats = _data()
    rng = np.random.default_rng(len(variant) + 7)
    steps = jax_steps + 1
    idxs = [rng.choice(6, 2, replace=False) for _ in range(steps)]
    epss = [rng.standard_normal((2, LATENT)).astype(np.float32) for _ in range(steps)]

    tx = j_make_optimizer(lr=LR, **opt_kw)
    update = jax.jit(tx.update)
    p, opt_state = params, tx.init(params)
    j_losses, sign, clear = [], {}, {}
    for s in range(steps):
        idx = jnp.asarray(idxs[s])
        pair = jt.make_pair(j_hr[idx], 4, "pertimestep", jt.slice_stats(j_stats, "pertimestep", idx))
        (total, _), grads = grad_fn(p, pair["inputs"], pair["targets"], jnp.asarray(epss[s]), 1.0)
        upd, opt_state = update(grads, opt_state, p)
        p = optax.apply_updates(p, upd)
        j_losses.append(float(total))
        if s == jax_steps - 1:
            transplanted = jax.device_get(JTrainState(p, opt_state, jnp.asarray(s + 1, jnp.int32)))
        for name, g in _flat(grads).items():  # clear of zero, one sign at every step
            sign.setdefault(name, np.sign(g))
            ok = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.sign(g) == sign[name])
            clear[name] = clear.get(name, True) & ok

    tm = _torch_model(params)
    state = t_create(tm, t_make_optimizer(lr=LR, **opt_kw))
    load_payload(state, flax_train_state_to_torch(transplanted, [n for n, _ in tm.named_parameters()]))
    assert state.step == jax_steps and state.optimizer.mini_step == jax_steps % accum
    if accum > 1:
        acc = _flat(transplanted.opt_state.acc_grads)
        for a, (name, _) in zip(state.optimizer.acc, tm.named_parameters()):
            np.testing.assert_array_equal(a.numpy(), acc[name])
    step = tsteps.make_probunet_train_step(tm, 4, "pertimestep", accum=accum)
    m = step(state, t_hr, t_stats, torch.from_numpy(idxs[-1]), 0, eps=torch.from_numpy(epss[-1]))
    # the tolerances of test_torch_train.py::test_train_steps_match_jax
    assert m["train_loss"].item() == pytest.approx(j_losses[-1], rel=1e-4, abs=1e-6)
    tol = 3 * LR * 2 ** -6 if opt_kw.get("state_dtype") == "bfloat16" else 1e-5
    ref = _flat(p)
    for name, w in tm.named_parameters():
        d = np.abs(w.detach().numpy() - ref[name])
        assert d.max() <= 2 * LR * 3 + 1e-6, name
        assert d[clear[name]].max(initial=0.0) <= tol, name


@pytest.mark.parametrize("opt_kw", [dict(), dict(state_dtype="bfloat16"), dict(accum=3)],
                         ids=["adamw", "adamw_bf16", "accum3"])
def test_optimizer_state_roundtrip_keeps_the_config_lr(opt_kw):
    """``Optimizer.state_dict`` -> ``load_state_dict`` into an optimizer
    built with another lr: the moments, counts and accumulation window come
    from the state, the lr stays the new optimizer's (the config's, as the
    JAX engine rebuilds ``tx`` from the config on resume)."""
    torch.manual_seed(0)
    w = [torch.nn.Parameter(torch.randn(4, 3)), torch.nn.Parameter(torch.randn(3))]
    opt = t_make_optimizer(lr=1e-3, **opt_kw)(w)
    for _ in range(4):
        for p in w:
            p.grad = torch.randn_like(p)
        opt.step()
    w2 = [torch.nn.Parameter(p.detach().clone()) for p in w]
    opt2 = t_make_optimizer(lr=5e-4, **opt_kw)(w2)
    opt2.load_state_dict(opt.state_dict())
    assert [g["lr"] for g in opt2.inner.param_groups] == [5e-4]
    assert opt2.mini_step == opt.mini_step
    for p, q in zip(w, w2):
        for key, val in opt.inner.state[p].items():
            assert opt2.inner.state[q][key].dtype == val.dtype
            torch.testing.assert_close(opt2.inner.state[q][key], val, rtol=0, atol=0)
    assert opt2.inner.param_groups[0].get("count") == opt.inner.param_groups[0].get("count")
    for a, b in zip(opt.acc or [], opt2.acc or []):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_make_optimizer(accum=2)(w2).load_state_dict(t_make_optimizer()(w2).state_dict())


# ---- the port's own lifecycle ----------------------------------------------------------------

def _cfg(tmp, tag, **kw):
    return TConfig(**{**TINY, "num_epochs": 1, **_dirs(tmp, tag), **kw})


def test_interrupted_plus_resume_equals_uninterrupted(tmp_path):
    """Bit-equal on the CPU: the restored step gives (epoch, offset), the
    per-step streams derive from (seed, step), the optimizer state is
    restored whole."""
    datasets = _t_datasets(train_days=16)
    res_a = t_train(_cfg(tmp_path, "a", max_steps=2), datasets, False, "cpu")
    assert res_a["state"].step == 2
    ckpt = os.path.join(str(tmp_path), "ckpt_a", "probunet")
    res_b = t_train(_cfg(tmp_path, "b", resume=ckpt), datasets, False, "cpu")
    res_c = t_train(_cfg(tmp_path, "c"), datasets, False, "cpu")
    assert res_b["state"].step == res_c["state"].step == 4
    for a, b in zip(res_b["state"].model.state_dict().values(),
                    res_c["state"].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    inner_b, inner_c = res_b["state"].optimizer.inner, res_c["state"].optimizer.inner
    for pb, pc in zip(inner_b.param_groups[0]["params"], inner_c.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(inner_b.state[pb][key], inner_c.state[pc][key],
                                       rtol=0, atol=0)
    assert res_b["val_losses"] == res_c["val_losses"]


def test_resume_finished_run_and_added_epoch(tmp_path):
    datasets = _t_datasets()
    res = t_train(_cfg(tmp_path, "f"), datasets, False, "cpu")
    assert res["state"].step == 3
    ckpt = os.path.join(str(tmp_path), "ckpt_f", "probunet")
    # resuming a finished run is a no-op (no step, no new epoch)
    again = t_train(_cfg(tmp_path, "g", resume=ckpt), datasets, False, "cpu")
    assert again["state"].step == 3 and again["tr_losses"] == []
    assert not os.path.exists(os.path.join(str(tmp_path), "ckpt_g"))
    # a finished max_steps run as well
    stop = t_train(_cfg(tmp_path, "h", resume=ckpt, max_steps=3), datasets, False, "cpu")
    assert stop["state"].step == 3 and stop["tr_losses"] == []
    # extending num_epochs trains exactly the added epoch
    more = t_train(_cfg(tmp_path, "i", resume=ckpt, num_epochs=2), datasets, False, "cpu")
    assert more["state"].step == 6 and len(more["val_losses"]) == 1


def test_checkpoint_every_periodic_saves(tmp_path, monkeypatch):
    calls = []
    save = TE.save_checkpoint
    monkeypatch.setattr(TE, "save_checkpoint", lambda d, s: calls.append(s.step) or save(d, s))
    t_train(_cfg(tmp_path, "p", checkpoint_every=2), _t_datasets(train_days=16), False, "cpu")
    # 4 steps -> periodic saves at steps 2 and 4, plus the epoch-end save
    assert calls == [2, 4, 4]


def test_streaming_ingest_matches_resident(tmp_path):
    """``device_resident_data=False``: host batches through the prefetcher,
    statistics from the streaming pass; the same losses as the resident
    run (pertimestep statistics are computed per sample either way)."""
    datasets = _t_datasets()
    res = {}
    for tag, resident in (("res", True), ("str", False)):
        cfg = _cfg(tmp_path, tag, device_resident_data=resident, max_steps=3)
        t_train(cfg, datasets, False, "cpu")
        res[tag] = [r["train_loss"] for r in _records(os.path.join(cfg.plotdir, "metrics.jsonl"))
                    if "train_loss" in r]
    assert len(res["res"]) == 3
    np.testing.assert_allclose(res["str"], res["res"], rtol=1e-6)


def test_unported_modes_raise(tmp_path):
    """Spatial sharding (item 8) still raises; ``data_shards=2`` (item 7,
    the lockstep plan on one process) now trains: 12 train days over 3
    years shard 8 / 4, so 2 lockstep steps in the epoch at batch 4."""
    with pytest.raises(NotImplementedError, match="item 8"):
        t_train(_cfg(tmp_path, "x", parallel_mode="spatial"), _t_datasets(), False, "cpu")
    datasets = _t_datasets()
    datasets["train"].years = [2000, 2001, 2002]
    res = t_train(_cfg(tmp_path, "y", data_shards=2), datasets, False, "cpu")
    assert res["state"].step == 2 and len(res["val_losses"]) == 1


@pytest.mark.parametrize("x,w", [([], 3), ([1.0, 4.0, 2.0, 8.0], 2), ([5.0, 1.0], 24)])
def test_moving_average_matches_jax(x, w):
    np.testing.assert_array_equal(t_moving_average(x, w), j_moving_average(x, w))


# ---- remat ---------------------------------------------------------------------------------

def test_remat_matches_plain_backward():
    """Every U-Net block recomputed in the backward, dropout 0.1 drawn from
    the step's generator: the same loss and gradients as without remat
    (bit-equal on the CPU: the recompute replays the forward's masks), and
    the same parameters after two AdamW steps. Attention is on (model
    width 64), so the recompute runs the attention forward too."""
    kw = dict(num_filters=(16, 32), img_resolution=(16, 16), model_channels=64,
              channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,), dropout=0.1)
    t_hr, t_stats, _, _ = _data()
    out = {}
    for remat in (False, True):
        tm = TProbUNet(3, 3, latent_dim=LATENT, remat=remat, device="cpu",
                       generator=torch.Generator().manual_seed(3), **kw)
        with torch.no_grad():   # fill the zero-init convs, which would hide most of each block
            g = torch.Generator().manual_seed(4)
            for prm in tm.parameters():
                prm.copy_(torch.randn(prm.shape, generator=g) * 0.1)
        state = t_create(tm, t_make_optimizer())
        step = tsteps.make_probunet_train_step(tm, 4, "pertimestep")
        m = step(state, t_hr, t_stats, torch.tensor([0, 4]), 11)
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
        step(state, t_hr, t_stats, torch.tensor([1, 5]), 11)
        out[remat] = (m["train_loss"].item(), grads, tm.state_dict())
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, rtol=0, atol=0, msg=name)
    for name, w in out[False][2].items():
        torch.testing.assert_close(out[True][2][name], w, rtol=0, atol=0, msg=name)


# ---- the command line ----------------------------------------------------------------------------

def test_cli_synthetic_trains_and_plots(tmp_path):
    """``python -m probunet_torch.train --synthetic`` on synthetic files (16
    days a year, written here, so the command finds them): trains 2
    epochs, writes the loss curve, the epoch-2 ensemble plot, the metrics
    and a checkpoint."""
    from probunet_torch.data.synthetic import generate_climex_like

    out = str(tmp_path)
    generate_climex_like(os.path.join(out, "data"), years=(2000, 2001, 2002), grid=16,
                         days_per_year=16)
    argv = ["--synthetic", "--device", "cpu", "--datadir", os.path.join(out, "data"),
            "--years_train", "2000,2001", "--years_val", "2001,2002", "--years_test", "2002,2003",
            "--coords", "0,16,0,16", "--resolution", "16,16", "--batch_size", "4",
            "--num_epochs", "2", "--latent_dim", "4", "--num_filters", "8",
            "--model_channels", "8", "--channel_mult", "1,2", "--num_blocks", "1",
            "--attn_resolutions", "8", "--log_every", "2", "--plotdir", os.path.join(out, "plots"),
            "--checkpoints_dir", os.path.join(out, "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "probunet_torch.train", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final train loss" in proc.stdout and "Generating" not in proc.stdout
    for name in ("loss.png", "epoch2.png", "metrics.jsonl"):
        assert os.path.getsize(os.path.join(out, "plots", name)) > 0, name
    assert os.path.exists(os.path.join(out, "ckpt", "probunet", "state", "state.pt"))
