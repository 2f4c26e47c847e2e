"""Real multi-process runs of the port on the CPU (gloo), each held against
one process computing the same global batches (``--data_shards N``), as
tests/test_multihost_e2e.py holds the JAX package's: the prob-U-Net with
dropout 0.1, the EDM downscaler and the deterministic U-Net trained by
``python -m probunet_torch.train`` in two processes, a two-process resume,
the float64 collectives and ``run_bcsd`` (three processes), and serving by
``python -m probunet_torch.serve`` (four processes, one of them with no
batch). Every
child runs one torch thread (``tests/_torch_cli_child.py``). Limits, from the
JAX test: step 1 within 1e-5 relative (the same parameters and global
batch; only the summation order of the gradient across two backwards
differs), the whole trajectory and the val loss within 5e-3 (that noise
compounds through the optimizer). Also the port's ``--data_shards 2`` loop
against the JAX package's: the same global batch ids fed to each step and
the same global statistics."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from probunet_torch.config import Config as TConfig
from probunet_torch.data.netcdf import NetCDFFile
from probunet_torch.data.synthetic import generate_climex_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_CHILD = os.path.join(REPO, "tests", "_torch_cli_child.py")
COLLECTIVES_CHILD = os.path.join(REPO, "tests", "_torch_collectives_child.py")
LAUNCH_VARS = ("COORDINATOR_ADDRESS", "PROBUNET_NUM_PROCESSES", "PROBUNET_PROCESS_ID",
               "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")
STEP1_RTOL, TRAJ_RTOL = 1e-5, 5e-3
STEPS = 8   # 4 train years x 16 days at batch 8, stratified over 2 shards


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_names(n):
    """The JAX package's launch variables of ``n`` ranks."""
    port = _free_port()
    return [{"COORDINATOR_ADDRESS": f"localhost:{port}", "PROBUNET_NUM_PROCESSES": str(n),
             "PROBUNET_PROCESS_ID": str(r)} for r in range(n)]


def _torchrun_names(n):
    """torchrun's launch variables of ``n`` ranks."""
    port = _free_port()
    return [{"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
             "RANK": str(r), "LOCAL_RANK": str(r)} for r in range(n)]


def _start(script, args, launch=None):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(OMP_NUM_THREADS="1", **(launch or {}))
    return subprocess.Popen([sys.executable, script, *args], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout=240):
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    failed = [f"child {i}:\n{out[-3000:]}" for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode]
    assert not failed, "\n".join(failed)
    return outs


def _flags(datadir, out, tag, extra=()):
    """tests/test_multihost_e2e.py's flags (default dropout 0.1)."""
    return ["--device", "cpu", "--datadir", datadir,
            "--years_train", "2000,2004", "--years_val", "2004,2005", "--years_test", "2005,2006",
            "--coords", "0,16,0,16", "--resolution", "16,16", "--lowres_scale", "4",
            "--standardization", "perpixel", "--batch_size", "8", "--num_epochs", "1",
            "--log_every", "1", "--latent_dim", "4", "--num_filters", "8,16",
            "--model_channels", "8", "--channel_mult", "1,2", "--num_blocks", "1",
            "--attn_resolutions", "8", "--lr", "1e-3", "--seed", "42",
            "--metrics_path", os.path.join(out, f"{tag}.jsonl"),
            "--checkpoints_dir", os.path.join(out, f"{tag}_ckpt"), *extra]


def _train_legs(datadir, out, tag, extra=(), names=_jax_names):
    """One process with --data_shards 2 and two processes, started
    together; each process plots into its own directory."""
    single = _start(CLI_CHILD, ["probunet_torch.train", *_flags(
        datadir, out, f"{tag}_single", (*extra, "--data_shards", "2",
                                        "--plotdir", os.path.join(out, f"{tag}_plots_s")))])
    ranks = [_start(CLI_CHILD, ["probunet_torch.train", *_flags(
        datadir, out, f"{tag}_multi", (*extra, "--plotdir", os.path.join(out, f"{tag}_plots_m{r}")))],
        launch) for r, launch in enumerate(names(2))]
    _wait([single, *ranks])


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _series(recs, key):
    return np.asarray([r[key] for r in recs if key in r and "epoch" not in r])


def _check_parity(out, tag, keys):
    single = _records(os.path.join(out, f"{tag}_single.jsonl"))
    multi = _records(os.path.join(out, f"{tag}_multi.jsonl"))
    # rank 0 alone writes the record: as many records as the single run
    assert [sorted(r) for r in multi] == [sorted(r) for r in single]
    for key in keys:
        s, m = _series(single, key), _series(multi, key)
        assert len(s) == len(m) == STEPS, (key, len(s), len(m))
        np.testing.assert_allclose(m[0], s[0], rtol=STEP1_RTOL, err_msg=key)
        np.testing.assert_allclose(m, s, rtol=TRAJ_RTOL, err_msg=key)
    ep_s = [r for r in single if "epoch" in r]
    ep_m = [r for r in multi if "epoch" in r]
    assert len(ep_s) == len(ep_m) == 1
    for key in ep_s[0]:
        if key not in ("step", "time"):
            np.testing.assert_allclose(ep_m[0][key], ep_s[0][key], rtol=TRAJ_RTOL, err_msg=key)
    return single, multi


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mh_data"))
    generate_climex_like(d, years=range(2000, 2006), grid=16, days_per_year=16, seed=7)
    return d


@pytest.fixture(scope="module")
def probunet_legs(data, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh_probunet"))
    _train_legs(data, out, "pu")
    return out


def test_two_process_training_matches_single_process(probunet_legs):
    """prob-U-Net, dropout 0.1: losses and the global gradient norm per
    step, and the epoch's val losses (rank 0 alone writes them, and alone
    draws the loss curve)."""
    out = probunet_legs
    _check_parity(out, "pu", ("train_loss", "recon_loss", "kl_div", "grad_norm"))
    assert os.path.exists(os.path.join(out, "pu_plots_m0", "loss.png"))
    assert not os.path.exists(os.path.join(out, "pu_plots_m1", "loss.png"))


def test_two_process_resume_is_exact(probunet_legs, data):
    """Two processes stopped at step 3 (rank 0 writes the checkpoint), then
    two processes resumed from it: the steps after 3 and the final
    parameters and optimizer state equal the uninterrupted two-process
    run's bit for bit."""
    out = probunet_legs
    ckpt = os.path.join(out, "rs_ckpt")
    for extra in (("--max_steps", "3"), ("--resume", os.path.join(ckpt, "probunet"))):
        _wait([_start(CLI_CHILD, ["probunet_torch.train", *_flags(
            data, out, "rs", (*extra, "--plotdir", os.path.join(out, f"rs_plots{r}")))], launch)
            for r, launch in enumerate(_jax_names(2))])
    full = _series(_records(os.path.join(out, "pu_multi.jsonl")), "train_loss")
    resumed = _series(_records(os.path.join(out, "rs.jsonl")), "train_loss")
    np.testing.assert_array_equal(resumed, full)   # steps 1-3, then 4-8 after the resume
    a = torch.load(os.path.join(out, "pu_multi_ckpt", "probunet", "state", "state.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(ckpt, "probunet", "state", "state.pt"), weights_only=True)
    assert a["step"] == b["step"] == STEPS
    for name, w in a["params"].items():
        torch.testing.assert_close(b["params"][name], w, rtol=0, atol=0, msg=name)
    for sa, sb in zip(a["optimizer"]["inner"]["state"].values(),
                      b["optimizer"]["inner"]["state"].values()):
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0)


def test_two_process_edm_training_matches_single_process(data, tmp_path):
    """The EDM downscaler (a mean loss: gradients averaged over the ranks),
    launched by torchrun's variables."""
    out = str(tmp_path)
    _train_legs(data, out, "edm", ("--ds_model", "edm", "--edm_steps", "2"), _torchrun_names)
    _check_parity(out, "edm", ("train_loss", "grad_norm"))


def test_two_process_baseline_training_matches_single_process(data, tmp_path):
    """The deterministic U-Net with cyclic time labels (timestamps ride in
    each rank's rows): per-variable losses, the eval losses and the final
    physical-unit MAE."""
    out = str(tmp_path)
    extra = ("--ds_model", "deterministic_unet", "--baseline_channels", "8",
             "--timetransform", "cyclic")
    _train_legs(data, out, "det", extra)
    single, multi = _check_parity(out, "det", ("train_loss",))
    mae_s = [r for r in single if "mae_pr" in r]
    mae_m = [r for r in multi if "mae_pr" in r]
    assert len(mae_s) == len(mae_m) == 1
    for v in ("pr", "tasmin", "tasmax"):
        np.testing.assert_allclose(mae_m[0][f"mae_{v}"], mae_s[0][f"mae_{v}"], rtol=TRAJ_RTOL)


def _kelvin_half_century(pid):
    """Keep in sync with tests/_torch_collectives_child.py::local_moments."""
    x = 273.0 + 5.0 * np.random.default_rng(1234 + pid).standard_normal((18250, 4, 4, 3))
    return x, x.sum(axis=0, dtype=np.float64), np.square(x).sum(axis=0, dtype=np.float64)


def test_three_process_collectives_and_bcsd(data, tmp_path):
    """Three processes: float64 moments summed in process order, ((p0 + p1)
    + p2), bit for bit on every rank (float32 would lose the std; with three
    terms the order shows), counts above 2**24 exact, each rank's train
    shard, ``run_bcsd`` with the climatologies summed across the processes
    against one process over every train year (the predictions within
    chip_smoke's BCSD limit, 1e-5 of the largest value: fp32 day-of-year
    sums in another order; the MAEs within 1e-5), and one prob-U-Net step
    with dropout 0.1 and filled weights on each rank's 2 rows against one
    process's step on the 6 rows: the loss and gradient norm within the
    step-1 limit, every gradient within 1e-5 of its tensor's largest entry
    (the same masks and noise; the sums of three backwards in another
    order)."""
    import _torch_collectives_child as child

    from probunet_torch.config import get_config
    from probunet_torch.train.engine import load_datasets
    from probunet_torch.train.loop import run_bcsd

    prefix = str(tmp_path / "coll")
    flags = _flags(data, str(tmp_path), "bcsd")[2:]   # no --device: the child picks the CPU
    _wait([_start(COLLECTIVES_CHILD, [prefix, *flags], launch) for launch in _jax_names(3)])
    halves = [_kelvin_half_century(p) for p in range(3)]
    s1_ref = (halves[0][1] + halves[1][1]) + halves[2][1]
    s2_ref = (halves[0][2] + halves[1][2]) + halves[2][2]
    n_ref = sum(len(h[0]) for h in halves)
    cfg = get_config(flags)
    ref = run_bcsd(cfg, load_datasets(cfg, "cpu"), chunk=7, device="cpu")
    hr, stats = child.step_batch(3 * child.STEP_ROWS)
    step_ref = child.one_step(child.step_state(), hr, stats, None)
    for pid in range(3):
        r = np.load(f"{prefix}.p{pid}.npz")
        np.testing.assert_array_equal(r["rs1"], s1_ref)
        np.testing.assert_array_equal(r["rs2"], s2_ref)
        assert int(r["rn"]) == n_ref
        np.testing.assert_array_equal(r["counts"], [16_777_217, 16_777_218, 16_777_219])
        assert r["train_years"].tolist() == [[2000, 2001], [2002], [2003]][pid]
        for split in ("val", "test"):
            want = ref[split]["preds"]
            assert np.abs(r[f"{split}_preds"] - want).max() <= 1e-5 * np.abs(want).max()
            np.testing.assert_allclose(r[f"{split}_mae"], list(ref[split]["mae"].values()),
                                       rtol=1e-5)
        for key in ("loss", "grad_norm"):   # one step on a rank's rows of the global batch
            np.testing.assert_allclose(r[key], step_ref[key], rtol=STEP1_RTOL, err_msg=key)
        for key, g in step_ref.items():
            if key.startswith("grad/"):
                assert np.abs(r[key] - g).max() <= 1e-5 * max(np.abs(g).max(), 1e-12), key
    std_ref = np.concatenate([h[0] for h in halves]).std(axis=0, ddof=1, dtype=np.float64)
    np.testing.assert_allclose(np.load(f"{prefix}.p0.npz")["std"], std_ref, rtol=1e-6)
    # float32 sums of the same moments would miss that limit
    s2_f32 = sum(h[2].astype(np.float32) for h in halves).astype(np.float64)
    mean = s1_ref / n_ref
    std_f32 = np.sqrt(np.maximum((s2_f32 - n_ref * mean * mean) / (n_ref - 1), 0))
    assert np.max(np.abs(std_f32 - std_ref) / std_ref) > 1e-6


def test_four_process_serving_matches_single_process(probunet_legs, data, tmp_path):
    """``python -m probunet_torch.serve`` from the prob-U-Net checkpoint of
    the one-process leg: 16 test days at batch 6 are 3 batches (the last
    ragged), so of four processes the last owns none and writes an empty
    part. The merged file equals the one-process file: every variable
    array-equal, the time axis and the attributes equal; no part is left."""
    ckpt = os.path.join(probunet_legs, "pu_single_ckpt", "probunet")
    flags = [a for a in _flags(data, str(tmp_path), "srv") if a not in ()]
    flags[flags.index("--batch_size") + 1] = "6"

    def serve(out, launch=None):
        return _start(CLI_CHILD, ["probunet_torch.serve", "--checkpoint", ckpt, "--out", out,
                                  "--num_samples", "3", *flags], launch)

    one, merged = str(tmp_path / "single.nc"), str(tmp_path / "multi.nc")
    outs = _wait([serve(one), *[serve(merged, launch) for launch in _jax_names(4)]])
    assert all("wrote" in o for o in outs)
    assert not any(os.path.exists(f"{merged}.part{r}") for r in range(4))
    with NetCDFFile(one) as a, NetCDFFile(merged) as b:
        for var in ("pr", "tasmin", "tasmax"):
            fa = a.read_var(var)
            assert fa.shape == (16, 3, 16, 16)
            np.testing.assert_array_equal(b.read_var(var), fa)
            assert dict(b._f[var].attrs) == dict(a._f[var].attrs)
        np.testing.assert_array_equal(b.read_time(), a.read_time())


def test_data_shards_plan_feeds_the_jax_batches(tmp_path, monkeypatch):
    """The port's ``--data_shards 2`` loop and the JAX package's, on the
    same datasets: every training step and every eval batch is fed the same
    global batch ids (recorded where each plan assembles a batch), from the
    same GLOBAL perpixel statistics (2e-4: each side pools in fp32, as
    tests/test_torch_multihost.py states). Losses are not compared: jax.random
    and torch draw different dropout masks, so the JAX side runs its engine
    and plan with its model, steps and checkpoints stubbed out (compiling
    them would only slow the test)."""
    import probunet_torch.parallel.multihost as tmh
    from probunet_torch.data.dataset import ClimexDataset as TDataset
    from probunet_torch.train.loop import train_probunet as t_train
    from probunet_tpu.config import Config as JConfig
    from probunet_tpu.data.dataset import ClimexDataset as JDataset
    from probunet_tpu.parallel import multihost as jmh
    from probunet_tpu.train.loop import train_probunet as j_train

    import jax.numpy as jnp
    import probunet_tpu.train.engine as JE
    import probunet_tpu.train.loop as JL
    from probunet_tpu.train.state import TrainState as JTrainState

    torch.set_num_threads(2)
    monkeypatch.setattr(JL, "init_probunet_state",
                        lambda cfg, model, tx: JTrainState({"w": jnp.zeros(())}, None, 0))
    monkeypatch.setattr(JL, "make_probunet_train_step", lambda *a, **k: (
        lambda state, hr, stats, idx, rng: (state, {"train_loss": jnp.zeros(())})))
    monkeypatch.setattr(JL, "make_probunet_eval_step", lambda *a, **k: (
        lambda params, hr, stats, idx, rng, beta: {"val_loss": jnp.zeros(())}))
    monkeypatch.setattr(JE, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(JE, "put_replicated", lambda state, mesh: state)
    rng = np.random.default_rng(3)
    hr = {k: (280.0 + rng.standard_normal((n, 16, 16, 3))).astype(np.float32)
          for k, n in (("train", 16), ("val", 8), ("test", 4))}
    years = {"train": range(2000, 2004), "val": range(2004, 2006), "test": range(2006, 2007)}
    kw = dict(resolution=(16, 16), lowres_scale=4, batch_size=4, num_epochs=2, latent_dim=4,
              num_filters=(8,), model_channels=8, channel_mult=(1, 2), num_blocks=1,
              attn_resolutions=(8,), log_every=1, standardization="perpixel", data_shards=2)
    logs, plans = {}, {}
    for side, Cfg, Ds, mh, train, dev in (
            ("jax", JConfig, JDataset, jmh, j_train, {}),
            ("port", TConfig, TDataset, tmh, t_train, {"device": "cpu"})):
        log = logs[side] = []
        host = "device_batch" if side == "jax" else "_host_rows"
        orig = getattr(mh.MultihostPlan, host)

        def record(self, hr_np, gids, *a, _orig=orig, _log=log, _side=side, **k):
            plans[_side] = self
            src = k.get("replicated_source", a[2] if len(a) > 2 else False)
            _log.append(("val" if src else "train", np.asarray(gids).tolist()))
            return _orig(self, hr_np, gids, *a, **k)

        monkeypatch.setattr(mh.MultihostPlan, host, record)
        datasets = {s: Ds(hr=hr[s], standardization="perpixel", lowres_scale=4, years=years[s],
                          **dev) for s in hr}
        cfg = Cfg(**kw, plotdir=str(tmp_path / f"plots_{side}"),
                  checkpoints_dir=str(tmp_path / f"ckpt_{side}"))
        train(cfg, datasets=datasets, make_plots=False, **dev)
    assert [e for e in logs["port"] if e[0] == "train"] == \
        [e for e in logs["jax"] if e[0] == "train"]
    assert len([e for e in logs["port"] if e[0] == "train"]) == 2 * 4   # 2 epochs x 4 steps
    assert [e for e in logs["port"] if e[0] == "val"] == [e for e in logs["jax"] if e[0] == "val"]
    for g, w in zip(plans["port"].stats_np, plans["jax"].stats_np):
        np.testing.assert_allclose(g, w, rtol=2e-4)
