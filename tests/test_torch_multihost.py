"""The port's multi-process plan (``probunet_torch/parallel``) against the
JAX package's (``probunet_tpu/parallel/multihost.py``), numpy in and out at
the sizes of tests/test_multihost.py: the shard and merge math, the
stratified epoch plans, the shard sizes, the global statistics and a
``data_shards=2`` plan's batches and statistics on the same dataset. Each
case is exact unless it states its tolerance. Also the port's own pieces:
the launch environment's fail-fast, ``device_batch``/``batch_iter`` rows
against a direct gather, the process group's collectives and a training
step at world size 1 (one gloo rank in this process, bit-equal to no
group), and the serving merge of part files in both netCDF formats."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from probunet_torch.config import Config as TConfig
from probunet_torch.data import netcdf as tnetcdf
from probunet_torch.data import transforms as tt
from probunet_torch.data.dataset import ClimexDataset as TDataset
from probunet_torch.parallel import mesh as tmesh
from probunet_torch.parallel import multihost as tmh
from probunet_tpu.config import Config as JConfig
from probunet_tpu.data.dataset import ClimexDataset as JDataset
from probunet_tpu.parallel import make_mesh
from probunet_tpu.parallel import multihost as jmh


# ---- shard and merge math ----------------------------------------------------------------------

@pytest.mark.parametrize("pc", [1, 2, 3, 4, 7, 8, 16])
def test_shard_years_matches_jax(pc):
    years = list(range(1960, 2060))
    for i in range(pc):
        assert tmh.shard_years(years, i, pc) == jmh.shard_years(years, i, pc)
    assert [tmh.shard_years([2000, 2001], i, 4) for i in range(4)] == [[2000], [2001], [], []]
    with pytest.raises(ValueError):
        tmh.shard_years([2000], 2, 2)


def test_local_batch_slice_matches_jax():
    for b, pc in ((32, 4), (8, 2), (6, 3), (5, 1)):
        for i in range(pc):
            assert tmh.local_batch_slice(b, i, pc) == jmh.local_batch_slice(b, i, pc)
    with pytest.raises(ValueError):
        tmh.local_batch_slice(10, 0, 3)


def test_merge_moment_stats_matches_jax():
    rng = np.random.default_rng(0)
    chunks = [300.0 + rng.standard_normal((n, 4, 4)) for n in (100, 37, 263)]
    parts = [(c.sum(axis=0), (c * c).sum(axis=0), c.shape[0]) for c in chunks]
    for got, want in zip(tmh.merge_moment_stats(parts), jmh.merge_moment_stats(parts)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes,batch,seed,shuffle", [
    ([20, 20], 8, 3, True), ([12, 24], 4, 7, True), ([10], 5, 1, False),
    ([30, 25, 40], 6, 11, True), ([16, 16], 8, 42, False)])
def test_stratified_epoch_batches_match_jax(sizes, batch, seed, shuffle):
    got = tmh.stratified_epoch_batches(sizes, batch, seed, shuffle)
    np.testing.assert_array_equal(got, jmh.stratified_epoch_batches(sizes, batch, seed, shuffle))
    with pytest.raises(ValueError):
        tmh.stratified_epoch_batches([8, 8, 8], 8, seed)


def test_shard_sizes_for_matches_jax():
    for n, years, k in ((40, range(2000, 2004), 2), (40, range(2000, 2004), 3),
                        (365 * 7, range(1990, 1997), 4)):
        assert tmh.shard_sizes_for(n, years, k) == jmh.shard_sizes_for(n, years, k)
    with pytest.raises(ValueError):
        tmh.shard_sizes_for(41, range(2000, 2004), 2)


def test_single_process_collectives_are_the_identity():
    a = np.arange(6.0).reshape(2, 3)
    (out,) = tmh.allreduce_sum(a)
    np.testing.assert_array_equal(out, a)
    np.testing.assert_array_equal(tmh.allgather_counts(37), [37])
    assert tmh.allreduce_moments(a, a, 5) == (a, a, 5)
    assert tmh.process_info() == (0, 1)


def test_global_perpixel_stats_match_jax():
    """Single process: both pool in fp32 (torch's and XLA's CPU kernels, in
    other summation orders) and sum the moments in float64. The means agree
    to an fp32 ulp of 280 K; the std (~0.5) sees that ulp through ``s2 -
    n mean^2``, so it is held to tests/test_multihost.py's 2e-4."""
    hr = np.asarray(280.0 + np.random.default_rng(0).standard_normal((24, 8, 8, 3)), np.float32)
    got = tmh.global_perpixel_stats(hr, 2, device="cpu")
    want = jmh.global_perpixel_stats(hr, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-7, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)


# ---- a data_shards=2 plan on one process --------------------------------------------------------

STANDARDIZATIONS = ["none", "pertimestep", "perpixel", "minmax"]


def _hr():
    return np.asarray(2.0 + np.random.default_rng(1).standard_normal((16, 8, 8, 3)), np.float32)


def _plans(standardization):
    """The same dataset and config on both sides (tests/test_multihost.py's
    plan fixture): 16 days over 4 years, batch 4, 2 shards."""
    kw = dict(standardization=standardization, lowres_scale=2, years=range(2000, 2004))
    tds = TDataset(hr=_hr(), device="cpu", **kw)
    jds = JDataset(hr=_hr(), **kw)
    ckw = dict(standardization=standardization, lowres_scale=2, batch_size=4, data_shards=2,
               resolution=(8, 8))
    tplan = tmh.make_plan(TConfig(**ckw), tds, "cpu")
    jplan = jmh.make_plan(JConfig(**ckw), jds, make_mesh((-1,), ("data",)))
    return tds, tplan, jds, jplan


@pytest.mark.parametrize("standardization", STANDARDIZATIONS)
def test_plan_matches_jax(standardization):
    """Shard sizes, steps per epoch and epoch plans exact; the split
    statistics within the tolerance of test_global_perpixel_stats_match_jax
    (perpixel, pooled in fp32 by each side's CPU kernels), the per-sample
    ones (pertimestep, minmax) within 1e-6."""
    tds, tplan, jds, jplan = _plans(standardization)
    assert tplan.shard_sizes == jplan.shard_sizes == [8, 8]
    assert tplan.steps_per_epoch == jplan.steps_per_epoch == 4
    for seed in (0, 5, 43):
        np.testing.assert_array_equal(tplan.epoch_batches(seed), jplan.epoch_batches(seed))
    np.testing.assert_array_equal(tplan.replicated_batches(len(tds)),
                                  jplan.replicated_batches(len(jds)))
    for merged in (True, False):
        got, want = tplan.split_stats(tds, merged), jplan.split_stats(jds, merged)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4 if standardization == "perpixel" else 1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("standardization", STANDARDIZATIONS)
def test_device_batch_matches_direct_gather_and_jax(standardization):
    """One process holding both shards: the item's rows are the direct
    gather of the global ids, its standardized pair is the dataset's own
    (perpixel statistics streamed in float64 against the dataset's on-device
    fp32 ones: 1e-5), and its hr is JAX's ``device_batch`` value, its
    per-sample statistics within 1e-6 of JAX's (each side's CPU pooling)."""
    tds, tplan, jds, jplan = _plans(standardization)
    gids = tplan.epoch_batches(5)[0]
    item = tplan.device_batch(tds.hr_np, gids, tplan.stats_np)
    jitem = jplan.device_batch(jds.hr_np, gids, jplan.stats_np)
    np.testing.assert_array_equal(item["hr"].numpy(), tds.hr_np[gids])
    np.testing.assert_array_equal(item["hr"].numpy(), np.asarray(jitem["hr"]))
    np.testing.assert_array_equal(item["idx"].numpy(), np.arange(4))
    if standardization in ("pertimestep", "minmax"):
        for g, w in zip(item["stats"], jitem["stats"]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    sl = tt.slice_stats(item["stats"], standardization, item["idx"])
    pair = tt.make_pair(item["hr"], 2, standardization, sl)
    ref = tds.batch(torch.from_numpy(gids))
    atol = 1e-5 if standardization == "perpixel" else 0
    for key in ("inputs", "targets"):
        np.testing.assert_allclose(pair[key].numpy(), ref[key].numpy(), rtol=0, atol=atol)


def test_replicated_source_eval_batch_and_batch_iter():
    tds, tplan, _, _ = _plans("pertimestep")
    vb = tplan.replicated_batches(len(tds))
    assert vb.shape == (4, 4)
    item = tplan.device_batch(tds.hr_np, vb[1], tplan.split_stats(tds), replicated_source=True)
    np.testing.assert_array_equal(item["hr"].numpy(), tds.hr_np[4:8])
    batches = tplan.epoch_batches(3)
    ts = tds.timestamps_np
    items = list(tplan.batch_iter(tds.hr_np, batches, tplan.stats_np, timestamps_np=ts))
    assert len(items) == batches.shape[0]
    for gids, it in zip(batches, items):
        direct = tplan.device_batch(tds.hr_np, gids, tplan.stats_np, timestamps_np=ts)
        assert sorted(it) == sorted(direct) == ["hr", "idx", "stats", "timestamps"]
        for key in ("hr", "idx", "timestamps"):
            np.testing.assert_array_equal(it[key].numpy(), direct[key].numpy())
        np.testing.assert_array_equal(it["timestamps"].numpy(), ts[gids].astype(np.float32))


def test_make_plan_only_when_sharded():
    tds = TDataset(hr=_hr(), standardization="none", lowres_scale=2, years=range(2000, 2004),
                   device="cpu")
    assert tmh.make_plan(TConfig(batch_size=4, resolution=(8, 8)), tds, "cpu") is None
    with pytest.raises(ValueError, match="not divisible"):
        tmh.make_plan(TConfig(batch_size=4, data_shards=3, resolution=(8, 8)), tds, "cpu")
    with pytest.raises(ValueError, match="data_shards"):
        tmh.require_single_process("this path", TConfig(data_shards=2))


# ---- the launch environment ---------------------------------------------------------------------

LAUNCH_VARS = ("COORDINATOR_ADDRESS", "PROBUNET_NUM_PROCESSES", "PROBUNET_PROCESS_ID",
               "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.mark.parametrize("env,error", [
    ({}, None),
    ({"PROBUNET_NUM_PROCESSES": "2"}, "COORDINATOR_ADDRESS, PROBUNET_PROCESS_ID"),
    ({"COORDINATOR_ADDRESS": "localhost:1", "PROBUNET_NUM_PROCESSES": "2"},
     "missing PROBUNET_PROCESS_ID"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, "MASTER_ADDR, MASTER_PORT"),
])
def test_half_set_launch_fails_fast(monkeypatch, env, error):
    """A launch described only in part raises before any device work, as
    the JAX package's ``maybe_initialize_distributed`` does, instead of
    running as one process; no launch is a single process."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        assert tmh.maybe_initialize_distributed("cpu") is False
        assert not tmesh.is_initialized()
    else:
        with pytest.raises(ValueError, match=error):
            tmh.maybe_initialize_distributed("cpu")


def test_launch_env_forms(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("PROBUNET_NUM_PROCESSES", "2")
    monkeypatch.setenv("PROBUNET_PROCESS_ID", "1")
    assert tmesh.launch_env() == {"init_method": "tcp://localhost:1234", "world_size": 2,
                                  "rank": 1}
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "3"), ("MASTER_ADDR", "h"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    assert tmesh.launch_env() == {"init_method": "env://", "world_size": 4, "rank": 3}


# ---- one gloo rank in this process: the collectives at world size 1 -----------------------------

@pytest.fixture
def one_rank_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield tmesh.DataParallel()
    finally:
        dist.destroy_process_group()


def test_world_one_collectives_are_exact(one_rank_group):
    """Float64 values that float32 would round, and a count above 2**24,
    cross the transport bit-exact; the ordered all-gather is the value
    itself at world size 1."""
    x = 273.0 + 1e-9 * np.arange(7.0)
    assert not np.array_equal(x.astype(np.float32).astype(np.float64), x)
    s1, s2 = tmh.allreduce_sum(x, x.reshape(7, 1) * 3.0)
    np.testing.assert_array_equal(s1, x)
    np.testing.assert_array_equal(s2, x.reshape(7, 1) * 3.0)
    np.testing.assert_array_equal(tmh.allgather_counts(16_777_217), [16_777_217])
    assert tmh.allreduce_moments(x, x, 5)[2] == 5
    assert tmh.process_info() == (0, 1)


def test_rank_device_under_a_group(one_rank_group, monkeypatch):
    """Under a process group the entry points' default device is the rank's
    card, cuda:<LOCAL_RANK> (raising on a host without it); an explicit
    device wins, and ``utils.device`` knows nothing of the group."""
    from probunet_torch.utils import device as tdevice

    assert tmesh.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        tmesh.resolve_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.resolve_device(None) == torch.device("cuda", 1)
    assert tdevice.resolve_device(None) == torch.device("cuda")


def test_world_one_training_step_equals_no_group(one_rank_group):
    """Three prob-U-Net training steps with dropout 0.1 through the flat
    gradient all-reduce, the metric reduction and the global draws of one
    rank: bit-equal to the same steps with no process group (the CPU
    counterpart of chip_smoke's one-rank NCCL check)."""
    from test_torch_trainer import TINY, _t_datasets

    from probunet_torch.train import steps as tsteps
    from probunet_torch.train.loop import build_probunet, init_probunet_state
    from probunet_torch.train.state import make_optimizer

    cfg = TConfig(**TINY)
    ds = _t_datasets()["train"]
    runs = []
    for dp in (None, one_rank_group):
        state = init_probunet_state(cfg, build_probunet(cfg, device="meta"), make_optimizer(),
                                    device="cpu")
        step = tsteps.make_probunet_train_step(state.model, 4, "pertimestep", dp=dp)
        ms = [step(state, ds.hr_device(), ds.stats, torch.tensor([3 * i, 3 * i + 1, 7, 11]), 5)
              for i in range(3)]
        runs.append(([{k: float(v) for k, v in m.items()} for m in ms],
                     {k: v.clone() for k, v in state.model.state_dict().items()}))
    assert runs[1][0] == runs[0][0]
    for name, w in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], w, rtol=0, atol=0, msg=name)
    one_rank_group.check_same_params(state.model)


# ---- the serving merge ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["netcdf4", "classic"])
@pytest.mark.parametrize("packed", [False, True])
def test_merge_parts_in_both_formats(tmp_path, monkeypatch, fmt, packed):
    """Three part files (6 days, an empty one, 4 days) merged chunk by chunk
    into the 10-day file: every variable array-equal to the whole written at
    once (packed: the raw int16 values), the time axis equal, no part
    dropped."""
    from probunet_torch.serve import _merge_parts

    monkeypatch.setattr(tnetcdf, "default_format", lambda: fmt)
    rng = np.random.default_rng(0)
    variables, shape = ("pr", "tasmax"), (10, 3, 4, 5)
    data = {v: rng.standard_normal(shape).astype(np.float32) for v in variables}
    ts = np.arange(10, dtype=np.float64) * 86400e9 + 1e18
    lat, lon = rng.standard_normal((2, 4, 5)).astype(np.float32)
    packing = {v: (-4.0, 4.0) for v in variables} if packed else None
    kw = dict(lat=lat, lon=lon, attrs={"members": "3"}, packing=packing)
    parts = []
    for i, (lo, hi) in enumerate(((0, 6), (6, 6), (6, 10))):
        path = str(tmp_path / f"out.nc.part{i}")
        with tnetcdf.StreamingFieldWriter(path, {v: (hi - lo, *shape[1:]) for v in variables},
                                          ts[lo:hi], **kw) as w:
            if hi > lo:
                w.append({v: data[v][lo:hi] for v in variables}, 0)
        parts.append((lo, path))
    with tnetcdf.NetCDFFile(parts[1][1]) as f:
        assert f.length("pr") == 0 and f.read_raw("pr", 0, 64).shape == (0, *shape[1:])
    whole, merged = str(tmp_path / "whole.nc"), str(tmp_path / "out.nc")
    with tnetcdf.StreamingFieldWriter(whole, {v: shape for v in variables}, ts, **kw) as w:
        w.append(data, 0)
    _merge_parts(merged, parts, variables, {v: shape for v in variables}, ts, lat, lon,
                 {"members": "3"}, packing=packing, chunk=4)
    with tnetcdf.NetCDFFile(whole) as a, tnetcdf.NetCDFFile(merged) as b:
        for v in variables:
            np.testing.assert_array_equal(b.read_raw(v, 0, 10), a.read_raw(v, 0, 10))
            np.testing.assert_array_equal(b.read_var(v), a.read_var(v))
        np.testing.assert_array_equal(b.read_time(), a.read_time())
        assert b.read_raw("pr", 0, 10).dtype == (np.int16 if packed else np.float32)
