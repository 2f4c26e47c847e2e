"""Spatially-sharded training in the port (``probunet_torch/parallel/
spatial_train.py``) against the JAX package, the cases of
tests/test_spatial_train.py at its sizes (32x32, width 32), on gloo ranks
in child processes (``tests/_torch_spatial_child.py``): sp = 2 and 4, and
2d (dp = 2 x sp = 2 over 4 ranks).

- The sharded ELBO with an explicit z and every gradient (summed over the
  ranks) against JAX's unsharded ``elbo_with_z`` and JAX's sharded
  ``spatial_probunet_elbo`` (jax.grad outside its shard_map), with the same
  weights through the transplant: ELBO terms rtol 1e-4, gradients rtol
  5e-3 atol 5e-4 (JAX's own limits).
- Three planted faults, each of which must fail those limits: KL not
  divided by sp in a rank's share, a gather backward that only narrows
  (no sum over the ranks), and z drawn per rank.
- Remat leaves the gradients (1e-3 / 1e-5), the train step with dropout
  and remat lowers the loss, the eval is deterministic given its seed.
- End to end by the command line (``tests/_torch_cli_child.py``): 2 ranks
  ``--parallel_mode spatial`` and 4 ranks ``--parallel_mode 2d
  --mesh_shape 2,-1``, 2 epochs with dropout 0.1, remat, CRPS and a plot,
  against one process's ``--parallel_mode data`` run (``--data_shards 2``
  for 2d): step 1 within 1e-5, the run within 5e-3
  (tests/test_multihost_e2e.py's limits). And the refusals JAX makes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_spatial_child import ARCH, run_ranks
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_models import _params
from test_torch_multihost_e2e import (
    CLI_CHILD,
    STEP1_RTOL,
    TRAJ_RTOL,
    _jax_names,
    _records,
    _series,
    _start,
    _torchrun_names,
    _wait,
)

from probunet_torch.config import Config as TConfig
from probunet_torch.data.synthetic import generate_climex_like
from probunet_torch.utils.transplant import flax_probunet_to_torch
from probunet_tpu.models import ProbabilisticUNet
from probunet_tpu.parallel.spatial_train import shard_map_unchecked
from probunet_tpu.parallel.spatial_unet import spatial_probunet_elbo

B, BETA, Z_SEED = 4, 0.7, 11
# name: (ranks, dp)
CONFIGS = {"sp2": (2, 1), "sp4": (4, 1), "2d": (4, 2)}
ELBO_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 5e-3, 5e-4


@pytest.fixture(scope="module")
def jax_model():
    """The JAX prob-U-Net with filled weights (no zero-init conv hides a
    block) and its ELBO with z and gradients, unsharded."""
    m = ProbabilisticUNet(input_channels=3, num_classes=3, latent_dim=4,
                          img_resolution=(32, 32), dropout=0.0, **ARCH)
    x0 = jnp.zeros((1, 32, 32, 3))
    params = _params(m, x0, x0, seed=3, method=m.elbo)
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((B, 32, 32, 3)).astype(np.float32) for _ in range(2))
    z = torch.randn((B, 4), generator=torch.Generator().manual_seed(Z_SEED)).numpy()

    def loss(p):
        total, recon, kl = m.apply({"params": p}, x, y, z, BETA, method=m.elbo_with_z)
        return total, (recon, kl)

    (total, (recon, kl)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref = {"total": float(total), "recon": float(recon), "kl": float(kl),
           "grads": _flat(grads)}
    return m, params, x, y, z, ref


def _flat(tree):
    return {f"grad/{k}": v.numpy() for k, v in flax_probunet_to_torch(tree).items()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(config, jax_model, tmp_path_factory):
    _, params, x, y, _, _ = jax_model
    n, dp = CONFIGS[config]
    rng = np.random.default_rng(4)
    spec = {"probunet": {k: v.numpy() for k, v in flax_probunet_to_torch(params).items()},
            "x": x, "y": y, "z_shape": (B, 4), "z_seed": Z_SEED, "beta": BETA, "dp": dp,
            "x_step": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "y_step": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "steps": 6, "cases": ["train"]}
    return run_ranks(tmp_path_factory.mktemp(f"spatial_train_{config}"), n, spec)


@pytest.fixture(scope="module")
def jax_sharded(config, jax_model):
    """JAX's sharded ELBO and its gradients on the config's devices."""
    m, params, x, y, z, _ = jax_model
    n, dp = CONFIGS[config]
    devices = np.array(jax.devices()[:n])
    batch = "data" if dp > 1 else None
    mesh = Mesh(devices.reshape(dp, n // dp), ("data", "space")) if dp > 1 else Mesh(
        devices, ("space",))
    xy = P(batch, "space")

    def loss(p):
        def body(p, xl, yl, zl):
            return spatial_probunet_elbo(p, xl, yl, (32, 32), "space", beta=BETA, z=zl,
                                         batch_axis_name=batch, **ARCH)
        fn = shard_map_unchecked(body, mesh=mesh, in_specs=(P(), xy, xy, P(batch)),
                                 out_specs=(P(), P(), P()))
        total, recon, kl = fn(p, x, y, z)
        return total, (recon, kl)

    (total, (recon, kl)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return {"total": float(total), "recon": float(recon), "kl": float(kl), "grads": _flat(grads)}


def _misfits(got, ref):
    """Names of the ELBO terms and gradients outside the limits."""
    bad = [k for k in ("total", "recon", "kl")
           if not np.isclose(got[k], ref[k], rtol=ELBO_RTOL, atol=0)]
    for k, g in ref["grads"].items():
        if not np.allclose(got[k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL):
            bad.append(k)
    return bad


class TestShardedElboGradParity:
    def test_loss_and_grads_match_unsharded(self, config, ranks, jax_model):
        """Every rank ends with the global ELBO terms and the gradient of the
        ELBO; the z of a space group is one z, bit for bit, its data
        index's rows."""
        ref, z = jax_model[5], jax_model[4]
        n, dp = CONFIGS[config]
        for i, r in enumerate(ranks):
            assert sorted(k for k in r["elbo"] if k.startswith("grad/")) == sorted(ref["grads"])
            assert _misfits(r["elbo"], ref) == []
            d = i // (n // dp)
            np.testing.assert_array_equal(r["elbo"]["z"], z[d * B // dp:(d + 1) * B // dp])

    def test_loss_and_grads_match_jax_sharded(self, ranks, jax_sharded):
        for r in ranks:
            assert _misfits(r["elbo"], jax_sharded) == []

    def test_remat_grads_identical(self, ranks):
        for r in ranks:
            assert r["remat"]["total"] == pytest.approx(r["elbo"]["total"], rel=1e-6)
            for k, g in r["elbo"].items():
                if k.startswith("grad/"):
                    np.testing.assert_allclose(r["remat"][k], g, rtol=1e-3, atol=1e-5,
                                               err_msg=k)

    @pytest.mark.parametrize("fault", ["fault_kl", "fault_gather", "fault_z"])
    def test_planted_fault_fails_the_limits(self, ranks, jax_model, fault):
        """Negative controls: each fault must move some ELBO term or
        gradient outside the limits the sound run holds."""
        ref = jax_model[5]
        assert all(_misfits(r["elbo"], ref) == [] for r in ranks)
        assert _misfits(ranks[0][fault], ref), f"{fault} passes the limits"


def test_one_rank_mesh_is_the_unsharded_elbo(jax_model):
    """Without a process group the mesh is one rank and every collective the
    identity (the halo brings the zero rows of SAME padding, the gather
    returns its input): the sharded ELBO and its gradients, remat on, are
    JAX's unsharded ones, attention included."""
    from _torch_spatial_child import _probunet

    from probunet_torch.parallel.mesh import SpatialMesh
    from probunet_torch.parallel.spatial_unet import spatial_probunet_elbo

    _, params, x, y, z, ref = jax_model
    m = _probunet({"probunet": {k: v.numpy() for k, v in flax_probunet_to_torch(params).items()}})
    share, total, recon, kl = spatial_probunet_elbo(m.train(), torch.from_numpy(x),
                                                    torch.from_numpy(y), SpatialMesh(), BETA,
                                                    z=torch.from_numpy(z), remat=True)
    share.backward()
    got = {"total": float(total), "recon": float(recon), "kl": float(kl)}
    got.update({f"grad/{k}": (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                for k, p in m.named_parameters()})
    assert share.item() == pytest.approx(got["total"], rel=1e-6)
    assert _misfits(got, ref) == []


class TestSpatialTrainStep:
    def test_step_runs_and_optimizes(self, ranks):
        """The sharded step (dropout 0.1, remat) on one batch: the same
        finite, falling losses on every rank."""
        losses = ranks[0]["step_losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        for r in ranks:
            assert r["step_losses"] == losses

    def test_eval_elbo_deterministic_given_rng(self, ranks):
        for r in ranks:
            assert r["eval"][0] == r["eval"][1] == ranks[0]["eval"][0]


# ---- end to end, by the command line ---------------------------------------------------------

E2E_STEPS = 8   # 2 train years of 8 days at batch 4, 2 epochs


def _flags(datadir, out, tag, extra=()):
    return ["probunet_torch.train", "--device", "cpu", "--datadir", datadir,
            "--years_train", "2000,2002", "--years_val", "2002,2003", "--years_test", "2003,2004",
            "--coords", "0,32,0,32", "--resolution", "32,32", "--lowres_scale", "4",
            "--standardization", "pertimestep", "--batch_size", "4", "--num_epochs", "2",
            "--log_every", "1", "--latent_dim", "4", "--num_filters", "16,32",
            "--model_channels", "32", "--channel_mult", "1,2", "--num_blocks", "1",
            "--attn_resolutions", "16", "--dropout", "0.1", "--remat", "true",
            "--eval_crps", "true", "--crps_samples", "4", "--num_samples", "2", "--lr", "1e-3",
            "--seed", "42", "--metrics_path", os.path.join(out, f"{tag}.jsonl"),
            "--checkpoints_dir", os.path.join(out, f"{tag}_ckpt"), *extra]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both legs at once: one process in data mode and 2 ranks in spatial
    mode (torchrun's variables); one process with --data_shards 2 and 4
    ranks in 2d mode (the JAX package's variables). Each process plots
    into its own directory."""
    data = str(tmp_path_factory.mktemp("spatial_e2e_data"))
    generate_climex_like(data, years=range(2000, 2004), grid=32, days_per_year=8, seed=7)
    out = str(tmp_path_factory.mktemp("spatial_e2e"))

    def plots(tag):
        return ["--plotdir", os.path.join(out, f"plots_{tag}")]

    procs = [_start(CLI_CHILD, _flags(data, out, "data", plots("data"))),
             _start(CLI_CHILD, _flags(data, out, "shards", (*plots("shards"), "--data_shards",
                                                             "2")))]
    procs += [_start(CLI_CHILD, _flags(data, out, "spatial", (
        *plots(f"spatial{r}"), "--parallel_mode", "spatial")), launch)
        for r, launch in enumerate(_torchrun_names(2))]
    procs += [_start(CLI_CHILD, _flags(data, out, "2d", (
        *plots(f"2d{r}"), "--parallel_mode", "2d", "--mesh_shape", "2,-1")), launch)
        for r, launch in enumerate(_jax_names(4))]
    _wait(procs, timeout=400)
    return out


@pytest.mark.parametrize("tag,ref,n", [("spatial", "data", 2), ("2d", "shards", 4)])
def test_parallel_mode_e2e_matches_one_process(e2e, tag, ref, n):
    """The sharded run's records against one process computing the same
    global batches with the same seed: keys and count (rank 0 alone writes
    them), step 1 within 1e-5, every step and the epoch, eval and CRPS
    values within 5e-3; rank 0 alone plots (epoch 2) and writes one
    checkpoint."""
    single = _records(os.path.join(e2e, f"{ref}.jsonl"))
    multi = _records(os.path.join(e2e, f"{tag}.jsonl"))
    assert [sorted(r) for r in multi] == [sorted(r) for r in single]
    for key in ("train_loss", "recon_loss", "kl_div", "grad_norm"):
        s, m = _series(single, key), _series(multi, key)
        assert len(s) == len(m) == E2E_STEPS, (key, len(s), len(m))
        np.testing.assert_allclose(m[0], s[0], rtol=STEP1_RTOL, err_msg=key)
        np.testing.assert_allclose(m, s, rtol=TRAJ_RTOL, err_msg=key)
    crps = [r for r in multi if any(k.startswith("crps_") for k in r)]
    assert len(crps) == 2, "one CRPS record per epoch"
    for rs, rm in zip([r for r in single if "step" not in r or "train_loss" not in r],
                      [r for r in multi if "step" not in r or "train_loss" not in r]):
        for key, v in rs.items():
            if key not in ("step", "time"):
                assert np.isfinite(rm[key]), key
                np.testing.assert_allclose(rm[key], v, rtol=TRAJ_RTOL, err_msg=key)
    assert os.path.exists(os.path.join(e2e, f"plots_{tag}0", "epoch2.png"))
    for r in range(1, n):
        assert not os.path.exists(os.path.join(e2e, f"plots_{tag}{r}", "epoch2.png"))
    ckpt = os.path.join(e2e, f"{tag}_ckpt", "probunet")
    assert sorted(os.path.relpath(os.path.join(d, f), ckpt)
                  for d, _, fs in os.walk(ckpt) for f in fs) == [os.path.join("state",
                                                                              "state.pt")]


# ---- refusals -----------------------------------------------------------------------------------

def _cfg(tmp_path, **kw):
    base = dict(resolution=(32, 32), latent_dim=4, batch_size=4, num_epochs=1,
                parallel_mode="spatial", plotdir=os.path.join(str(tmp_path), "plots"),
                checkpoints_dir=os.path.join(str(tmp_path), "ckpt"), **ARCH)
    return TConfig(**{**base, **kw})


@pytest.mark.parametrize("world,kw,match", [
    (1, dict(ds_model="vae"), "ds_model=vae has no spatially-sharded kernels"),
    (1, dict(data_shards=2), "pure spatial mode has none"),
    (1, dict(parallel_mode="2d"), "2D-factorable"),
    (4, dict(parallel_mode="2d", mesh_shape=(3, -1)), "2D-factorable"),
    (4, dict(parallel_mode="2d", mesh_shape=(2, 4)), "2D-factorable"),
    (4, dict(parallel_mode="2d", batch_size=3), "must divide the data mesh axis"),
    (2, dict(resolution=(36, 36)), "multiple of 8"),
    (4, dict(parallel_mode="2d", resolution=(36, 36)), "multiple of 8"),
])
def test_refusals(tmp_path, monkeypatch, world, kw, match):
    """JAX's refusals with its conditions, before any work (the process
    count faked: they come before the mesh): ds_model=vae; --data_shards in
    pure spatial mode; a rank count that does not factor by --mesh_shape;
    a batch the data axis does not divide; and a tile height that does not
    split over the space group through every 2x pool."""
    from probunet_torch.parallel import multihost
    from probunet_torch.train.loop import train_probunet

    monkeypatch.setattr(multihost, "process_info", lambda: (0, world))
    with pytest.raises(ValueError, match=match):
        train_probunet(_cfg(tmp_path, **kw), datasets={}, make_plots=False, device="cpu")
