"""Child process of tests/test_torch_spatial*.py: one rank of a gloo process
group from the environment (the JAX package's names) on the CPU, one torch
thread. It builds the (dp, sp) mesh the spec names, runs the spec's cases
on its rows of the spec's numpy inputs and saves what it got for the
parent. Argv: <spec path> <output prefix>.

The parent side, :func:`run_ranks`, writes the spec, starts the ranks,
waits for them and returns each rank's results."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

LAUNCH_VARS = ("COORDINATOR_ADDRESS", "PROBUNET_NUM_PROCESSES", "PROBUNET_PROCESS_ID",
               "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")
# the JAX tests' architecture (tests/test_spatial_train.py ARCH), 32x32
ARCH = dict(num_filters=(16, 32), model_channels=32, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(16,))


def run_ranks(tmp, n, spec, timeout=240):
    """Run ``n`` ranks on ``spec`` (a dict; ``spec["dp"]`` data shards,
    default 1) and return the list of their result dicts, in rank order."""
    path = os.path.join(str(tmp), f"spec_{os.getpid()}_{id(spec)}.pt")
    torch.save(spec, path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
        env.update(OMP_NUM_THREADS="1", COORDINATOR_ADDRESS=f"localhost:{port}",
                   PROBUNET_NUM_PROCESSES=str(n), PROBUNET_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), path, path],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}:\n{o[-3000:]}" for r, (p, o) in enumerate(zip(procs, outs))
              if p.returncode]
    assert not failed, "\n".join(failed)
    return [torch.load(f"{path}.r{r}.pt", weights_only=False) for r in range(n)]


def join_rows(results, key, dp=1, batch=True):
    """The ranks' (B_loc, H_loc, ...) blocks of ``key`` joined into the
    global array: H in space order, batch in data order (``batch``)."""
    sp = len(results) // dp
    rows = [np.concatenate([results[d * sp + s][key] for s in range(sp)], axis=1)
            for d in range(dp)]
    return np.concatenate(rows, axis=0) if batch else rows[0]


# ---- the child -------------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().contiguous().numpy()


def _sum_over_ranks(t):
    torch.distributed.all_reduce(t)
    return t


def _primitives(spec, mesh):
    """Each primitive of ``parallel/spatial.py`` on this rank's rows; the
    gradients of sum(cot * out) (weights' gradients summed over the
    ranks)."""
    from probunet_torch.models.layers import nchw, nhwc
    from probunet_torch.parallel import spatial as S
    from probunet_torch.parallel.spatial_train import put_spatial

    out = {}

    def local(a, requires_grad=False):
        t = put_spatial(_t(a), mesh)
        return t.requires_grad_(requires_grad)

    out["halo"] = _np(nhwc(S.halo_exchange_rows(nchw(local(spec["x_halo"])), mesh, 1)))
    for stride in (1, 2):
        x = local(spec["x_conv"], True)
        w = _t(spec["w_conv"]).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
        b = _t(spec["b_conv"]).requires_grad_(True)
        y = nhwc(S.spatial_conv3x3(nchw(x), w, mesh, stride, b))
        (y * put_spatial(_t(spec[f"cot_conv{stride}"]), mesh)).sum().backward()
        out.update({f"conv{stride}": _np(y), f"conv{stride}_dx": _np(x.grad),
                    f"conv{stride}_dw": _np(_sum_over_ranks(w.grad).permute(2, 3, 1, 0)),
                    f"conv{stride}_db": _np(_sum_over_ranks(b.grad))})
    x = local(spec["x_stack"])
    w1, w2 = (_t(spec[k]).permute(3, 2, 0, 1).contiguous() for k in ("w1", "w2"))
    out["stack"] = _np(nhwc(S.spatial_conv3x3(torch.relu(S.spatial_conv3x3(nchw(x), w1, mesh)),
                                              w2, mesh)))
    x = local(spec["x_gn"], True)
    wg, bg = (_t(spec[k]).requires_grad_(True) for k in ("w_gn", "b_gn"))
    y = nhwc(S.spatial_group_norm_silu(nchw(x), wg, bg, 4, mesh))
    (y * put_spatial(_t(spec["cot_gn"]), mesh)).sum().backward()
    out.update(gn=_np(y), gn_dx=_np(x.grad), gn_dw=_np(_sum_over_ranks(wg.grad)),
               gn_db=_np(_sum_over_ranks(bg.grad)))
    out["pool"] = _np(nhwc(S.spatial_avg_pool(nchw(local(spec["x_pool"])), 2)))
    out["up"] = _np(nhwc(S.spatial_nearest_up_2x(nchw(local(spec["x_up"])))))
    x = local(spec["x_gather"], True)
    full = S.spatial_attention(nchw(x), mesh)
    out["roundtrip"] = _np(nhwc(S.local_rows(full, mesh)))
    # rows mixed across the whole map: every rank's rows reach every rank's
    mixed = full * full.mean(dim=2, keepdim=True)
    y = nhwc(S.local_rows(mixed, mesh))
    (y * put_spatial(_t(spec["cot_gather"]), mesh)).sum().backward()
    out["gather_dx"] = _np(x.grad)
    return out


def _load(model, state_dict):
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    return model.to(memory_format=torch.channels_last)


def _probunet(spec, dropout=0.0):
    from probunet_torch.models.prob_unet import ProbabilisticUNet

    m = ProbabilisticUNet(3, 3, latent_dim=4, img_resolution=(32, 32), dropout=dropout,
                          device="meta", **ARCH).to_empty(device="cpu")
    return _load(m, spec["probunet"])


def _forwards(spec, mesh):
    """spatial_unet_forward of the bare U-Net, the prior net and the decode
    with a given z (tests/test_spatial_unet.py)."""
    from probunet_torch.models.unet import UNet
    from probunet_torch.parallel import spatial_unet as SU
    from probunet_torch.parallel.spatial_train import put_spatial

    unet = UNet((32, 32), 3, 16, model_channels=32, channel_mult=(1, 2), num_blocks=1,
                attn_resolutions=(16,), dropout=0.0, device="meta").to_empty(device="cpu")
    unet = _load(unet, spec["unet"]).eval()
    m = _probunet(spec).eval()
    out = {}
    with torch.no_grad():
        out["unet"] = _np(SU.spatial_unet_forward(unet, put_spatial(_t(spec["x_unet"]), mesh),
                                                  mesh))
        prior = SU.spatial_gaussian_forward(m.prior, put_spatial(_t(spec["x_prior"]), mesh),
                                            mesh)
        out.update(prior_mu=_np(prior.mu), prior_ls=_np(prior.log_sigma))
        out["decode"] = _np(SU.spatial_probunet_forward(
            m, put_spatial(_t(spec["x_decode"]), mesh), _t(spec["z_decode"]), mesh))
    return out


def _unet_forward(spec, mesh):
    """spatial_unet_forward of a bare U-Net built from the spec's own
    arguments (``unet_kw``), for widths the forwards case does not reach."""
    from probunet_torch.models.unet import UNet
    from probunet_torch.parallel import spatial_unet as SU
    from probunet_torch.parallel.spatial_train import put_spatial

    unet = _load(UNet(device="meta", **spec["unet_kw"]).to_empty(device="cpu"),
                 spec["unet"]).eval()
    with torch.no_grad():
        return {"unet": _np(SU.spatial_unet_forward(unet, put_spatial(_t(spec["x_unet"]), mesh),
                                                    mesh))}


def _elbo(spec, mesh, remat=False, z=None):
    """The sharded ELBO with an explicit z and every gradient (summed over
    the ranks), on this rank's rows of the batch (2d: and its batch rows)."""
    from probunet_torch.parallel.mesh import DataParallel
    from probunet_torch.parallel.spatial_train import put_spatial
    from probunet_torch.parallel.spatial_unet import spatial_probunet_elbo

    m = _probunet(spec).train()
    x, y = (put_spatial(_t(spec[k]), mesh, batch=True) for k in ("x", "y"))
    if z is None:
        z = torch.randn(spec["z_shape"], generator=torch.Generator().manual_seed(spec["z_seed"]))
    b = x.shape[0]
    z = z.narrow(0, mesh.data_index * b, b)
    share, total, recon, kl = spatial_probunet_elbo(m, x, y, mesh, spec["beta"], z=z,
                                                    remat=remat)
    share.backward()
    params = list(m.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    DataParallel().allreduce_grads(params, mean=False)
    out = {"total": float(total), "recon": float(recon), "kl": float(kl), "z": _np(z)}
    out.update({f"grad/{k}": _np(p.grad) for k, p in m.named_parameters()})
    return out


def _train(spec, mesh):
    """tests/test_spatial_train.py on the port: the ELBO and gradients with
    z, with remat, the three planted faults, the train step with dropout
    and remat on a fixed batch, and the eval twice with one seed."""
    from probunet_torch.parallel import spatial as S
    from probunet_torch.parallel import spatial_unet as SU
    from probunet_torch.parallel.mesh import DataParallel
    from probunet_torch.parallel.spatial_train import (
        make_spatial_eval_elbo,
        make_spatial_probunet_train_step,
        put_spatial,
    )
    from probunet_torch.train.state import create_train_state, make_optimizer

    out = {"elbo": _elbo(spec, mesh), "remat": _elbo(spec, mesh, remat=True)}
    rank = torch.distributed.get_rank()
    z = torch.randn(spec["z_shape"], generator=torch.Generator().manual_seed(
        spec["z_seed"] + rank))
    out["fault_z"] = _elbo(spec, mesh, z=z)   # each rank its own draw
    share = SU.elbo_share
    SU.elbo_share = lambda recon, kl, beta, mesh: recon + beta * kl   # KL not divided by sp
    try:
        out["fault_kl"] = _elbo(spec, mesh)
    finally:
        SU.elbo_share = share
    backward = S._GatherRows.backward

    def narrow_only(ctx, g):   # the gather's backward without the sum over the ranks
        h = g.shape[1] // ctx.mesh.sp
        return g.narrow(1, ctx.mesh.space_index * h, h), None

    S._GatherRows.backward = staticmethod(narrow_only)
    try:
        out["fault_gather"] = _elbo(spec, mesh)
    finally:
        S._GatherRows.backward = backward

    m = _probunet(spec, dropout=0.1)
    state = create_train_state(m, make_optimizer(lr=1e-3))
    step = make_spatial_probunet_train_step(m, mesh, remat=True, dp=DataParallel())
    x, y = (put_spatial(_t(spec[k]), mesh, batch=True) for k in ("x_step", "y_step"))
    out["step_losses"] = [float(step(state, x, y, 5)["train_loss"])
                          for _ in range(spec["steps"])]
    ev = make_spatial_eval_elbo(m, mesh)
    out["eval"] = [float(ev(x, y, 7, 1.0)["val_loss"]) for _ in range(2)]
    return out


CASES = {"primitives": _primitives, "forwards": _forwards, "unet_forward": _unet_forward,
         "train": _train}


def main():
    from probunet_torch.parallel.mesh import SpatialMesh
    from probunet_torch.parallel.multihost import maybe_initialize_distributed, process_info

    torch.set_num_threads(1)
    spec = torch.load(sys.argv[1], weights_only=False)
    maybe_initialize_distributed("cpu")
    mesh = SpatialMesh(spec.get("dp", 1))
    out = {}
    for case in spec["cases"]:
        out.update(CASES[case](spec, mesh))
    torch.save(out, f"{sys.argv[2]}.r{process_info()[0]}.pt")


if __name__ == "__main__":
    main()
