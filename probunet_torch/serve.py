"""Batch inference: checkpoint -> downscaled ensemble netCDF —
``downscale`` of ``probunet_tpu/serve.py``.

Load a checkpoint, stream the requested years through the ensemble sampler
on the card, and write physical-unit HR ensembles as netCDF, one dataset
per variable shaped (time, member, rlat, rlon). Writes stream batch by batch
with a one-deep overlap: batch i's ensemble is copied to pinned host memory
behind its compute on the CUDA stream, and written while batch i+1 computes,
so host memory stays O(batch).

``ds_model`` is the Probabilistic U-Net or the conv-VAE (``vae``; K prior
draws per input), ``edm``, the diffusion downscaler (K Heun chains of
``cfg.edm_steps`` steps per input, folded into one batch), or ``corrdiff``
(NVIDIA's CorrDiff: a regression U-Net's mean per input, then K residual
Heun chains on a second U-Net, folded the same way). The
deterministic baselines draw no ensemble and are not served, as in the JAX
package.

Several processes (one per card, ``torch.distributed``): the batch list is
split into contiguous ranges by ``multihost.shard_years``, one per process;
each samples its range on its card, with no collective in the sampling
path, and writes its time slice to ``<out>.part<rank>`` (an empty part when
it owns no batch). After a barrier rank 0 merges the parts chunk by chunk
into ``<out>``, and after a second barrier it removes them. Every process
reads the same days and statistics and draws each batch's members from the
batch's GLOBAL index, so the merged file equals a single process's. The
parts must lie on a filesystem every process sees.

    python -m probunet_torch.serve --checkpoint ./results/checkpoints/probunet \\
        --out ./results/downscaled.nc --num_samples 16 [config flags...]
    python -m probunet_torch.serve --ds_model edm --checkpoint ./results/checkpoints/edm \\
        --out ./results/downscaled_edm.nc --num_samples 16 [config flags...]
    python -m probunet_torch.serve --ds_model corrdiff --checkpoint ./ckpt/corrdiff \\
        --resolution 448,448 --model_channels 128 --channel_mult 1,2,2,2,2 \\
        --num_blocks 4 --attn_resolutions 28 --out ./results/downscaled_corrdiff.nc ...
    python -m probunet_torch.serve --ds_model vae --checkpoint ./results/checkpoints/vae \\
        --out ./results/downscaled_vae.nc --num_samples 16 [config flags...]
    torchrun --nproc_per_node 2 -m probunet_torch.serve --checkpoint ... [config flags...]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from probunet_torch.config import Config, get_config
from probunet_torch.data.dataset import ClimexDataset
from probunet_torch.data.netcdf import NetCDFFile, StreamingFieldWriter, pack_params
from probunet_torch.parallel import mesh
from probunet_torch.parallel.multihost import (
    maybe_initialize_distributed,
    process_info,
    shard_years,
)
from probunet_torch.train.checkpoint import restore_checkpoint
from probunet_torch.train.loop import build_corrdiff_model, build_edm_model, build_probunet
from probunet_torch.train.state import TrainState
from probunet_torch.train.steps import (
    make_corrdiff_sample_fn,
    make_edm_sample_fn,
    make_sample_fn,
)
from probunet_torch.utils.device import full_fp32


def _batch_generator(seed: int, batch_index: int) -> torch.Generator:
    """CPU generator for one batch's draws (prior draws, or the Heun chains'
    initial noise): the same members whatever device samples them, and
    independent of the batch order."""
    return torch.Generator().manual_seed(seed * 1_000_003 + batch_index)


def _batch_range(nb: int, pi: int, pc: int):
    """The contiguous [lo, hi) batch range of process ``pi`` of ``pc``: the
    partition of :func:`shard_years`. With more processes than batches the
    last ones get an empty range (they still join the merge's barriers)."""
    lo = sum(len(shard_years(range(nb), p, pc)) for p in range(pi))
    return lo, lo + len(shard_years(range(nb), pi, pc))


def downscale(
    cfg: Config,
    checkpoint_dir: str,
    out_path: str,
    years: Optional[Sequence[int]] = None,
    num_samples: Optional[int] = None,
    batch_size: Optional[int] = None,
    seed: int = 0,
    dataset: Optional[ClimexDataset] = None,
    compression: Optional[str] = None,
    batch_seconds: Optional[list] = None,
    pack_ranges: Optional[dict] = None,
    device=None,
) -> str:
    """Run ensemble downscaling over a year range and write netCDF output.

    Returns the written path. Output per variable: (T, K, H, W) physical-unit
    HR fields, as netCDF-4 where h5py is installed, else netCDF classic.
    ``compression``: 'gzip' | 'lzf' | 'none' (default gzip for netCDF-4,
    none for classic, which has no compression). ``batch_seconds``:
    optional list; each loop iteration's wall time is appended.
    ``pack_ranges``: optional {var: (lo, hi)} covering every output
    variable; the ensemble is CF-packed to int16 on the device, so half the
    bytes cross to the host, and stored as int16 with scale_factor/add_offset.
    ``device``: default the CUDA card (under a process group this rank's);
    ``"cpu"`` runs the plain versions. Under a process group every process
    calls this with the same arguments (see the module docstring)."""
    if cfg.ds_model not in ("probabilistic_unet", "vae", "edm", "corrdiff"):
        raise NotImplementedError(f"ds_model={cfg.ds_model!r} draws no ensemble and is not "
                                  "served (nor by the JAX package); serving takes "
                                  "probabilistic_unet, vae, edm or corrdiff")
    pi, pc = process_info()
    dev = mesh.resolve_device(device)
    years = list(years if years is not None else cfg.years("test"))
    num_samples = num_samples or cfg.num_samples
    batch_size = batch_size or cfg.batch_size

    ds = dataset or ClimexDataset(
        cfg.datadir, years=years, variables=cfg.variables, coords=cfg.coords,
        lowres_scale=cfg.lowres_scale, standardization=cfg.standardization, device=dev)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    edm = cfg.ds_model in ("edm", "corrdiff")   # chains that start from noise
    build = {"edm": build_edm_model, "corrdiff": build_corrdiff_model}.get(cfg.ds_model,
                                                                          build_probunet)
    model = build(cfg, device="meta").to_empty(device=dev).eval()
    restore_checkpoint(checkpoint_dir, TrainState(model, None))
    if edm:
        make = make_corrdiff_sample_fn if cfg.ds_model == "corrdiff" else make_edm_sample_fn
        sample_fn = make(model, cfg.lowres_scale, cfg.standardization, num_samples,
                         cfg.edm_steps, compute_dtype=dtype)
    else:
        sample_fn = make_sample_fn(model, cfg.lowres_scale, cfg.standardization, num_samples,
                                   dtype)

    pack = None
    if pack_ranges is not None:
        missing = [v for v in cfg.variables if v not in pack_ranges]
        if missing:
            raise ValueError(f"pack_ranges must cover every output variable; missing {missing}")
        scales, offsets = zip(*(pack_params(*pack_ranges[v]) for v in cfg.variables))
        sc = torch.tensor(scales, dtype=torch.float32, device=dev)
        off = torch.tensor(offsets, dtype=torch.float32, device=dev)

        def pack(preds):  # (..., C) float -> CF int16, clipped
            q = torch.round((preds.float() - off) / sc)
            return q.clamp_(-32767, 32767).to(torch.int16)

    batches = ds.epoch_indices(0, batch_size, shuffle=False, drop_remainder=False)
    batches_dev = torch.from_numpy(batches).to(dev)
    hr_all, stats = ds.hr_device(), ds.stats
    n, (h, w) = len(ds), ds.spatial_shape
    lo_b, hi_b = _batch_range(len(batches), pi, pc)
    # both bounds clamped: a range past the ragged tail, or empty, owns no day
    t_lo, t_hi = min(lo_b * batch_size, n), min(hi_b * batch_size, n)
    my_path = out_path if pc == 1 else f"{out_path}.part{pi}"
    attrs = {"source": "probunet_torch ensemble downscaling", "members": str(num_samples)}
    shapes = {var: (t_hi - t_lo, num_samples, h, w) for var in cfg.variables}
    on_cuda = dev.type == "cuda"
    host_bufs = []  # two pinned buffers, alternating: one filling, one writing

    def to_host(preds: torch.Tensor, slot: int):
        if len(host_bufs) <= slot:
            host_bufs.append(torch.empty(preds.shape, dtype=preds.dtype, pin_memory=on_cuda))
        buf = host_bufs[slot]
        buf.copy_(preds, non_blocking=on_cuda)
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
        return buf, done

    def write(t0: int, take: int, buf: torch.Tensor, done) -> None:
        if done is not None:
            done.synchronize()
        arr = buf.numpy()[:take]
        writer.append({var: arr[..., i] for i, var in enumerate(cfg.variables)}, t0)

    with full_fp32(), StreamingFieldWriter(my_path, shapes, ds.timestamps_np[t_lo:t_hi],
                                           lat=ds.lat, lon=ds.lon, attrs=attrs,
                                           compression=compression,
                                           packing=pack_ranges) as writer:
        pending = None  # (t0, rows_to_keep, host buffer, copy-done event)
        last_t = time.perf_counter()
        for bi in range(lo_b, hi_b):
            if edm:   # the K*B chains' initial noise, K-major
                noise = torch.randn((num_samples * batch_size, h, w, cfg.nvars),
                                    generator=_batch_generator(seed, bi))
                preds, _ = sample_fn(hr_all, stats, batches_dev[bi], noise=noise)
            else:
                eps = torch.randn((num_samples, batch_size, cfg.latent_dim),
                                  generator=_batch_generator(seed, bi))
                preds, _ = sample_fn(hr_all, stats, batches_dev[bi], eps=eps)
            if pack is not None:
                preds = pack(preds)  # int16 crosses the host link, not fp32
            staged = to_host(preds, (bi - lo_b) % 2)
            if pending is not None:
                write(*pending)  # overlaps this batch's compute on the card
            pending = (bi * batch_size - t_lo, min(batch_size, n - bi * batch_size), *staged)
            if batch_seconds is not None:
                now = time.perf_counter()
                batch_seconds.append(now - last_t)
                last_t = now
        if pending is not None:
            write(*pending)

    if pc > 1:
        mesh.barrier()   # every part file is closed
        parts = [(_batch_range(len(batches), p, pc)[0] * batch_size, f"{out_path}.part{p}")
                 for p in range(pc)]
        if pi == 0:
            _merge_parts(out_path, parts, cfg.variables,
                         {var: (n, num_samples, h, w) for var in cfg.variables},
                         ds.timestamps_np, ds.lat, ds.lon, attrs, compression, pack_ranges)
        mesh.barrier()   # the merged file is whole before any process returns
        if pi == 0:
            for _, part in parts:
                os.remove(part)
    return out_path


def _merge_parts(out_path, part_offsets, variables, shapes, timestamps, lat, lon, attrs,
                 compression: Optional[str] = None, packing: Optional[dict] = None,
                 chunk: int = 64) -> None:
    """Rank 0's merge: copy every part's variables into the full-range file
    chunk by chunk (host memory stays O(chunk)), each part at its time
    offset. Parts are read in either format through :class:`NetCDFFile`,
    packed variables as their raw int16."""
    missing = [part for _, part in part_offsets if not os.path.exists(part)]
    if missing:
        raise RuntimeError(f"part files not visible to rank 0: {missing}; multi-process "
                           "serving needs the output on a filesystem every process sees")
    with StreamingFieldWriter(out_path, shapes, timestamps, lat=lat, lon=lon, attrs=attrs,
                              compression=compression, packing=packing) as writer:
        for t0, part in part_offsets:
            with NetCDFFile(part) as f:
                nt = f.length(variables[0]) if variables else 0
                for lo in range(0, nt, chunk):
                    writer.append({var: f.read_raw(var, lo, lo + chunk) for var in variables},
                                  t0 + lo)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", default="./results/downscaled.nc")
    p.add_argument("--nc_compression", default=None, choices=("gzip", "lzf", "none"),
                   help="default: gzip for netCDF-4, none for netCDF classic")
    p.add_argument("--pack", action="append", default=None, metavar="VAR=LO:HI",
                   help="CF int16 packing range per variable (repeatable; must cover "
                        "every output variable), e.g. --pack pr=0:0.02")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (under a process group cuda:<LOCAL_RANK>)")
    args, rest = p.parse_known_args(argv)
    cfg = get_config(rest)
    maybe_initialize_distributed(args.device)
    pack_ranges = None
    if args.pack:
        pack_ranges = {}
        for spec in args.pack:
            var, rng = spec.split("=", 1)
            lo, hi = rng.split(":", 1)
            pack_ranges[var] = (float(lo), float(hi))
    path = downscale(cfg, args.checkpoint, args.out, compression=args.nc_compression,
                     pack_ranges=pack_ranges, device=args.device)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
