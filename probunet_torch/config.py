"""Unified configuration, a copy of ``probunet_tpu/config.py``.

The same dataclass and flags drive both packages, so one command line means
the same run in JAX and in PyTorch. Fields that only the JAX package reads
(``use_pallas``, ``rng_impl``, ``mesh_*``, ...) are kept as inert fields so
that a config round-trips between the two. ``parse_known_args`` semantics
are kept so sweep runners can inject unknown flags; parsing has no
filesystem side effects.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class Config:
    # --- climate dataset arguments (reference train_prob_unet_model.py:21-31) ---
    datadir: str = "./data/climex"
    variables: Tuple[str, ...] = ("pr", "tasmin", "tasmax")
    years_train: Tuple[int, int] = (1960, 2060)   # half-open [start, end)
    years_val: Tuple[int, int] = (2060, 2080)
    years_test: Tuple[int, int] = (2080, 2098)
    coords: Tuple[int, int, int, int] = (120, 184, 120, 184)  # rlon0, rlon1, rlat0, rlat1
    resolution: Tuple[int, int] = (64, 64)
    lowres_scale: int = 4
    timetransform: str = "id"            # {"id", "cyclic"}
    standardization: str = "perpixel"    # {"none", "perpixel", "pertimestep", "minmax"}

    # --- model selection (reference trainmodel.py:33; "edm" makes the
    # reference's dead EDMPrecond a live diffusion downscaler, "vae" its dead
    # vae enum a live conditional conv-VAE) ---
    # "corrdiff" (the port only) serves NVIDIA's CorrDiff: a regression
    # DDPM++ U-Net, then an EDM residual chain on a second one; "climax" (the
    # port only) trains ClimaX, a vision transformer, as a deterministic
    # downscaler; "fourcastnet" (the port only) trains FourCastNet's AFNO
    # backbone, a Fourier token mixer, as one
    ds_model: str = "probabilistic_unet"  # {deterministic_unet, probabilistic_unet, linearcnn, bcsd, edm, vae, corrdiff, climax, fourcastnet}

    # --- prob-U-Net architecture (reference main.py:32-37, prob_unet.py:129) ---
    latent_dim: int = 6
    num_filters: Tuple[int, ...] = (64, 128, 256, 512)
    model_channels: int = 128               # U-Net width (networks.py:232; baseline uses 64)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32, 16, 8)
    dropout: float = 0.10
    baseline_channels: int = 64  # deterministic U-Net width (baseline/deterministic_unet.py:232)

    # --- ClimaX (ds_model="climax"; arXiv:2301.10343, the 1.40625 deg model's
    # widths); its drop_rate is ``dropout``. FourCastNet (ds_model=
    # "fourcastnet"; arXiv:2202.11214, AFNO.yaml's backbone) reads embed_dim,
    # depth, patch_size, mlp_ratio, drop_path and ``dropout`` alike ---
    embed_dim: int = 1024
    depth: int = 8
    num_heads: int = 16
    patch_size: int = 4
    decoder_depth: int = 2
    mlp_ratio: float = 4.0
    drop_path: float = 0.1

    # --- ML training arguments (reference train_prob_unet_model.py:34-39) ---
    batch_size: int = 8
    num_epochs: int = 3
    lr: float = 1e-3
    accum: int = 1                  # gradient-accumulation steps (reference's knob is inert; ours works)
    beta: float = 1.0               # ELBO KL weight
    beta_schedule: str = "const"    # {"const", "linear", "cyclic"} — beta annealing (BASELINE config #4)
    beta_warmup_steps: int = 0      # counts OPTIMIZER updates (micro-steps / accum), see steps.py
    optimizer: str = "adamw"
    weight_decay: float = 0.01      # torch AdamW default
    opt_state_dtype: str = "float32"  # {"float32","bfloat16"}: bf16 m/v/grads = production bandwidth mode
    seed: int = 42

    # --- numerics ---
    compute_dtype: str = "float32"  # {"float32", "bfloat16"} activations/matmul dtype
    use_pallas: bool = True         # inert in both packages (no reader); kept for flag parity
    fast_attention: bool = False    # QK^T in activation dtype (softmax stays fp32)
    rng_impl: str = "threefry2x32"  # {"threefry2x32","rbg","unsafe_rbg"}; JAX only
    remat: bool = False             # recompute each U-Net block in the backward (memory/time trade)
    donate_state: bool = True

    # --- parallelism ---
    mesh_shape: Tuple[int, ...] = (-1,)          # -1 => all devices on the data axis
    mesh_axes: Tuple[str, ...] = ("data",)
    # "data" = DP mesh; "spatial" = H-axis model parallelism; "2d" = both at
    # once on a (data, space) mesh (--mesh_shape dp,-1)
    parallel_mode: str = "data"
    # Keep the full HR tensor in HBM ("auto": yes for parallel_mode=data —
    # the fused-gather fast path — no for spatial/2d, whose reason to exist
    # is tiles too large for resident placement; True/False force it).
    # Resolve via .resident_data, never read this field directly.
    device_resident_data: object = "auto"        # "auto" | True | False
    # Ingest shard count for the lockstep multi-host batch plan. 0 = auto
    # (jax.process_count()). Setting >1 on a SINGLE process reproduces the
    # multi-process stratified batch order exactly — the mechanism the
    # 2-process parity test uses (tests/test_multihost_e2e.py).
    data_shards: int = 0
    # Background-assembly depth for the multi-host batch plan (how many steps
    # of global-batch host assembly run ahead of the device); JAX only so far.
    prefetch_buffer: int = 4

    # --- observability ---
    wandb: bool = False
    log_every: int = 50
    # wandb.watch parity (reference baseline/main.py:57-58): every N steps log
    # per-layer gradient norms + parameter histograms/norms. 0 = off.
    watch_every: int = 0
    plotdir: str = "./results/plots"
    checkpoints_dir: str = "./results/checkpoints"
    metrics_path: str = ""          # JSONL metrics file ("" => <plotdir>/metrics.jsonl)
    profile_dir: str = ""           # torch.profiler trace dir of the training run ("" => disabled)

    # --- eval / sampling ---
    num_samples: int = 3            # ensemble members for sampling plots
    edm_steps: int = 18             # EDM Heun sampler steps (ds_model="edm")
    eval_seed: int = 1234           # seeded stochastic eval (reference eval samples the posterior)
    eval_crps: bool = False         # ensemble CRPS eval in physical units after each epoch
    crps_samples: int = 16          # ensemble size for CRPS (BASELINE config #3)
    crps_eval_batches: int = 0      # val batches for the CRPS eval (0 = the FULL split);
                                    # the evaluated count is logged as crps_batches_evaluated
    resume: str = ""                # checkpoint directory to resume from
    # Step-granular checkpointing for long production runs (prob-U-Net loop):
    # save every N micro-steps (0 = epoch-end only). Resume is EXACT: the
    # loop derives (epoch, intra-epoch offset) from the restored step counter
    # and continues with the identical batch/noise sequence, so an
    # interrupted run converges to the same state as an uninterrupted one
    # (tests/test_round3_fixes.py::TestExactResume).
    checkpoint_every: int = 0
    max_steps: int = 0              # stop after N global micro-steps (0 = unlimited)

    def __post_init__(self) -> None:
        if self.ds_model not in ("deterministic_unet", "probabilistic_unet",
                                 "linearcnn", "bcsd", "edm", "vae", "corrdiff", "climax",
                                 "fourcastnet"):
            raise ValueError(f"unknown ds_model {self.ds_model!r}")
        if self.standardization not in ("none", "perpixel", "pertimestep", "minmax"):
            raise ValueError(f"unknown standardization {self.standardization!r}")
        if self.timetransform not in ("id", "cyclic"):
            raise ValueError(f"unknown timetransform {self.timetransform!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.opt_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown opt_state_dtype {self.opt_state_dtype!r}")
        if self.parallel_mode not in ("data", "spatial", "2d"):
            raise ValueError(f"unknown parallel_mode {self.parallel_mode!r}")
        v = self.device_resident_data
        if isinstance(v, str) and v.lower() not in (
                "auto", "true", "false", "1", "0", "yes", "no"):
            raise ValueError(f"device_resident_data must be auto/true/false, "
                             f"got {v!r}")

    # ---- convenience ----
    @property
    def resident_data(self) -> bool:
        """Resolved device-residency policy (see device_resident_data)."""
        v = self.device_resident_data
        if isinstance(v, str):
            if v.lower() == "auto":
                return self.parallel_mode == "data"
            return v.lower() in ("1", "true", "yes")
        return bool(v)

    @property
    def nvars(self) -> int:
        return len(self.variables)

    def years(self, split: str) -> range:
        lo, hi = {"train": self.years_train, "val": self.years_val, "test": self.years_test}[split]
        return range(lo, hi)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=str, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def _parse_tuple(s: str, elem=int) -> tuple:
    return tuple(elem(x) for x in s.replace("(", "").replace(")", "").split(",") if x.strip())


def get_config(argv: Optional[Sequence[str]] = None, **overrides) -> Config:
    """Parse CLI flags into a :class:`Config` (parse_known_args semantics,
    mirroring reference ``train_prob_unet_model.py:55``)."""
    parser = argparse.ArgumentParser()
    _add_args(parser)
    args, _unknown = parser.parse_known_args(argv)
    kw = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if v is None:
            continue
        if isinstance(f.default, tuple) and isinstance(v, str):
            elem = str if f.name == "variables" else int
            v = _parse_tuple(v, elem)
        kw[f.name] = v
    kw.update(overrides)
    return Config(**kw)
