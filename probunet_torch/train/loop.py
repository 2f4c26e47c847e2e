"""Model and train-state construction from a :class:`Config` —
``build_probunet`` and ``init_probunet_state`` of
``probunet_tpu/train/loop.py``. The epoch loop and drivers come later."""

from __future__ import annotations

from typing import Optional

import torch

from probunet_torch.config import Config
from probunet_torch.models.layers import reset_parameters
from probunet_torch.models.prob_unet import ProbabilisticUNet
from probunet_torch.train.state import TrainState, create_train_state
from probunet_torch.utils.device import resolve_device


def build_probunet(cfg: Config, device=None,
                   generator: Optional[torch.Generator] = None) -> ProbabilisticUNet:
    """The Probabilistic U-Net for ``cfg`` on ``device`` (default the CUDA
    card), in ``channels_last`` memory format. Its weights are drawn from
    ``generator``; on the ``meta`` device nothing is allocated."""
    if cfg.ds_model != "probabilistic_unet":
        raise NotImplementedError(f"ds_model={cfg.ds_model!r} is not ported yet; the port "
                                  "serves the Probabilistic U-Net")
    device = resolve_device(device)
    model = ProbabilisticUNet(
        input_channels=cfg.nvars,
        num_classes=cfg.nvars,
        latent_dim=cfg.latent_dim,
        num_filters=tuple(cfg.num_filters),
        beta=cfg.beta,
        img_resolution=tuple(cfg.resolution),
        model_channels=cfg.model_channels,
        channel_mult=tuple(cfg.channel_mult),
        num_blocks=cfg.num_blocks,
        attn_resolutions=tuple(cfg.attn_resolutions),
        dropout=cfg.dropout,
        fast_attention=cfg.fast_attention,
        device=device,
        generator=generator,
    )
    return model.to(memory_format=torch.channels_last)


def init_probunet_state(cfg: Config, model: ProbabilisticUNet, tx, device=None) -> TrainState:
    """A fresh :class:`TrainState` for ``model``: its parameters moved to
    ``device`` (default the CUDA card; a ``meta`` model is materialized
    there) and drawn anew from ``cfg.seed`` by the layers' own init, in
    construction order, so the weights equal those of ``build_probunet(cfg,
    device, torch.Generator().manual_seed(cfg.seed))``; then the optimizer
    ``tx`` on them."""
    if cfg.remat:
        raise NotImplementedError("remat (block recomputation in the backward) is not "
                                  "ported yet")
    model.to_empty(device=resolve_device(device))
    reset_parameters(model, torch.Generator().manual_seed(cfg.seed))
    return create_train_state(model, tx)
