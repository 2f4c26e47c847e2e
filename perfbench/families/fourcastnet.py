"""The FourCastNet family: ``train``, the fast deterministic training step of
probunet_torch (``train/steps.py::make_deterministic_train_step``) on
FourCastNet's AFNO backbone (``models/fourcastnet.py``), with AdamW; the
ClimaX family's ``Train`` with another model, reference and counts.

The days are ``inputs.climex_like`` fields at W x W cut to their first H
rows, (T, H, W, C), as ClimaX's: at 1440 x 1440 that is a ~45 GB transient
in set-up, before the window, for 9.1 GB kept.

The weights are ``AFNONet``'s own init, drawn on the card from the seed
(:func:`published_weights`), not ``inputs.make_weights``' N(0, 1) /
sqrt(fan_in): that rule gives the filters' (2, 8, 96, 96) weights std 1 /
sqrt(73,728), and every LayerNorm N(0, 1) weights and biases; LN1's bias is
the same at every position and lands in the (0, 0) mode, so the filter's
output would be mostly its own biases' fixed pattern, and a filter that
transforms all the columns reads within the check's limits.

The reference (``perfbench/reference/fourcastnet.py``) repeats the checked
steps after the window in parts of ``reference_rows`` rows (1 at 720x1440:
one fp32 sample holds ~12 GB of activations). ``counts()`` adds, beside the
model's FLOPs, ``"spectral"``: per forward filter call, the kept modes'
block products' real FLOPs and the bytes of x read once, the output written
once (at the activation size) and the four weight tensors read once.
"""

from __future__ import annotations

import math

import torch

from perfbench import counts, inputs
from perfbench.families.climax import Train as ClimaXTrain
from perfbench.reference import fourcastnet as ref


def program_config(cfg: dict, program: dict):
    from probunet_torch.config import Config

    keys = ("variables", "resolution", "lowres_scale", "standardization", "embed_dim", "depth",
            "patch_size", "mlp_ratio", "drop_path", "dropout", "lr", "weight_decay")
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in keys}
    return Config(ds_model="fourcastnet", **kw, **program)


def published_weights(model: torch.nn.Module, cfg: dict, seed: int, device):
    """``AFNONet``'s init for ``model``'s ``state_dict`` names and shapes, in
    the order of the names, from one generator seeded from ``seed``:
    LayerNorms 1 and 0; the tokenizer's weight and bias U(-1 / sqrt(C p^2),
    1 / sqrt(C p^2)) (PyTorch's ``Conv2d`` default); the other biases 0; the
    rest (``pos_embed``, the Linears' weights, the filters' ``w1``, ``b1``,
    ``w2``, ``b2``) 0.02 times a standard normal (timm's ``trunc_normal_``
    cuts at +-2 absolute, 100 of its standard deviations)."""
    gen = inputs.device_generator(device, inputs.subseed(seed, 6))
    fan_in = len(cfg["variables"]) * cfg["patch_size"] ** 2
    out = {}
    for name, t in sorted(model.state_dict().items()):
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if ".norm" in name:
            out[name] = torch.full(shape, float(leaf == "weight"), device=device)
        elif name.startswith("patch_embed."):
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = (2 * u - 1) / math.sqrt(fan_in)
        elif leaf == "bias":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = 0.02 * torch.randn(shape, generator=gen, device=device)
    return out


def spectral_sites(cfg: dict, batch: int, itemsize: int):
    """Per forward filter call {"flops", "bytes"}, one entry a block."""
    h, w = (r // cfg["patch_size"] for r in cfg["resolution"])
    d, nb = cfg["embed_dim"], cfg["num_blocks"]
    total = h // 2 + 1
    kept = int(total * cfg["hard_thresholding_fraction"])
    modes = batch * (min(h, total + kept) - (total - kept)) * min(w // 2 + 1, kept)
    # two layers, each four real products of (modes nb, bs) x (bs, bs)
    flops = 2 * 4 * 2.0 * modes * d * (d // nb)
    weights = 4 * 2 * (2 * nb * (d // nb) ** 2 + 2 * d)
    nbytes = 2 * batch * h * w * d * itemsize + weights
    return [{"pass": "fwd", "flops": flops, "bytes": float(nbytes)}] * cfg["depth"]


class Train(ClimaXTrain):
    def build_program(self):
        from probunet_torch.train.loop import build_fourcastnet_model

        self.make_inputs()
        self.pcfg = program_config(self.cfg, self.wl["program"])
        model = build_fourcastnet_model(self.pcfg, device="meta").to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        self.dtype = getattr(torch, self.pcfg.compute_dtype)
        self.mark("program and weights")
        return model

    def weights(self, model):
        return published_weights(model, self.cfg, self.seed, self.device)

    def reference(self) -> ref.FourCastNet:
        with torch.device("meta"):
            model = ref.FourCastNet(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        return model

    def counts(self):
        b = self.wl["batch"]
        (h, w), c = self.cfg["resolution"], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.FourCastNet(self.cfg)
            x, y = torch.empty(b, h, w, c), torch.empty(b, h, w, c)
        model.train()

        def run():
            (model(x) - y).square().mean().backward()

        out = counts.count(model, run, self.itemsize(), backward=True)
        out["spectral"] = spectral_sites(self.cfg, b, self.itemsize())
        return out


def make_job(cell, seed, device):
    # a program without FourCastNet fails here, before the kernel library is built
    from probunet_torch.train.loop import build_fourcastnet_model  # noqa: F401

    return {"train": Train}[cell.workload["job"]](cell, seed, device)
