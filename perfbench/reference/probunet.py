"""The Probabilistic U-Net (prob_unet.py of prob-unet-mds) in plain PyTorch:
its ELBO training step with AdamW and its K-member prior sampler.

Parameter names are the program's ``state_dict`` keys. The U-Net maps the
standardized LR input to ``num_filters[0]`` features; the prior sees the
input, the posterior the input and the target, each a 4-level conv encoder
(conv 3x3, ReLU, 2x2 average) with a global mean and 1x1 convs to the
latent mean and log sigma; Fcomb concatenates the features with z tiled
over the map and runs three 1x1 convs with ReLUs between. ELBO = sum of
squared errors + beta * KL(posterior || prior), summed over the batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from perfbench.compare import row_norms
from perfbench.reference.unet import Conv, Ref, UNet, fp32_math, make_pair


class Encoder(nn.Module):
    def __init__(self, cin: int, filters: Sequence[int], latent: int):
        super().__init__()
        layers = []
        for cout in filters:
            layers += [Conv(cin, cout, 3), nn.ReLU(), nn.AvgPool2d(2)]
            cin = cout
        self.encoder = nn.Sequential(*layers)
        self.conv_mu = Conv(cin, latent, 1)
        self.conv_log_sigma = Conv(cin, latent, 1)

    def forward(self, x):
        h = self.encoder(x).mean(dim=(2, 3), keepdim=True)
        return self.conv_mu(h)[:, :, 0, 0], self.conv_log_sigma(h)[:, :, 0, 0]


class Fcomb(Ref):
    def __init__(self, c: int, latent: int, classes: int):
        super().__init__()
        self.layers = nn.Sequential(Conv(c + latent, c, 1), nn.ReLU(), Conv(c, c, 1), nn.ReLU(),
                                    Conv(c, classes, 1))

    def forward(self, feats_nhwc, z):
        n, h, w, _ = feats_nhwc.shape
        x = torch.cat([feats_nhwc, z[:, None, None, :].expand(n, h, w, z.shape[-1])], dim=-1)
        return self.layers(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ProbUNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        nv, nf = len(cfg["variables"]), list(cfg["num_filters"])
        self.latent_dim, self.beta = cfg["latent_dim"], cfg["beta"]
        self.unet = UNet(cfg["resolution"][0], nv, nf[0], cfg["model_channels"],
                         cfg["channel_mult"], cfg["num_blocks"], cfg["attn_resolutions"],
                         cfg["dropout"])
        self.prior = Encoder(nv, nf, self.latent_dim)
        self.posterior = Encoder(2 * nv, nf, self.latent_dim)
        self.fcomb = Fcomb(nf[0], self.latent_dim, nv)

    def elbo(self, x, y, eps, generator=None, shard=(0, 1)):
        """(total, recon, kl) for NHWC input x and target y, the posterior
        draw mu + exp(log_sigma) * eps; ``shard``: the U-Net's dropout
        (``unet.dropout``)."""
        feats = self.unet(x, generator=generator, shard=shard)
        p_mu, p_ls = self.prior(x.permute(0, 3, 1, 2))
        q_mu, q_ls = self.posterior(torch.cat([x, y], dim=-1).permute(0, 3, 1, 2))
        out = self.fcomb(feats, q_mu + torch.exp(q_ls) * eps)
        recon = (out - y).square().sum()
        kl = (0.5 * (torch.exp(2 * (q_ls - p_ls)) + (q_mu - p_mu).square() * torch.exp(-2 * p_ls)
                     - 1) - (q_ls - p_ls)).sum()
        return recon + self.beta * kl, recon, kl

    def sample(self, x, eps):
        """(B, K, H, W, C) residuals of K prior draws, ``eps`` (K, B, D)."""
        feats = self.unet(x)
        mu, ls = self.prior(x.permute(0, 3, 1, 2))
        k, b = eps.shape[:2]
        z = (mu[None] + torch.exp(ls)[None] * eps).reshape(k * b, -1)
        f = feats[None].expand(k, *feats.shape).reshape(k * b, *feats.shape[1:])
        out = self.fcomb(f, z)
        return out.reshape(k, b, *out.shape[1:]).transpose(0, 1)


def adamw_(params: List[nn.Parameter], state: Dict, lr: float, wd: float,
           betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One decoupled-weight-decay Adam update of every parameter, in place:
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    with torch.no_grad():
        for i, p in enumerate(params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m = state.setdefault(("m", i), torch.zeros_like(p))
            v = state.setdefault(("v", i), torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps) + wd * p
            p.sub_(lr * upd)


def train_readings(model: ProbUNet, hr_all, stats, feeds, lr: float, wd: float, scale: int,
                   fault: Optional[str] = None, chunk: Optional[int] = None) -> Dict:
    """Runs the training steps of ``feeds`` (idx, eps, dropout generator)
    from the model's weights: each step's loss, the norms of the first
    step's gradient of each leaf and of its rows (slices along the first
    axis), and the row norms of each leaf's change over all the steps.
    ``chunk``: rows a backward, the batch's parts drawing their parts of the
    whole batch's dropout masks from the generator as it stood after the
    step's noise; the ELBO sums over the batch, so the parts' losses and
    gradients add. ``fault`` plants a fault: ``"half_batch"``, the loss of
    the first half of each batch, doubled; ``"no_exchange"`` (with
    ``chunk``), the first part's alone, as rank 0 steps on its own rows
    where the ranks exchange no gradient."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    state, losses, grad_rows = {}, [], None
    model.train()
    with fp32_math():
        for idx, eps, gen in feeds:
            pair = make_pair(hr_all[idx], scale, stats)
            x, y = pair["inputs"], pair["targets"]
            for p in params:
                p.grad = None
            drawn = gen.get_state() if gen is not None else None
            loss = 0.0
            for rows, shard, weight in _parts(len(idx), chunk, fault):
                if drawn is not None:
                    gen.set_state(drawn)
                total, _, _ = model.elbo(x[rows], y[rows], eps[rows], gen, shard)
                total = weight * total
                total.backward()
                loss += total.item()
            losses.append(loss)
            if grad_rows is None:
                grad_rows = {n: row_norms(p.grad if p.grad is not None else torch.zeros_like(p))
                             for n, p in zip(names, params)}
            adamw_(params, state, lr, wd)
    return {"losses": losses, "grad_rows": grad_rows,
            "grad_norms": {n: float(r.norm()) for n, r in grad_rows.items()},
            "change_rows": {n: row_norms(p - s) for n, p, s in zip(names, params, start)}}


def _parts(batch: int, chunk: Optional[int], fault: Optional[str]) -> List[tuple]:
    """(rows, dropout shard, loss weight) of each backward of a step."""
    if chunk is None or chunk == batch:
        if fault == "half_batch":
            return [(slice(0, batch // 2), (0, 1), 2.0)]
        return [(slice(0, batch), (0, 1), 1.0)]
    n = batch // chunk
    if fault == "no_exchange":
        return [(slice(0, chunk), (0, n), 1.0)]
    keep, weight = (n // 2, 2.0) if fault == "half_batch" else (n, 1.0)
    return [(slice(j * chunk, (j + 1) * chunk), (j, n), weight) for j in range(keep)]


def sample_residuals(model: ProbUNet, hr_all, stats, idx, eps, scale: int) -> Dict:
    """The sampler's standardized residuals (B, K, H, W, C) for the days
    ``idx`` and draws ``eps`` (K, B, D), with the pair they came from."""
    model.eval()
    with torch.no_grad(), fp32_math():
        pair = make_pair(hr_all[idx], scale, stats)
        return {"residual": model.sample(pair["inputs"], eps), "pair": pair}
