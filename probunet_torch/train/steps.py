"""Training, evaluation and sampling steps — ``probunet_tpu/train/steps.py``.

Per step, all on the device: gather the HR batch from the device-resident
dataset tensor, slice the standardization stats, synthesize the LR input
(avg-pool, bilinear upsample, standardize), then the model's work. The JAX
package compiles each step into one XLA program; here PyTorch runs it
eagerly, and the training step updates its :class:`TrainState` in place.
Every step runs under :func:`full_fp32`, so fp32 convolutions and matmuls
are IEEE fp32 (the JAX package's ``Precision.HIGHEST``), never TF32.

Data parallel: given ``dp`` (a :class:`~probunet_torch.parallel.mesh.
DataParallel`), a step runs on this rank's rows of the global batch and
computes what one process computes on the whole of it, as the JAX step does
on a batch sharded over the mesh: every random draw (dropout, label
dropout, posterior and prior noise, EDM sigmas and noise) is this rank's
rows of the global draw, the gradients are all-reduced before the gradient
norm, the clip and the optimizer, and the metrics are reduced on the device
(summed where the loss sums over the batch, as the ELBO does, else
averaged). Without ``dp`` every step is the single-process step.

Spans (``utils/logging.py::span``, recorded only under a profiler): each
training step is one ``probunet.train_step`` and each sampler call one
``probunet.sample``; inside it the phases ``probunet.pair`` (the pair
synthesis), ``probunet.regression`` (CorrDiff's mean, before its chains),
``probunet.forward``, ``probunet.backward`` (with the zero gradients of
unused parameters), ``probunet.allreduce`` and ``probunet.optimizer``
(``parallel/mesh.py``, ``train/state.py``) and ``probunet.output``
(residual -> HR), in that order. ClimaX's and FourCastNet's forwards mark
their tokenizer and head inside ``probunet.forward`` (``probunet.tokenize``,
``probunet.head``; ``models/climax.py``, ``models/fourcastnet.py``), and
FourCastNet's each block's filter (``probunet.spectral``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from probunet_torch.data import transforms
from probunet_torch.data.units import k_to_c, kgm2s_to_mmday
from probunet_torch.ops.crps import crps_empirical
from probunet_torch.train.state import TrainState, global_norm
from probunet_torch.utils.device import full_fp32
from probunet_torch.utils.logging import span

SeedOrGenerator = Union[int, torch.Generator]


def _randn(dp, shape, generator, device, dtype=None, axis: int = 0) -> torch.Tensor:
    """Standard normals of ``shape``; with ``dp``, this rank's rows (along
    ``axis``) of the draw for the global batch."""
    if dp is None:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return dp.randn(shape, generator, device, dtype, axis)


def _shard(dp) -> Tuple[int, int]:
    """The (rank, world) whose rows of the global batch's dropout draws the
    model takes: ``dp``'s, else the whole batch."""
    return (0, 1) if dp is None else (dp.rank, dp.world)


def beta_schedule(schedule: str, beta: float, warmup_steps: int = 0) -> Callable[[int], float]:
    """KL-weight schedule of the optimizer step.

    const  : beta
    linear : 0 -> beta over warmup_steps, then beta
    cyclic : sawtooth 0 -> beta every warmup_steps (cyclical annealing)
    """
    def fn(step: int) -> float:
        s = float(step)
        if schedule == "const" or warmup_steps <= 0:
            return float(beta)
        if schedule == "linear":
            return beta * min(s / warmup_steps, 1.0)
        if schedule == "cyclic":
            return beta * min((s % warmup_steps) / (0.5 * warmup_steps), 1.0)
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return fn


def _step_generators(seed_or_generator: SeedOrGenerator, step: int, device, n: int = 2):
    """``n`` generators on ``device`` for micro-step ``step`` ((latent,
    dropout) by default): streams derived from (seed, step), as
    ``_split_rngs`` folds the step into the key and splits it, so any step
    can be replayed. A generator passed instead feeds every stream as it is."""
    if isinstance(seed_or_generator, torch.Generator):
        return (seed_or_generator,) * n
    seeds = np.random.SeedSequence([int(seed_or_generator), int(step)]).generate_state(n)
    return tuple(torch.Generator(device).manual_seed(int(s)) for s in seeds)


def _grad_leaf_norms(model: torch.nn.Module) -> dict:
    """Per-parameter L2 gradient norms under 'gradnorm/<name>' keys, named
    by the port's (the reference's torch) parameter names."""
    return {f"gradnorm/{name}": torch.linalg.vector_norm(p.grad.float())
            for name, p in model.named_parameters() if p.grad is not None}


def _pair(hr_all, stats, idx, lowres_scale, standardization, compute_dtype):
    with span("probunet.pair"):
        hr = hr_all[idx]
        sl = transforms.slice_stats(stats, standardization, idx)
        pair = transforms.make_pair(hr, lowres_scale, standardization, sl)
        return pair["inputs"].to(compute_dtype), pair["targets"].to(compute_dtype)


def _backward(loss: torch.Tensor, params) -> None:
    """``loss.backward()``, then a zero gradient for each parameter outside
    the graph: unused parameters (map_layer*) still decay, as in optax."""
    with span("probunet.backward"):
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_probunet_train_step(model, lowres_scale: int, standardization: str,
                             beta_fn: Optional[Callable[[int], float]] = None,
                             compute_dtype: torch.dtype = torch.float32, accum: int = 1,
                             watch: bool = False, dp=None):
    """Returns step(state, hr_all, stats, idx, seed_or_generator, eps=None)
    -> metrics, for ``state.model is model``.

    One micro-step: the ELBO with dropout and a reparameterized posterior
    draw, backward, and ``state.optimizer.step()``; ``state.step`` counts
    micro-steps. As in the JAX package, beta follows the optimizer step
    ``state.step // accum`` (``accum`` must match the optimizer's window),
    and the latent and dropout draws derive from (seed, micro-step). ``eps``
    is an optional (B, latent_dim) posterior noise in place of the latent
    draw. Metrics are ``train_loss``, ``recon_loss``, ``kl_div``, ``beta``
    and ``grad_norm`` (before clipping), plus per-parameter gradient norms
    with ``watch``; tensors stay on the device. The JAX factory's ``tx`` and
    ``donate`` have no counterpart: the optimizer lives in the state, which
    is updated in place. ``dp``: data parallel (the module docstring); the
    ELBO sums over the batch, so the gradients and losses are summed over
    the ranks."""
    beta_fn = beta_fn or (lambda step: model.beta)
    accum = max(1, int(accum))

    def step(state: TrainState, hr_all: torch.Tensor, stats, idx: torch.Tensor,
             seed_or_generator: SeedOrGenerator, eps: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        model.train()
        with span("probunet.train_step"), full_fp32():
            x, y = _pair(hr_all, stats, idx, lowres_scale, standardization, compute_dtype)
            beta = beta_fn(state.step // accum)
            g_latent, g_dropout = _step_generators(seed_or_generator, state.step, x.device)
            if eps is None:
                eps = _randn(dp, (x.shape[0], model.latent_dim), g_latent, x.device)
            params = state.optimizer.params
            for p in params:
                p.grad = None
            with span("probunet.forward"):
                total, recon, kl = model.elbo(x, y, beta, generator=g_dropout, eps=eps,
                                          shard=_shard(dp))
            _backward(total, params)
            metrics = {"train_loss": total.detach(), "recon_loss": recon.detach(),
                       "kl_div": kl.detach()}
            if dp is not None:
                dp.allreduce_grads(params, mean=False)
                metrics = dp.reduce_metrics(metrics, sums=list(metrics))
            metrics.update(beta=beta, grad_norm=global_norm(p.grad for p in params))
            if watch:
                metrics.update(_grad_leaf_norms(model))
            state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_probunet_train_multistep(model, lowres_scale: int, standardization: str,
                                  beta_fn: Optional[Callable[[int], float]] = None,
                                  compute_dtype: torch.dtype = torch.float32, accum: int = 1,
                                  dp=None):
    """multi(state, hr_all, stats, idxs, seed_or_generator) runs one training
    step per row of ``idxs`` (K, B) and returns the metrics stacked over K:
    the JAX package's scanned multistep as a plain loop."""
    step = make_probunet_train_step(model, lowres_scale, standardization, beta_fn,
                                    compute_dtype, accum, dp=dp)

    def multi(state, hr_all, stats, idxs, seed_or_generator):
        ms = [step(state, hr_all, stats, idx, seed_or_generator) for idx in idxs]
        return {k: torch.stack([torch.as_tensor(m[k]) for m in ms]) for k in ms[0]}

    return multi


def make_probunet_eval_step(model, lowres_scale: int, standardization: str,
                            compute_dtype: torch.dtype = torch.float32, dp=None):
    """Returns step(hr_all, stats, idx, seed_or_generator, beta, eps=None)
    -> {val_loss, val_recon_loss, val_kl_div}: the ELBO with dropout off
    (``model.eval()``) and a seeded posterior draw, as the reference's eval
    still samples the posterior. With ``dp`` the draw is this rank's rows
    of the global one and the losses are summed over the ranks."""

    @torch.no_grad()
    def step(hr_all, stats, idx, seed_or_generator: SeedOrGenerator, beta,
             eps: Optional[torch.Tensor] = None):
        model.eval()
        with full_fp32():
            x, y = _pair(hr_all, stats, idx, lowres_scale, standardization, compute_dtype)
            gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
                   else torch.Generator(x.device).manual_seed(int(seed_or_generator)))
            if eps is None and dp is not None:   # as DiagGaussian draws it: generator's device, fp32
                eps = dp.randn((x.shape[0], model.latent_dim), gen, gen.device, torch.float32)
            total, recon, kl = model.elbo(x, y, beta, generator=gen, eps=eps)
        out = {"val_loss": total, "val_recon_loss": recon, "val_kl_div": kl}
        return out if dp is None else dp.reduce_metrics(out, sums=list(out))

    return step


def _members_to_hr(preds, pair, standardization, sl):
    """(B, K, H, W, C) residuals -> physical HR fields (``probunet.output``)."""
    with span("probunet.output"):
        # the stats broadcast over the K axis for the inverse transform
        if sl is not None and standardization != "perpixel":
            sl = (sl[0][:, None], sl[1][:, None])
        return transforms.residual_to_hr(preds, pair["lrinterp"][:, None], standardization, sl)


def make_sample_fn(model, lowres_scale: int, standardization: str, num_samples: int,
                   compute_dtype: torch.dtype = torch.float32):
    """Returns fn(hr_all, stats, idx, generator=None, eps=None) ->
    (hr_preds (B, K, H, W, C) fp32, pair dict). ``eps`` is an optional
    (K, B, latent_dim) tensor of standard normals; else the draws come from
    ``generator``. Runs in eval mode (no dropout, as the JAX sampler runs
    the U-Net with ``train=False``) under ``torch.inference_mode``."""

    @torch.inference_mode()
    def fn(hr_all: torch.Tensor, stats, idx: torch.Tensor,
           generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        model.eval()
        with span("probunet.sample"):
            with span("probunet.pair"):
                hr = hr_all[idx]
                sl = transforms.slice_stats(stats, standardization, idx)
                pair = transforms.make_pair(hr, lowres_scale, standardization, sl)
                x = pair["inputs"].to(compute_dtype)
            with span("probunet.forward"):
                preds = model.sample(x, num_samples, generator=generator, eps=eps).float()
            return _members_to_hr(preds, pair, standardization, sl), pair

    return fn


def _ensemble_crps_metrics(hr_preds: torch.Tensor, hr: torch.Tensor,
                           variables: Sequence[str]) -> dict:
    """(B, K, H, W, C) physical ensemble + (B, H, W, C) truth -> per-variable
    mean CRPS (mm/day, deg C) and ensemble-mean MAE."""
    def to_physical(field, var):
        return kgm2s_to_mmday(field) if var == "pr" else k_to_c(field)

    ens = hr_preds.transpose(0, 1)                                # (K, B, H, W, C)
    out = {}
    for i, var in enumerate(variables):
        p = to_physical(ens[..., i], var)
        t = to_physical(hr[..., i], var)
        out[f"crps_{var}"] = crps_empirical(p, t).mean()
        out[f"ensmean_mae_{var}"] = (p.mean(dim=0) - t).abs().mean()
    return out


def make_crps_eval_fn(model, lowres_scale: int, standardization: str,
                      variables: Tuple[str, ...], num_samples: int = 16,
                      compute_dtype: torch.dtype = torch.float32, dp=None):
    """Returns fn(hr_all, stats, idx, generator=None, eps=None) -> metrics:
    K prior draws, residual -> HR, per-variable mean CRPS in physical units
    and the ensemble-mean MAE. With ``dp`` the draws are this rank's rows
    of the global batch's and the metrics are averaged over the ranks."""
    sample = make_sample_fn(model, lowres_scale, standardization, num_samples, compute_dtype)

    def fn(hr_all, stats, idx, generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None):
        if eps is None and dp is not None:   # as DiagGaussian.sample draws them: fp32
            eps = dp.randn((num_samples, len(idx), model.latent_dim), generator,
                           generator.device if generator is not None else idx.device,
                           torch.float32, axis=1)
        hr_preds, pair = sample(hr_all, stats, idx, generator, eps)
        with torch.inference_mode():
            out = _ensemble_crps_metrics(hr_preds, pair["hr"], variables)
        return out if dp is None else dp.reduce_metrics(out, means=list(out))

    return fn


# ---- deterministic baselines (U-Net, LinearCNN) ------------------------------------------

def _elementwise_loss(loss: str):
    """fp32 MSE or MAE of (pred, target)."""
    def loss_of(pred, target):
        d = pred.float() - target.float()
        return d.square().mean() if loss == "mse" else d.abs().mean()
    return loss_of


def make_deterministic_train_step(model, lowres_scale: int, standardization: str,
                                  compute_dtype: torch.dtype = torch.float32, loss: str = "mse",
                                  timetransform: str = "id", watch: bool = False, dp=None):
    """Returns step(state, hr_all, stats, idx, timestamps, seed_or_generator)
    -> metrics, for ``state.model is model`` (a deterministic U-Net or a
    :class:`~probunet_torch.models.baselines.LinearCNN`).

    One step of the reference's baseline training (trainmodel.py:119-202):
    the model maps the standardized LR-interp input to the residual, with
    class labels ``transforms.time_features(timestamps, timetransform)``
    (``timestamps`` (B,) float32 ns); the MSE (or MAE) loss in fp32,
    backward, ``state.optimizer.step()``. Only x and y are cast to
    ``compute_dtype``; the layers cast their fp32 weights to x's dtype, as
    the JAX layers do. The dropout draws derive from (seed, micro-step).
    Metrics: ``train_loss``, ``train_loss_var{i}`` per variable, and
    per-parameter gradient norms with ``watch``; tensors stay on the device.
    ``dp``: data parallel; the loss is a mean, so the gradients and losses
    are averaged over the ranks."""
    loss_of = _elementwise_loss(loss)

    def step(state: TrainState, hr_all: torch.Tensor, stats, idx: torch.Tensor,
             timestamps: torch.Tensor, seed_or_generator: SeedOrGenerator):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        model.train()
        with span("probunet.train_step"), full_fp32():
            x, y = _pair(hr_all, stats, idx, lowres_scale, standardization, compute_dtype)
            _, g_dropout = _step_generators(seed_or_generator, state.step, x.device)
            params = state.optimizer.params
            for p in params:
                p.grad = None
            with span("probunet.forward"):
                labels = transforms.time_features(timestamps, timetransform)
                preds = model(x, class_labels=labels, generator=g_dropout, shard=_shard(dp))
                total = loss_of(preds, y)
            _backward(total, params)
            preds = preds.detach()
            metrics = {"train_loss": total.detach()}
            for i in range(y.shape[-1]):
                metrics[f"train_loss_var{i}"] = loss_of(preds[..., i], y[..., i])
            if dp is not None:
                dp.allreduce_grads(params, mean=True)
                metrics = dp.reduce_metrics(metrics, means=list(metrics))
            if watch:
                metrics.update(_grad_leaf_norms(model))
            state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_deterministic_eval_step(model, lowres_scale: int, standardization: str,
                                 variables: Tuple[str, ...], reconstruct: bool = False,
                                 loss: str = "mse", compute_dtype: torch.dtype = torch.float32,
                                 timetransform: str = "id", dp=None):
    """Returns step(hr_all, stats, idx, timestamps) -> {eval_<var>}: the
    per-variable loss of the model's residual (reference
    trainmodel.py:235-304) in eval mode; with ``reconstruct`` on the
    physical HR fields after residual -> HR and unit conversion (mm/day,
    deg C). With ``dp`` the losses are averaged over the ranks."""
    loss_of = _elementwise_loss(loss)

    def to_physical(field, var):
        return kgm2s_to_mmday(field) if var == "pr" else k_to_c(field)

    @torch.inference_mode()
    def step(hr_all, stats, idx, timestamps):
        model.eval()
        with full_fp32():
            hr = hr_all[idx]
            sl = transforms.slice_stats(stats, standardization, idx)
            pair = transforms.make_pair(hr, lowres_scale, standardization, sl)
            x = pair["inputs"].to(compute_dtype)
            preds = model(x, class_labels=transforms.time_features(timestamps, timetransform))
            out = {}
            if reconstruct:
                hr_pred = transforms.residual_to_hr(preds.float(), pair["lrinterp"],
                                                    standardization, sl)
                for i, var in enumerate(variables):
                    out[f"eval_{var}"] = loss_of(to_physical(hr_pred[..., i], var),
                                                 to_physical(hr[..., i], var))
            else:
                y = pair["targets"]
                for i, var in enumerate(variables):
                    out[f"eval_{var}"] = loss_of(preds[..., i], y[..., i])
        return out if dp is None else dp.reduce_metrics(out, means=list(out))

    return step


# ---- EDM diffusion downscaler -----------------------------------------------------------

def _edm_pair(hr_all, stats, idx, lowres_scale, standardization, compute_dtype):
    """(condition in ``compute_dtype``, fp32 clean residual, pair dict)."""
    with span("probunet.pair"):
        hr = hr_all[idx]
        sl = transforms.slice_stats(stats, standardization, idx)
        pair = transforms.make_pair(hr, lowres_scale, standardization, sl)
        return pair["inputs"].to(compute_dtype), pair["targets"].float(), pair, sl


def _dsm_loss(model, x, y, sigma, noise, sigma_data, compute_dtype, generator=None,
              shard=(0, 1)):
    """The lambda(sigma)-weighted denoising loss of one batch: the residual
    ``y`` noised by ``noise * sigma``, denoised conditioned on ``x``
    (dropout: ``generator`` and ``shard``, ``UNet.forward``)."""
    weight = (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2
    noisy = (y + noise * sigma[:, None, None, None]).to(compute_dtype)
    d = model(noisy, sigma, condition_img=x, generator=generator, shard=shard)
    per = (d.float() - y).square().mean(dim=(1, 2, 3))
    return (weight * per).mean()


def _dsm_draws(b, shape, device, g_sigma, g_noise, p_mean, p_std, sigma=None, noise=None,
               dp=None):
    """Log-normal sigmas (B,) and standard-normal noise ``shape``, each drawn
    from its generator unless given (with ``dp``, this rank's rows of the
    global draws)."""
    if sigma is None:
        sigma = torch.exp(p_mean + p_std * _randn(dp, (b,), g_sigma, device))
    if noise is None:
        noise = _randn(dp, tuple(shape), g_noise, device)
    return sigma.to(device, torch.float32), noise.to(device, torch.float32)


def make_edm_train_step(model, lowres_scale: int, standardization: str, p_mean: float = -1.2,
                        p_std: float = 1.2, sigma_data: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32, watch: bool = False,
                        dp=None):
    """Returns step(state, hr_all, stats, idx, seed_or_generator, sigma=None,
    noise=None) -> metrics, for ``state.model is model`` (an
    :class:`~probunet_torch.models.edm.EDMPrecond`).

    One denoising-score-matching step (Karras et al.): the clean residual is
    noised with log-normal sigmas (``p_mean``, ``p_std``), the denoiser
    conditioned on the LR-interp input, the loss weighted by lambda(sigma) =
    (sigma^2 + sigma_data^2) / (sigma sigma_data)^2, then backward and
    ``state.optimizer.step()``. As in the JAX step, the noisy input and the
    condition are rounded to ``compute_dtype``; the denoiser itself runs in
    fp32. The sigma, noise and dropout draws derive from (seed, micro-step);
    ``sigma`` (B,) and ``noise`` (B, H, W, C) standard normals may be given
    instead. Metrics: ``train_loss`` and ``grad_norm``, plus per-parameter
    gradient norms with ``watch``; tensors stay on the device. ``dp``: data
    parallel; the loss is a mean, so the gradients and the loss are averaged
    over the ranks."""

    def step(state: TrainState, hr_all: torch.Tensor, stats, idx: torch.Tensor,
             seed_or_generator: SeedOrGenerator, sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        model.train()
        with span("probunet.train_step"), full_fp32():
            x, y, _, _ = _edm_pair(hr_all, stats, idx, lowres_scale, standardization,
                                   compute_dtype)
            g_sigma, g_noise, g_dropout = _step_generators(seed_or_generator, state.step,
                                                           x.device, 3)
            sigma, noise = _dsm_draws(y.shape[0], y.shape, x.device, g_sigma, g_noise, p_mean,
                                      p_std, sigma, noise, dp)
            params = state.optimizer.params
            for p in params:
                p.grad = None
            with span("probunet.forward"):
                loss = _dsm_loss(model, x, y, sigma, noise, sigma_data, compute_dtype,
                                 g_dropout, _shard(dp))
            _backward(loss, params)
            metrics = {"train_loss": loss.detach()}
            if dp is not None:
                dp.allreduce_grads(params, mean=True)
                metrics = dp.reduce_metrics(metrics, means=list(metrics))
            metrics["grad_norm"] = global_norm(p.grad for p in params)
            if watch:
                metrics.update(_grad_leaf_norms(model))
            state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_edm_eval_step(model, lowres_scale: int, standardization: str, p_mean: float = -1.2,
                       p_std: float = 1.2, sigma_data: float = 1.0,
                       compute_dtype: torch.dtype = torch.float32, dp=None):
    """Returns step(hr_all, stats, idx, seed_or_generator, sigma=None,
    noise=None) -> {val_loss}: the seeded denoising loss of
    :func:`make_edm_train_step` with dropout off (``model.eval()``); the
    sigmas, then the noise, are drawn from the one generator unless given.
    With ``dp`` the draws are this rank's rows of the global ones and the
    loss is averaged over the ranks."""

    @torch.inference_mode()
    def step(hr_all, stats, idx, seed_or_generator: SeedOrGenerator,
             sigma: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        model.eval()
        with full_fp32():
            x, y, _, _ = _edm_pair(hr_all, stats, idx, lowres_scale, standardization,
                                   compute_dtype)
            gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
                   else torch.Generator(x.device).manual_seed(int(seed_or_generator)))
            sigma, noise = _dsm_draws(y.shape[0], y.shape, x.device, gen, gen, p_mean, p_std,
                                      sigma, noise, dp)
            out = {"val_loss": _dsm_loss(model, x, y, sigma, noise, sigma_data, compute_dtype)}
            return out if dp is None else dp.reduce_metrics(out, means=list(out))

    return step


def karras_schedule(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                    rho: float = 7.0) -> np.ndarray:
    """The EDM noise levels t_0 > ... > t_{S-1}, then 0: (S + 1,) float32,
    computed in float32 as the JAX chain computes them on the device."""
    steps = np.arange(num_steps, dtype=np.float32)
    t = (sigma_max ** (1 / rho)
         + steps / np.float32(num_steps - 1) * np.float32(sigma_min ** (1 / rho)
                                                          - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t.astype(np.float32), np.zeros(1, np.float32)])


def edm_heun_chain(model, x_cond: torch.Tensor, num_steps: int = 18, sigma_min: float = 0.002,
                   sigma_max: float = 80.0, rho: float = 7.0,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The deterministic EDM sampler (Heun, 2nd order; the last step Euler),
    noise -> residual, conditioned on the LR-interp tiles ``x_cond`` (B, H,
    W, C): 2 S - 1 denoiser passes for S steps. ``noise`` (B, H, W, C)
    standard normals start the chain, else drawn from ``generator``. The
    schedule lives on the host, so the chain makes no host sync. Runs the
    model as it is set (the callers set eval mode)."""
    b = x_cond.shape[0]
    t = [float(v) for v in karras_schedule(num_steps, sigma_min, sigma_max, rho)]
    if noise is None:
        noise = torch.randn(x_cond.shape, generator=generator, device=x_cond.device)
    x = noise.to(x_cond.device, torch.float32) * t[0]

    def denoise(xk, sigma):
        return model(xk, torch.full((b,), sigma, device=xk.device), condition_img=x_cond)

    for t_cur, t_next in zip(t[:-1], t[1:]):
        d = (x - denoise(x, t_cur)) / t_cur
        x_euler = x + (t_next - t_cur) * d
        if t_next > 0:
            d2 = (x_euler - denoise(x_euler, t_next)) / t_next
            x = x + (t_next - t_cur) * 0.5 * (d + d2)
        else:
            x = x_euler
    return x


def edm_sample(model, x_cond: torch.Tensor, num_steps: int = 18, sigma_min: float = 0.002,
               sigma_max: float = 80.0, rho: float = 7.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One EDM (Heun) residual draw per input, (B, H, W, C): the chain in
    eval mode under ``torch.inference_mode``."""
    model.eval()
    with torch.inference_mode(), full_fp32():
        return edm_heun_chain(model, x_cond, num_steps, sigma_min, sigma_max, rho,
                              generator, noise)


def make_edm_sample_fn(model, lowres_scale: int, standardization: str, num_samples: int,
                       num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
                       rho: float = 7.0, compute_dtype: torch.dtype = torch.float32):
    """Returns fn(hr_all, stats, idx, generator=None, noise=None) ->
    (hr_preds (B, K, H, W, C) fp32, pair dict), the surface of
    :func:`make_sample_fn`: K Heun chains folded K-major into the batch axis
    (one (K*B)-row chain), then residual -> HR. ``noise`` is an optional
    (K*B, H, W, C) tensor of the chains' initial standard normals, else they
    come from ``generator``. Runs in eval mode under ``torch.inference_mode``."""

    @torch.inference_mode()
    def fn(hr_all: torch.Tensor, stats, idx: torch.Tensor,
           generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        model.eval()
        with span("probunet.sample"), full_fp32():
            x, _, pair, sl = _edm_pair(hr_all, stats, idx, lowres_scale, standardization,
                                       compute_dtype)
            b, h, w, c = x.shape
            k = num_samples
            with span("probunet.forward"):
                x_rep = x[None].expand(k, b, h, w, c).reshape(k * b, h, w, c)
                residual = edm_heun_chain(model, x_rep, num_steps, sigma_min, sigma_max, rho,
                                          generator, noise)
                preds = residual.float().reshape(k, b, h, w, c).transpose(0, 1)   # (B, K, ...)
            return _members_to_hr(preds, pair, standardization, sl), pair

    return fn


def make_corrdiff_sample_fn(model, lowres_scale: int, standardization: str, num_samples: int,
                            num_steps: int = 18, sigma_min: float = 0.002,
                            sigma_max: float = 80.0, rho: float = 7.0,
                            compute_dtype: torch.dtype = torch.float32):
    """Returns fn(hr_all, stats, idx, generator=None, noise=None) ->
    (hr_preds (B, K, H, W, C) fp32, pair dict), the surface of
    :func:`make_edm_sample_fn`, for a :class:`~probunet_torch.models.corrdiff.
    CorrDiff` ``model``: the pair, the regression mean ``mu`` once per input
    (span ``probunet.regression``), then K residual Heun chains folded
    K-major into one (K*B)-row chain of the residual denoiser, member k =
    ``mu + r_k`` (span ``probunet.forward``), then residual -> HR. ``noise``
    is an optional (K*B, H, W, C) tensor of the chains' initial standard
    normals, else they come from ``generator``. Runs in eval mode under
    ``torch.inference_mode``, in fp32 whatever ``compute_dtype`` says (the
    condition is cast to it first, as :func:`make_edm_sample_fn` does)."""

    @torch.inference_mode()
    def fn(hr_all: torch.Tensor, stats, idx: torch.Tensor,
           generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        model.eval()
        with span("probunet.sample"), full_fp32():
            x, _, pair, sl = _edm_pair(hr_all, stats, idx, lowres_scale, standardization,
                                       compute_dtype)
            b, h, w, c = x.shape
            k = num_samples
            with span("probunet.regression"):
                mu = model.regression(x)
            with span("probunet.forward"):
                x_rep = x[None].expand(k, b, h, w, c).reshape(k * b, h, w, c)
                residual = edm_heun_chain(model, x_rep, num_steps, sigma_min, sigma_max, rho,
                                          generator, noise)
                preds = (mu[None] + residual.reshape(k, b, h, w, c)).transpose(0, 1)
            return _members_to_hr(preds, pair, standardization, sl), pair

    return fn


def make_edm_crps_eval_fn(model, lowres_scale: int, standardization: str,
                          variables: Tuple[str, ...], num_samples: int = 16,
                          num_steps: int = 18, compute_dtype: torch.dtype = torch.float32,
                          dp=None):
    """Returns fn(hr_all, stats, idx, generator=None, noise=None) -> metrics:
    the K-member Heun ensemble of :func:`make_edm_sample_fn`, then the
    per-variable CRPS and ensemble-mean MAE of :func:`make_crps_eval_fn`
    (with ``dp``: the chains' noise is this rank's rows of the global
    batch's, K-major, and the metrics are averaged over the ranks)."""
    sample = make_edm_sample_fn(model, lowres_scale, standardization, num_samples, num_steps,
                                compute_dtype=compute_dtype)

    def fn(hr_all, stats, idx, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None):
        if noise is None and dp is not None:   # as edm_heun_chain draws it: (K*B, H, W, C)
            shape = (num_samples, len(idx), *hr_all.shape[1:])
            noise = dp.randn(shape, generator, hr_all.device, axis=1).reshape(-1, *shape[2:])
        hr_preds, pair = sample(hr_all, stats, idx, generator, noise)
        with torch.inference_mode():
            out = _ensemble_crps_metrics(hr_preds, pair["hr"], variables)
        return out if dp is None else dp.reduce_metrics(out, means=list(out))

    return fn
