"""Training state and optimizer construction — ``probunet_tpu/train/state.py``.

The default optimizer is ``torch.optim.AdamW(lr, (0.9, 0.999), 1e-8,
weight_decay)``, decoupled decay on every parameter: optax.adamw's math and
the reference's optimizer. ``state_dtype="bfloat16"`` selects the port's
:class:`AdamWBf16State`, written out from the JAX package's bandwidth
variant. Clipping by global norm and gradient accumulation with
``optax.MultiSteps`` semantics wrap the inner optimizer in :class:`Optimizer`.
The JAX optimizer is plain XLA, so ``torch.optim`` stands in for it here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

from probunet_torch.ops import adamw_bf16
from probunet_torch.utils.logging import span


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), fp32."""
    return torch.nn.utils.get_total_norm([t.float() for t in tensors])


class AdamWBf16State(torch.optim.Optimizer):
    """AdamW with the first moment stored in bf16, written out from
    ``_scale_by_adam_bf16_state`` and its chain (state.py:26-88): gradients
    cast to bf16, mu = b1 mu + (1 - b1) g rounded to bf16, nu = b2 nu +
    (1 - b2) g^2 in fp32, the bias-corrected ratio in fp32, then decoupled
    weight decay, then -lr. nu stays fp32: its per-step increment is below
    bf16's resolution."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      count=0))
        self._table = adamw_bf16.Table()   # the fused launch's buffer, on the card

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient
        (``ops/adamw_bf16.py::update``): one kernel launch a group on the
        card, multi-tensor (``torch._foreach_*``) ops with the bf16 roundings
        tensor by tensor on the CPU; the two give equal bits."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p, dtype=torch.bfloat16),
                                         nu=torch.zeros_like(p, dtype=torch.float32))
            adamw_bf16.update(params, [self.state[p] for p in params], betas=group["betas"],
                              count=group["count"] + 1, lr=group["lr"], eps=group["eps"],
                              weight_decay=group["weight_decay"], table=self._table)
            group["count"] += 1  # one count for the group, as optax keeps one

    def load_state_dict(self, state_dict):
        """torch's load casts each state tensor to its parameter's dtype;
        mu goes back to bf16 (bf16 -> fp32 -> bf16 is exact). Both moments
        take their parameter's memory layout, as at their first step (a
        checkpoint holds them contiguous; the fused launch reads p, mu and
        nu in one layout)."""
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            if "mu" in st:
                st["mu"] = torch.empty_like(p, dtype=torch.bfloat16).copy_(st["mu"])
                st["nu"] = torch.empty_like(p).copy_(st["nu"])


class Optimizer:
    """One update rule on a fixed parameter list, as an optax chain:
    accumulation (``optax.MultiSteps``) around clipping by global norm
    around the inner ``torch.optim`` optimizer. :meth:`step` consumes the
    gradients in ``p.grad`` and updates the parameters in place."""

    def __init__(self, params: List[nn.Parameter], inner: torch.optim.Optimizer,
                 grad_clip: Optional[float] = None, accum: int = 1):
        self.params = params
        self.inner = inner
        self.grad_clip = grad_clip
        self.accum = max(1, int(accum))
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params] if self.accum > 1 else None

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step. With ``accum`` > 1 the gradients join the window's
        running mean (Welford, as MultiSteps keeps it) and the inner update
        runs with that mean on the window's last micro-step only. Returns
        whether the parameters were updated. One ``probunet.optimizer``
        span."""
        with span("probunet.optimizer"):
            grads = [p.grad for p in self.params]
            if self.acc is not None:
                delta = torch._foreach_sub(grads, self.acc)
                torch._foreach_div_(delta, self.mini_step + 1)
                torch._foreach_add_(self.acc, delta)
                self.mini_step = (self.mini_step + 1) % self.accum
                if self.mini_step:
                    return False
                torch._foreach_copy_(grads, self.acc)
                torch._foreach_zero_(self.acc)
            if self.grad_clip:
                norm = global_norm(grads)
                torch._foreach_mul_(grads, torch.where(norm < self.grad_clip, 1.0,
                                                       self.grad_clip / norm))
            self.inner.step()
            return True

    def state_dict(self) -> dict:
        """What exact resume needs: the inner optimizer's ``state_dict``
        (per-parameter moments and steps, ``AdamWBf16State``'s group
        ``count``), the accumulation window's position and its running
        mean (parameter order)."""
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": None if self.acc is None else list(self.acc)}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load :meth:`state_dict` output (or a transplanted optax state,
        ``utils.transplant.flax_opt_state_to_torch``) onto this optimizer's
        parameters, on their device. The hyperparameters (lr, betas, eps,
        weight decay) stay this optimizer's, which its config built: as the
        JAX engine rebuilds ``tx`` from the config on resume, a checkpoint's
        ``lr`` never wins."""
        if (state_dict["acc"] is None) != (self.acc is None):
            raise ValueError(f"the checkpoint's accumulation state does not fit accum="
                             f"{self.accum}")
        hyper = [{k: v for k, v in g.items() if k not in ("params", "count")}
                 for g in self.inner.param_groups]
        self.inner.load_state_dict(state_dict["inner"])
        for group, h in zip(self.inner.param_groups, hyper):
            group.update(h)
        self.mini_step = int(state_dict["mini_step"])
        if self.acc is not None:
            with torch.no_grad():
                for a, saved in zip(self.acc, state_dict["acc"], strict=True):
                    a.copy_(saved)


def make_optimizer(lr: float = 1e-3, weight_decay: float = 0.01, accum: int = 1,
                   optimizer: str = "adamw", grad_clip: Optional[float] = None,
                   state_dtype: str = "float32") -> Callable[[Iterable[nn.Parameter]], Optimizer]:
    """The update rule of ``probunet_tpu.train.state.make_optimizer`` for
    these options. torch optimizers bind to their parameters, so this
    returns ``tx(params) -> Optimizer``; :func:`create_train_state` calls it."""
    if optimizer == "adamw" and state_dtype == "bfloat16":
        inner = functools.partial(AdamWBf16State, lr=lr, weight_decay=weight_decay)
    elif optimizer == "adamw":
        inner = functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    elif optimizer == "adam":  # optax.adam's defaults are torch's
        inner = functools.partial(torch.optim.Adam, lr=lr)
    elif optimizer == "sgd":
        inner = functools.partial(torch.optim.SGD, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def tx(params: Iterable[nn.Parameter]) -> Optimizer:
        params = list(params)
        return Optimizer(params, inner(params), grad_clip, accum)

    return tx


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), its optimizer and the micro-step count.
    Unlike the JAX package's immutable state, a training step updates all
    three in place. ``optimizer`` is None where only the model is held
    (serving): checkpoints then save and restore the parameters and step."""

    model: nn.Module
    optimizer: Optional[Optimizer]
    step: int = 0


def create_train_state(model: nn.Module, tx: Callable[[Iterable[nn.Parameter]], Optimizer]
                       ) -> TrainState:
    return TrainState(model, tx(model.parameters()))
