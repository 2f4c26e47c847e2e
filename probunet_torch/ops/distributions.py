"""Diagonal Gaussian utilities — ``probunet_tpu/ops/distributions.py``.

``scale = exp(log_sigma)``; the KL is computed in float32. Draws take an
explicit ``torch.Generator`` or the standard-normal ``eps`` itself, so a
test can feed the JAX package and the port the same noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiagGaussian(NamedTuple):
    """Axis-aligned (diagonal-covariance) Gaussian over the last axis."""

    mu: torch.Tensor         # (..., D)
    log_sigma: torch.Tensor  # (..., D)

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma)

    def _eps(self, shape, generator: Optional[torch.Generator],
             eps: Optional[torch.Tensor]) -> torch.Tensor:
        if eps is None:
            # drawn on the generator's device (a CPU generator gives the same
            # draws whatever device the model runs on), then moved
            gdev = generator.device if generator is not None else self.mu.device
            eps = torch.randn(shape, generator=generator, device=gdev, dtype=self.mu.dtype)
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {tuple(shape)}")
        return eps.to(self.mu.device, self.mu.dtype)

    def rsample(self, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterized sample mu + sigma * eps."""
        return self.mu + self.sigma * self._eps(self.mu.shape, generator, eps)

    def sample(self, num: int, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``num`` independent draws stacked on a leading axis: (num, ..., D)."""
        e = self._eps((num,) + tuple(self.mu.shape), generator, eps)
        return self.mu[None] + self.sigma[None] * e


def kl_diag_gaussian(q: DiagGaussian, p: DiagGaussian) -> torch.Tensor:
    """KL(q || p) per batch element (sum over the event axis), in float32."""
    q_mu, p_mu = q.mu.float(), p.mu.float()
    q_ls, p_ls = q.log_sigma.float(), p.log_sigma.float()
    var_ratio = torch.exp(2.0 * (q_ls - p_ls))
    t1 = (q_mu - p_mu).square() * torch.exp(-2.0 * p_ls)
    per_dim = 0.5 * (var_ratio + t1 - 1.0) - (q_ls - p_ls)
    return per_dim.sum(dim=-1)
