"""Reverse-SDE samplers (counterpart of
``brever_tpu/models/sgmse/solvers.py``): ``pc`` (predictor-corrector with
an annealed Langevin corrector) and ``edm`` (Heun's second order with
optional stochastic churn).

The JAX package's ``lax.scan`` is a Python loop over time grids computed up
front in float32, as JAX builds them (``np.arange(1, 0, -1/n)``, ``n``
entries, and ``linspace(1, 0, n + 1)``). The last step is deterministic in
PC (the probability flow, no noise) and plain Euler in EDM, whose Heun
correction it skips, so EDM evaluates the model ``2 n - 1`` times. Noise
comes from the ``torch.Generator`` a solver is given, through
:func:`.sdes.randn_like`.
"""

import numpy as np
import torch

from ...registry import Registry
from . import sdes

SolverRegistry = Registry('solver')


def _grid(values, like):
    return torch.from_numpy(values.astype(np.float32)).to(like.device)


@SolverRegistry.register('edm')
class EDMSolver:
    """Heun 2nd-order sampler with stochastic churn (Karras 2022)."""

    def __init__(self, num_steps, schurn, smin, smax, snoise, **kwargs):
        self.num_steps = num_steps
        self.schurn = schurn
        self.smin = smin
        self.smax = smax
        self.snoise = snoise
        self._gamma = min(schurn / num_steps, 2 ** 0.5 - 1)

    @property
    def evaluations(self):
        """Model evaluations of one call: the last step skips Heun's."""
        return 2 * self.num_steps - 1

    def __call__(self, sde, y, model, generator=None):
        t_grid = _grid(np.linspace(1.0, 0.0, self.num_steps + 1), y)
        sigma_grid = sde.sigma(t_grid)
        x = sde.prior(y, generator)
        for idx in range(self.num_steps):
            t_i, t_next = t_grid[idx], t_grid[idx + 1]
            sigma_i, sigma_next = sigma_grid[idx], sigma_grid[idx + 1]
            eps = self.snoise * sdes.randn_like(x, generator)
            churn = (self.smin <= sigma_i) & (sigma_i <= self.smax)
            gamma = torch.where(churn, self._gamma, 0.0)
            sigma_hat = sigma_i * (1 + gamma)
            t_hat = sde.sigma_inv(sigma_hat)
            x_hat = sde.s(t_hat) / sde.s(t_i) * (x - y) + y \
                + sde.s(t_hat) * torch.sqrt(
                    torch.clamp(sigma_hat ** 2 - sigma_i ** 2, min=0.0)) * eps

            score = model.score((x_hat - y) / sde.s(t_hat), y, sigma_hat,
                                t_hat)
            d_hat = sde.probability_flow(x_hat, y, score, t_hat)
            x = x_hat + (t_next - t_hat) * d_hat
            if idx < self.num_steps - 1:
                score2 = model.score((x - y) / sde.s(t_next), y, sigma_next,
                                     t_next)
                d_next = sde.probability_flow(x, y, score2, t_next)
                x = x_hat + 0.5 * (t_next - t_hat) * (d_hat + d_next)
        return x, self.evaluations


@SolverRegistry.register('pc')
class PCSolver:
    """Predictor-corrector: annealed-Langevin corrector and reverse step."""

    def __init__(self, num_steps, corrector_steps, corrector_snr, **kwargs):
        self.num_steps = num_steps
        self.corrector_steps = corrector_steps
        self.corrector_snr = corrector_snr

    @property
    def evaluations(self):
        """Model evaluations of one call."""
        return self.num_steps * (self.corrector_steps + 1)

    def __call__(self, sde, y, model, generator=None):
        dt = -1.0 / self.num_steps
        t_grid = _grid(np.arange(1.0, 0.0, dt, dtype=np.float32), y)
        sigma_grid = sde.sigma(t_grid)
        eps_grid = 2 * (self.corrector_snr * sde.s(t_grid) * sigma_grid) ** 2
        x = sde.prior(y, generator)
        for idx in range(self.num_steps):
            t_i, sigma_i, eps_i = t_grid[idx], sigma_grid[idx], eps_grid[idx]
            for _ in range(self.corrector_steps):
                score = model.score((x - y) / sde.s(t_i), y, sigma_i, t_i)
                x = x + eps_i * score + torch.sqrt(2 * eps_i) \
                    * sdes.randn_like(x, generator)
            score = model.score((x - y) / sde.s(t_i), y, sigma_i, t_i)
            if idx == self.num_steps - 1:
                x = x + dt * sde.probability_flow(x, y, score, t_i)
            else:
                x = x + sde.reverse_step(x, y, score, t_i, dt, generator)
        return x, self.evaluations
