"""Forward SDEs for score-based speech enhancement (counterpart of
``brever_tpu/models/sgmse/sdes.py``).

``richter-ouve``, ``brever-ouve``, ``brever-ouvp``, ``brever-oucosine``,
``bbed``, ``bbcd`` and ``bbls``, each with ``s``/``sigma``/``f``/``g`` and,
where the JAX package has it, ``sigma_inv``, plus ``probability_flow``,
``reverse_step`` and ``prior``. ``t`` and ``sigma`` are tensors. The
exponential integral of BBED is the JAX package's fixed-order series.

Randomness comes from an explicit ``torch.Generator`` (:func:`randn_like`);
a complex tensor takes two draws, real then imaginary, as the JAX package
splits its key in two. ``torch.Generator`` and ``jax.random`` give other
numbers from the same seed.
"""

import math

import torch

from ...registry import Registry

SDERegistry = Registry('sde')

_EULER_GAMMA = 0.5772156649015329


def expi(x, terms=40):
    """Exponential integral Ei(x) for ``|x| <~ 10``: ``gamma + ln|x| +
    sum x^n / (n n!)`` to a fixed order."""
    acc = torch.zeros_like(x)
    term = torch.ones_like(x)
    for n in range(1, terms + 1):
        term = term * x / n
        acc = acc + term / n
    return _EULER_GAMMA + torch.log(torch.abs(x)) + acc


def randn_like(x, generator=None):
    """Standard normal noise of x's shape, dtype and device; complex noise
    draws the real part, then the imaginary part. The draws are float32,
    cast to x's precision, so that a float64 run from the same generator
    state gets the noise of the float32 run (its reference)."""
    def draw():
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=torch.float32)

    if x.is_complex():
        real, imag = draw(), draw()
        return torch.complex(real, imag).to(x.dtype)
    return draw().to(x.dtype)


def _tensor(t, like):
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


class _BaseSDE:
    """Interface: s (scaling), sigma (noise), f (drift), g (diffusion)."""

    def probability_flow(self, x, y, score, t):
        return self.f(x, y, t) - 0.5 * self.g(t) ** 2 * score

    def reverse_step(self, x, y, score, t, dt, generator=None):
        noise = self.g(t) * math.sqrt(-dt) * randn_like(x, generator)
        return (self.f(x, y, t) - self.g(t) ** 2 * score) * dt + noise

    def prior(self, y, generator=None):
        t = _tensor(1.0, y)
        sigma = self.s(t) * self.sigma(t)
        return y + sigma * randn_like(y, generator)

    def s(self, t):
        raise NotImplementedError

    def sigma(self, t):
        raise NotImplementedError

    def f(self, x, y, t):
        raise NotImplementedError

    def g(self, t):
        raise NotImplementedError

    def sigma_inv(self, sigma):
        raise NotImplementedError


class _BaseOUVE(_BaseSDE):
    """Ornstein-Uhlenbeck drift toward y and variance-exploding noise."""

    def __init__(self, stiffness, sigma_min, sigma_max, **kwargs):
        self.stiffness = stiffness
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self._ratio = sigma_max / sigma_min
        self._log_ratio = math.log(self._ratio)

    def s(self, t):
        return torch.exp(-self.stiffness * t)

    def f(self, x, y, t):
        return self.stiffness * (y - x)


@SDERegistry.register('richter-ouve')
class RichterOUVESDE(_BaseOUVE):
    """OUVE as in Welker/Richter et al. (INTERSPEECH 2022)."""

    def sigma(self, t):
        return self.sigma_min * torch.sqrt(
            ((self._ratio ** t / self.s(t)) ** 2 - 1)
            / (1 + self.stiffness / self._log_ratio))

    def g(self, t):
        return self.sigma_min * self._ratio ** t \
            * math.sqrt(2 * self._log_ratio)

    def sigma_inv(self, sigma):
        return 0.5 * torch.log(
            1 + (1 + self.stiffness / self._log_ratio)
            * (sigma / self.sigma_min) ** 2
        ) / (self.stiffness + self._log_ratio)


@SDERegistry.register('brever-ouve')
class BreverOUVESDE(_BaseOUVE):

    def sigma(self, t):
        return self.sigma_min * torch.sqrt(self._ratio ** (2 * t) - 1)

    def g(self, t):
        return self.s(t) * self.sigma_min * self._ratio ** t \
            * math.sqrt(2 * self._log_ratio)

    def sigma_inv(self, sigma):
        return 0.5 * torch.log((sigma / self.sigma_min) ** 2 + 1) \
            / self._log_ratio


class _BaseVP(_BaseSDE):
    """Variance-preserving style with OU stiffness."""

    def s(self, t):
        return torch.exp(-self.stiffness * t) \
            / torch.sqrt(1 + self.sigma(t) ** 2)

    def f(self, x, y, t):
        return (self.stiffness + 0.5 * self.beta(t)) * (y - x)

    def g(self, t):
        return torch.exp(-self.stiffness * t) * torch.sqrt(self.beta(t))


@SDERegistry.register('brever-ouvp')
class BreverOUVPSDE(_BaseVP):

    def __init__(self, stiffness, beta_min, beta_max, **kwargs):
        self.stiffness = stiffness
        self.beta_min = beta_min
        self.beta_max = beta_max
        self._beta_d = beta_max - beta_min

    def beta(self, t):
        return self.beta_min + self._beta_d * t

    def sigma(self, t):
        return torch.sqrt(
            torch.exp(0.5 * self._beta_d * t ** 2 + self.beta_min * t) - 1)

    def sigma_inv(self, sigma):
        return (torch.sqrt(self.beta_min ** 2 + 2 * self._beta_d
                           * torch.log(sigma ** 2 + 1))
                - self.beta_min) / self._beta_d


@SDERegistry.register('brever-oucosine')
class BreverOUCosineSDE(_BaseVP):
    """Shifted-cosine noise schedule with clamped beta."""

    def __init__(self, stiffness, lambda_min, lambda_max, shift, beta_clamp,
                 **kwargs):
        self.stiffness = stiffness
        self.shift = shift
        self.lambda_min = lambda_min + shift
        self.lambda_max = lambda_max + shift
        self.t_min = self._lambda_inv_float(self.lambda_min)
        self.t_max = self._lambda_inv_float(self.lambda_max)
        self.t_d = self.t_min - self.t_max
        self.beta_clamp = beta_clamp

    def _lambda_inv_float(self, lambda_):
        return 2 / math.pi * math.atan(math.exp((-lambda_ + self.shift) / 2))

    def lambda_(self, t):
        return -2 * torch.log(torch.tan(math.pi * t / 2)) + self.shift

    def lambda_inv(self, lambda_):
        return 2 / math.pi * torch.arctan(
            torch.exp((-lambda_ + self.shift) / 2))

    def lambda_tilde(self, t):
        return self.lambda_(self.t_max + self.t_d * t)

    def lambda_tilde_inv(self, lambda_):
        return (self.lambda_inv(lambda_) - self.t_max) / self.t_d

    def beta(self, t):
        angle = math.pi * (self.t_max + self.t_d * t) / 2
        raw = (math.pi * self.t_d / torch.cos(angle) ** 2 * torch.tan(angle)
               / (math.exp(self.shift) + torch.tan(angle) ** 2))
        return torch.clamp(raw, max=self.beta_clamp)

    def sigma(self, t):
        return torch.exp(-self.lambda_tilde(t) / 2)

    def sigma_inv(self, sigma):
        return self.lambda_tilde_inv(-2 * torch.log(sigma))


class _BaseBB(_BaseSDE):
    """Brownian-bridge family: the drift pulls linearly toward y."""

    def clamp(self, t):
        return t * self.t_max

    def s(self, t):
        return 1 - self.clamp(t)

    def f(self, x, y, t):
        return (y - x) / (1 - self.clamp(t))


@SDERegistry.register('bbed')
class BBEDSDE(_BaseBB):
    """Brownian bridge with exponential diffusion (Lay et al. 2023)."""

    def __init__(self, scaling=0.1, k=10.0, **kwargs):
        self.scaling = scaling
        self.t_max = 0.999
        self.k = k
        self._k2 = k ** 2
        self._logk2 = 2 * math.log(k)

    def g(self, t):
        return self.scaling * self.k ** self.clamp(t)

    def sigma(self, t):
        t = self.clamp(t)
        return self.scaling * torch.sqrt(
            self._k2 * self._logk2 * (
                expi((t - 1) * self._logk2)
                - expi(_tensor(-self._logk2, t)))
            - self._k2 ** t / (t - 1) - 1)


@SDERegistry.register('bbcd')
class BBCDSDE(_BaseBB):

    def __init__(self, scaling=0.1, **kwargs):
        self.scaling = scaling
        self.t_max = 0.999

    def g(self, t):
        return self.scaling * torch.ones_like(t)

    def sigma(self, t):
        t = self.clamp(t)
        return self.scaling * torch.sqrt(t / (1 - t))

    def sigma_inv(self, sigma):
        return sigma ** 2 / (self.scaling ** 2 + sigma ** 2) / self.t_max


@SDERegistry.register('bbls')
class BBLSSDE(_BaseBB):

    def __init__(self, scaling=0.1, **kwargs):
        self.scaling = scaling
        self.t_max = 0.999

    def g(self, t):
        t = self.clamp(t)
        return self.scaling * (1 - t) * torch.sqrt(2 * t)

    def sigma(self, t):
        return self.scaling * self.clamp(t)

    def sigma_inv(self, sigma):
        return sigma / (self.scaling * self.t_max)
