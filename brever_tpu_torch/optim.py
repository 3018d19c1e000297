"""The optimizer of the port's trainer: global-norm clipping and Adam, as
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``
computes them in the JAX package, on one flat float32 vector; the learning
rate a constant or a schedule of the update count
(:func:`cosine_onecycle_schedule`, optax's), as ``optax.adam(schedule)``.

The trainer keeps every parameter of a model as a view into one flat
buffer (:func:`flatten_parameters`), so a step is a handful of
elementwise launches over that buffer instead of a few per parameter.
"""

import numpy as np
import torch


def flatten_parameters(module):
    """Move every parameter of ``module`` into one contiguous buffer and
    make each parameter a view of its slice; returns the buffer. Writing
    into a parameter (``load_state_dict``, ``copy_``) writes into the
    buffer."""
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        n = p.numel()
        p.data = flat[offset:offset + n].view_as(p)
        offset += n
    return flat


def clip_by_global_norm(grads, max_norm):
    """``optax.clip_by_global_norm``: ``g / norm * max_norm`` where the
    global norm reaches ``max_norm``, ``g`` below it (no 1e-6 is added,
    unlike ``torch.nn.utils.clip_grad_norm_``). No host sync."""
    norm = torch.linalg.vector_norm(grads)
    return torch.where(norm < max_norm, grads, grads / norm * max_norm)


def cosine_onecycle_schedule(transition_steps, peak_value, pct_start=0.3,
                             div_factor=25.0, final_div_factor=1e4):
    """``optax.cosine_onecycle_schedule`` (optax 0.2.6): a function of the
    update count, the cosine ``piecewise_interpolate_schedule`` from
    ``peak / div_factor`` up to ``peak`` at ``int(pct_start N)`` and down to
    ``peak / (div_factor final_div_factor)`` at ``N``, evaluated in float32
    as optax evaluates it; returns a Python float."""
    if transition_steps <= 0:
        raise ValueError('a onecycle schedule needs transition_steps > 0')
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)
    # optax halves the float64 differences before they meet float32
    end = values[1:].astype(np.float32)
    half = ((values[:-1] - values[1:]) / 2.0).astype(np.float32)
    last = np.float32(values[-1])

    def schedule(count):
        count = np.int32(count)
        inside = ((bounds[:-1] <= count)
                  & (count < bounds[1:])).astype(np.float32)
        with np.errstate(divide='ignore', invalid='ignore'):
            pct = (count - bounds[:-1]).astype(np.float32) / sizes
            interp = end + half * (np.cos(np.float32(np.pi) * pct)
                                   + np.float32(1.0))
        value = inside @ interp + np.float32(bounds[-1] <= count) * last
        return float(np.float32(value))

    return schedule


class Adam:
    """``optax.adam`` on a flat vector: ``step`` updates the parameters
    in place. State: ``count`` (int32), ``mu`` and ``nu``; with a schedule
    for ``learning_rate`` (a function of the update count), also the
    schedule's own ``schedule_count``, as ``optax.scale_by_schedule``
    keeps it: the rate of an update is ``schedule(schedule_count)``, before
    the count moves on."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = self.mu = self.nu = None
        self.schedule_count = 0

    @property
    def scheduled(self):
        return callable(self.learning_rate)

    def current_rate(self):
        """The learning rate of the next update."""
        if self.scheduled:
            return self.learning_rate(self.schedule_count)
        return self.learning_rate

    def init(self, params):
        self.count = torch.zeros((), dtype=torch.int32, device=params.device)
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.schedule_count = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.mu.mul_(self.b1).add_(grads, alpha=1 - self.b1)
        self.nu.mul_(self.b2).add_(grads * grads, alpha=1 - self.b2)
        self.count += 1
        count = self.count.float()
        b1 = torch.tensor(self.b1, dtype=params.dtype, device=params.device)
        b2 = torch.tensor(self.b2, dtype=params.dtype, device=params.device)
        mu_hat = self.mu / (1 - b1 ** count)
        nu_hat = self.nu / (1 - b2 ** count)
        params.add_(mu_hat / (nu_hat.sqrt() + self.eps)
                    * -self.current_rate())
        if self.scheduled:
            self.schedule_count += 1

    def state_dict(self):
        state = {'count': self.count, 'mu': self.mu, 'nu': self.nu}
        if self.scheduled:
            state['schedule_count'] = self.schedule_count
        return state

    def load_state_dict(self, state):
        self.count.copy_(torch.as_tensor(state['count']))
        self.mu.copy_(torch.as_tensor(state['mu']))
        self.nu.copy_(torch.as_tensor(state['nu']))
        if self.scheduled:
            self.schedule_count = int(state['schedule_count'])
