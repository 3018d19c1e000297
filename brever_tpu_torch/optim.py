"""The optimizer of the port's trainer: global-norm clipping and Adam, as
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``
computes them in the JAX package, on one flat float32 vector.

The trainer keeps every parameter of a model as a view into one flat
buffer (:func:`flatten_parameters`), so a step is a handful of
elementwise launches over that buffer instead of a few per parameter.
"""

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


class Adam:
    """``optax.adam`` on a flat vector: ``step`` updates the parameters
    in place. State: ``count`` (int32), ``mu`` and ``nu``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = self.mu = self.nu = None

    def init(self, params):
        self.count = torch.zeros((), dtype=torch.int32, device=params.device)
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)

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
        params.add_(mu_hat / (nu_hat.sqrt() + self.eps) * -self.learning_rate)

    def state_dict(self):
        return {'count': self.count, 'mu': self.mu, 'nu': self.nu}

    def load_state_dict(self, state):
        self.count.copy_(torch.as_tensor(state['count']))
        self.mu.copy_(torch.as_tensor(state['mu']))
        self.nu.copy_(torch.as_tensor(state['nu']))
