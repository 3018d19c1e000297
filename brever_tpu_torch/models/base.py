"""Model family base class and registry (counterpart of
``brever_tpu/models/base.py``).

A family is an ``nn.Module`` that implements ``transform`` (raw sources
to model inputs), ``_enhance`` (batched enhancement) and, to be trained,
``loss(batch, lengths, generator)`` -> a ``(batch,)`` vector (a family
whose loss draws random numbers, SGMSE+'s, draws them from the trainer's
``torch.Generator``; the others ignore it); ``enhance`` wraps
``_enhance`` for batched and unbatched input. The trainer reads
``optimizer()`` and ``grad_clip``, and calls the hooks
``prepare_optimizer``, ``pre_train``, ``on_validate``, ``extra_state`` and
``load_extra_state``, which do nothing here. The device is explicit:
every family takes ``device=`` and builds its parameters there.
"""

import torch
from torch import nn

from ..registry import Registry

ModelRegistry = Registry('model')


def count_params(module):
    """Number of trainable parameters of a module."""
    return sum(p.numel() for p in module.parameters())


def sample_weighted_mean(per_item, lengths):
    """Mean over real samples only: rows with length 0 pad the batch
    and drop out."""
    if per_item.ndim == 0:
        return per_item
    weights = (lengths > 0).to(per_item.dtype)
    if weights.ndim > 1:
        weights = weights[:, 0]
    return (per_item * weights).sum() / weights.sum().clamp_min(1)


class BreverBaseModel(nn.Module):
    """Base for all model families. A family keeps its constructor's
    keyword arguments in ``hparams`` (without ``device``)."""

    #: gradient clipping max-norm (0 disables)
    grad_clip = 0.0

    @property
    def device(self):
        return next(self.parameters()).device

    def init_parameters(self, seed):
        """Draw every parameter and buffer anew from ``seed``, on the CPU
        generator, so that every device gets the same values."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = type(self)(**self.hparams, device='cpu')
        with torch.no_grad():
            for p, q in zip(self.parameters(), fresh.parameters()):
                p.copy_(q)
            for p, q in zip(self.buffers(), fresh.buffers()):
                p.copy_(q)

    def to_flax(self, state_dict):
        """The JAX package's flax ``params`` tree of a ``state_dict``."""
        raise NotImplementedError

    def from_flax(self, params, aux=None):
        """A ``state_dict`` (numpy or tensors) of a flax ``params`` tree
        and, for a family with buffers, the checkpoint's ``aux``
        collections."""
        raise NotImplementedError

    def flax_aux(self, state_dict):
        """The JAX package's ``aux`` collections (a checkpoint's ``aux``)
        of a ``state_dict``: none here."""
        return {}

    def loss(self, batch, lengths, generator=None):
        """Per-item loss ``(batch,)`` of a padded batch."""
        raise NotImplementedError

    def optimizer(self):
        """The optimizer the family trains with (``optim.Adam``); the
        trainer adds the ``grad_clip`` clipping."""
        raise NotImplementedError

    def prepare_optimizer(self, steps_per_epoch, epochs):
        pass

    def pre_train(self, dataset, dataloader, epochs):
        pass

    def on_validate(self, val_loss):
        """May return a dict of hyperparameter updates; none here."""
        return None

    def extra_state(self):
        """Host-side state to keep in checkpoints (JSON-serialisable)."""
        return {}

    def load_extra_state(self, state):
        pass

    def transform(self, sources):
        """Pre-processing from raw sources ``(..., channels, samples)``
        to model inputs."""
        return sources

    def _enhance(self, x):
        """Batched enhancement: ``(B, 2, n) -> (B, n)`` or
        ``(B, S, n)``."""
        raise NotImplementedError

    @torch.inference_mode()
    def enhance(self, x, **kwargs):
        """Unbatched ``(2, n)`` or batched ``(B, 2, n)`` enhancement of
        an array or tensor; returns a float32 tensor on the model's
        device. Keyword arguments go to ``_enhance``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        unbatched = x.ndim == 2
        if unbatched:
            x = x[None]
        elif x.ndim != 3:
            raise ValueError(
                f'input must be 2 or 3 dimensional, got {x.ndim}')
        out = self._enhance(x, **kwargs)
        return out[0] if unbatched else out
