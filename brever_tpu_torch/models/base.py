"""Model family base class and registry (counterpart of
``brever_tpu/models/base.py``).

A family is an ``nn.Module`` that implements ``transform`` (raw sources
to model inputs) and ``_enhance`` (batched enhancement); ``enhance``
wraps it for batched and unbatched input. The device is explicit: every
family takes ``device=`` and builds its parameters there.
"""

import torch
from torch import nn

from ..registry import Registry

ModelRegistry = Registry('model')


def count_params(module):
    """Number of trainable parameters of a module."""
    return sum(p.numel() for p in module.parameters())


class BreverBaseModel(nn.Module):
    """Base for all model families."""

    @property
    def device(self):
        return next(self.parameters()).device

    def transform(self, sources):
        """Pre-processing from raw sources ``(..., channels, samples)``
        to model inputs."""
        return sources

    def _enhance(self, x):
        """Batched enhancement: ``(B, 2, n) -> (B, n)`` or
        ``(B, S, n)``."""
        raise NotImplementedError

    @torch.inference_mode()
    def enhance(self, x):
        """Unbatched ``(2, n)`` or batched ``(B, 2, n)`` enhancement of
        an array or tensor; returns a float32 tensor on the model's
        device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        unbatched = x.ndim == 2
        if unbatched:
            x = x[None]
        elif x.ndim != 3:
            raise ValueError(
                f'input must be 2 or 3 dimensional, got {x.ndim}')
        out = self._enhance(x)
        return out[0] if unbatched else out
