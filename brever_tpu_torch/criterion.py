"""Training criteria (counterpart of ``brever_tpu/criterion.py``).

Every criterion takes ``(x, y, lengths)`` with zero-padded batches and
returns a ``(batch,)`` loss; padding is neutralised by masking before and
after any mean subtraction, so a padded batch gives each item's loss as
if it stood alone.
"""

import inspect as _inspect
from itertools import permutations

import numpy as np
import torch

from .registry import Registry

eps = float(np.finfo(np.float32).eps)

CriterionRegistry = Registry('criterion')


def init_criterion(name, **kwargs):
    criterion = CriterionRegistry.get(name)
    if _inspect.isclass(criterion):
        criterion = criterion(**kwargs)
    return criterion


def length_mask(shape, lengths, dtype=torch.float32):
    """Mask of ones up to ``lengths`` along the last axis, zeros after."""
    idx = torch.arange(shape[-1], device=lengths.device)
    mask = idx[None, :] < lengths[:, None]
    mask = mask.reshape(shape[0], *([1] * (len(shape) - 2)), shape[-1])
    return mask.expand(shape).to(dtype)


def apply_mask(x, y, lengths):
    """Zero the padded tail of both tensors."""
    mask = length_mask(x.shape, lengths, x.dtype)
    return x * mask, y * mask


@CriterionRegistry.register('sisnr')
def sisnr(x, y, lengths):
    """Scale-invariant SNR with permutation-invariant training.

    ``x``/``y``: ``(batch, sources, length)``; returns the ``(batch,)``
    negated SI-SNR averaged over the best source permutation."""
    if x.shape != y.shape or x.ndim != 3:
        raise ValueError(f'sisnr takes two equal (B, S, L) tensors, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    x, y = apply_mask(x, y, lengths)
    denom = lengths.clamp_min(1).reshape(-1, 1, 1).to(x.dtype)
    x = x - x.sum(dim=2, keepdim=True) / denom
    y = y - y.sum(dim=2, keepdim=True) / denom
    x, y = apply_mask(x, y, lengths)

    s_hat = x[:, None, :, :]   # (B, 1, S, L)
    s = y[:, :, None, :]       # (B, S, 1, L)
    s_target = (s_hat * s).sum(dim=3, keepdim=True) * s \
        / (s ** 2).sum(dim=3, keepdim=True)
    e_noise = s_hat - s_target
    ratio = (s_target ** 2).sum(dim=3) / ((e_noise ** 2).sum(dim=3) + eps)
    si_snr = 10 * torch.log10(ratio + eps)  # (B, S, S)

    n_sources = x.shape[1]
    perms = torch.tensor(list(permutations(range(n_sources))),
                         device=x.device)  # (P, S)
    rows = torch.arange(n_sources, device=x.device)[None, :]
    gathered = si_snr[:, rows, perms]      # (B, P, S)
    best = gathered.sum(dim=-1).max(dim=-1).values / n_sources
    return -best


@CriterionRegistry.register('snr')
def snr(x, y, lengths):
    """Element-wise SNR (no PIT); ``(batch, ..., length)`` ->
    ``(batch,)``."""
    if x.shape != y.shape or x.ndim < 2:
        raise ValueError(f'snr takes two equal (B, ..., L) tensors, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    x, y = apply_mask(x, y, lengths)
    ratio = (y ** 2).sum(dim=-1) / (((y - x) ** 2).sum(dim=-1) + eps)
    out = -10 * torch.log10(ratio + eps)
    return out.mean(dim=tuple(range(1, x.ndim - 1))) if x.ndim > 2 else out


@CriterionRegistry.register('mse')
def mse(x, y, lengths, weight=None):
    """Length-normalised MSE with an optional per-sample weight."""
    if x.shape != y.shape or x.ndim < 2:
        raise ValueError(f'mse takes two equal (B, ..., L) tensors, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    x, y = apply_mask(x, y, lengths)
    loss = ((x - y).abs() ** 2).sum(dim=-1)
    shape = (-1,) + (1,) * (x.ndim - 2)
    loss = loss / lengths.clamp_min(1).reshape(shape).to(loss.dtype)
    if weight is not None:
        loss = loss * weight.reshape(shape)
    return loss.mean(dim=tuple(range(1, x.ndim - 1))) if x.ndim > 2 \
        else loss


@CriterionRegistry.register('multiresyu')
class MultiResYuLoss:
    """Multi-resolution STFT loss: needs the port of the STFT, which the
    port does not have yet (ROADMAP.md, Queue 1). A model configured
    with it still loads and serves; computing the loss raises."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, x, y, lengths):
        raise NotImplementedError(
            'criterion multiresyu needs the STFT port (ROADMAP.md, Queue 1)')
