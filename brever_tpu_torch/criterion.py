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

from .ops.stft import STFT
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
    """Zero the padded tail of both tensors (real or complex)."""
    mask = length_mask(x.shape, lengths, x.real.dtype)
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
    """Length-normalised MSE with an optional per-sample weight. For
    complex tensors ``|x - y|^2`` is ``real^2 + imag^2``: ``abs`` has no
    derivative at 0, where the masked tail of every padded item is."""
    if x.shape != y.shape or x.ndim < 2:
        raise ValueError(f'mse takes two equal (B, ..., L) tensors, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    x, y = apply_mask(x, y, lengths)
    diff = x - y
    square = diff.real ** 2 + diff.imag ** 2 if diff.is_complex() \
        else diff.abs() ** 2
    loss = square.sum(dim=-1)
    shape = (-1,) + (1,) * (x.ndim - 2)
    loss = loss / lengths.clamp_min(1).reshape(shape).to(loss.dtype)
    if weight is not None:
        loss = loss * weight.reshape(shape)
    return loss.mean(dim=tuple(range(1, x.ndim - 1))) if x.ndim > 2 \
        else loss


@CriterionRegistry.register('multiresyu')
class MultiResYuLoss:
    """Multi-resolution STFT magnitude L1 + time-domain L1 loss (the
    ESPnet-SE L3DAS22 loss), with optional scale invariance: boxcar
    windows, ``normalized=False``, hop ``f // 2`` by default; the sum is
    divided by ``max(lengths, 1)``."""

    def __init__(self, frame_lengths=(512,), hop_lengths=None,
                 time_domain_weight=0.5, spectral_weight=0.5,
                 scale_invariant=False):
        if hop_lengths is None:
            hop_lengths = [f // 2 for f in frame_lengths]
        self.stfts = [
            STFT(frame_length=f, hop_length=h, window=None, normalized=False)
            for f, h in zip(frame_lengths, hop_lengths)
        ]
        self.time_domain_weight = time_domain_weight
        self.spectral_weight = spectral_weight
        self.scale_invariant = scale_invariant

    def __call__(self, x, y, lengths):
        if x.shape != y.shape:
            raise ValueError(f'multiresyu takes two equal tensors, got '
                             f'{tuple(x.shape)} and {tuple(y.shape)}')
        x, y = apply_mask(x, y, lengths)
        if self.scale_invariant:
            scaling = (x * y).sum(dim=-1, keepdim=True) \
                / ((x ** 2).sum(dim=-1, keepdim=True) + eps)
        else:
            scaling = 1.0
        out = self.time_domain_weight * (scaling * x - y).abs().sum(dim=-1)
        for stft in self.stfts:
            y_mag = stft(y).abs()
            x_mag = stft(scaling * x).abs()
            spectral = (x_mag - y_mag).abs().sum(dim=(-2, -1))
            out = out + self.spectral_weight * spectral / len(self.stfts)
        shape = (-1,) + (1,) * (x.ndim - 2)
        out = out / lengths.clamp_min(1).reshape(shape).to(out.dtype)
        return out.mean(dim=tuple(range(1, x.ndim - 1))) if x.ndim > 2 \
            else out
