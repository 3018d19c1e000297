"""Functional forms of the shared layers, channels-last ``(batch, time,
channels)``: used by the modules of ``models/common.py`` and by the plain
versions of the kernels."""

import torch


def prelu(x, alpha):
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def gln_stats(x, eps=1e-8):
    """Global-norm statistics over every axis but the batch, at least in
    f32 and with a two-pass variance: ``(mean, 1/sqrt(var + eps))``, each
    shaped to broadcast against x."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(1, x.ndim))
    mean = x32.mean(dim=axes, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=axes, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def global_layer_norm(x, scale, bias, eps=1e-8):
    """Normalize over every axis but the batch (:func:`gln_stats`);
    per-channel affine on the last axis."""
    mean, rstd = gln_stats(x, eps)
    return ((x - mean) * rstd * scale + bias).to(x.dtype)


def depthwise_conv1d(x, weight, bias, dilation, padding):
    """Depthwise conv along time as ``k`` shifted multiply-adds.

    weight: (k, channels), cast to x's dtype as flax's module casts its
    kernel; padding: the (lo, hi) zeros added to the time axis."""
    weight = weight.to(x.dtype)
    k = weight.shape[0]
    lo, hi = padding
    pad = torch.nn.functional.pad(x, (0, 0, lo, hi))
    t_out = x.shape[1] + lo + hi - (k - 1) * dilation
    out = pad[:, :t_out] * weight[0]
    for i in range(1, k):
        out = out + pad[:, i * dilation:i * dilation + t_out] * weight[i]
    return out + bias.to(out.dtype)
