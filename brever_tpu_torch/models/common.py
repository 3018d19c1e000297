"""Shared modules for the model zoo (counterpart of
``brever_tpu/models/common.py``).

Channels-last convention, as in the JAX package: model internals keep
tensors as ``(batch, time, channels)``. The math lives in
``ops/functional.py``, which the plain versions of the kernels share. The
batch norms (DCCRN's) take channels first, ``(batch, channels, ...)``, the
layout of the port's 2-D convolutions, and keep their running statistics
as buffers, the JAX package's ``batch_stats`` collection. MANNER's
:class:`BatchNormAct` (flash-BN) runs its train-mode statistics through
``ops/batchnorm.py``: the CUDA kernels K7-BN and K8-BN on the card.

bf16 (the trainer's amp casts the parameters): as flax's modules, PReLU
casts ``alpha`` to the activation's dtype, the gLN takes float32
statistics and casts its output back to the input's dtype, and the
depthwise conv multiplies and adds in the activation's dtype with its
kernel and bias cast to it. MANNER's :class:`BatchNormAct` takes a
bfloat16 input through K7-BN/K8-BN's bf16 route. DCCRN's :class:`BatchNorm`
takes flax's batch statistics in float32 from a bfloat16 input, normalises
in float32 and casts back (the JAX package's ``batch_norm``); its running
``mean``/``var`` stay float32 and are only ever written from float32
statistics.
:class:`ComplexBatchNorm` whitens in float32 and casts back, as the JAX
package's does.
"""

import torch
from torch import nn

from ..ops.functional import depthwise_conv1d, global_layer_norm, prelu
from ..ops.groupnorm import _act
# looked up at call time: a run may put batch_norm_act_plain in its place
from ..ops.batchnorm import batch_norm_act


def stats_input(x):
    """``x`` as flax's norms (and the JAX package's, which follow them) take
    their statistics and affine: float32 for a bfloat16 input, the input
    itself otherwise; the norm casts its output back to ``x``'s dtype."""
    return x.float() if x.dtype == torch.bfloat16 else x


class PReLU(nn.Module):
    """Parametric ReLU with a single learned slope."""

    def __init__(self, init=0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return prelu(x, self.alpha)


class GlobalLayerNorm(nn.Module):
    """``GroupNorm(num_groups=1)`` over time and channels per sample:
    eps 1e-8, f32 statistics, two-pass variance."""

    def __init__(self, channels, eps=1e-8):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return global_layer_norm(x, self.scale, self.bias, self.eps)


class DepthwiseConv1D(nn.Module):
    """Dilated depthwise conv as shifted multiply-adds, weight
    ``(k, channels)``."""

    def __init__(self, channels, kernel_size, dilation=1, padding=(0, 0)):
        super().__init__()
        self.dilation = dilation
        self.padding = padding
        self.weight = nn.Parameter(
            torch.randn(kernel_size, channels) / kernel_size ** 0.5)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return depthwise_conv1d(x, self.weight, self.bias, self.dilation,
                                self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over a channels-first tensor: in train mode the
    batch statistics over every axis but the channels, the variance as
    ``E[x^2] - E[x]^2`` clipped at 0 (biased), and the running update
    ``ra = momentum ra + (1 - momentum) stat`` of ``mean`` and ``var`` (the
    variance kept biased, where ``F.batch_norm`` keeps it unbiased, and
    flax's ``momentum``, where torch's would be ``1 - momentum``); in eval
    mode the running statistics. ``y = (x - mean) rsqrt(var + eps) scale +
    bias``. A bfloat16 input: statistics and ``y`` in float32 (flax's
    ``_compute_stats`` and ``_normalize``), ``y`` cast back to bfloat16."""

    def __init__(self, channels, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def forward(self, x):
        xs = stats_input(x)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = xs.mean(dim=dims)
            var = ((xs * xs).mean(dim=dims) - mean * mean).clamp_min(0)
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        return self.affine(xs, mean, var).to(x.dtype)

    def update_running(self, mean, var):
        """flax's running update from a batch's statistics."""
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean
                            + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var
                           + (1 - self.momentum) * var)

    def affine(self, x, mean, var):
        """``(x - mean) rsqrt(var + eps) scale + bias`` over the channels."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


class BatchNormAct(BatchNorm):
    """BatchNorm fused with its activation (``none``, ``relu`` or ``silu``),
    the JAX package's ``batch_norm_act``, over a channels-first contiguous
    tensor: :class:`BatchNorm`'s parameters, buffers, running update and
    eval mode, with the activation after. In train mode the batch
    statistics over every axis but the channels, in float32 in the
    fast-variance form ``E[x^2] - E[x]^2`` (not clipped at 0, as the JAX
    package's XLA branch has it), go through ``ops.batchnorm``'s
    ``batch_norm_act`` (K7-BN and K8-BN on CUDA), and the running update
    takes the detached statistics; in eval mode the running statistics'
    affine in plain torch, as the JAX package never takes the kernel in
    eval. A bfloat16 input (amp): train mode takes the kernels' bf16 route
    with the affine cast to the input's dtype, as the JAX package's
    ``batch_norm_act`` casts it before its kernel, and the statistics and
    running buffers stay float32; eval mode normalises in float32 from the
    running statistics, casts to bfloat16 and applies the activation there,
    as the JAX package's XLA branch does."""

    def __init__(self, channels, act='none', momentum=0.99, eps=1e-5):
        super().__init__(channels, momentum, eps)
        self.act = act

    def forward(self, x):
        if self.training:
            y, mean, var = batch_norm_act(x, self.scale.to(x.dtype),
                                          self.bias.to(x.dtype), self.eps,
                                          self.act)
            self.update_running(mean, var)
            return y
        return _act(self.affine(stats_input(x), self.mean, self.var)
                    .to(x.dtype), self.act)


class ComplexBatchNorm(nn.Module):
    """Complex batch norm by 2 x 2 covariance whitening (counterpart of
    ``ComplexBatchNorm`` in ``brever_tpu/models/common.py``) over a
    channels-first tensor ``(batch, 2 C, ...)``, the real parts in the first
    C channels: statistics per complex channel over the batch and spatial
    axes, running ``mean (2, C)`` and ``cov (2, 2, C)`` updated as ``r +=
    momentum (stat - r)``, an affine of ``weight (3, C)`` (W_rr, W_ri, W_ii,
    the identity at init) and ``bias (2, C)``. A bfloat16 input is whitened
    in float32 and the output cast back, as the JAX package's is."""

    def __init__(self, channels, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(
            torch.tensor([[1.0], [0.0], [1.0]]).repeat(1, channels))
        self.bias = nn.Parameter(torch.zeros(2, channels))
        self.register_buffer('mean', torch.zeros(2, channels))
        self.register_buffer('cov', torch.eye(2)[:, :, None]
                             .repeat(1, 1, channels))

    def forward(self, x):
        in_dtype = x.dtype
        x = stats_input(x)
        n = x.shape[1] // 2
        z = torch.stack([x[:, :n], x[:, n:]])           # (2, B, C, ...)
        dims = (1,) + tuple(range(3, z.ndim))
        shape = (2, 1, n) + (1,) * (z.ndim - 3)
        if self.training:
            mean = z.mean(dim=dims)
            centred = z - mean.reshape(shape)
            var = (centred ** 2).mean(dim=dims) + self.eps
            cov_uv = (centred[0] * centred[1]).mean(
                dim=tuple(d - 1 for d in dims))
            cov = torch.stack([var[0], cov_uv, cov_uv, var[1]]) \
                .reshape(2, 2, n)
            with torch.no_grad():
                self.mean.copy_(self.mean + self.momentum
                                * (mean - self.mean))
                self.cov.copy_(self.cov + self.momentum * (cov - self.cov))
        else:
            mean, cov = self.mean, self.cov
            centred = z - mean.reshape(shape)
        # the inverse square root of the 2 x 2 covariance, explicitly
        s = torch.sqrt(cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0])
        t = torch.sqrt(cov[0, 0] + cov[1, 1] + 2 * s)
        denom = t * s
        p = (cov[1, 1] + s) / denom
        q = -cov[0, 1] / denom
        r = -cov[1, 0] / denom
        w = (cov[0, 0] + s) / denom
        per = shape[1:]

        def bc(v):
            return v.reshape(per)

        white_r = centred[0] * bc(p) + centred[1] * bc(r)
        white_i = centred[0] * bc(q) + centred[1] * bc(w)
        out_r = white_r * bc(self.weight[0]) + white_i * bc(self.weight[1]) \
            + bc(self.bias[0])
        out_i = white_r * bc(self.weight[1]) + white_i * bc(self.weight[2]) \
            + bc(self.bias[1])
        return torch.cat([out_r, out_i], dim=1).to(in_dtype)
