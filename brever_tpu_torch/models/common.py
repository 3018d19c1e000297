"""Shared modules for the model zoo (counterpart of
``brever_tpu/models/common.py``).

Channels-last convention, as in the JAX package: model internals keep
tensors as ``(batch, time, channels)``. The math lives in
``ops/functional.py``, which the plain versions of the kernels share.
"""

import torch
from torch import nn

from ..ops.functional import depthwise_conv1d, global_layer_norm, prelu


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
