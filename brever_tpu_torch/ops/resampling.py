"""2x FIR down- and upsampling of ``(B, C, H, W)`` tensors (counterpart of
``brever_tpu/ops/resampling.py``, Karras EDM style), for the diffusion
U-Net.

Both are depthwise convolutions (``groups=C``) with the same separable FIR
kernel on every channel:

* down: ``F.conv2d`` with stride 2 and, per spatial axis, the padding
  ``ceil(K/2) - 1`` (even size) or ``ceil((K+1)/2) - 1`` (odd size);
* up: the kernel scaled by 4 through ``F.conv_transpose2d`` with stride 2,
  padding ``p`` and output padding ``op``, which is the 2x-dilated
  convolution with the asymmetric padding ``(K-1-p, K-1-p+op)`` of the JAX
  package (the FIR kernel is symmetric, so no flip is needed).

The ``Resampler`` pushes each down's ``(padding, output_padding)`` on a
stack and pops it at the matching up, so odd sizes (501 -> 251 -> 126 ->
63 -> 32 frames) come back exactly. Only the JAX package's ``fold``/``group``
arithmetic is ported (one mode); its ``shift`` mode is not.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def _fir_kernel_2d(fir_kernel):
    k = np.asarray(fir_kernel, dtype=np.float32)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _depthwise(kernel2d, x):
    """The 2-D kernel as a ``(C, 1, K, K)`` depthwise weight of x's dtype
    and device."""
    weight = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    return weight.expand(x.shape[1], 1, *kernel2d.shape)


def downsample_2d(x, fir_kernel, return_padding=False):
    """Depthwise FIR low-pass and 2x decimation over the last two axes;
    with ``return_padding`` also the ``(padding, output_padding)`` pair that
    makes :func:`upsample_2d` restore the input's size."""
    kernel2d = _fir_kernel_2d(fir_kernel)
    ksize = kernel2d.shape[-1]
    dims = tuple(x.shape[-2:])
    padding = tuple(math.ceil(ksize / 2) - 1 if dim % 2 == 0
                    else math.ceil((ksize + 1) / 2) - 1 for dim in dims)
    out = F.conv2d(x, _depthwise(kernel2d, x), stride=2, padding=padding,
                   groups=x.shape[1])
    if return_padding:
        output_padding = tuple(0 if (dim + 2 * p - ksize) % 2 == 0 else 1
                               for dim, p in zip(dims, padding))
        return out, (padding, output_padding)
    return out


def upsample_2d(x, fir_kernel, padding=None):
    """2x zero-stuffed upsampling and depthwise FIR interpolation;
    ``padding`` is a ``(padding, output_padding)`` pair from
    ``downsample_2d(..., return_padding=True)``."""
    kernel2d = _fir_kernel_2d(fir_kernel) * 4
    ksize = kernel2d.shape[-1]
    if padding is None:
        pad, out_pad = ((ksize - 1) // 2,) * 2, (0, 0)
    else:
        pad, out_pad = padding
    return F.conv_transpose2d(x, _depthwise(kernel2d, x), stride=2,
                              padding=tuple(pad),
                              output_padding=tuple(out_pad),
                              groups=x.shape[1])


class Resampler:
    """Pairs downs with ups through a padding stack (one per forward pass
    of the U-Net)."""

    def __init__(self, fir_kernel):
        self.fir_kernel = tuple(fir_kernel)
        self._paddings = []

    def down(self, x):
        out, padding = downsample_2d(x, self.fir_kernel, return_padding=True)
        self._paddings.append(padding)
        return out

    def up(self, x):
        padding = self._paddings.pop() if self._paddings else None
        return upsample_2d(x, self.fir_kernel, padding)

    def __call__(self, x, up_or_down):
        if up_or_down == 'down':
            return self.down(x)
        if up_or_down == 'up':
            return self.up(x)
        raise ValueError(
            f'up_or_down must be up or down, got {up_or_down}')
