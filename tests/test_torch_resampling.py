"""The port's FIR resampling (brever_tpu_torch.ops.resampling) against the
JAX package's (brever_tpu.ops.resampling, in the channels-last layout the
diffusion U-Net uses), in float32 on the CPU: down, up and the
``Resampler``'s padding stack at odd and even sizes, within 1e-6 (one
depthwise convolution of a 4 x 4 kernel whose taps are exact in binary)."""

import numpy as np
import pytest
import torch

from brever_tpu.ops import resampling as jax_resampling
from brever_tpu_torch.ops import resampling

FIR = (1, 3, 3, 1)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nhwc(x):
    return np.moveaxis(x, 1, -1)


def _nchw(y):
    return np.moveaxis(np.asarray(y), -1, 1)


@pytest.mark.parametrize('size', [(16, 8), (501, 256), (7, 9), (63, 32)],
                         ids=['even', 'frames501', 'odd', 'mixed'])
@pytest.mark.parametrize('fir', [FIR, (1, 1)], ids=['k4', 'k2'])
def test_down_and_up_match_jax(size, fir):
    x = _x((2, 3) + size)
    ref, ref_pad = jax_resampling.downsample_2d(
        _nhwc(x), fir, return_padding=True, data_format='NHWC')
    got, pad = resampling.downsample_2d(torch.from_numpy(x), fir,
                                        return_padding=True)
    assert pad == ref_pad
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=1e-6, rtol=0)
    up_ref = jax_resampling.upsample_2d(np.asarray(ref), fir, ref_pad,
                                        data_format='NHWC')
    up = resampling.upsample_2d(got, fir, pad)
    assert tuple(up.shape) == x.shape
    np.testing.assert_allclose(up.numpy(), _nchw(up_ref), atol=1e-6, rtol=0)
    plain_ref = jax_resampling.upsample_2d(_nhwc(x), fir, None,
                                           data_format='NHWC')
    plain = resampling.upsample_2d(torch.from_numpy(x), fir)
    np.testing.assert_allclose(plain.numpy(), _nchw(plain_ref), atol=1e-6,
                               rtol=0)


def test_resampler_stack_restores_odd_sizes():
    """501 frames down six times (501 -> 251 -> 126 -> 63 -> 32 -> 16 ->
    8) and up again through the stack, as the U-Net's encoder pushes and
    its decoder pops, against the JAX Resampler on the same sequence."""
    x = _x((1, 2, 10, 501), seed=1)
    ref = jax_resampling.Resampler(FIR, buffer_padding=True,
                                   data_format='NHWC')
    port = resampling.Resampler(FIR)
    a, b = _nhwc(x), torch.from_numpy(x)
    frames = [501]
    for _ in range(6):
        a, b = ref.down(a), port(b, 'down')
        frames.append(b.shape[-1])
        np.testing.assert_allclose(b.numpy(), _nchw(a), atol=1e-6, rtol=0)
    assert frames == [501, 251, 126, 63, 32, 16, 8]
    for _ in range(6):
        a, b = ref.up(a), port(b, 'up')
        np.testing.assert_allclose(b.numpy(), _nchw(a), atol=1e-5, rtol=0)
    assert tuple(b.shape) == x.shape
    with pytest.raises(ValueError):
        port(b, 'sideways')
