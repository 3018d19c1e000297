"""The port's TCN block (brever_tpu_torch.ops.tcn_block) against the JAX
package: its plain version against ``tcn_block_reference`` and the
Pallas kernel in interpret mode, on the same numpy inputs, at the JAX
tests' own tolerance (atol 2e-5, rtol 1e-4, tests/test_tcn_fused.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.ops.pallas.tcn_block as tcn
from brever_tpu_torch.ops import build
from brever_tpu_torch.ops import tcn_block as port


def _params(rng, c, h, cs):
    def arr(*s):
        return rng.randn(*s).astype('float32') * 0.1
    quarter = np.asarray([0.25], np.float32)
    return (arr(c, h), arr(h), quarter, arr(h), arr(h), arr(3, h), arr(h),
            quarter, arr(h), arr(h), arr(h, c), arr(c), arr(h, cs), arr(cs))


def _port_params(params):
    """The same parameters for the port: 2-D weights in torch Linear
    layout, (out, in)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p.T) if i in (0, 10, 12)
                                  else p) for i, p in enumerate(params))


def _close(actual, expected):
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('last', [False, True])
@pytest.mark.parametrize('t_total', [512, 520])
@pytest.mark.parametrize('dilation', [1, 4, 64, 250, 600])
def test_plain_matches_jax(dilation, t_total, last):
    """d=250 puts the boundary region across tiles (d ~ tile), d=600 is
    d >= T, where every outer tap reads the zero padding."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, t_total, 128).astype('float32')
    params = _params(rng, 128, 256, 128)
    jparams = tuple(jnp.asarray(p) for p in params)
    ref = tcn.tcn_block_reference(jnp.asarray(x), jparams, dilation, last)
    fused = tcn.tcn_block_fused(jnp.asarray(x), jparams, dilation, last,
                                tile=256, interpret=True)

    port.tcn_block.launches = 0
    res, skip = port.tcn_block(torch.from_numpy(x), _port_params(params),
                               dilation, last)
    assert port.tcn_block.launches == 0   # the CPU takes the plain version
    for ref_res, ref_skip in (ref, fused):
        _close(skip, ref_skip)
        if last:
            assert res is None and ref_res is None
        else:
            _close(res, ref_res)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if os.access('/usr/local/cuda/bin/nvcc', os.X_OK):
        pytest.skip('nvcc is installed')
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / 'out'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build()


def test_wrapper_off_cuda_raises():
    """Only CUDA tensors reach the kernel path: anything else raises
    cleanly there and counts nothing."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 64, 128).astype('float32'))
    params = _port_params(_params(rng, 128, 256, 128))
    port.tcn_block.launches = 0
    with pytest.raises(ValueError, match='no kernel for device meta'):
        port.tcn_block(x.to('meta'), params, 1, False)
    with pytest.raises(ValueError, match='no kernel for device cpu'):
        port._launch(x, params, 1, False)
    assert port.tcn_block.launches == 0


# ---------------------------------------------------------------------------
# The bf16 route (K1-bf16's plain twin): x and the parameters bfloat16, the
# Pallas kernel's rounding points (bf16 matmul operands, float32 sums and
# statistics, the gLN2 affine folded into bf16 output weights, bf16 h2 and
# outputs). Held against ``tcn_block_fused`` at bf16 in interpret mode
# within 2 bf16 ulps elementwise (rtol 2^-7) with an atol of 1e-3 of the
# tensor's largest value (an output near 0 is a cancelling float32 sum,
# whose order moves it by more ulps of its own), tighter than the JAX
# tests' own bf16 bound of 5e-2 (tests/test_tcn_fused.py); and against
# float64 on the same bf16 values: the twin's SNR within 0.1 dB of the
# kernel's.

def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())


def _close_bf16(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3 * np.abs(want).max())


#: the bf16 twins' widths C/H/Cs: 64/96/48, and the float32 route's widths
#: off the 128-grid and off the 8-element grid that the bf16 kernels stage
#: piece by piece (smoke phases 2, 6 and 54)
BF16_WIDTHS = (64, 96, 48)
OFF_GRID_WIDTHS = [(150, 1, (36, 100, 20)), (129, 2, (32, 64, 32)),
                   (150, 128, (36, 102, 20)), (77, 4, (130, 257, 21))]


@pytest.mark.parametrize('last', [False, True])
@pytest.mark.parametrize('t_total,dilation,widths', [
    pytest.param(t, d, BF16_WIDTHS, id=f'{t}-{d}')
    for t, d in [(192, 1), (200, 4), (200, 8), (130, 64), (100, 250)]] + [
    pytest.param(t, d, w, id=f'{t}-{d}-' + 'x'.join(map(str, w)))
    for t, d, w in OFF_GRID_WIDTHS])
def test_bf16_plain_matches_pallas(dilation, t_total, widths, last):
    """T=200 and 130 are off the tile grid (tile 64), d=250 >= T; C, H and
    Cs off the 128-grid and the 8-element grid."""
    c, h, cs = widths
    rng = np.random.RandomState(5)
    x = _bf16(rng.randn(2, t_total, c))
    params = [_bf16(p) for p in _params(rng, c, h, cs)]
    res_j, skip_j = tcn.tcn_block_fused(
        jnp.asarray(x, jnp.bfloat16),
        tuple(jnp.asarray(p, jnp.bfloat16) for p in params), dilation, last,
        tile=64, interpret=True)
    pt = _port_params(params)
    if last:
        pt = pt[:10] + (None, None) + pt[12:]
    port.tcn_block.launches = 0
    res, skip, stats = port.tcn_block_fwd(
        torch.from_numpy(x).bfloat16(),
        [None if p is None else p.bfloat16() for p in pt], dilation, last)
    assert port.tcn_block.launches == 0
    assert skip.dtype == torch.bfloat16 and stats.dtype == torch.float32
    exact = port.tcn_block_fwd_plain(
        torch.from_numpy(x).double(),
        [None if p is None else p.double() for p in pt], dilation, last)
    pairs = [(skip, skip_j, exact[1])]
    if not last:
        assert res.dtype == torch.bfloat16
        pairs.append((res, res_j, exact[0]))
    else:
        assert res is None
    for got, want, ref in pairs:
        _close_bf16(got, want)
        assert _snr_db(got.float(), ref) >= _snr_db(
            np.asarray(want, np.float32), ref.numpy()) - 0.1
