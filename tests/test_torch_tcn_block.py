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
