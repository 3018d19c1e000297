"""The elementwise-rate probe's plain version
(``brever_tpu_torch.ops.fma_chain.fma_chain_reference``, the twin of K10)
against the JAX benchmark's Pallas kernel (``_kernel`` of
``benchmarks/bench_vpu_dtype.py``, its ``K`` and ``PASSES``) run in
interpret mode on the CPU at (2, 16, 128), in float32 and bfloat16, on the
benchmark's input (``rand * 0.001 + 0.5``: bfloat16 rounds it to 0.5, whose
chain is 1.0 everywhere) and on a wider one (``rand * 0.5 + 0.1``). Both
round the product and the sum of each step in the dtype: float32 within
2e-6 of the largest value, bfloat16 within one bfloat16 ulp of each value.
The probe's operation count and bounds are the arithmetic of its
docstring; the kernel's wrapper refuses a CPU tensor and other dtypes.

``fma_chain_limit``, the bound that the card's comparisons hold K10 to at
every element, holds between the plain chain and a chain that rounds once a
step as the kernel's fused multiply-add (each step computed in float64 and
rounded to the dtype), at the benchmark's arguments and at the probe's
``STEP_CASES``; on each of those a chain one step short breaks it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks.bench_vpu_dtype import K, PASSES, _kernel
from brever_tpu_torch import bench_alu_dtype as probe
from brever_tpu_torch.ops import fma_chain as fc

SHAPE = (2, 16, 128)


def _jax_chain(x):
    """The benchmark's pallas_call, one (1, T, H) block a grid step, in
    interpret mode."""
    f = pl.pallas_call(
        functools.partial(_kernel, k=K, passes=PASSES),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0],),
        in_specs=[pl.BlockSpec((1,) + x.shape[1:], lambda r: (r, 0, 0))],
        out_specs=pl.BlockSpec((1,) + x.shape[1:], lambda r: (r, 0, 0)),
        interpret=True)
    return np.asarray(jax.jit(f)(x).astype(jnp.float32))


def _ulp_bf16(v):
    """One bfloat16 ulp at each value (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.abs(v))) - 7)


@pytest.mark.parametrize('kind', ['bench', 'wide'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_chain_matches_the_jax_kernel(dtype, kind):
    wide = kind == 'wide'
    x = probe.probe_input(getattr(torch, dtype), 'cpu', SHAPE, kind)
    got = fc.fma_chain_reference(x, K, PASSES).float().numpy()
    want = _jax_chain(jnp.asarray(x.float().numpy(), getattr(jnp, dtype)))
    assert np.isfinite(want).all() and got.shape == want.shape == SHAPE
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= _ulp_bf16(want)).all()
        if not wide:   # the input rounds to 0.5, the chain's fixed point 1
            assert (got == 1.0).all()
    if wide:   # the wide input's chains spread out
        assert want.std() > 0.1


def test_probe_counts_and_bounds():
    numel = probe.ROWS * probe.T * probe.H
    assert (probe.ROWS, probe.T, probe.H, K, PASSES) == (8, 1024, 512, 64, 8)
    assert probe.n_ops(numel) == 2_147_483_648
    f32_ms, f32_by = probe.bound(numel, torch.float32)
    bf16_ms, bf16_by = probe.bound(numel, torch.bfloat16)
    assert f32_by == bf16_by == 'operations'
    np.testing.assert_allclose(f32_ms, 2_147_483_648 / 67e12 * 1e3)
    np.testing.assert_allclose(bf16_ms, 2_147_483_648 / 133.8e12 * 1e3)
    assert round(f32_ms * 1e3, 1) == 32.1 and round(bf16_ms * 1e3, 1) == 16.0
    # the bytes, each input read once and each output written once
    assert round(2 * 4 * numel / 3.35e12 * 1e6, 1) == 10.0
    assert round(2 * 2 * numel / 3.35e12 * 1e6, 1) == 5.0


def test_kernel_wrapper_refuses_what_it_does_not_take():
    before = fc.fma_chain.launches
    with pytest.raises(ValueError, match='no kernel for device cpu'):
        fc.fma_chain(torch.ones(8))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fc.fma_chain(torch.ones(8, dtype=torch.float64))
    assert fc.fma_chain.launches == before


def test_bench_runs_the_plain_version_on_the_cpu(capsys):
    result = probe.main(['--device', 'cpu'])
    assert result['device'] == 'cpu (plain version)'
    assert [r['dtype'] for r in result['rows']] == ['float32', 'bfloat16']
    assert all(r['bound_share'] is None for r in result['rows'])
    assert 'bf16:f32 time ratio' in capsys.readouterr().out


def _fused_chain(x, k, passes):
    """The chain with one rounding a step, as the kernel's fused
    multiply-add: the product and sum in float64 (exact for bfloat16, one
    extra rounding for float32), then rounded to ``x``'s dtype."""
    acc, xd = x, x.double()
    for _ in range(passes * (k // 2)):
        acc = (acc.double() * xd + xd).to(x.dtype)
    return acc


_LIMIT_CASES = [(kind, k, passes, dtype)
                for kind, k, passes, dtypes in
                [('bench', K, PASSES, probe.DTYPES),
                 ('wide', K, PASSES, probe.DTYPES)] + probe.STEP_CASES
                for dtype in dtypes]


@pytest.mark.parametrize(
    'kind,k,passes,dtype', _LIMIT_CASES,
    ids=[f'{kind}-{k}-{passes}-{str(dtype)[6:]}'
         for kind, k, passes, dtype in _LIMIT_CASES])
def test_limit_bounds_one_rounding_a_step(kind, k, passes, dtype):
    x = probe.probe_input(dtype, 'cpu', SHAPE, kind)
    want = fc.fma_chain_reference(x, k, passes)
    limit, margin = fc.fma_chain_limit(x, k, passes)
    assert limit.dtype == margin.dtype == torch.float64
    assert limit.shape == margin.shape == x.shape
    err = (_fused_chain(x, k, passes).double() - want.double()).abs()
    assert (err <= limit).all()
    if (kind, k, passes) == ('bench', K, PASSES):
        return      # converged: the benchmark's own arguments resolve nothing
    short = fc.fma_chain_reference(x, 2, passes * (k // 2) - 1)
    broken = (short.double() - want.double()).abs() > limit
    if (kind, k, passes) == ('wide', K, PASSES):
        assert not broken.any()     # nor the wide input's 256 steps
    else:
        assert margin.max() > 0 and broken.any()
