"""The bf16 mode of the port's GroupNorm and BatchNorm twins (the plain
versions of K7/K8 and K7-BN/K8-BN's bf16 route, ``ops.groupnorm`` and
``ops.batchnorm``) against the JAX package on the same numpy inputs rounded
to bfloat16:

* K7/K8's twins against the Pallas kernels ``_fwd_pallas``/``_bwd_pallas``
  of ``brever_tpu/ops/pallas/groupnorm.py`` run at bf16 I/O in interpret
  mode (``FORCE_INTERPRET``, a small ``_CHUNK_BYTES`` so that the grid
  walks several blocks), rank 3 and rank 4, SiLU on and off. XLA on the
  CPU may keep float32 between fused bfloat16 operations
  (``xla_allow_excess_precision``), so the kernels are compiled with that
  option off, as tests/test_torch_lstm_scan_bf16.py compiles the LSTM
  kernels. Given the kernel's own statistics, the twins' y and dx are the
  kernel's bits; from their own statistics (float32 sums in another order)
  at most 1 bf16 ulp apart, and bitwise for at least 99 % of the elements;
  the statistics and the affine's float32 gradients within float32 rounding
  (rtol 1e-5);
* the external-affine twin (IDMSE's ``adm`` ``norm_2``, the plain route on
  every device) against ``_make_gn_silu(..., has_ext=True)`` in bfloat16:
  y within 1 ulp (99 % bitwise), the five gradients each rounded to its
  input's dtype within 2 ulps of the tensor's largest value;
* K7-BN/K8-BN's twins, through ``models.common.BatchNormAct`` with a
  bfloat16 affine (as the amp trainer casts it) and float32 running
  statistics, against both branches of the JAX ``batch_norm_act`` in
  bfloat16: the Pallas branch (``BREVER_BN_FUSED=1``), which rounds y once
  after the activation as the twin does (1 ulp, 99 % bitwise), and the XLA
  default, which rounds before the activation and applies it in bfloat16:
  ReLU keeps the bits (1 ulp, 99 % bitwise), while SiLU rounds three times
  there (z, the sigmoid, the product): about half the elements differ by
  a bf16 ulp, up to 3 ulps allowed, and the twin is held no farther from
  float64 than that branch. The running statistics (float32) within 1e-6,
  the gradients (bfloat16, cast at the autograd boundary) within 2 ulps of
  each tensor's largest value.

Each twin is also no farther from float64 than the kernel (within 1e-3 of
its relative error).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.models.common as jax_common
import brever_tpu.ops.pallas.groupnorm as gnp
from brever_tpu.ops.normalization import _make_gn_silu
from brever_tpu_torch.models.common import BatchNormAct
from brever_tpu_torch.ops import batchnorm as bn
from brever_tpu_torch.ops import groupnorm as gn

AS_WRITTEN = {'xla_allow_excess_precision': False}
#: (channels-first shape, groups): rank 4 and rank 3 (an odd length, so the
#: last block of rows is masked), the U-Net's group rule and G = C
GN_CASES = [((2, 32, 8, 24), 8), ((3, 16, 37), 4), ((2, 8, 5, 16), 8)]
BN_SHAPES = [(3, 60, 50), (4, 1, 37)]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(gnp, 'FORCE_INTERPRET', True)
    monkeypatch.setattr(gnp, '_CHUNK_BYTES', 1024)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(a):
    """float32 numpy values rounded to bfloat16 (kept float32)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def _gn_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[1]
    return (_bf16(0.3 + 2.0 * rng.randn(*shape)),
            _bf16(1.0 + 0.1 * rng.randn(c)), _bf16(0.1 * rng.randn(c)),
            _bf16(rng.randn(*shape)))


def _ordered(a):
    bits = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .view(torch.int16).numpy().astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7fff), bits)


def _ulps(got, want):
    return np.abs(_ordered(got) - _ordered(want))


def _rel(got, exact):
    return float(np.linalg.norm(np.asarray(got, np.float64) - exact)
                 / np.linalg.norm(exact))


def _np(t):
    return t.detach().float().numpy()


def _last(x):
    """Channels first to the JAX package's channels last."""
    return np.moveaxis(x, 1, -1)


def _first(x):
    return np.moveaxis(np.asarray(x, np.float32), -1, 1)


def _pallas(x, scale, bias, dy, groups, act):
    """The Pallas kernels at bf16 I/O in interpret mode, compiled as
    written: (y, mean, rstd, dx, dscale, dbias), channels first, the
    statistics (B, G), dscale/dbias float32."""
    def run(x, scale, bias, dy):
        y, mean, rstd = gnp._fwd_pallas(x, scale, bias, groups, 1e-6, act,
                                        True)
        dx, dscale, dbias = gnp._bwd_pallas(x, dy, scale, bias, mean, rstd,
                                            groups, act, True)
        return y, mean[:, 0], rstd[:, 0], dx, dscale, dbias

    args = [jnp.asarray(_last(a)).astype(jnp.bfloat16) for a in (x, dy)]
    args = [args[0], jnp.asarray(scale).astype(jnp.bfloat16),
            jnp.asarray(bias).astype(jnp.bfloat16), args[1]]
    compiled = jax.jit(run).lower(*args).compile(compiler_options=AS_WRITTEN)
    y, mean, rstd, dx, dscale, dbias = (np.asarray(o, np.float32)
                                        for o in compiled(*args))
    return _first(y), mean, rstd, _first(dx), dscale, dbias


def _assert_bf16_close(name, got, want, exact=None, kernel=None):
    ulps = _ulps(got, want)
    print(f'{name}: {np.mean(ulps > 0):.2e} of elements differ, at most '
          f'{ulps.max()} ulp')
    assert ulps.max() <= 1, name
    assert np.mean(ulps > 0) <= 0.01, name
    if exact is not None:
        assert _rel(got, exact) <= _rel(kernel, exact) * (1 + 1e-3) + 1e-12


@pytest.mark.parametrize('act', ['silu', 'none'])
@pytest.mark.parametrize('shape,groups', GN_CASES, ids=str)
def test_groupnorm_bf16_twin_matches_the_pallas_kernel(shape, groups, act):
    x, scale, bias, dy = _gn_inputs(shape)
    k_y, k_mean, k_rstd, k_dx, k_dscale, k_dbias = _pallas(
        x, scale, bias, dy, groups, act)
    tx, ts, tb, tdy = (torch.from_numpy(a).bfloat16()
                       for a in (x, scale, bias, dy))

    # given the kernel's statistics: the kernel's bits
    mean, rstd = torch.from_numpy(k_mean), torch.from_numpy(k_rstd)
    y_at = gn._act(gn._folded(tx.float(), ts.float(), tb.float(), mean,
                              rstd), act).bfloat16()
    np.testing.assert_array_equal(_np(y_at), k_y)
    dx_at, ds_at, db_at = gn.group_norm_act_bwd_plain(
        tx, tdy, ts, tb, mean, rstd, groups, act)
    assert dx_at.dtype == torch.bfloat16 and ds_at.dtype == torch.float32
    np.testing.assert_array_equal(_np(dx_at), k_dx)
    np.testing.assert_allclose(_np(ds_at), k_dscale, rtol=1e-5,
                               atol=1e-5 * np.abs(k_dscale).max())
    np.testing.assert_allclose(_np(db_at), k_dbias, rtol=1e-5,
                               atol=1e-5 * np.abs(k_dbias).max())

    # from its own statistics, as the CPU path runs it
    y, t_mean, t_rstd = gn.group_norm_act_reference(tx, ts, tb, groups, 1e-6,
                                                    act)
    assert y.dtype == torch.bfloat16 and t_mean.dtype == torch.float32
    np.testing.assert_allclose(_np(t_mean), k_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(t_rstd), k_rstd, rtol=1e-5)
    wide = [torch.from_numpy(a).double() for a in (x, scale, bias, dy)]
    e_y, e_mean, e_rstd = gn.group_norm_act_reference(*wide[:3], groups,
                                                      1e-6, act)
    _assert_bf16_close('y', _np(y), k_y, e_y.numpy(), k_y)
    dx, dscale, dbias = gn.group_norm_act_bwd_plain(tx, tdy, ts, tb, t_mean,
                                                    t_rstd, groups, act)
    e_dx = gn.group_norm_act_bwd_plain(wide[0], wide[3], *wide[1:3], e_mean,
                                       e_rstd, groups, act)[0]
    _assert_bf16_close('dx', _np(dx), k_dx, e_dx.numpy(), k_dx)


def test_groupnorm_function_casts_the_affine_gradients():
    """Through the autograd function a bf16 affine gets bf16 gradients, the
    float32 sums rounded once, as ``_make_gn_act_pallas``'s VJP casts them;
    a float32 affine with a bf16 x keeps them float32, and y stays bf16."""
    x, scale, bias, dy = _gn_inputs((2, 32, 4, 6))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    for dtype in (torch.bfloat16, torch.float32):
        ts, tb = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (scale, bias))
        y = gn.group_norm_silu(tx, ts, tb, 8)
        assert y.dtype == torch.bfloat16
        grads = torch.autograd.grad(y, (tx, ts, tb),
                                    torch.from_numpy(dy).bfloat16())
        assert [g.dtype for g in grads] == [torch.bfloat16, dtype, dtype]
        _, mean, rstd = gn.group_norm_act_reference(tx, ts, tb, 8, 1e-6,
                                                    'silu')
        want = gn.group_norm_act_bwd_plain(tx, torch.from_numpy(dy)
                                           .bfloat16(), ts, tb, mean, rstd,
                                           8, 'silu')
        assert torch.equal(grads[0], want[0])
        assert torch.equal(grads[1], want[1].to(dtype))


def test_ext_affine_twin_matches_the_jax_bf16_path():
    """IDMSE's external-affine GroupNorm in bfloat16: float32 arithmetic,
    each output cast as the JAX package's jnp path casts it."""
    shape, groups = (2, 16, 6, 10), 4
    x, scale, bias, dy = _gn_inputs(shape, seed=3)
    rng = np.random.RandomState(4)
    ext_scale = _bf16(1 + 0.2 * rng.randn(shape[0], shape[1]))
    ext_shift = _bf16(0.2 * rng.randn(shape[0], shape[1]))
    f = _make_gn_silu(groups, 1e-6, True, True)
    b, c = shape[:2]

    def run(x, scale, bias, es, eh):
        return f(x.reshape(b, -1, c), scale, bias, es, eh)

    bf = jnp.bfloat16
    jargs = [jnp.asarray(_last(x)).astype(bf)] + [
        jnp.asarray(a).astype(bf) for a in (scale, bias, ext_scale,
                                            ext_shift)]
    jy, vjp = jax.vjp(run, *jargs)
    jgrads = vjp(jnp.asarray(_last(dy).reshape(b, -1, c)).astype(bf))
    assert jy.dtype == bf and all(g.dtype == bf for g in jgrads)

    targs = [torch.from_numpy(a).bfloat16().requires_grad_()
             for a in (x, scale, bias, ext_scale, ext_shift)]
    y = gn.group_norm_silu(targs[0], targs[1], targs[2], groups,
                           ext_scale=targs[3], ext_shift=targs[4])
    assert y.dtype == torch.bfloat16
    _assert_bf16_close('y', _np(y), _first(jy).reshape(shape))
    grads = torch.autograd.grad(y, targs, torch.from_numpy(dy).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want = [_first(np.asarray(jgrads[0], np.float32).reshape(
        b, *shape[2:], c))] + [np.asarray(g, np.float32) for g in jgrads[1:]]
    for name, g, w in zip(('dx', 'dscale', 'dbias', 'd_ext_scale',
                           'd_ext_shift'), grads, want):
        # 2 ulps of the tensor's largest value: float32 sums in another
        # order, each rounded to bfloat16 once
        np.testing.assert_allclose(_np(g), w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=name)


class _JaxBN(nn.Module):
    act: str

    @nn.compact
    def __call__(self, x, train):
        return jax_common.batch_norm_act(x, train, 'bn', act=self.act)


def _jax_bn(act, x, scale, bias, dy):
    """The JAX ``batch_norm_act`` in train mode at bfloat16 (x and the
    parameters, as the amp trainer gives them; the running statistics
    float32): (y, updated mean and var, (dx, dscale, dbias)), channels
    first."""
    bf = jnp.bfloat16
    c = x.shape[1]
    stats = {'bn': {'mean': jnp.zeros(c, jnp.float32),
                    'var': jnp.ones(c, jnp.float32)}}

    def run(x, scale, bias):
        v = {'params': {'bn': {'scale': scale, 'bias': bias}},
             'batch_stats': stats}
        return _JaxBN(act).apply(v, x, train=True, mutable=['batch_stats'])

    args = (jnp.asarray(_last(x)).astype(bf), jnp.asarray(scale).astype(bf),
            jnp.asarray(bias).astype(bf))
    (y, new), vjp = jax.vjp(run, *args)
    grads = vjp((jnp.asarray(_last(dy)).astype(bf),
                 jax.tree.map(jnp.zeros_like, new)))
    assert y.dtype == bf
    return (_first(y), {k: np.asarray(v) for k, v in
                        new['batch_stats']['bn'].items()},
            [_first(grads[0])] + [np.asarray(g, np.float32)
                                  for g in grads[1:]])


def _port_bn(act, x, scale, bias, dy):
    module = BatchNormAct(x.shape[1], act)
    # the amp trainer's bfloat16 parameters; the buffers stay float32
    module.scale = torch.nn.Parameter(torch.from_numpy(scale).bfloat16())
    module.bias = torch.nn.Parameter(torch.from_numpy(bias).bfloat16())
    module.train()
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    y = module(tx)
    assert y.dtype == torch.bfloat16
    assert module.mean.dtype == module.var.dtype == torch.float32
    grads = torch.autograd.grad(y, [tx, module.scale, module.bias],
                                torch.from_numpy(dy).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    return (_np(y), {'mean': module.mean.numpy(), 'var': module.var.numpy()},
            [_np(g) for g in grads])


@pytest.mark.parametrize('branch', ['pallas', 'xla'])
@pytest.mark.parametrize('act', ['none', 'relu', 'silu'])
@pytest.mark.parametrize('shape', BN_SHAPES, ids=str)
def test_batchnorm_bf16_twin_matches_both_jax_branches(shape, act, branch,
                                                       monkeypatch):
    if branch == 'pallas':
        monkeypatch.setattr(jax_common, '_FUSED_BN_MIN_BYTES', 0)
        monkeypatch.setenv('BREVER_BN_FUSED', '1')
    else:
        monkeypatch.setenv('BREVER_BN_FUSED', '0')
    rng = np.random.RandomState(1)
    b, c, t = shape
    x = _bf16(rng.randn(b, c, t) * 1.5 + rng.randn(1, c, 1))
    scale, bias = _bf16(rng.rand(c) + 0.5), _bf16(0.3 * rng.randn(c))
    dy = _bf16(rng.randn(*shape))
    j_y, j_stats, j_grads = _jax_bn(act, x, scale, bias, dy)
    p_y, p_stats, p_grads = _port_bn(act, x, scale, bias, dy)
    ulps = _ulps(p_y, j_y)
    print(f'{branch} {act}: {np.mean(ulps > 0):.2e} of y differ, at most '
          f'{ulps.max()} ulp')
    if branch == 'pallas' or act != 'silu':
        assert ulps.max() <= 1 and np.mean(ulps > 0) <= 0.01
    else:
        exact = bn.batch_norm_act_reference(
            *(torch.from_numpy(a).double() for a in (x, scale, bias)), 1e-5,
            act)[0].numpy()
        assert ulps.max() <= 3
        assert _rel(p_y, exact) <= _rel(j_y, exact)
    for k in ('mean', 'var'):
        np.testing.assert_allclose(p_stats[k], j_stats[k], rtol=1e-5,
                                   atol=1e-6)
    for name, g, w in zip(('dx', 'dscale', 'dbias'), p_grads, j_grads):
        np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=name)
