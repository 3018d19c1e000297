"""The port's BatchNorm + activation (``models.common.BatchNormAct`` over
``ops.batchnorm``: the plain versions of K7-BN and K8-BN, which the CPU path
runs) against the JAX package's ``batch_norm_act`` on the same numpy inputs,
twice on the JAX side: its XLA branch, and its Pallas branch
(``gn_act_stats_pallas``) in interpret mode, as tests/test_batchnorm_fused.py
runs it (``FORCE_INTERPRET``, ``BREVER_BN_FUSED=1``, no byte floor).

Train and eval mode, each activation, at MANNER's width (3, 60, 50) and at
C = 1 (its local attention's gate). Bounds: y at atol 1e-5 (normalised
values of order 1; float32 sums in another order), the updated running
statistics at atol 1e-6 (they move by 1 % of a batch statistic), and the
VJP (dx, dscale, dbias) at rtol 1e-4 with a floor of 1e-5 of the tensor's
largest value."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.models.common as jax_common
from brever_tpu_torch.models.common import BatchNormAct
from brever_tpu_torch.ops import batchnorm as bn

SHAPES = [(3, 60, 50), (4, 1, 37)]   # (B, C, T)
ACTS = ['none', 'relu', 'silu']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=['xla', 'pallas'])
def jax_branch(request, monkeypatch):
    """The JAX package's branch of ``batch_norm_act`` to hold against."""
    if request.param == 'pallas':
        import brever_tpu.ops.pallas.groupnorm as gnp
        monkeypatch.setattr(gnp, 'FORCE_INTERPRET', True)
        monkeypatch.setattr(gnp, '_CHUNK_BYTES', 8 * 1024)
        monkeypatch.setattr(jax_common, '_FUSED_BN_MIN_BYTES', 0)
        monkeypatch.setenv('BREVER_BN_FUSED', '1')
    else:
        monkeypatch.setenv('BREVER_BN_FUSED', '0')
    return request.param


class _JaxBN(nn.Module):
    act: str

    @nn.compact
    def __call__(self, x, train):
        return jax_common.batch_norm_act(x, train, 'bn', act=self.act)


def _inputs(shape, seed=0):
    """x (B, C, T) with a channel offset, the affine, running statistics
    and a cotangent, all float32 numpy."""
    rng = np.random.RandomState(seed)
    b, c, t = shape
    f32 = np.float32
    return dict(
        x=(rng.randn(b, c, t) * 1.5 + rng.randn(1, c, 1)).astype(f32),
        scale=(rng.rand(c) + 0.5).astype(f32),
        bias=(0.3 * rng.randn(c)).astype(f32),
        mean=(0.2 * rng.randn(c)).astype(f32),
        var=(rng.rand(c) + 0.5).astype(f32),
        dy=rng.randn(b, c, t).astype(f32))


def _jax(act, d, train):
    """(y, updated batch_stats, (dx, dscale, dbias)) of the JAX module; the
    JAX layout is channels last."""
    module = _JaxBN(act)
    x = jnp.asarray(d['x'].transpose(0, 2, 1))
    variables = {'params': {'bn': {'scale': jnp.asarray(d['scale']),
                                   'bias': jnp.asarray(d['bias'])}},
                 'batch_stats': {'bn': {'mean': jnp.asarray(d['mean']),
                                        'var': jnp.asarray(d['var'])}}}

    def run(x, scale, bias):
        v = {**variables, 'params': {'bn': {'scale': scale, 'bias': bias}}}
        if train:
            return module.apply(v, x, train=True, mutable=['batch_stats'])
        return module.apply(v, x, train=False), {}

    scale, bias = (variables['params']['bn'][k] for k in ('scale', 'bias'))
    y, stats = run(x, scale, bias)
    _, vjp = jax.vjp(lambda *a: run(*a)[0], x, scale, bias)
    dx, dscale, dbias = vjp(jnp.asarray(d['dy'].transpose(0, 2, 1)))
    stats = stats.get('batch_stats', {}).get('bn', {})
    return (np.asarray(y).transpose(0, 2, 1),
            {k: np.asarray(v) for k, v in stats.items()},
            (np.asarray(dx).transpose(0, 2, 1), np.asarray(dscale),
             np.asarray(dbias)))


def _port(act, d, train):
    module = BatchNormAct(d['x'].shape[1], act)
    with torch.no_grad():
        for name in ('scale', 'bias', 'mean', 'var'):
            getattr(module, name).copy_(torch.from_numpy(d[name]))
    module.train(train)
    x = torch.from_numpy(d['x']).requires_grad_()
    y = module(x)
    grads = torch.autograd.grad(y, [x, module.scale, module.bias],
                                torch.from_numpy(d['dy']))
    stats = {'mean': module.mean.numpy(), 'var': module.var.numpy()} \
        if train else {}
    return y.detach().numpy(), stats, tuple(g.numpy() for g in grads)


def _close_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('act', ACTS)
@pytest.mark.parametrize('shape', SHAPES, ids=['C60', 'C1'])
def test_batch_norm_act_matches_jax(shape, act, train, jax_branch):
    d = _inputs(shape, seed=len(act) + shape[1])
    y_want, stats_want, grads_want = _jax(act, d, train)
    y_got, stats_got, grads_got = _port(act, d, train)
    np.testing.assert_allclose(y_got, y_want, atol=1e-5, rtol=1e-5)
    assert stats_got.keys() == stats_want.keys()
    for key in stats_want:
        np.testing.assert_allclose(stats_got[key], stats_want[key],
                                   atol=1e-6, rtol=1e-6)
    _close_grads(grads_got, grads_want)


def test_statistics_are_detached_and_fast_variance():
    """The train-mode statistics carry no gradient, and the variance is
    E[x^2] - mean^2 in float32, not clipped at 0."""
    x = torch.full((2, 3, 5), 0.1).requires_grad_()
    scale, bias = torch.ones(3, requires_grad=True), torch.zeros(3)
    y, mean, var = bn.batch_norm_act(x, scale, bias, 1e-5, 'relu')
    assert y.requires_grad and not mean.requires_grad \
        and not var.requires_grad
    x32 = x.detach()
    want = (x32 * x32).mean(dim=(0, 2)) - x32.mean(dim=(0, 2)) ** 2
    assert torch.equal(var, want)


def test_backward_saves_only_x_and_channel_statistics():
    """The autograd node keeps x and (C,) vectors, not the normalised
    tensor."""
    d = _inputs((2, 4, 9))
    x = torch.from_numpy(d['x']).requires_grad_()
    scale = torch.from_numpy(d['scale']).requires_grad_()
    y, _, _ = bn.batch_norm_act(x, scale, torch.from_numpy(d['bias']),
                                1e-5, 'silu')
    saved = y.grad_fn.saved_tensors
    assert sum(t.numel() for t in saved) == x.numel() + 4 * 4


def test_plain_backward_is_autograd_of_the_forward():
    """``batch_norm_act_bwd_plain`` against autograd through the plain
    forward in float64."""
    d = _inputs((3, 5, 11), seed=3)
    x, scale, bias = (torch.from_numpy(d[k]).double().requires_grad_()
                      for k in ('x', 'scale', 'bias'))
    dy = torch.from_numpy(d['dy']).double()
    y, mean, _, rstd = bn.batch_norm_act_reference(x, scale, bias, 1e-5,
                                                   'silu')
    want = torch.autograd.grad(y, [x, scale, bias], dy)
    got = bn.batch_norm_act_bwd_plain(x.detach(), dy, scale.detach(),
                                      bias.detach(), mean.detach(),
                                      rstd.detach(), 'silu')
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-9)


def test_refuses_other_layouts_and_activations():
    x = torch.randn(2, 3, 4)
    scale, bias = torch.ones(3), torch.zeros(3)
    with pytest.raises(ValueError, match='contiguous'):
        bn.batch_norm_act(x.transpose(1, 2).contiguous().transpose(1, 2),
                          scale, bias)
    with pytest.raises(ValueError, match='activation'):
        bn.batch_norm_act(x, scale, bias, act='gelu')
