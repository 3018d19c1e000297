"""The port's GroupNorm + SiLU (brever_tpu_torch.ops.groupnorm) against the
JAX package's, in float32 on the CPU, where the port's wrapper takes its
plain versions (the forward and the memory-lean backward of
``GroupNormActFunction``):

* against ``gn_silu_pallas``, the Pallas kernels in interpret mode, at
  C = 128 with 32 groups (chunks forced small, so the kernel walks several
  chunks and a masked tail);
* against ``_make_gn_silu``, the jnp custom VJP the JAX package takes for
  every other shape, at C = 32 with 8 groups;

both ranks (B, N, C) and (B, F, T, C), with and without SiLU. The forward
agrees within rtol 2e-5 / atol 2e-6, the gradients of x, scale and bias
within rtol 3e-4 / atol 2e-5: the bounds of tests/test_groupnorm_fused.py
(the kernel sums chunk by chunk, the port in one reduction). The JAX
package is channels last; the port takes ``(B, C, *spatial)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import brever_tpu.ops.pallas.groupnorm as gnp
from brever_tpu.ops.normalization import _make_gn_silu
from brever_tpu_torch.ops import groupnorm

EPS = 1e-6
SHAPES = {3: (2, 301, None), 4: (2, 7, 43, None)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(rank, channels, seed=0):
    rng = np.random.RandomState(seed)
    shape = SHAPES[rank][:-1] + (channels,)
    x = (1.5 * rng.randn(*shape) + 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(channels)).astype(np.float32)
    bias = (0.1 * rng.randn(channels)).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, w


def _port(x, scale, bias, w, groups, apply_silu):
    """The port's output (channels last again) and its gradients of
    ``sum(y * w)``."""
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = groupnorm.group_norm_silu(xt, st, bt, groups, EPS,
                                  apply_silu=apply_silu)
    wt = torch.from_numpy(np.moveaxis(w, -1, 1).copy())
    grads = torch.autograd.grad((y * wt).sum(), (xt, st, bt))
    return (np.moveaxis(y.detach().numpy(), 1, -1),
            (np.moveaxis(grads[0].numpy(), 1, -1), grads[1].numpy(),
             grads[2].numpy()))


def _compare(ref_fn, x, scale, bias, w, groups, apply_silu):
    ref_y = ref_fn(x, scale, bias)
    ref_g = jax.grad(lambda a: (ref_fn(*a) * w).sum())(
        (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    y, grads = _port(x, scale, bias, w, groups, apply_silu)
    np.testing.assert_allclose(y, np.asarray(ref_y), rtol=2e-5, atol=2e-6)
    for got, want, name in zip(grads, ref_g, ('x', 'scale', 'bias')):
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize('rank', [3, 4])
@pytest.mark.parametrize('apply_silu', [True, False], ids=['silu', 'none'])
def test_plain_matches_pallas_kernel(rank, apply_silu, monkeypatch):
    monkeypatch.setattr(gnp, 'FORCE_INTERPRET', True)
    monkeypatch.setattr(gnp, '_CHUNK_BYTES', 16 * 1024)
    x, scale, bias, w = _data(rank, 128, seed=rank)

    def kernel(x, scale, bias):
        return gnp.gn_silu_pallas(x, scale, bias, 32, EPS, apply_silu)

    _compare(kernel, x, scale, bias, w, 32, apply_silu)


@pytest.mark.parametrize('rank', [3, 4])
@pytest.mark.parametrize('apply_silu', [True, False], ids=['silu', 'none'])
def test_plain_matches_jnp_custom_vjp(rank, apply_silu):
    x, scale, bias, w = _data(rank, 32, seed=10 + rank)
    f = _make_gn_silu(8, EPS, apply_silu, False)

    def twin(x, scale, bias):
        b, c = x.shape[0], x.shape[-1]
        zeros = jnp.zeros((b, c), jnp.float32)
        return f(x.reshape(b, -1, c), scale, bias, zeros, zeros) \
            .reshape(x.shape)

    _compare(twin, x, scale, bias, w, 8, apply_silu)


def test_one_group_a_channel_with_relu():
    """G = C with ReLU, flash-BN's case, needs nothing new: the plain
    versions against torch's group_norm and its autograd in float64."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 16, 5, 7)).requires_grad_()
    scale = torch.from_numpy(1 + 0.1 * rng.randn(16)).requires_grad_()
    bias = torch.from_numpy(0.1 * rng.randn(16)).requires_grad_()
    dy = torch.from_numpy(rng.randn(3, 16, 5, 7))
    y, mean, rstd = groupnorm.group_norm_act_reference(
        x.detach(), scale.detach(), bias.detach(), 16, EPS, 'relu')
    ref = torch.relu(F.group_norm(x, 16, scale, bias, EPS))
    torch.testing.assert_close(y, ref.detach(), rtol=1e-10, atol=1e-10)
    want = torch.autograd.grad(ref, (x, scale, bias), dy)
    got = groupnorm.group_norm_act_bwd_plain(
        x.detach(), dy, scale.detach(), bias.detach(), mean, rstd, 16,
        'relu')
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    x = torch.randn(2, 8, 3, 5)
    scale, bias = torch.ones(8), torch.zeros(8)
    fwd, bwd = groupnorm.group_norm_act_fwd, groupnorm.group_norm_act_bwd
    before = fwd.launches, fwd.recompute_launches, bwd.launches
    y = groupnorm.group_norm_silu(x.requires_grad_(), scale, bias, 2)
    y.sum().backward()
    assert (fwd.launches, fwd.recompute_launches, bwd.launches) == before
    ref = groupnorm.group_norm_act_reference(x.detach(), scale, bias, 2,
                                             1e-6, 'silu')[0]
    assert torch.equal(y.detach(), ref)


def test_refusals():
    x, scale, bias = torch.randn(2, 8, 4), torch.ones(8), torch.zeros(8)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        groupnorm.group_norm_silu(x, scale, bias, 2,
                                  ext_scale=torch.ones(2, 8),
                                  ext_shift=torch.zeros(2, 8))
    with pytest.raises(ValueError, match='divisible'):
        groupnorm.group_norm_silu(x, scale, bias, 3)
    # the kernels' wrapper takes CUDA tensors only, and never falls back
    with pytest.raises(ValueError, match='no kernel'):
        groupnorm._check(x, scale, bias, 2, 'silu')
