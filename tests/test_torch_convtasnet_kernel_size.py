"""A Conv-TasNet whose depthwise convs do not have 3 taps: its blocks
take the plain block under autograd on every device (the kernels take 3
taps, as the JAX package's fused kernel does), and the model matches the
JAX package's, which runs such blocks on XLA. One set of flax weights
(brever_tpu_torch.convert); forward at atol 1e-4, rtol 1e-4, per-item
loss at rtol 1e-4, atol 1e-4, gradients at rtol 1e-3, atol 1e-4 of each
tensor's largest value, the tolerances of test_torch_convtasnet.py and
test_torch_convtasnet_grad.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu_torch.models.convtasnet as convtasnet
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch.convert import flax_to_state_dict
from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.models.base import sample_weighted_mean

SMALL = dict(filters=64, filter_length=16, bottleneck_channels=32,
             hidden_channels=64, skip_channels=32, layers=2, repeats=2,
             kernel_size=5)


@pytest.fixture(scope='module')
def twins():
    jax_model = JaxModels.get('convtasnet')(**SMALL)
    variables = jax_model.init_variables(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables['params'])
    model = ModelRegistry.get('convtasnet')(**SMALL, device='cpu')
    model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.RandomState(0)
    target = 0.3 * rng.randn(3, 1, 2, 2400)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2400)
    batch = np.concatenate([mix, target], axis=1).astype(np.float32)
    lengths = np.array([2400, 1700, 0], np.int32)
    return jax_model, variables, params, model, batch, lengths


class _Counting:
    """A stand-in for ``tcn_block`` that counts its calls and runs the
    plain block."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, params, dilation, last):
        self.calls += 1
        return convtasnet.tcn_block_plain(x, params, dilation, last)


@pytest.mark.parametrize('kernel_size,reaches', [(3, True), (5, False),
                                                 (2, False)])
def test_only_three_tap_blocks_reach_the_kernel_wrapper(kernel_size, reaches,
                                                        monkeypatch):
    counting = _Counting()
    monkeypatch.setattr(convtasnet, 'tcn_block', counting)
    if not reaches:
        def refuse(*args):
            raise AssertionError('a block off 3 taps reached tcn_block')
        monkeypatch.setattr(convtasnet, 'tcn_block', refuse)
    model = ModelRegistry.get('convtasnet')(
        **dict(SMALL, kernel_size=kernel_size), device='cpu')
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 800)
                         .astype(np.float32))
    out = model(x)
    out.sum().backward()   # the plain block is differentiable by autograd
    assert out.shape == (2, 1, 800)
    assert all(p.grad is not None for p in model.parameters())
    if reaches:
        assert counting.calls == len(model.tcn.blocks) == 4


def test_enhance_matches_jax(twins):
    jax_model, variables, _, model, _, _ = twins
    x = np.random.RandomState(0).randn(2, 2, 4000).astype('float32')
    ref = np.asarray(jax_model.enhance(variables, x))
    out = model.enhance(x)
    assert out.shape == ref.shape == (2, 4000)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_loss_matches_jax(twins):
    jax_model, _, params, model, batch, lengths = twins
    want = np.asarray(jax_model.loss({'params': params}, jnp.asarray(batch),
                                     jnp.asarray(lengths), None))
    with torch.no_grad():
        got = model.loss(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert got.shape == (3,)
    np.testing.assert_allclose(got[:2].numpy(), want[:2], rtol=1e-4,
                               atol=1e-4)


def test_gradients_match_jax(twins):
    jax_model, _, params, model, batch, lengths = twins

    def loss(p):
        per_item = jax_model.loss({'params': p}, jnp.asarray(batch),
                                  jnp.asarray(lengths), None)
        return jax_mean(per_item, jnp.asarray(lengths))

    want = flax_to_state_dict(jax.tree.map(np.asarray,
                                           jax.grad(loss)(params)))
    n = torch.from_numpy(lengths)
    model.zero_grad()
    sample_weighted_mean(model.loss(torch.from_numpy(batch), n), n).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert got['tcn.blocks.0.depthwise.weight'].shape == (5, 64)
    for name, ref in want.items():
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got[name].grad.numpy(), ref.numpy(),
                                   rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)
