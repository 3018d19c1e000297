"""The port's Conv-TasNet (brever_tpu_torch.models.convtasnet) against
the JAX package's: one set of flax weights, converted by
brever_tpu_torch.convert, gives the same enhancement in float32."""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from brever_tpu_torch.models import ModelRegistry, count_params

SMALL = dict(filters=64, filter_length=16, bottleneck_channels=32,
             hidden_channels=64, skip_channels=32, layers=2, repeats=2)


@pytest.fixture(scope='module')
def small():
    """A small JAX Conv-TasNet (scanned sweep + block_last path) and the
    port's twin holding the same weights."""
    jax_model = JaxModels.get('convtasnet')(**SMALL)
    variables = jax_model.init_variables(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables['params'])
    model = ModelRegistry.get('convtasnet')(**SMALL, device='cpu')
    model.load_state_dict(flax_to_state_dict(params))
    return jax_model, variables, params, model


def test_enhance_matches_jax(small):
    jax_model, variables, _, model = small
    x = np.random.RandomState(0).randn(2, 2, 4000).astype('float32')
    ref = np.asarray(jax_model.enhance(variables, x))
    out = model.enhance(x)
    assert out.shape == ref.shape == (2, 4000)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    # unbatched input takes the same path
    np.testing.assert_allclose(model.enhance(x[1]).numpy(), ref[1],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('dilation', [1, 3])
def test_common_modules_match_flax(dilation):
    """PReLU -> depthwise -> gLN, flax modules vs the port's."""
    import flax.linen as fnn

    from brever_tpu.models import common as jax_common
    from brever_tpu_torch.models import common

    class Chain(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = jax_common.PReLU()(x)
            x = jax_common.DepthwiseConv1D(
                features=8, kernel_size=3, kernel_dilation=dilation,
                padding=(dilation, dilation))(x)
            return jax_common.GlobalLayerNorm()(x)

    rng = np.random.RandomState(4)
    x = rng.randn(2, 50, 8).astype('float32')
    alpha = np.asarray([0.1], np.float32)
    kernel = rng.randn(3, 1, 8).astype('float32')
    bias, scale, shift = (rng.randn(8).astype('float32') for _ in range(3))
    params = {'PReLU_0': {'alpha': alpha},
              'DepthwiseConv1D_0': {'kernel': kernel, 'bias': bias},
              'GlobalLayerNorm_0': {'scale': scale, 'bias': shift}}
    ref = jax.jit(Chain().apply)({'params': params}, x)

    prelu = common.PReLU()
    dw = common.DepthwiseConv1D(8, 3, dilation, (dilation, dilation))
    gln = common.GlobalLayerNorm(8)
    with torch.no_grad():
        prelu.alpha.copy_(torch.from_numpy(alpha))
        dw.weight.copy_(torch.from_numpy(kernel.reshape(3, 8)))
        dw.bias.copy_(torch.from_numpy(bias))
        gln.scale.copy_(torch.from_numpy(scale))
        gln.bias.copy_(torch.from_numpy(shift))
        out = gln(dw(prelu(torch.from_numpy(x))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_convert_round_trip(small):
    _, _, params, model = small
    back = flatten_dict(state_dict_to_flax(model.state_dict(),
                                           SMALL['layers']))
    flat = flatten_dict(params)
    assert back.keys() == flat.keys()
    for key, value in flat.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_single_repeat_round_trip():
    """repeats=1 has no scanned sweep: every block is a block_last."""
    kwargs = dict(SMALL, repeats=1)
    variables = JaxModels.get('convtasnet')(**kwargs).init_variables(
        jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, variables['params'])
    model = ModelRegistry.get('convtasnet')(**kwargs, device='cpu')
    model.load_state_dict(flax_to_state_dict(params))
    back = flatten_dict(state_dict_to_flax(model.state_dict(),
                                           kwargs['layers']))
    flat = flatten_dict(params)
    assert back.keys() == flat.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_default_width_param_count():
    """Pinned like the JAX model (brever_tpu/models/convtasnet.py)."""
    model = ModelRegistry.get('convtasnet')(device='cpu')
    assert count_params(model) == 4_935_217
    assert sum(b.res is None for b in model.tcn.blocks) == 1
    assert [b.dilation for b in model.tcn.blocks[:8]] == \
        [1, 2, 4, 8, 16, 32, 64, 128]


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match='causal'):
        ModelRegistry.get('convtasnet')(**SMALL, causal=True, device='cpu')
    with pytest.raises(TypeError):
        ModelRegistry.get('convtasnet')(**SMALL)   # no ambient device
