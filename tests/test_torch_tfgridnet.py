"""The port's TF-GridNet (brever_tpu_torch.models.tfgridnet) against the
JAX package's: one set of flax weights, converted by
brever_tpu_torch.convert, gives the same enhancement, the same per-item
losses (multiresyu and snr) on a padded batch with a row of length 0, and
the same parameter gradients, in float32 on the CPU, at a small width
(2 layers, LSTM hidden 16, emb 8, 2 heads, qk 32). Outputs and losses at
1e-4; gradients at rtol 1e-4 with atol 1e-4 of the tensor's largest
value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch.convert import (tfgridnet_flax_to_state_dict,
                                      tfgridnet_state_dict_to_flax)
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models.base import sample_weighted_mean

SMALL = dict(n_layers=2, lstm_hidden_units=16, emb_dim=8, attn_n_head=2,
             attn_approx_qk_dim=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twins(criterion):
    jax_model = JaxModels.get('tfgridnet')(**SMALL, criterion=criterion)
    variables = jax_model.init_variables(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables['params'])
    model = ModelRegistry.get('tfgridnet')(**SMALL, criterion=criterion,
                                           device='cpu')
    model.load_state_dict(tfgridnet_flax_to_state_dict(params))
    return jax_model, params, model


@pytest.fixture(scope='module')
def twins():
    return _twins('multiresyu')


@pytest.fixture(scope='module')
def batch():
    rng = np.random.RandomState(0)
    target = 0.3 * rng.randn(3, 1, 2, 2100)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2100)
    data = np.concatenate([mix, target], axis=1).astype(np.float32)
    return data, np.array([2100, 1500, 0], np.int32)


def test_default_width_param_count():
    """Pinned like the JAX model (tests/test_training.py)."""
    model = ModelRegistry.get('tfgridnet')(device='cpu')
    assert count_params(model) == 3_735_344
    assert len(model.blocks) == 6


def test_convert_round_trip(twins):
    """flax -> state_dict -> flax is exact, key for key and shape for
    shape (the scanned block axis split and stacked again)."""
    _, params, model = twins
    back = flatten_dict(tfgridnet_state_dict_to_flax(model.state_dict()))
    flat = flatten_dict(params)
    assert back.keys() == flat.keys()
    for key, value in flat.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))
    assert count_params(model) == sum(v.size for v in flat.values())


def test_enhance_matches_jax(twins):
    jax_model, params, model = twins
    x = (0.5 * np.random.RandomState(1).randn(2, 2, 3001)).astype(np.float32)
    ref = np.asarray(jax_model.enhance({'params': params}, x))
    out = model.enhance(x)
    assert out.shape == ref.shape == (2, 3001)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('criterion', ['multiresyu', 'snr'])
def test_loss_matches_jax(twins, batch, criterion):
    if criterion == 'multiresyu':
        jax_model, params, model = twins
    else:
        jax_model, params, model = _twins(criterion)
    data, lengths = batch
    want = np.asarray(jax_model.loss({'params': params}, jnp.asarray(data),
                                     jnp.asarray(lengths), None))
    with torch.no_grad():
        got = model.loss(torch.from_numpy(data), torch.from_numpy(lengths))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gradients_match_jax(twins, batch):
    jax_model, params, model = twins
    data, lengths = batch

    def loss(p):
        per_item = jax_model.loss({'params': p}, jnp.asarray(data),
                                  jnp.asarray(lengths), None)
        return jax_mean(per_item, jnp.asarray(lengths))

    want = tfgridnet_flax_to_state_dict(
        jax.tree.map(np.asarray, jax.grad(loss)(params)))
    n = torch.from_numpy(lengths)
    model.zero_grad()
    sample_weighted_mean(model.loss(torch.from_numpy(data), n), n).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, ref in want.items():
        grad = got[name].grad
        assert grad is not None, name
        # the floor is for deconv.bias, whose gradient is 0 up to rounding
        # (~1e-10 on both sides): a constant spectrum lands on each frame's
        # first sample, where the periodic hann window is 0
        scale = float(ref.abs().max())
        np.testing.assert_allclose(grad.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale + 1e-8, err_msg=name)


def test_deconv_is_an_unflipped_conv():
    """flax's stride-1 ConvTranspose (transpose_kernel=False, padding 1)
    equals conv2d with the kernel as it is; the flipped kernel does not."""
    import flax.linen as fnn
    x = np.random.RandomState(2).randn(1, 5, 6, 3).astype(np.float32)
    layer = fnn.ConvTranspose(2, kernel_size=(3, 3), padding=((1, 1), (1, 1)))
    variables = layer.init(jax.random.PRNGKey(0), x)
    want = np.asarray(layer.apply(variables, x))
    kernel = np.asarray(variables['params']['kernel'])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bias = torch.from_numpy(np.array(variables['params']['bias']))

    def conv(k):
        w = torch.from_numpy(np.ascontiguousarray(k)).permute(3, 2, 0, 1)
        return torch.nn.functional.conv2d(xt, w, bias, padding=1) \
            .permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(conv(kernel), want, atol=1e-5, rtol=1e-5)
    assert np.abs(conv(kernel[::-1, ::-1]) - want).max() > 0.1


def test_scheduler_state_round_trips():
    model = ModelRegistry.get('tfgridnet')(**SMALL, learning_rate=1e-2,
                                           device='cpu')
    for value in (1.0, 1.1, 1.2, 1.3):
        assert model.on_validate(value) is None
    assert model.on_validate({'a': 0.7, 'b': 0.7}) == {'learning_rate': 5e-3}
    twin = ModelRegistry.get('tfgridnet')(**SMALL, device='cpu')
    twin.load_extra_state(model.extra_state())
    assert twin.scheduler.state_dict() == {'lr': 5e-3, 'best': 1.0,
                                           'num_bad': 0}
    with pytest.raises(NotImplementedError, match='emb_ks'):
        ModelRegistry.get('tfgridnet')(**SMALL, emb_hs=2, device='cpu')
