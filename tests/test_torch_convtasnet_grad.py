"""The port's Conv-TasNet training loss and gradients against the JAX
package's: one set of flax weights (brever_tpu_torch.convert), one padded
numpy batch with a row of length 0, per-item loss and the gradient of
every parameter against ``jax.grad`` of ``ConvTasNet.loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch.convert import flax_to_state_dict
from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.models.base import sample_weighted_mean

SMALL = dict(filters=64, filter_length=16, bottleneck_channels=32,
             hidden_channels=64, skip_channels=32, layers=2, repeats=2)


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
    return jax_model, params, model, batch, lengths


def test_loss_matches_jax(twins):
    jax_model, params, model, batch, lengths = twins
    want = np.asarray(jax_model.loss({'params': params}, jnp.asarray(batch),
                                     jnp.asarray(lengths), None))
    with torch.no_grad():
        got = model.loss(torch.from_numpy(batch), torch.from_numpy(lengths))
    assert got.shape == (3,)
    np.testing.assert_allclose(got[:2].numpy(), want[:2], rtol=1e-4,
                               atol=1e-4)


def test_gradients_match_jax(twins):
    jax_model, params, model, batch, lengths = twins

    def loss(p):
        per_item = jax_model.loss({'params': p}, jnp.asarray(batch),
                                  jnp.asarray(lengths), None)
        return jax_mean(per_item, jnp.asarray(lengths))

    want = flax_to_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    n = torch.from_numpy(lengths)
    model.zero_grad()
    sample_weighted_mean(model.loss(torch.from_numpy(batch), n), n).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, ref in want.items():
        grad = got[name].grad
        assert grad is not None, name
        scale = float(ref.abs().max())
        np.testing.assert_allclose(grad.numpy(), ref.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_optimizer_and_criterion_from_config():
    model = ModelRegistry.get('convtasnet')(**SMALL, criterion='sisnr',
                                            learning_rate=3e-4,
                                            device='cpu')
    assert model.criterion.__name__ == 'sisnr'
    assert model.optimizer().learning_rate == 3e-4
    assert model.grad_clip == 5.0
    with pytest.raises(NotImplementedError, match='adam'):
        ModelRegistry.get('convtasnet')(**SMALL, optimizer='sgd',
                                        device='cpu').optimizer()
