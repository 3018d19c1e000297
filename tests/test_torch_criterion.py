"""The port's criteria and validation metrics (brever_tpu_torch.criterion,
.metrics, .models.base.sample_weighted_mean) against the JAX package's on
the same ragged numpy batches, one row of length 0 included; multiresyu
with its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brever_tpu import criterion as jax_criterion
from brever_tpu import metrics as jax_metrics
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch import criterion, metrics
from brever_tpu_torch.models.base import sample_weighted_mean

LENGTHS = np.array([300, 211, 0, 157], np.int32)


def _batch(sources, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, sources, 300).astype(np.float32)
    y = (0.5 * x + rng.randn(4, sources, 300)).astype(np.float32)
    return x, y


def _both(fn_name, x, y, lengths=LENGTHS, **kwargs):
    want = np.asarray(jax_criterion.CriterionRegistry.get(fn_name)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths), **kwargs))
    got = criterion.CriterionRegistry.get(fn_name)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(lengths),
        **{k: torch.from_numpy(v) for k, v in kwargs.items()}).numpy()
    return got, want


@pytest.mark.parametrize('sources', [1, 2])
def test_sisnr_matches_jax(sources):
    """Permutation-invariant for two sources; padding neutral."""
    got, want = _both('sisnr', *_batch(sources))
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('shape', [(4, 300), (4, 1, 300), (4, 2, 300)])
def test_snr_matches_jax(shape):
    x, y = _batch(2)
    x, y = x.reshape(-1)[:np.prod(shape)].reshape(shape), \
        y.reshape(-1)[:np.prod(shape)].reshape(shape)
    got, want = _both('snr', x, y)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('weighted', [False, True])
def test_mse_matches_jax(weighted):
    kwargs = {'weight': np.array([1.0, 0.5, 2.0, 0.1], np.float32)} \
        if weighted else {}
    got, want = _both('mse', *_batch(2), **kwargs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_padding_is_neutral():
    """A padded row scores as the same row cut to its length."""
    x, y = _batch(1)
    n = int(LENGTHS[1])
    full = criterion.snr(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(LENGTHS))[1]
    alone = criterion.snr(torch.from_numpy(x[1:2, :, :n]),
                          torch.from_numpy(y[1:2, :, :n]),
                          torch.tensor([n]))[0]
    torch.testing.assert_close(full, alone)


def test_sample_weighted_mean_drops_empty_rows():
    per_item = np.array([1.0, 2.0, 100.0, 4.0], np.float32)
    got = sample_weighted_mean(torch.from_numpy(per_item),
                               torch.from_numpy(LENGTHS))
    want = jax_mean(jnp.asarray(per_item), jnp.asarray(LENGTHS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(float(got) - 7 / 3) < 1e-6
    zero = sample_weighted_mean(torch.ones(2), torch.zeros(2))
    assert float(zero) == 0.0


@pytest.mark.parametrize('name', ['snr', 'sisnr'])
def test_metrics_match_jax(name):
    x, y = _batch(1, seed=3)
    x, y = x[:, 0], y[:, 0]
    want = np.asarray(jax_metrics.MetricRegistry.get(name)(x, y, LENGTHS))
    got = metrics.MetricRegistry.get(name)(x, y, LENGTHS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    one = metrics.MetricRegistry.get(name)(x[0], y[0])
    assert isinstance(one, float)
    assert abs(one - float(got[0])) < 1e-4


def test_unported_names_raise():
    # every name of the JAX registry is ported (the host twins of stoi,
    # estoi and pesq since the slice that ported them); an unknown name
    # raises
    with pytest.raises(KeyError, match='registry'):
        metrics.check_metrics({'snr', 'no_such_metric'})
    metrics.check_metrics({'snr', 'sisnr', 'pesq', 'pesq_approx', 'stoi',
                           'estoi'})
    # multiresyu was refused until the STFT was ported; it computes now
    loss = criterion.init_criterion('multiresyu', frame_lengths=[512])
    out = loss(torch.zeros(1, 1, 8), torch.zeros(1, 1, 8), torch.tensor([8]))
    assert out.shape == (1,) and float(out) == 0.0


MULTIRES = [dict(), dict(frame_lengths=[256, 512], scale_invariant=True),
            dict(frame_lengths=[128], hop_lengths=[32],
                 time_domain_weight=0.2, spectral_weight=0.8)]


@pytest.mark.parametrize('kwargs', MULTIRES, ids=['default', 'two-res-si',
                                                  'weighted'])
@pytest.mark.parametrize('shape', [(4, 1200), (4, 2, 1200)])
def test_multiresyu_matches_jax(kwargs, shape):
    """Boxcar STFT magnitudes (normalized=False, hop f/2 by default) plus
    time-domain L1, over max(lengths, 1); a row of length 0 scores 0."""
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    y = (0.5 * x + rng.randn(*shape)).astype(np.float32)
    lengths = np.array([1200, 911, 0, 517], np.int32)
    want = np.asarray(jax_criterion.init_criterion('multiresyu', **kwargs)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths)))
    got = criterion.init_criterion('multiresyu', **kwargs)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(lengths))
    assert got.shape == (4,) and float(got[2]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_multiresyu_gradient_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 1, 1000).astype(np.float32)
    y = rng.randn(3, 1, 1000).astype(np.float32)
    lengths = np.array([1000, 0, 640], np.int32)
    loss = jax_criterion.init_criterion('multiresyu')
    want = np.asarray(jax.grad(lambda v: loss(
        v, jnp.asarray(y), jnp.asarray(lengths)).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    criterion.init_criterion('multiresyu')(
        xt, torch.from_numpy(y), torch.from_numpy(lengths)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert not xt.grad[1].any()
