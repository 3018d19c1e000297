"""The port's STFT (brever_tpu_torch.ops.stft) against the JAX package's
``brever_tpu.ops.STFT`` on the same numpy signals: forward spectra, the
overlap-add inverse of a given spectrum, and the round trip, at 256/128
hann (TF-GridNet) and 512/256 boxcar (the multiresyu loss), with lengths
that are not whole frames. float32 FFTs on both sides: atol 1e-4 on
spectra of magnitude up to ~30, 1e-5 on waveforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brever_tpu.ops import STFT as JaxSTFT
from brever_tpu_torch.ops.stft import STFT

CONFIGS = [dict(frame_length=256, hop_length=128, window='hann',
                normalized=False),
           dict(frame_length=512, hop_length=256, window=None,
                normalized=False),
           dict(frame_length=256, hop_length=128, window='hann',
                normalized=True, compression_factor=0.5, scale_factor=2.0)]
IDS = ['hann256', 'boxcar512', 'hann256-compressed']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('n', [1001, 4000])
@pytest.mark.parametrize('config', CONFIGS, ids=IDS)
def test_forward_matches_jax(config, n):
    x = np.random.RandomState(n).randn(2, 2, n).astype(np.float32)
    want = np.asarray(JaxSTFT(**config)(jnp.asarray(x)))
    got = STFT(**config)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.real, want.real, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.imag, want.imag, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('config', CONFIGS, ids=IDS)
def test_backward_matches_jax(config):
    bins = config['frame_length'] // 2 + 1
    rng = np.random.RandomState(1)
    spec = (rng.randn(2, bins, 17) + 1j * rng.randn(2, bins, 17)) \
        .astype(np.complex64)
    want = np.asarray(JaxSTFT(**config).backward(jnp.asarray(spec)))
    got = STFT(**config).backward(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('config', CONFIGS, ids=IDS)
def test_round_trip(config):
    x = np.random.RandomState(2).randn(3, 3333).astype(np.float32)
    stft = STFT(**config)
    y = stft.backward(stft(torch.from_numpy(x)))[..., :3333].numpy()
    np.testing.assert_allclose(y, x, atol=1e-5, rtol=2e-3)


def test_gradient_flows():
    """Magnitudes of the STFT are differentiable (the loss takes them)."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1000)) \
        .requires_grad_()
    stft = STFT(512, 256, window=None, normalized=False)
    assert torch.autograd.gradcheck(
        lambda v: stft(v).abs().sum(dim=(-2, -1)), (x,), eps=1e-6,
        atol=1e-5)
