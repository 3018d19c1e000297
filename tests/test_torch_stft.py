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


# MANNER's loss resolutions (n_fft, hop, frame_length): the window centred
# in a longer FFT frame, reflect padding, no normalisation
MANNER = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]


@pytest.mark.parametrize('n_fft,hop,win', MANNER,
                         ids=[f'{r[0]}-{r[1]}-{r[2]}' for r in MANNER])
def test_manner_resolutions_match_jax(n_fft, hop, win):
    config = dict(frame_length=win, hop_length=hop, n_fft=n_fft,
                  window='hann', center=True, pad_mode='reflect',
                  normalized=False)
    x = np.random.RandomState(n_fft).randn(3, 4000).astype(np.float32)
    want = np.asarray(JaxSTFT(**config)(jnp.asarray(x)))
    stft = STFT(**config)
    got = stft(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)
    # the inverse of the JAX spectrum
    want_y = np.asarray(JaxSTFT(**config).backward(jnp.asarray(want)))
    got_y = stft.backward(torch.from_numpy(np.array(want))).numpy()
    np.testing.assert_allclose(got_y, want_y, atol=1e-5, rtol=0)


@pytest.mark.parametrize('n_fft,hop', [(256, 128), (512, 128), (400, 100)])
def test_fused_backend_plain_version_matches_jax(n_fft, hop):
    """``backend='pallas'`` on the CPU runs ``stft_basis_plain`` (framing,
    then the product against the windowed basis): TF-GridNet's 256/128,
    DCCRN's and SGMSE+'s 512/128 and 400/100 (an n_fft that K9 takes on its
    dense route) against the JAX ``STFT(backend='auto')`` (its rFFT), atol
    1e-4 of the spectrum's largest magnitude."""
    from brever_tpu_torch.ops import stft_kernel
    x = np.random.RandomState(hop).randn(2, 2, 5000).astype(np.float32)
    want = np.asarray(JaxSTFT(frame_length=n_fft, hop_length=hop,
                              backend='auto')(jnp.asarray(x)))
    stft = STFT(frame_length=n_fft, hop_length=hop, backend='pallas')
    assert stft.fused
    got = stft(torch.from_numpy(x)).numpy()
    bound = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    padded = torch.nn.functional.pad(stft.pad(torch.from_numpy(x[0])),
                                     (n_fft // 2, n_fft // 2))
    basis = torch.from_numpy(stft_kernel.stft_basis(n_fft,
                                                    stft._np_window))
    direct = stft_kernel.stft_basis_plain(padded, basis, hop).numpy()
    bins = n_fft // 2 + 1
    direct = (direct[..., :bins] + 1j * direct[..., bins:]) \
        .transpose(0, 2, 1) / stft._win_norm
    np.testing.assert_allclose(direct, want[0], atol=bound, rtol=0)


def test_fused_backend_refuses_grad_and_keeps_eligibility():
    """K9 has no backward: an input that requires grad raises. With hop not
    dividing n_fft the JAX package's ``backend='pallas'`` takes its FFT
    path, and so does the port."""
    x = torch.randn(2, 3000, requires_grad=True)
    with pytest.raises(NotImplementedError, match='no backward'):
        STFT(frame_length=512, hop_length=128, backend='pallas')(x)
    with torch.no_grad():
        STFT(frame_length=512, hop_length=128, backend='pallas')(x)
    odd = STFT(frame_length=512, hop_length=120, backend='pallas')
    assert not odd.fused
    torch.testing.assert_close(
        odd(x), STFT(frame_length=512, hop_length=120)(x))


# ---------------------------------------------------------------------------
# K9's FFT route: its route rule, twiddles and pass schedule


@pytest.mark.parametrize('n_fft', [8, 16, 32, 64, 128, 256, 400, 512, 1000,
                                   1024, 2048, 4096, 6000, 8192])
def test_fft_route_takes_the_powers_of_two_from_16_to_4096(n_fft):
    """The FFT route takes a power of two from 16 to 4096 and every other
    n_fft the dense route; its passes multiply to n_fft / 2, radix 8 first
    (8, 8, 4 at 512)."""
    from brever_tpu_torch.ops import stft_kernel
    power = n_fft & (n_fft - 1) == 0
    want = 'fft' if power and 16 <= n_fft <= 4096 else 'dense'
    assert stft_kernel.fft_route(n_fft) == want
    if want == 'fft':
        radices = stft_kernel.fft_radices(n_fft)
        assert int(np.prod(radices)) == n_fft // 2
        assert radices == sorted(radices, reverse=True) and radices[0] == 8
        assert radices.count(4) + radices.count(2) <= 1
    assert stft_kernel.fft_radices(512) == [8, 8, 4]


@pytest.mark.parametrize('n_fft', [16, 256, 512, 4096])
def test_fft_twiddles_are_the_roots_of_unity(n_fft):
    """The host-built float32 table holds exp(-2 pi i m / n_fft) to 1e-7."""
    from brever_tpu_torch.ops import stft_kernel
    table = stft_kernel.fft_twiddles(n_fft)
    assert table.shape == (n_fft, 2) and table.dtype == np.float32
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    np.testing.assert_allclose(table[:, 0], want.real, rtol=0, atol=1e-7)
    np.testing.assert_allclose(table[:, 1], want.imag, rtol=0, atol=1e-7)


def _fft_schedule(x, window, hop):
    """The FFT route's arithmetic in plain torch, stage for stage as
    ``stft_fft_kernel`` runs it: frames windowed and packed as n_fft / 2
    complex values (even samples real, odd imaginary), the Stockham passes
    of ``fft_radices`` with the twiddles of ``fft_twiddles`` (pass of
    radix R after sub-transforms of length ns: value r of butterfly j is
    read at j + r N / R, twiddled by W^(r (j mod ns)), and output s of its
    DFT written at (j - j mod ns) R + j mod ns + s ns), then the real
    split of bins 0 .. N. Returns ``(rows, frames, 2 bins)``."""
    from brever_tpu_torch.ops import stft_kernel
    n_fft = window.shape[0]
    half = n_fft // 2
    table = torch.from_numpy(stft_kernel.fft_twiddles(n_fft))
    tw = torch.complex(table[:, 0], table[:, 1])
    frames = x.unfold(-1, n_fft, hop) * window
    z = torch.complex(frames[..., 0::2], frames[..., 1::2])
    ns = 1
    for radix in stft_kernel.fft_radices(n_fft):
        j = torch.arange(half // radix)
        k = j % ns
        r = torch.arange(radix)
        vals = z[..., j[:, None] + r * (half // radix)]
        vals = vals * tw[(r * k[:, None]) * (n_fft // (ns * radix))]
        dft = tw[(r[:, None] * r) % radix * (n_fft // radix)]
        out = vals @ dft
        z = torch.empty_like(z)
        z[..., ((j - k) * radix + k)[:, None] + r * ns] = out
        ns *= radix
    k = torch.arange(half + 1)
    a, b = z[..., k % half], z[..., (half - k) % half].conj()
    spec = (a + b) / 2 - 0.5j * tw[k] * (a - b)
    return torch.cat([spec.real, spec.imag], dim=-1)


@pytest.mark.parametrize('n_fft', [16, 256, 512, 4096])
def test_fft_schedule_matches_rfft_and_the_plain_version(n_fft):
    """The FFT route's schedule (the mirror above, in float32) against
    ``np.fft.rfft`` of the windowed frames in float64 and against
    ``stft_basis_plain``, atol 1e-5 of the spectrum's largest magnitude."""
    from brever_tpu_torch.ops import stft_kernel
    hop = n_fft // 4
    rng = np.random.RandomState(n_fft)
    x = rng.randn(2, n_fft + 7 * hop).astype(np.float32)
    window = STFT(frame_length=n_fft, hop_length=hop)._np_window
    got = _fft_schedule(torch.from_numpy(x), torch.from_numpy(window),
                        hop).numpy()
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=-1)
    ref = np.fft.rfft(frames[:, ::hop].astype(np.float64) * window, axis=-1)
    ref = np.concatenate([ref.real, ref.imag], axis=-1)
    bound = 1e-5 * np.abs(ref).max()
    assert got.shape == ref.shape == (2, 8, n_fft + 2)
    np.testing.assert_allclose(got, ref, atol=bound, rtol=0)
    basis = torch.from_numpy(stft_kernel.stft_basis(n_fft, window))
    assert torch.equal(basis[:, 0], torch.from_numpy(window))
    plain = stft_kernel.stft_basis_plain(torch.from_numpy(x), basis,
                                         hop).numpy()
    np.testing.assert_allclose(got, plain, atol=bound, rtol=0)
