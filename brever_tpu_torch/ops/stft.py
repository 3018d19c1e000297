"""Short-time Fourier transform and its overlap-add inverse (counterpart of
``STFT`` in ``brever_tpu/ops/stft.py``).

The contract is the JAX package's:

* the input is right-padded to whole frames,
  ``frames = ceil(max(n - frame_length, 0) / hop) + 1``, then padded by
  ``n_fft // 2`` on both sides when ``center``, with zeros or, with
  ``pad_mode='reflect'``, the signal's reflection;
* the window (``scipy.signal.get_window``, periodic) has ``frame_length``
  taps, centred in an FFT frame of ``n_fft`` (default ``frame_length``)
  samples; frames of ``n_fft`` samples are windowed and go through
  ``torch.fft.rfft``;
* ``normalized`` divides by ``sqrt(sum(window ** 2))``, then magnitude
  compression ``|X| ** c * exp(j angle(X))`` and ``scale_factor``;
* the inverse is the overlap-add of the windowed inverse FFT, divided by
  the overlap-added squared window where that exceeds 1e-11, and trimmed.

The FFT runs outside any kernel (cuFFT on the card), as the JAX package
leaves it to XLA: that is ``backend='auto'``, differentiable. With
``backend='pallas'`` and ``hop_length`` dividing ``n_fft`` (the JAX
package's eligibility), the forward is the fused STFT kernel K9
(``ops/stft_kernel.py``: framing, window and DFT as one product against the
windowed basis; its plain version on the CPU), which has no backward, as in
the JAX package: it raises if the input requires grad. The onesided complex
spectrum only; ``ConvSTFT`` is not ported.

``MelFilterbank`` (FFNN's) is the JAX package's triangular HTK filterbank,
built on the host in numpy float32 bit for bit and applied as a matrix
product.
"""

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from .stft_kernel import stft_basis, stft_fused


def overlap_add(frames, hop_length, out_length):
    """Overlap-add ``(..., T, L)`` frames into ``(..., out_length)``: the
    frames' ``ceil(L / hop)`` hop-sized pieces are summed in the JAX
    package's order, piece 0 first."""
    *batch, n_frames, frame_length = frames.shape
    n_chunks = -(-frame_length // hop_length)
    padded_len = (n_frames + n_chunks) * hop_length
    frames = F.pad(frames, (0, n_chunks * hop_length - frame_length))
    chunks = frames.reshape(*batch, n_frames, n_chunks, hop_length)
    out = frames.new_zeros((*batch, padded_len))
    for k in range(n_chunks):
        seg = chunks[..., k, :].reshape(*batch, n_frames * hop_length)
        out = out + F.pad(seg, (k * hop_length,
                                padded_len - (k + n_frames) * hop_length))
    return out[..., :out_length]


def compress(x, factor):
    """Magnitude compression ``|x| ** factor * exp(1j angle(x))``."""
    mag = x.abs() ** factor
    theta = torch.atan2(x.imag, x.real)
    return torch.complex(mag * torch.cos(theta), mag * torch.sin(theta))


class STFT:
    """STFT/iSTFT with compression; ``forward`` ``(..., n)`` ->
    ``(..., bins, frames)`` complex, ``backward`` the inverse. ``window``
    is a ``scipy.signal.get_window`` name, ``None`` for boxcar."""

    def __init__(self, frame_length=512, hop_length=256, window='hann',
                 center=True, pad_mode='constant', normalized=True,
                 compression_factor=1, scale_factor=1, n_fft=None,
                 backend='auto'):
        if pad_mode not in ('constant', 'reflect'):
            raise ValueError(f'pad_mode {pad_mode!r}: constant or reflect')
        self.frame_length = frame_length
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.normalized = normalized
        self.compression_factor = compression_factor
        self.scale_factor = scale_factor
        self.n_fft = frame_length if n_fft is None else n_fft
        self.backend = backend
        window = scipy.signal.get_window(window or 'boxcar', frame_length) \
            .astype(np.float32)
        if self.n_fft > frame_length:
            # the analysis window centred in the FFT frame
            left = (self.n_fft - frame_length) // 2
            window = np.pad(window, (left, self.n_fft - frame_length - left))
        self._np_window = window
        self._win_norm = float(np.sqrt(np.sum(
            self._np_window.astype(np.float64) ** 2)))
        self._windows = {}
        self._bases = {}

    def _cached(self, cache, make, like):
        """The array ``make()`` returns, as a tensor of ``like``'s real dtype
        (float32 for bfloat16, as the JAX package's float32 window widens a
        bfloat16 signal's frames) and device; ``make`` runs only when the
        cache lacks that pair."""
        dtype = like.real.dtype if like.is_complex() else like.dtype
        if dtype == torch.bfloat16:
            dtype = torch.float32
        key = (dtype, like.device)
        if key not in cache:
            # a normal tensor even when first made under inference mode,
            # so that a later autograd pass may save it
            with torch.inference_mode(False):
                cache[key] = torch.as_tensor(make()).to(dtype=dtype,
                                                        device=like.device)
        return cache[key]

    def window(self, like):
        """The window (``n_fft`` taps) as a tensor of ``like``'s real dtype
        and device."""
        return self._cached(self._windows, lambda: self._np_window, like)

    @property
    def fused(self):
        """Whether the forward runs K9: ``backend='pallas'`` with ``hop``
        dividing ``n_fft`` (the JAX package's eligibility; otherwise the
        cuFFT path)."""
        return self.backend == 'pallas' \
            and self.n_fft % self.hop_length == 0

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        x = self.pad(x)
        if self.center:
            half = self.n_fft // 2
            if self.pad_mode == 'reflect':
                lead = x.shape[:-1]
                x = F.pad(x.reshape(-1, 1, x.shape[-1]), (half, half),
                          mode='reflect').reshape(*lead, -1)
            else:
                x = F.pad(x, (half, half))
        if self.fused and not x.is_complex():
            spec = self._fused_forward(x)
        else:
            frames = x.unfold(-1, self.n_fft, self.hop_length) \
                * self.window(x)
            spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
        if self.normalized:
            spec = spec / self._win_norm
        if self.compression_factor != 1:
            spec = compress(spec, self.compression_factor)
        return spec * self.scale_factor

    def _fused_forward(self, x):
        """K9 over the padded signal: ``(..., bins, frames)`` complex."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                'STFT(backend=\'pallas\'): the fused STFT kernel has no '
                'backward (nor has the JAX package\'s); use backend=\'auto\''
                ' under autograd')
        lead, n = x.shape[:-1], x.shape[-1]
        basis = self._cached(
            self._bases, lambda: stft_basis(self.n_fft, self._np_window), x)
        out = stft_fused(x.reshape(-1, n).contiguous(), basis,
                         self.hop_length)
        bins = self.n_fft // 2 + 1
        spec = torch.complex(out[..., :bins], out[..., bins:])
        return spec.transpose(-1, -2).reshape(*lead, bins, out.shape[1])

    def backward(self, x):
        x = x / self.scale_factor
        if self.compression_factor != 1:
            x = compress(x, 1 / self.compression_factor)
        if self.normalized:
            x = x * self._win_norm
        # (..., frames, bins), contiguous: cuFFT's C2R transform takes the
        # transformed axis dense
        frames = torch.fft.irfft(x.transpose(-1, -2).contiguous(),
                                 n=self.n_fft, dim=-1)
        window = self.window(frames)
        n_frames = frames.shape[-2]
        out_length = (n_frames - 1) * self.hop_length + self.n_fft
        num = overlap_add(frames * window, self.hop_length, out_length)
        den = overlap_add((window ** 2).expand(n_frames, -1),
                          self.hop_length, out_length)
        y = num / torch.where(den > 1e-11, den, torch.ones_like(den))
        if self.center:
            half = self.n_fft // 2
            y = y[..., half:out_length - half]
        return y

    def pad(self, x):
        """Right-pad so the signal holds a whole number of frames."""
        n = x.shape[-1]
        padding = (self.frame_count(n) - 1) * self.hop_length \
            + self.frame_length - n
        return F.pad(x, (0, padding))

    def frame_count(self, samples):
        """Frame count before the center padding is applied."""
        return math.ceil(max(samples - self.frame_length, 0)
                         / self.hop_length) + 1


def fft_freqs(fs=16e3, n_fft=512):
    """The centre frequencies of ``np.fft.rfft``'s bins (float64)."""
    freqs = np.arange(n_fft) * fs / n_fft
    return freqs[freqs <= fs / 2]


class MelFilterbank:
    """Triangular mel filterbank (HTK formula), area-normalised
    (counterpart of ``MelFilterbank`` in ``brever_tpu/ops/stft.py``; the
    filters are built in numpy float32 as there, bit for bit).

    ``forward`` maps ``(..., bins, frames)`` to mel bands, ``filters @ x``;
    ``backward`` maps bands back to bins through ``(filters * scaling).T``,
    the filters without their area normalisation (not a pseudo-inverse)."""

    def __init__(self, n_filters=64, n_fft=512, fs=16e3, fmin=50, fmax=8000):
        self.n_filters = n_filters
        self.n_fft = n_fft
        self.fs = fs
        self.fmin = fmin
        self.fmax = fmax
        filters, fc, scaling = self._build()
        self.filters = filters
        self.fc = fc
        self.scaling = scaling
        self.inverse_filters = (filters * scaling).T
        self._cache = {}

    def _build(self):
        mel_lims = [self.freq_to_mel(f) for f in (self.fmin, self.fmax)]
        mel = np.linspace(*mel_lims, self.n_filters + 2)
        fc = self.mel_to_freq(mel)
        f = fft_freqs(self.fs, self.n_fft).astype(np.float32)
        filters = np.zeros((self.n_filters, len(f)), dtype=np.float32)
        for i in range(1, self.n_filters + 1):
            rising = (fc[i - 1] <= f) & (f <= fc[i])
            filters[i - 1, rising] = \
                (f[rising] - fc[i - 1]) / (fc[i] - fc[i - 1])
            falling = (fc[i] <= f) & (f <= fc[i + 1])
            filters[i - 1, falling] = \
                (fc[i + 1] - f[falling]) / (fc[i + 1] - fc[i])
        scaling = filters.sum(axis=1, keepdims=True)
        filters = filters / scaling
        return filters, fc, scaling

    @staticmethod
    def mel_to_freq(mel):
        return 700 * (10**(mel / 2595) - 1)

    @staticmethod
    def freq_to_mel(f):
        return 2595 * math.log10(1 + f / 700)

    def _matrix(self, which, like):
        """``filters`` or ``inverse_filters`` as a tensor of ``like``'s real
        dtype on its device (cached)."""
        dtype = like.real.dtype if like.is_complex() else like.dtype
        key = (which, dtype, like.device)
        if key not in self._cache:
            with torch.inference_mode(False):
                self._cache[key] = torch.as_tensor(
                    getattr(self, which)).to(dtype=dtype, device=like.device)
        return self._cache[key]

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        return torch.matmul(self._matrix('filters', x), x)

    def backward(self, x):
        return torch.matmul(self._matrix('inverse_filters', x), x)
