"""Short-time Fourier transform and its overlap-add inverse (counterpart of
``STFT`` in ``brever_tpu/ops/stft.py``).

The contract is the JAX package's:

* the input is right-padded to whole frames,
  ``frames = ceil(max(n - frame_length, 0) / hop) + 1``, then padded by
  ``frame_length // 2`` zeros on both sides when ``center``;
* frames are windowed (``scipy.signal.get_window``, periodic) and go
  through ``torch.fft.rfft``;
* ``normalized`` divides by ``sqrt(sum(window ** 2))``, then magnitude
  compression ``|X| ** c * exp(j angle(X))`` and ``scale_factor``;
* the inverse is the overlap-add of the windowed inverse FFT, divided by
  the overlap-added squared window where that exceeds 1e-11, and trimmed.

The FFT runs outside any kernel here, as the JAX package leaves it to
XLA. Only what the port's callers set is ported (TF-GridNet, SGMSE+ with
its compression and scale, DCCRN with the normalised window, and the
multiresyu loss): the onesided complex spectrum, constant center padding
and a named window; the other options of the JAX ``STFT``, its opt-in
Pallas backend (``backend='pallas'``, the TPU kernel K9) and ``ConvSTFT``
are not ported yet. Every operation is differentiable.
"""

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F


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
                 center=True, normalized=True, compression_factor=1,
                 scale_factor=1):
        self.frame_length = frame_length
        self.hop_length = hop_length
        self.center = center
        self.normalized = normalized
        self.compression_factor = compression_factor
        self.scale_factor = scale_factor
        window = scipy.signal.get_window(window or 'boxcar', frame_length)
        self._np_window = window.astype(np.float32)
        self._win_norm = float(np.sqrt(np.sum(
            self._np_window.astype(np.float64) ** 2)))
        self._windows = {}

    def window(self, like):
        """The window as a tensor of ``like``'s real dtype and device."""
        dtype = like.real.dtype if like.is_complex() else like.dtype
        key = (dtype, like.device)
        if key not in self._windows:
            # a normal tensor even when first made under inference mode,
            # so that a later autograd pass may save it
            with torch.inference_mode(False):
                self._windows[key] = torch.as_tensor(self._np_window).to(
                    dtype=dtype, device=like.device)
        return self._windows[key]

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        x = self.pad(x)
        if self.center:
            half = self.frame_length // 2
            x = F.pad(x, (half, half))
        frames = x.unfold(-1, self.frame_length, self.hop_length) \
            * self.window(x)
        spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
        if self.normalized:
            spec = spec / self._win_norm
        if self.compression_factor != 1:
            spec = compress(spec, self.compression_factor)
        return spec * self.scale_factor

    def backward(self, x):
        x = x / self.scale_factor
        if self.compression_factor != 1:
            x = compress(x, 1 / self.compression_factor)
        if self.normalized:
            x = x * self._win_norm
        # (..., frames, bins), contiguous: cuFFT's C2R transform takes the
        # transformed axis dense
        frames = torch.fft.irfft(x.transpose(-1, -2).contiguous(),
                                 n=self.frame_length, dim=-1)
        window = self.window(frames)
        n_frames = frames.shape[-2]
        out_length = (n_frames - 1) * self.hop_length + self.frame_length
        num = overlap_add(frames * window, self.hop_length, out_length)
        den = overlap_add((window ** 2).expand(n_frames, -1),
                          self.hop_length, out_length)
        y = num / torch.where(den > 1e-11, den, torch.ones_like(den))
        if self.center:
            half = self.frame_length // 2
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
