"""Acoustic features of a binaural complex STFT (counterpart of
``brever_tpu/ops/features.py``): the twelve of the reference's family,
filterbank energies with normalisation, compression and DCT variants
(``fbe``, ``logfbe``, ``cubicfbe``, ``pdf``, ``logpdf``, ``cubicpdf``,
``mfcc``, ``cubicmfcc``, ``pdfcc``) and the binaural cues (``ild``,
``ipd``, ``ic``).

Plain torch, as the JAX package leaves these to XLA: the mel filterbank and
the DCT are matrix products (the DCT matrix built with scipy on the host),
the deltas zero-padded at the front. The exponential smoothing of ``ic``,
a ``jax.lax.associative_scan`` there, is a doubling scan over frames here:
ceil(log2 T) steps, each adding ``alpha ** d`` times the signal shifted by
``d`` frames (d = 1, 2, 4, ...).
"""

import math

import numpy as np
import scipy.fft
import torch
import torch.nn.functional as F

#: the JAX package's ``utils.eps``
eps = float(np.finfo(np.float32).eps)


def dct_matrix(n, n_out=None, dct_type=2, norm='ortho'):
    """The DCT as an ``(n_out, n)`` float32 matrix; rows are the output
    coefficients."""
    mat = scipy.fft.dct(np.eye(n), axis=0, type=dct_type, norm=norm).T
    if n_out is not None:
        mat = mat[:n_out]
    return mat.astype(np.float32)


def first_order_smooth(x, alpha, dim=-1):
    """``y[t] = (1 - alpha) x[t] + alpha y[t - 1]`` along ``dim`` from a
    zero state, as a doubling scan: after the step with offset ``d`` every
    ``y[t]`` holds the recurrence over the last ``2 d`` inputs, so
    ``ceil(log2 T)`` elementwise steps finish it. Each step multiplies by
    ``alpha ** d``, which only shrinks."""
    y = (1 - alpha) * x.movedim(dim, -1)
    n, d = y.shape[-1], 1
    while d < n:
        y = y + F.pad(alpha ** d * y[..., :n - d], (d, 0))
        d *= 2
    return y.movedim(-1, dim)


class FeatureExtractor:
    """A sorted, concatenated feature stack of a complex STFT: input
    ``(batch, 2 channels, bins, frames)`` (or ``(2, bins, frames)``), output
    ``(batch, n_features, frames)``. ``indices`` holds each feature's rows
    after a call."""

    def __init__(self, features, mel_fb, hop_length=256, fs=16e3):
        self.features = sorted(features)
        self.mel_fb = mel_fb
        self.hop_length = hop_length
        self.fs = fs
        self.indices = None
        n_mel = mel_fb.n_filters
        n_cc = 13 * 3
        self._feature_dict = {
            'ild': (self.ild, n_mel),
            'ipd': (self.ipd, n_mel),
            'ic': (self.ic, n_mel),
            'fbe': (self.fbe, n_mel),
            'logfbe': (lambda x: self.fbe(x, compression='log'), n_mel),
            'cubicfbe': (lambda x: self.fbe(x, compression='cubic'), n_mel),
            'pdf': (lambda x: self.fbe(x, normalize=True), n_mel),
            'logpdf': (lambda x: self.fbe(x, normalize=True,
                                          compression='log'), n_mel),
            'cubicpdf': (lambda x: self.fbe(x, normalize=True,
                                            compression='cubic'), n_mel),
            'mfcc': (lambda x: self.fbe(x, compression='log', dct=True),
                     n_cc),
            'cubicmfcc': (lambda x: self.fbe(x, compression='cubic',
                                             dct=True), n_cc),
            'pdfcc': (lambda x: self.fbe(x, normalize=True,
                                         compression='log', dct=True), n_cc),
        }
        self._dct = {}

    def __call__(self, x):
        output = []
        self.indices = {}
        i_start = 0
        for feature in self.features:
            data = self.calc_feature(x, feature)
            output.append(data)
            i_end = i_start + data.shape[-2]
            self.indices[feature] = (i_start, i_end)
            i_start = i_end
        return torch.cat(output, dim=-2)

    def _info(self, feature):
        try:
            return self._feature_dict[feature]
        except KeyError:
            raise ValueError(f'unrecognized feature, got {feature}') from None

    @property
    def n_features(self):
        return sum(self._info(f)[1] for f in self.features)

    def calc_feature(self, x, feature):
        unbatched = x.ndim == 3
        if unbatched:
            x = x[None]
        elif x.ndim != 4:
            raise ValueError(f'input must be 3 or 4 dimensional, got {x.ndim}')
        out = self._info(feature)[0](x)
        return out[0] if unbatched else out

    def _dct_matrix(self, n, dct_type, norm, like):
        key = (n, dct_type, norm, like.dtype, like.device)
        if key not in self._dct:
            with torch.inference_mode(False):
                self._dct[key] = torch.as_tensor(
                    dct_matrix(n, dct_type=dct_type, norm=norm)).to(
                        dtype=like.dtype, device=like.device)
        return self._dct[key]

    def fbe(self, x, normalize=False, compression='none', dct=False,
            n_dct=14, dct_type=2, dct_norm='ortho', return_dc=False,
            return_deltas=True, return_double_deltas=True):
        """Filterbank energies and the MFCC/PDF family."""
        out = self.mel_fb((x.abs() ** 2).mean(dim=1))   # (B, bands, T)
        if normalize:
            out = out / (out.sum(dim=1, keepdim=True) + eps)
        if compression == 'log':
            out = torch.log(out + eps)
        elif compression == 'cubic':
            out = out ** (1 / 3)
        elif compression != 'none':
            raise ValueError('compression must be log, cubic or none, got '
                             f'{compression}')
        if dct:
            out = self._dct_matrix(out.shape[1], dct_type, dct_norm,
                                   out) @ out
            coeffs = out[:, 0:n_dct] if return_dc else out[:, 1:n_dct]
            parts = [coeffs]
            if return_deltas:
                parts.append(F.pad(torch.diff(coeffs, n=1, dim=2), (1, 0)))
            if return_double_deltas:
                parts.append(F.pad(torch.diff(coeffs, n=2, dim=2), (2, 0)))
            out = torch.cat(parts, dim=1)
        return out

    def ild(self, x):
        """Interaural level difference, mel-pooled."""
        mag = x.abs()
        return self.mel_fb(20 * torch.log10((mag[:, 1] + eps)
                                            / (mag[:, 0] + eps)))

    def ipd(self, x):
        """Interaural phase difference, mel-pooled."""
        phase = torch.angle(x)
        return self.mel_fb(phase[:, 1] - phase[:, 0])

    def ic(self, x, tau=10e-3):
        """Interaural coherence from exponentially smoothed cross-spectra
        (divided by ``phi_ll * phi_rr`` with no guard, as the JAX package
        divides)."""
        mag, phase = x.abs(), torch.angle(x)
        alpha = math.exp(-self.hop_length / (tau * self.fs))
        dphi = phase[:, 0] - phase[:, 1]
        cross = mag[:, 0] * mag[:, 1]
        stacked = torch.stack([mag[:, 0] ** 2, mag[:, 1] ** 2,
                               cross * torch.cos(dphi),
                               cross * torch.sin(dphi)])
        phi_ll, phi_rr, phi_lr_real, phi_lr_imag = first_order_smooth(
            stacked, alpha, dim=-1)
        coh = (phi_lr_real ** 2 + phi_lr_imag ** 2) / (phi_ll * phi_rr)
        return torch.sqrt(self.mel_fb(coh))
