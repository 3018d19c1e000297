"""STOI / ESTOI host twins (counterpart of ``brever_tpu/stoi.py``): float64
numpy, pystoi's numerics, on the port's own tables
(:mod:`brever_tpu_torch.metric_tables`).

Taal et al. (ICASSP 2011) and the extended variant (Jensen & Taal, TASLP
2016): the Octave-compatible kaiser-window resampler to 10 kHz, frames laid
out as ``range(0, len(x) - frame, hop)`` (the exactly-fitting final frame is
dropped), silent frames of the clean signal removed (40 dB range), 15
third-octave bands from 150 Hz, 384 ms segments, and 1e-5 with a warning on
signals with fewer than 30 frames after silence removal. As in the JAX
package, ESTOI's normalisation is deterministic (pystoi adds eps-scaled
noise; the difference is ~1e-8).

:func:`stoi_batch` scores the items of a padded batch one by one through the
persistent spawn pool of :mod:`brever_tpu_torch.pesq` (serially where it
declines), or, with ``BREVER_STOI_VEC=1``, through
:func:`stoi_batch_vectorized`, one numpy pipeline over the batch.

numpy and scipy only, no torch: the pool's spawned workers import this
module, and a worker that imported torch would pay its start-up for
nothing.
"""

import os
import warnings

import numpy as np
import scipy.signal

from .metric_tables import EPS
from .metric_tables import OBM as _OBM
from .metric_tables import STOI_BETA as _STOI_BETA
from .metric_tables import STOI_DYN_RANGE as _STOI_DYN_RANGE
from .metric_tables import STOI_FRAME as _STOI_FRAME
from .metric_tables import STOI_FS as _STOI_FS
from .metric_tables import STOI_HOP as _STOI_HOP
from .metric_tables import STOI_NBANDS as _STOI_NBANDS
from .metric_tables import STOI_NFFT as _STOI_NFFT
from .metric_tables import STOI_SEG as _STOI_SEG
from .metric_tables import WIN as _WIN
from .metric_tables import resample_window_oct as _resample_window_oct


def _resample_oct(x, p, q):
    h = _resample_window_oct(p, q)
    return scipy.signal.resample_poly(x, p, q, window=h / np.sum(h))


def _frame(x, frame_len, hop):
    # pystoi frames with range(0, len(x) - frame_len, hop): a frame
    # that fits exactly at the end is dropped — replicated for parity
    n_frames = max(int(np.ceil((len(x) - frame_len) / hop)), 0)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def _overlap_add(frames, hop):
    n = (len(frames) - 1) * hop + frames.shape[1]
    out = np.zeros(n)
    for i, frame in enumerate(frames):
        out[i * hop:i * hop + frames.shape[1]] += frame
    return out


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    """Drop frames where the clean signal is more than ``dyn_range`` dB
    below its loudest frame, then re-synthesize both signals."""
    x_frames = _frame(x, frame_len, hop) * _WIN
    y_frames = _frame(y, frame_len, hop) * _WIN
    if len(x_frames) == 0:
        raise RuntimeError('signal is too short to frame for STOI')
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + EPS)
    mask = energies > energies.max() - dyn_range
    return _overlap_add(x_frames[mask], hop), \
        _overlap_add(y_frames[mask], hop)


def _band_envelopes(x):
    """(frames, bins) power spectrum -> (bands, frames) envelopes."""
    frames = _frame(x, _STOI_FRAME, _STOI_HOP) * _WIN
    spec = np.fft.rfft(frames, _STOI_NFFT, axis=1)
    return np.sqrt(_OBM @ (np.abs(spec)**2).T)


def _sliding_segments(spec, seg_len):
    """(bands, T) -> (M, bands, seg_len), sliding window with step 1."""
    n_frames = spec.shape[1]
    return np.array([
        spec[:, m - seg_len:m] for m in range(seg_len, n_frames + 1)
    ])


def stoi_single(deg, ref, fs, extended):
    """STOI/ESTOI of one pair of 1-D signals (deg = estimate, ref = clean)."""
    deg = np.asarray(deg, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if deg.shape != ref.shape:
        raise ValueError('signals must have the same shape')
    if fs != _STOI_FS:
        # pystoi resamples with an Octave-compatible kaiser window
        deg = _resample_oct(deg, _STOI_FS, fs)
        ref = _resample_oct(ref, _STOI_FS, fs)

    ref, deg = _remove_silent_frames(
        ref, deg, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_HOP
    )

    x_spec = _band_envelopes(ref)   # clean
    y_spec = _band_envelopes(deg)   # degraded
    if x_spec.shape[1] < _STOI_SEG:
        # pystoi warns and returns 1e-5 instead of raising
        warnings.warn(
            f'not enough STFT frames for STOI: {x_spec.shape[1]} after '
            f'silence removal, need at least {_STOI_SEG}; returning 1e-5'
        )
        return 1e-5

    x_seg = _sliding_segments(x_spec, _STOI_SEG)  # (M, J, N)
    y_seg = _sliding_segments(y_spec, _STOI_SEG)

    if extended:
        def row_col_normalize(seg):
            # pystoi additionally perturbs by EPS-scaled gaussian noise
            # (~2e-16, below any meaningful tolerance); omitted so the
            # metric stays deterministic
            def safe_inv_norm(s, axis):
                n2 = np.sum(s**2, axis=axis, keepdims=True)
                return np.where(n2 > 0, 1.0 / np.sqrt(np.maximum(n2, EPS)),
                                0.0)

            seg = seg - seg.mean(axis=2, keepdims=True)
            seg = seg * safe_inv_norm(seg, 2)
            seg = seg - seg.mean(axis=1, keepdims=True)
            seg = seg * safe_inv_norm(seg, 1)
            return seg

        x_n = row_col_normalize(x_seg)
        y_n = row_col_normalize(y_seg)
        return float(
            np.sum(x_n * y_n / _STOI_SEG) / x_n.shape[0]
        )

    # classic STOI: normalize + clip the degraded envelope, correlate
    norm_const = (
        np.linalg.norm(x_seg, axis=2, keepdims=True)
        / (np.linalg.norm(y_seg, axis=2, keepdims=True) + EPS)
    )
    y_norm = y_seg * norm_const
    clip_val = 10**(-_STOI_BETA / 20)
    y_prime = np.minimum(y_norm, x_seg * (1 + clip_val))

    y_prime = y_prime - y_prime.mean(axis=2, keepdims=True)
    x_c = x_seg - x_seg.mean(axis=2, keepdims=True)
    y_prime = y_prime / (np.linalg.norm(y_prime, axis=2, keepdims=True) + EPS)
    x_c = x_c / (np.linalg.norm(x_c, axis=2, keepdims=True) + EPS)
    corr = np.sum(y_prime * x_c)
    return float(corr / (x_seg.shape[0] * x_seg.shape[1]))


def _stoi_job(args):
    """Pool worker: one (deg, ref, fs, extended) scoring job."""
    deg, ref, fs, extended = args
    try:
        return stoi_single(deg, ref, fs, extended)
    except (RuntimeError, ValueError) as e:
        warnings.warn(f'STOI failed for one item: {e}')
        return np.nan


def stoi_batch_vectorized(deg, ref, fs, extended, lengths=None):
    """Fully vectorized batch STOI/ESTOI with per-item lengths.

    One numpy pipeline over the whole ``(batch, samples)`` pair, the JAX
    package's construction. Per-item variability (resampled
    length, silent-frame removal, segment counts) is carried by masks
    and a stable kept-first frame compaction; numerics match
    :func:`stoi_single` to float rounding (batched reductions reorder
    float sums; parity is test-pinned at rtol 1e-6).

    Items too short to frame score NaN (with a warning); items with
    fewer than 30 envelope frames after silence removal score 1e-5 —
    both exactly :func:`stoi_single`'s behavior.
    """
    deg = np.asarray(deg, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if deg.shape != ref.shape or deg.ndim != 2:
        raise ValueError('deg and ref must be 2-D arrays of equal shape')
    n_items, width = deg.shape
    if lengths is None:
        lengths = np.full(n_items, width, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)

    # zero the padding tails: batched resampling then sees exactly the
    # per-item signals (resample_poly's boundary handling is
    # zero-extension, so resample(trim(x)) == resample(pad0(x))[:out])
    tail = np.arange(width)[None, :] >= lengths[:, None]
    deg = np.where(tail, 0.0, deg)
    ref = np.where(tail, 0.0, ref)
    if fs != _STOI_FS:
        g = np.gcd(_STOI_FS, int(fs))
        p, q = _STOI_FS // g, int(fs) // g
        h = _resample_window_oct(p, q)
        deg = scipy.signal.resample_poly(deg, p, q, axis=-1,
                                         window=h / np.sum(h))
        ref = scipy.signal.resample_poly(ref, p, q, axis=-1,
                                         window=h / np.sum(h))
        l10 = -((-(lengths * p)) // q)      # ceil(l * p / q)
    else:
        l10 = lengths

    # ---- framing (pystoi layout: the exactly-fitting final frame is
    # dropped; see _frame) + per-item validity masks
    n_f1 = np.maximum(-((_STOI_FRAME - l10) // _STOI_HOP), 0)
    too_short = n_f1 == 0
    f1_max = int(n_f1.max(initial=0))
    if f1_max == 0:
        warnings.warn('STOI failed for all items: signals too short')
        return np.full(n_items, np.nan)
    need = (f1_max - 1) * _STOI_HOP + _STOI_FRAME + _STOI_HOP
    if deg.shape[1] < need:
        pad = need - deg.shape[1]
        deg = np.pad(deg, ((0, 0), (0, pad)))
        ref = np.pad(ref, ((0, 0), (0, pad)))
    idx = (np.arange(f1_max)[:, None] * _STOI_HOP
           + np.arange(_STOI_FRAME)[None, :])
    x_frames = ref[:, idx] * _WIN           # clean  (B, F1, 256)
    y_frames = deg[:, idx] * _WIN           # degraded
    valid1 = np.arange(f1_max)[None, :] < n_f1[:, None]

    # ---- silent-frame removal on the clean signal's frame energies
    energies = 20 * np.log10(
        np.linalg.norm(x_frames, axis=2) + EPS)
    energies = np.where(valid1, energies, -np.inf)
    keep = energies > (energies.max(axis=1, keepdims=True)
                       - _STOI_DYN_RANGE)
    n_kept = keep.sum(axis=1)
    # stable kept-first compaction, then zero the tail rows
    order = np.argsort(~keep, axis=1, kind='stable')
    kept_max = int(n_kept.max(initial=0))
    order = order[:, :kept_max]
    kept_mask = (np.arange(kept_max)[None, :]
                 < n_kept[:, None])[:, :, None]
    x_kept = np.take_along_axis(x_frames, order[:, :, None],
                                axis=1) * kept_mask
    y_kept = np.take_along_axis(y_frames, order[:, :, None],
                                axis=1) * kept_mask

    # ---- overlap-add at 50 % overlap: two strided adds (each output
    # sample gets exactly the two terms _overlap_add gives it)
    out_len = (kept_max + 1) * _STOI_HOP
    x_res = np.zeros((n_items, out_len))
    y_res = np.zeros((n_items, out_len))
    half = _STOI_HOP
    x_res[:, :kept_max * half] += x_kept[:, :, :half].reshape(n_items, -1)
    x_res[:, half:] += x_kept[:, :, half:].reshape(n_items, -1)
    y_res[:, :kept_max * half] += y_kept[:, :, :half].reshape(n_items, -1)
    y_res[:, half:] += y_kept[:, :, half:].reshape(n_items, -1)

    # ---- band envelopes of the re-synthesized signals.  Re-framing a
    # hop-aligned overlap-add gives n_kept - 1 frames per item (the
    # final exactly-fitting frame is dropped)
    n_f2 = np.maximum(n_kept - 1, 0)
    f2_max = int(n_f2.max(initial=0))
    short = n_f2 < _STOI_SEG                # scores 1e-5 (pystoi parity)
    result = np.full(n_items, 1e-5)
    if np.any(too_short):
        warnings.warn('STOI failed for some items: too short to frame')
        result[too_short] = np.nan
    if f2_max >= _STOI_SEG and not np.all(short | too_short):
        idx2 = (np.arange(f2_max)[:, None] * _STOI_HOP
                + np.arange(_STOI_FRAME)[None, :])
        spec_x = np.fft.rfft(x_res[:, idx2] * _WIN, _STOI_NFFT, axis=2)
        spec_y = np.fft.rfft(y_res[:, idx2] * _WIN, _STOI_NFFT, axis=2)
        # (B, F2, bins) @ (bins, bands) -> (B, bands, F2)
        env_x = np.sqrt(
            (np.abs(spec_x) ** 2) @ _OBM.T).transpose(0, 2, 1)
        env_y = np.sqrt(
            (np.abs(spec_y) ** 2) @ _OBM.T).transpose(0, 2, 1)

        # ---- sliding 30-frame segments: (B, M, bands, 30), made
        # contiguous — every downstream reduction runs a short
        # inner axis, which is ~6x slower on the strided view
        x_seg = np.ascontiguousarray(np.moveaxis(
            np.lib.stride_tricks.sliding_window_view(
                env_x, _STOI_SEG, axis=2), 2, 1))
        y_seg = np.ascontiguousarray(np.moveaxis(
            np.lib.stride_tricks.sliding_window_view(
                env_y, _STOI_SEG, axis=2), 2, 1))
        m_count = np.maximum(n_f2 - _STOI_SEG + 1, 0)
        m_valid = np.arange(x_seg.shape[1])[None, :] < m_count[:, None]

        if extended:
            def row_col_normalize(seg):
                def safe_inv_norm(s, axis):
                    n2 = np.sum(s ** 2, axis=axis, keepdims=True)
                    return np.where(
                        n2 > 0, 1.0 / np.sqrt(np.maximum(n2, EPS)), 0.0)

                seg = seg - seg.mean(axis=3, keepdims=True)
                seg = seg * safe_inv_norm(seg, 3)
                seg = seg - seg.mean(axis=2, keepdims=True)
                seg = seg * safe_inv_norm(seg, 2)
                return seg

            x_n = row_col_normalize(x_seg)
            y_n = row_col_normalize(y_seg)
            per_seg = np.sum(x_n * y_n / _STOI_SEG, axis=(2, 3))
            scores = (np.sum(np.where(m_valid, per_seg, 0.0), axis=1)
                      / np.maximum(m_count, 1))
        else:
            norm_const = (
                np.linalg.norm(x_seg, axis=3, keepdims=True)
                / (np.linalg.norm(y_seg, axis=3, keepdims=True) + EPS))
            clip_val = 10 ** (-_STOI_BETA / 20)
            y_prime = np.minimum(y_seg * norm_const,
                                 x_seg * (1 + clip_val))
            y_prime = y_prime - y_prime.mean(axis=3, keepdims=True)
            x_c = x_seg - x_seg.mean(axis=3, keepdims=True)
            y_prime = y_prime / (np.linalg.norm(y_prime, axis=3,
                                                keepdims=True) + EPS)
            x_c = x_c / (np.linalg.norm(x_c, axis=3,
                                        keepdims=True) + EPS)
            per_seg = np.sum(y_prime * x_c, axis=(2, 3))
            scores = (np.sum(np.where(m_valid, per_seg, 0.0), axis=1)
                      / np.maximum(m_count * _STOI_NBANDS, 1))
        ok = ~(short | too_short)
        result[ok] = scores[ok]
    if np.any(short & ~too_short):
        warnings.warn('not enough STFT frames for STOI on some items '
                      'after silence removal; returning 1e-5')
    return result


def stoi_batch(deg, ref, fs, extended, lengths=None):
    """Batched STOI over 2-D arrays, items sliced by ``lengths``.

    Two paths, both matching :func:`stoi_single` numerics:

    * per-item scoring through the shared persistent spawn pool
      (serial where the pool declines) — the default;
    * ``BREVER_STOI_VEC=1``: :func:`stoi_batch_vectorized`, one numpy
      pipeline over the whole batch.

    Per item is the default, as in the JAX package: an item's segment
    tensors (~1.7 MB at 4 s) stay in cache where the batch's (B, M, 15,
    30) temporaries stream from memory, and the pool runs the items in
    parallel."""
    deg = np.asarray(deg, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if os.environ.get('BREVER_STOI_VEC', '0') == '1':
        return stoi_batch_vectorized(deg, ref, fs, extended, lengths)
    from .pesq import _get_pool

    if lengths is None:
        lengths = [deg.shape[-1]] * deg.shape[0]
    jobs = [(deg[i, :int(lengths[i])], ref[i, :int(lengths[i])],
             fs, extended) for i in range(deg.shape[0])]
    if len(jobs) > 1:
        pool = _get_pool(min(len(jobs), 8))
        if pool is not None:
            return np.array(pool.map(_stoi_job, jobs))
    return np.array([_stoi_job(j) for j in jobs])
