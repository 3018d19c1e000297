"""Validation metrics on the device (counterpart of
``brever_tpu/metrics_device.py``): STOI, ESTOI, SNR, SI-SNR and PESQ as
batched torch graphs over a padded ``(B, T)`` batch with per-item
``lengths``. They run on the tensor's device, in float32 (float64 when
given float64, for reference runs), and only the ``(B,)`` scores leave it.

Each is the JAX package's twin step for step: the Octave-compatible
rational resampler (zero stuffing, a full convolution with the centred
Kaiser FIR, decimation, trim), pystoi's framing, the silent-frame removal
as a mask and a compaction scatter (no data-dependent shapes), the
third-octave envelopes, the sliding 30-frame segments; PESQ's level
alignment, input filter (the IRS curve in the FFT domain for ``nb``, the
P.862.2 biquad's truncated impulse response as an FIR for ``wb``), one
global delay from the FFT cross-correlation, Bark spectra, frequency and
gain compensation (a recurrence over frames), Zwicker loudness and the
disturbance aggregation.

PESQ keeps the JAX twin's documented deviation from the host metric: time
alignment uses the single global delay only (no utterance splitting, no
per-utterance delays, no bad-interval realignment). For time-aligned
enhancement outputs that is the host's result; a heavily degraded signal
can still send the host's realignment to another correlation peak, so the
host twin (ROADMAP.md, Queue 1) stays the authority for test-set scores.
The constants and tables are :mod:`brever_tpu_torch.metric_tables`.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import metric_tables as mt
from .metrics import _batched, sisnr, snr
from .ops.stft import overlap_add

EPS32 = float(np.float32(np.finfo(np.float64).eps))


def _zero_padding(x, lengths):
    mask = torch.arange(x.shape[-1], device=x.device)[None] < lengths[:, None]
    return torch.where(mask, x, 0.0)


def _as_tensors(tables, dtype, device):
    """numpy tables as tensors on ``device``, floating ones in ``dtype`` and
    integer ones int64; normal tensors even when first made under inference
    mode. Their callers cache them: no host-to-device copy a call."""
    with torch.inference_mode(False):
        return {name: torch.as_tensor(a, device=device).to(
                    dtype if a.dtype.kind == 'f' else torch.int64)
                for name, a in tables.items()}


# ---------------------------------------------------------------------------
# octave-compatible rational resampling (scipy.signal.resample_poly
# semantics)

@functools.lru_cache(maxsize=8)
def resample_plan(fs_in, fs_out):
    """``(p, q, taps, n_pre_remove)``: up by p, down by q, the FIR (float32,
    zero-padded in front so the output grid starts on a tap) and the output
    samples to drop in front."""
    g = np.gcd(int(fs_out), int(fs_in))
    p, q = int(fs_out) // g, int(fs_in) // g
    h = mt.resample_window_oct(p, q)
    h = h / h.sum() * p
    half_len = (len(h) - 1) // 2
    n_pre_pad = (q - half_len % q)
    h = np.concatenate([np.zeros(n_pre_pad), h])
    n_pre_remove = (half_len + n_pre_pad) // q
    return p, q, h.astype(np.float32), n_pre_remove


@functools.lru_cache(maxsize=8)
def _reversed_taps(fs_in, fs_out, dtype, device):
    """The FIR reversed (``conv1d`` correlates) as a tensor."""
    h = resample_plan(fs_in, fs_out)[2]
    return _as_tensors({'taps': h[::-1].copy()}, dtype, device)['taps']


def resample_poly(x, fs_in, fs_out):
    """``(B, T)`` -> ``(B, ceil(T p / q))``: zero-stuffed upsampling, a full
    convolution with the FIR, every q-th sample, trimmed."""
    p, q, h, n_pre_remove = resample_plan(fs_in, fs_out)
    b, t = x.shape
    n_out = -(-t * p // q)
    xu = x.new_zeros((b, t * p))
    xu[:, ::p] = x
    taps = _reversed_taps(fs_in, fs_out, x.dtype, x.device)
    y = F.conv1d(F.pad(xu[:, None], (len(h) - 1, len(h) - 1)),
                 taps[None, None])[:, 0, ::q]
    return y[:, n_pre_remove:n_pre_remove + n_out]


# ---------------------------------------------------------------------------
# STOI / ESTOI

def _n_frames(t, frame, hop):
    """pystoi's framing: ceil((t - frame) / hop) frames (the frame that
    fits exactly at the end is dropped)."""
    return max(-(-(t - frame) // hop), 0)


def _frames(x, n):
    return x.unfold(-1, mt.STOI_FRAME, mt.STOI_HOP)[:, :n]


def _norm(x, dim):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


@functools.lru_cache(maxsize=8)
def _stoi_tables(dtype, device):
    """STOI's window and band matrix, float32 values as the JAX twin's."""
    return _as_tensors({'win': mt.WIN.astype(np.float32),
                        'obm': mt.OBM.astype(np.float32)}, dtype, device)


def _stoi_batch(deg, ref, n, extended):
    """``(B,)`` scores of ``(B, T)`` signals at 10 kHz with ``n`` valid
    samples each."""
    b, t = deg.shape
    dtype, device = deg.dtype, deg.device
    sentinel = torch.full((b,), 1e-5, dtype=dtype, device=device)
    n_static = _n_frames(t, mt.STOI_FRAME, mt.STOI_HOP)
    if n_static == 0:
        return sentinel
    tables = _stoi_tables(dtype, device)
    win, obm = tables['win'], tables['obm']
    x_frames = _frames(ref, n_static) * win          # x = clean
    y_frames = _frames(deg, n_static) * win
    # per-item frame validity: pystoi frames the sliced x[:n]
    n_valid = torch.clamp(-((mt.STOI_FRAME - n) // mt.STOI_HOP), min=0)
    frame_idx = torch.arange(n_static, device=device)
    valid = frame_idx[None] < n_valid[:, None]

    energies = 20.0 * torch.log10(_norm(x_frames, -1)[..., 0] + EPS32)
    emax = torch.where(valid, energies, -torch.inf).amax(dim=1,
                                                         keepdim=True)
    mask = (energies > emax - mt.STOI_DYN_RANGE) & valid

    # compact retained frames to the front (stable), then overlap-add
    tgt = torch.where(mask, torch.cumsum(mask, dim=1) - 1, n_static)
    tgt = tgt[..., None].expand(-1, -1, mt.STOI_FRAME)

    def compact(frames):
        out = frames.new_zeros((b, n_static + 1, mt.STOI_FRAME))
        return out.scatter(1, tgt, frames)[:, :n_static]

    k = mask.sum(dim=1)
    ola_len = (n_static - 1) * mt.STOI_HOP + mt.STOI_FRAME
    x_sig = overlap_add(compact(x_frames), mt.STOI_HOP, ola_len)
    y_sig = overlap_add(compact(y_frames), mt.STOI_HOP, ola_len)

    # band envelopes over the resynthesised signals; valid spectral frames
    # = k - 1
    m_static = _n_frames(ola_len, mt.STOI_FRAME, mt.STOI_HOP)

    def envelopes(sig):
        spec = torch.fft.rfft(_frames(sig, m_static) * win, mt.STOI_NFFT,
                              dim=-1)
        return torch.sqrt(obm @ (spec.abs() ** 2).transpose(-1, -2))

    x_spec, y_spec = envelopes(x_sig), envelopes(y_sig)   # (B, bands, M)

    # sliding segments of SEG frames, step 1 (only segments inside the
    # k - 1 valid spectral frames count)
    n_seg_static = m_static - mt.STOI_SEG + 1
    if n_seg_static <= 0:
        return sentinel
    x_seg = x_spec.unfold(-1, mt.STOI_SEG, 1).transpose(1, 2)
    y_seg = y_spec.unfold(-1, mt.STOI_SEG, 1).transpose(1, 2)
    n_seg_valid = torch.clamp(k - mt.STOI_SEG, min=0)
    seg_ok = torch.arange(n_seg_static, device=device)[None] \
        < n_seg_valid[:, None]
    denom = torch.clamp(n_seg_valid, min=1)

    if extended:
        def safe_inv_norm(s, dim):
            n2 = (s ** 2).sum(dim=dim, keepdim=True)
            return torch.where(
                n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=EPS32)), 0.0)

        def row_col_normalize(seg):
            seg = seg - seg.mean(dim=3, keepdim=True)
            seg = seg * safe_inv_norm(seg, 3)
            seg = seg - seg.mean(dim=2, keepdim=True)
            return seg * safe_inv_norm(seg, 2)

        per_seg = (row_col_normalize(x_seg) * row_col_normalize(y_seg)) \
            .sum(dim=(2, 3)) / mt.STOI_SEG
        score = torch.where(seg_ok, per_seg, 0.0).sum(dim=1) / denom
    else:
        y_norm = y_seg * (_norm(x_seg, 3) / (_norm(y_seg, 3) + EPS32))
        clip_val = 10.0 ** (-mt.STOI_BETA / 20.0)
        y_prime = torch.minimum(y_norm, x_seg * (1 + clip_val))
        y_prime = y_prime - y_prime.mean(dim=3, keepdim=True)
        x_cs = x_seg - x_seg.mean(dim=3, keepdim=True)
        y_prime = y_prime / (_norm(y_prime, 3) + EPS32)
        x_cs = x_cs / (_norm(x_cs, 3) + EPS32)
        per_seg = (y_prime * x_cs).sum(dim=(2, 3))
        score = torch.where(seg_ok, per_seg, 0.0).sum(dim=1) \
            / (denom * x_seg.shape[2])

    # pystoi warns and returns 1e-5 with < SEG frames after removal
    return torch.where(k - 1 < mt.STOI_SEG, sentinel, score)


def stoi_device(x, y, lengths=None, fs=16000, extended=False):
    """Batched STOI (``x`` the estimate, ``y`` the clean reference) of
    ``(T,)`` or ``(B, T)`` arrays or tensors: ``(B,)`` scores on ``x``'s
    device (``()`` for one item)."""
    x, y, lengths, unbatched = _batched(x, y, lengths)
    # zero the padding, so batched resampling sees what the host sees when
    # it slices x[:n]
    deg, ref = _zero_padding(x, lengths), _zero_padding(y, lengths)
    if fs != mt.STOI_FS:
        p, q, _, _ = resample_plan(int(fs), mt.STOI_FS)
        deg = resample_poly(deg, int(fs), mt.STOI_FS)
        ref = resample_poly(ref, int(fs), mt.STOI_FS)
        lengths = -(-lengths * p // q)
    out = _stoi_batch(deg, ref, lengths, bool(extended))
    return out[0] if unbatched else out


def estoi_device(x, y, lengths=None, fs=16000):
    return stoi_device(x, y, lengths=lengths, fs=fs, extended=True)


# ---------------------------------------------------------------------------
# PESQ

@functools.lru_cache(maxsize=16)
def pesq_plan(fs, mode, t_in):
    """Host-side static tables of a (fs, mode, padded length) graph."""
    cfg = mt.PesqConfig(fs, mode)
    pad_front = mt.SEARCHBUFFER * cfg.downsample
    datapad = mt.DATAPADDING_MS * fs // 1000
    length = pad_front + t_in + mt.SEARCHBUFFER * cfg.downsample + datapad
    plan = {
        'pad_front': pad_front,
        'length': length,
        'n_frames': (t_in + datapad - cfg.nf) // cfg.hop + 1,
        'span': mt.SEARCHBUFFER * cfg.downsample,
        'datapad': datapad,
        'xcorr_nfft': 1 << int(np.ceil(np.log2(2 * length))),
        'window': np.asarray(cfg.window, np.float32),
        'group': np.asarray(cfg.group, np.float32),
        'abs_thresh': np.asarray(cfg.abs_thresh, np.float32),
        'centre_bark': np.asarray(cfg.centre_bark, np.float32),
        'width_bark': np.asarray(cfg.width_bark, np.float32),
        'nf': cfg.nf,
        'hop': cfg.hop,
        'n_bins': cfg.n_bins,
    }
    f_static = plan['n_frames']
    plan['frame_index'] = (np.arange(f_static)[:, None] * cfg.hop
                           + np.arange(cfg.nf)[None, :] + pad_front)
    # L6 over 20-frame syllables sliding by 10: starts and frame indices
    starts = np.arange(0, f_static, mt.SYLLABLE_FRAMES // 2)
    plan['syllable_starts'] = starts
    plan['syllable_frames'] = starts[:, None] \
        + np.arange(mt.SYLLABLE_FRAMES)[None]
    freqs = np.fft.rfftfreq(length, 1.0 / fs)
    plan['hp_mask'] = (freqs >= 300.0).astype(np.float32)
    if mode == 'nb':
        gain_db = np.interp(freqs, mt.IRS_FILTER_DB[:, 0],
                            mt.IRS_FILTER_DB[:, 1])
        plan['input_gain'] = (10.0 ** (gain_db / 20.0)).astype(np.float32)
        plan['fir'] = None
    else:
        # the P.862.2 biquad's impulse response is < 1e-9 past ~350 taps
        # (pole radius 0.946): a truncated-IR FIR is exact to float32
        b0, b1, b2, a1, a2 = mt.WB_IIR_16K
        n_taps = 384
        imp = np.zeros(n_taps)
        imp[0] = 1.0
        h = np.zeros(n_taps)
        y1 = y2 = x1 = x2 = 0.0
        for i in range(n_taps):
            y = b0 * imp[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            h[i] = y
            x2, x1 = x1, imp[i]
            y2, y1 = y1, y
        plan['input_gain'] = None
        plan['fir'] = h.astype(np.float32)
    return plan


@functools.lru_cache(maxsize=16)
def _pesq_tables(fs, mode, t_in, dtype, device):
    """The plan's arrays as tensors of ``dtype`` on ``device`` (the FIR
    reversed for ``conv1d``'s correlation)."""
    plan = pesq_plan(fs, mode, t_in)
    arrays = {k: v for k, v in plan.items() if isinstance(v, np.ndarray)}
    if plan['fir'] is not None:
        arrays['fir_reversed'] = plan['fir'][::-1].copy()
    return _as_tensors(arrays, dtype, device)


def _pesq_graph(deg, ref, lengths, fs, mode):
    """``(B, T)`` in, ``(B,)`` MOS-LQO out; everything masked by
    ``lengths``; NaN for a silent reference."""
    b, t_in = deg.shape
    dtype, device = deg.dtype, deg.device
    plan = pesq_plan(fs, mode, t_in)
    tables = _pesq_tables(fs, mode, t_in, dtype, device)

    pad_front, length = plan['pad_front'], plan['length']
    pads = (pad_front, length - pad_front - t_in)
    deg = F.pad(_zero_padding(deg, lengths), pads)
    ref = F.pad(_zero_padding(ref, lengths), pads)
    n_active = pad_front + lengths
    hp_mask = tables['hp_mask']

    def fix_power_level(x):
        hp = torch.fft.irfft(torch.fft.rfft(x, dim=1) * hp_mask, length,
                             dim=1)
        amask = torch.arange(length, device=device)[None] \
            < n_active[:, None]
        power = (torch.where(amask, hp, 0.0) ** 2).sum(dim=1) \
            / torch.clamp(n_active, min=1)
        return x * torch.sqrt(mt.TARGET_AVG_POWER
                              / torch.clamp(power, min=1e-20))[:, None], power

    def input_filter(x):
        if plan['input_gain'] is not None:
            spec = torch.fft.rfft(x, dim=1) * tables['input_gain']
            return torch.fft.irfft(spec, length, dim=1)
        taps = tables['fir_reversed']
        return F.conv1d(F.pad(x[:, None], (len(taps) - 1, 0)),
                        taps[None, None])[:, 0]

    ref_s, ref_power = fix_power_level(ref)
    deg_s, _ = fix_power_level(deg)
    silent = ref_power <= 0.0
    ref_f = input_filter(ref_s)
    deg_f = input_filter(deg_s)

    # global delay: the full-signal FFT cross-correlation within +-span;
    # argmax takes the first maximum, as jnp.argmax does
    span, nfft2 = plan['span'], plan['xcorr_nfft']
    corr = torch.fft.irfft(
        torch.fft.rfft(deg_f, nfft2, dim=1)
        * torch.conj(torch.fft.rfft(ref_f, nfft2, dim=1)), nfft2, dim=1)
    lags = torch.cat([torch.arange(span + 1, device=device),
                      torch.arange(-span, 0, device=device)])
    vals = torch.cat([corr[:, :span + 1], corr[:, nfft2 - span:]], dim=1)
    delay = lags[torch.argmax(vals, dim=1)]

    # frames over the active region; degraded frames shifted by the global
    # delay
    nf, hop, n_bins = plan['nf'], plan['hop'], plan['n_bins']
    f_static = plan['n_frames']
    fidx = tables['frame_index']
    n_valid = (lengths + plan['datapad'] - nf) // hop + 1
    fmask = torch.arange(f_static, device=device)[None] < n_valid[:, None]
    win, group = tables['window'], tables['group']
    abs_thresh = tables['abs_thresh']

    def spectra(x, offs):
        idx = torch.clamp(fidx[None] + offs[:, None, None], 0, length - 1)
        fr = x.gather(1, idx.reshape(b, -1)).reshape(b, f_static, nf) * win
        return torch.fft.rfft(fr, nf, dim=2)[:, :, :n_bins].abs() ** 2

    pp_ref = mt.SP * (spectra(ref_f, torch.zeros_like(delay)) @ group.T)
    pp_deg = mt.SP * (spectra(deg_f, delay) @ group.T)

    def total_audible(pp):
        return torch.where(pp[..., 1:] > abs_thresh[1:], pp[..., 1:],
                           0.0).sum(dim=-1)

    tot_ref = total_audible(pp_ref)
    tot_deg = total_audible(pp_deg)

    active = (tot_ref > 1e7) & fmask
    # the host twin raises when nothing is speech-active; here NaN
    n_act = active.sum(dim=1)
    silent = silent | (n_act == 0)
    n_act = torch.clamp(n_act, min=1)[:, None]
    avg_ref = torch.where(active[..., None], pp_ref, 0.0).sum(dim=1) / n_act
    avg_deg = torch.where(active[..., None], pp_deg, 0.0).sum(dim=1) / n_act
    band_comp = torch.clamp((avg_deg + 1000.0) / (avg_ref + 1000.0),
                            0.01, 100.0)
    pp_ref_c = pp_ref * band_comp[:, None, :]

    tot_ref_c = total_audible(pp_ref_c)
    inst = (tot_ref_c + 5e3) / (tot_deg + 5e3)                # (B, F)

    # short-term gain: a first-order recurrence over the valid frames
    drive = 0.8 * inst
    h = inst[:, 0]
    h = torch.where(fmask[:, 0], h, torch.ones_like(h))
    gains = [h]
    for f in range(1, f_static):
        h = torch.where(fmask[:, f], 0.2 * h + drive[:, f], h)
        gains.append(h)
    gains = torch.clamp(torch.stack(gains, dim=1), mt.MIN_SCALE,
                        mt.MAX_SCALE)
    pp_deg_c = pp_deg * gains[..., None]

    centre = tables['centre_bark']
    exponent = mt.ZWICKER_POWER * torch.where(
        centre < 4.0, torch.clamp(6.0 / (centre + 2.0), max=2.0) ** 0.15,
        1.0)

    def loudness(pp):
        loud = ((abs_thresh / 0.5) ** exponent
                * ((0.5 + 0.5 * pp / abs_thresh) ** exponent - 1.0))
        return mt.SL * torch.where(pp > abs_thresh, loud, 0.0)

    loud_ref = loudness(pp_ref_c)
    loud_deg = loudness(pp_deg_c)

    d = loud_deg - loud_ref
    m = 0.25 * torch.minimum(loud_deg, loud_ref)
    disturbance = torch.sign(d) * torch.clamp(d.abs() - m, min=0.0)

    ratio = ((pp_deg_c + 50.0) / (pp_ref_c + 50.0)) ** 1.2
    asym = torch.where(ratio < 3.0, 0.0, torch.clamp(ratio, max=12.0))
    disturbance_asym = disturbance * asym

    widths = tables['width_bark'][1:]
    total_w = widths.sum()

    def pseudo_lp(dd, p):
        res = (((dd[..., 1:].abs() * widths) ** p).sum(dim=-1)
               / total_w) ** (1.0 / p)
        return res * total_w                                  # (B, F)

    weight = ((tot_ref_c + 1e5) / 1e7) ** 0.04
    frame_d = torch.clamp(pseudo_lp(disturbance, 2.0) / weight, max=45.0)
    frame_da = torch.clamp(pseudo_lp(disturbance_asym, 1.0) / weight,
                           max=45.0)

    # L6 over 20-frame syllables sliding by 10, then L2 over them, masked
    # per item
    starts, sidx = tables['syllable_starts'], tables['syllable_frames']
    cm = (sidx[None] < f_static) & (sidx[None] < n_valid[:, None, None])
    sidx = torch.clamp(sidx, max=f_static - 1)
    cnt = torch.clamp(cm.sum(dim=2), min=1)
    block_on = (starts[None] < n_valid[:, None]).to(dtype)

    def lpq(fd, p_syll=6.0, p_time=2.0):
        chunks = fd[:, sidx]                                  # (B, S, 20)
        syll = (torch.where(cm, chunks ** p_syll, 0.0).sum(dim=2)
                / cnt) ** (1.0 / p_syll)
        num = (block_on * syll ** p_time).sum(dim=1)
        den = torch.clamp(block_on.sum(dim=1), min=1.0)
        return (num / den) ** (1.0 / p_time)

    raw = torch.clamp(4.5 - mt.D_WEIGHT * lpq(frame_d)
                      - mt.DA_WEIGHT * lpq(frame_da), -0.5, 4.5)
    if mode == 'nb':
        mos = 0.999 + 4.0 / (1.0 + torch.exp(-1.4945 * raw + 4.6607))
    else:
        mos = 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw + 3.8224))
    return torch.where(silent, torch.nan, mos)


def pesq_device(x, y, lengths=None, fs=16000, mode='wb'):
    """Batched PESQ MOS-LQO (``x`` the estimate, ``y`` the clean reference)
    with global-delay time alignment: ``(B,)`` scores on ``x``'s device,
    NaN for a silent reference."""
    mt.check_fs_mode(fs, mode)
    x, y, lengths, unbatched = _batched(x, y, lengths)
    out = _pesq_graph(x, y, lengths, int(fs), str(mode))
    return out[0] if unbatched else out


#: the device twins the trainer scores validation with when
#: ``device_val_metrics`` is true; ``snr`` and ``sisnr`` are the port's
#: metrics, which run on the tensor's device
DEVICE_METRICS = {
    'stoi': stoi_device,
    'estoi': estoi_device,
    'snr': snr,
    'sisnr': sisnr,
    'pesq': pesq_device,
    'pesq_approx': pesq_device,
}
