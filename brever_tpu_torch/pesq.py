"""PESQ host twin (counterpart of ``brever_tpu/pesq.py``): the JAX package's
own P.862 / P.862.2 implementation in float64 numpy, on the port's tables
(:mod:`brever_tpu_torch.metric_tables`).

Level alignment, the IRS (narrowband) or P.862.2 IIR (wideband) input
filter, time alignment (a crude global delay, utterances split on the
reference's 4 ms envelope, a fine delay per utterance and bad-interval
realignment), the perceptual model (32 ms Hann frames, 49 Bark bands,
partial frequency and short-term gain compensation, Zwicker loudness), the
disturbance aggregation and the P.862.1 / P.862.2 mapping to MOS-LQO. Its
deviations from the ITU reference code are the JAX package's (analytic Bark
bands and thresholds; a realignment shaped on the specification): identical
signals score the published maxima, 4.548638319075995 (nb) and
4.643888749336258 (wb).

:func:`pesq_batch` scores a padded batch item by item through a persistent
pool of ``spawn`` workers (never ``fork``: the parent may hold a CUDA
context), serially where the pool declines. A script that calls it at
import time needs the ``if __name__ == '__main__':`` guard, since a spawned
worker imports ``__main__`` again.

numpy and scipy only, no torch: the workers import this module.
"""

import multiprocessing
import os
import warnings

import numpy as np

from .metric_tables import (DA_WEIGHT, DATAPADDING_MS, D_WEIGHT,
                            IRS_FILTER_DB, MAX_SCALE, MIN_SCALE, SEARCHBUFFER,
                            SL, SP, SYLLABLE_FRAMES, TARGET_AVG_POWER,
                            WB_IIR_16K, ZWICKER_POWER, PesqConfig,
                            check_fs_mode)

MAX_UTTERANCES = 50        # P.862 cap on the utterance count
THRESHOLD_BAD_FRAMES = 30.0  # frame disturbance marking a frame "bad"
MIN_BAD_FRAMES = 5         # consecutive bad frames forming an interval


class PesqError(Exception):
    pass


class NoUtterancesError(PesqError):
    pass


def _fft_filter_db_curve(x, fs, curve):
    """Apply a piecewise-linear (Hz, dB) magnitude curve via rFFT."""
    n = len(x)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    gain_db = np.interp(freqs, curve[:, 0], curve[:, 1])
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n)


def _iir_sos(x, sos):
    import scipy.signal
    b0, b1, b2, a1, a2 = sos
    return scipy.signal.lfilter([b0, b1, b2], [1.0, a1, a2], x)


def _fix_power_level(x, fs, n_active):
    """Scale so the >300 Hz band power over the active part is 1e7."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    spec[freqs < 300.0] = 0.0
    hp = np.fft.irfft(spec, len(x))
    power = np.sum(hp[:n_active] ** 2) / max(n_active, 1)
    if power <= 0:
        raise NoUtterancesError('signal has no energy above 300 Hz')
    return x * np.sqrt(TARGET_AVG_POWER / power)


def _estimate_delay(ref, deg, cfg):
    """Single global delay of deg w.r.t. ref, in samples.

    Full waveform cross-correlation (one FFT over the file) restricted
    to P.862's search buffer of +-SEARCHBUFFER*Downsample samples.
    ``corr[k] = sum_t ref[t] * deg[t + k]``: a positive delay means the
    degraded signal lags the reference.
    """
    n = min(len(ref), len(deg))
    span = min(SEARCHBUFFER * cfg.downsample, n - cfg.nf)
    if span <= 0:
        return 0
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    corr = np.fft.irfft(
        np.fft.rfft(deg[:n], nfft) * np.conj(np.fft.rfft(ref[:n], nfft)),
        nfft)
    lags = np.concatenate([np.arange(span + 1), np.arange(-span, 0)])
    vals = np.concatenate([corr[:span + 1], corr[nfft - span:]])
    return int(lags[np.argmax(vals)])


def _frames(x, cfg, n_frames, offsets=None):
    idx = (np.arange(n_frames)[:, None] * cfg.hop
           + np.arange(cfg.nf)[None, :])
    if offsets is not None:
        idx = np.clip(idx + offsets[:, None], 0, len(x) - 1)
    return x[idx]


def _power_spectra(x, cfg, n_frames, offsets=None):
    fr = _frames(x, cfg, n_frames, offsets) * cfg.window
    spec = np.fft.rfft(fr, cfg.nf, axis=1)[:, :cfg.n_bins]
    return np.abs(spec) ** 2


def _split_utterances(ref, cfg, start, stop):
    """Speech-active [start, stop) sample spans within ``ref``.

    P.862 delimits utterances on the 4 ms (Downsample) envelope: a
    span is speech while the envelope stays above a threshold tied to
    the fixed internal level, and utterances separated by less than
    200 ms of silence are joined (ITU reference: utt_id/utt_start in
    the time-alignment module).  Returns at most ``MAX_UTTERANCES``
    spans, longest kept, in time order."""
    step = cfg.downsample
    n_units = (stop - start) // step
    if n_units <= 0:
        return []
    seg = ref[start:start + n_units * step].reshape(n_units, step)
    env = np.abs(seg).sum(axis=1)
    # the internal calibration puts active speech at ~1e7 power
    # (RMS ~ 3162); anything above 1 % of that RMS counts as active
    active = env > 0.01 * np.sqrt(TARGET_AVG_POWER) * step
    if not np.any(active):
        return []
    join_units = int(0.2 * cfg.fs) // step      # 200 ms
    min_units = int(0.05 * cfg.fs) // step      # 50 ms minimum
    spans = []
    idx = np.flatnonzero(active)
    run_start = idx[0]
    prev = idx[0]
    for i in idx[1:]:
        if i - prev > join_units:
            spans.append((run_start, prev + 1))
            run_start = i
        prev = i
    spans.append((run_start, prev + 1))
    spans = [(a, b) for a, b in spans if b - a >= min_units]
    spans.sort(key=lambda ab: ab[0] - ab[1])    # longest first
    spans = sorted(spans[:MAX_UTTERANCES])
    return [(start + a * step, start + b * step) for a, b in spans]


def _utterance_delay(ref, deg, a, b, global_delay, cfg):
    """Fine delay of deg vs ref over the utterance [a, b), searched
    within +-SEARCHBUFFER*Downsample around the crude global delay."""
    span = SEARCHBUFFER * cfg.downsample
    lo = max(a + global_delay - span, 0)
    hi = min(b + global_delay + span, len(deg))
    if hi - lo < cfg.nf:
        return global_delay
    r = ref[a:b]
    d = deg[lo:hi]
    nfft = 1 << int(np.ceil(np.log2(len(r) + len(d))))
    corr = np.fft.irfft(
        np.fft.rfft(d, nfft) * np.conj(np.fft.rfft(r, nfft)), nfft)
    # corr[k] pairs ref[a + t] with deg[lo + t + k]
    k_max = len(d) - 1
    k = int(np.argmax(corr[:k_max + 1]))
    delay = lo + k - a
    if abs(delay - global_delay) > span:
        return global_delay
    return delay


def _total_audible(pp, abs_thresh, factor):
    """Total power of audible components per frame (band 0 excluded)."""
    audible = np.where(pp[:, 1:] > factor * abs_thresh[None, 1:],
                       pp[:, 1:], 0.0)
    return audible.sum(axis=1)


def _loudness(pp, cfg):
    """Zwicker intensity->loudness transform per (frame, band)."""
    thresh = cfg.abs_thresh[None, :]
    h = 6.0 / (cfg.centre_bark[None, :] + 2.0)
    h = np.minimum(h, 2.0) ** 0.15
    exponent = ZWICKER_POWER * np.where(cfg.centre_bark[None, :] < 4.0,
                                        h, 1.0)
    loud = ((thresh / 0.5) ** exponent
            * ((0.5 + 0.5 * pp / thresh) ** exponent - 1.0))
    return SL * np.where(pp > thresh, loud, 0.0)


def _pseudo_lp(d, p, widths):
    """Band aggregation: width-weighted Lp over bands 1.. (P.862)."""
    w = widths[None, 1:]
    total_w = w.sum()
    res = (np.sum((np.abs(d[:, 1:]) * w) ** p, axis=1)
           / total_w) ** (1.0 / p)
    return res * total_w


def _lpq_weight(frame_d, time_weight, p_syll=6.0, p_time=2.0):
    """L6 over 20-frame syllables sliding by 10, then L2 over time."""
    n = len(frame_d)
    step = SYLLABLE_FRAMES // 2
    num, den = 0.0, 0.0
    for start in range(0, n, step):
        chunk = frame_d[start:start + SYLLABLE_FRAMES]
        syll = (np.mean(chunk ** p_syll)) ** (1.0 / p_syll)
        tw = float(np.mean(time_weight[start:start + SYLLABLE_FRAMES]))
        num += (tw * syll) ** p_time
        den += tw ** p_time
    if den == 0:
        return 0.0
    return (num / den) ** (1.0 / p_time)


def _frame_disturbances(pp_ref_c, pp_deg_c, weight, cfg):
    """Per-frame D and DA from compensated Bark power densities.

    Masked loudness difference, asymmetry factor, width-weighted band
    aggregation, listening-effort weighting and the 45 cap — the P.862
    disturbance pipeline downstream of the gain/frequency compensation.
    """
    loud_ref = _loudness(pp_ref_c, cfg)
    loud_deg = _loudness(pp_deg_c, cfg)

    # masked disturbance with a 0.25*min deadzone
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    disturbance = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor: added distortion counts more than removed
    ratio = ((pp_deg_c + 50.0) / (pp_ref_c + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))
    disturbance_asym = disturbance * asym

    frame_d = _pseudo_lp(disturbance, 2.0, cfg.width_bark)
    frame_da = _pseudo_lp(disturbance_asym, 1.0, cfg.width_bark)

    # emphasis on low-power (listening-effort) frames + clipping
    frame_d = np.minimum(frame_d / weight, 45.0)
    frame_da = np.minimum(frame_da / weight, 45.0)
    return frame_d, frame_da


def _bad_intervals(frame_d):
    """Runs of >= MIN_BAD_FRAMES consecutive frames whose disturbance
    exceeds THRESHOLD_BAD_FRAMES, as [f0, f1) frame spans (P.862
    bad-interval definition)."""
    bad = frame_d > THRESHOLD_BAD_FRAMES
    intervals = []
    i, n = 0, len(bad)
    while i < n:
        if bad[i]:
            j = i
            while j < n and bad[j]:
                j += 1
            if j - i >= MIN_BAD_FRAMES:
                intervals.append((i, j))
            i = j
        else:
            i += 1
    return intervals


def _raw_to_mos_lqo(raw, mode):
    if mode == 'nb':     # P.862.1
        return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def pesq(fs, ref, deg, mode='wb', realign=True):
    """MOS-LQO of ``deg`` against clean ``ref`` (same argument order as
    the canonical library: reference signal first).

    ``realign=False`` disables the bad-interval realignment (P.862
    refinement for delay drift inside an utterance; see the module
    docstring)."""
    check_fs_mode(fs, mode)
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    deg = np.asarray(deg, dtype=np.float64).reshape(-1)
    if len(ref) != len(deg):
        n = min(len(ref), len(deg))
        ref, deg = ref[:n], deg[:n]
    if len(ref) < int(0.25 * fs):
        raise PesqError('signals too short for PESQ (need >= 0.25 s)')
    cfg = PesqConfig(fs, mode)

    n_samples = len(ref)
    pad_front = SEARCHBUFFER * cfg.downsample
    pad_back = SEARCHBUFFER * cfg.downsample \
        + DATAPADDING_MS * fs // 1000

    def prepare(x):
        x = np.concatenate([
            np.zeros(pad_front), x, np.zeros(pad_back)])
        x = _fix_power_level(x, fs, pad_front + n_samples)
        if mode == 'nb':
            x = _fft_filter_db_curve(x, fs, IRS_FILTER_DB)
        else:
            x = _iir_sos(x, WB_IIR_16K)
        return x

    try:
        ref_f = prepare(ref)
        deg_f = prepare(deg)
    except NoUtterancesError:
        raise NoUtterancesError(
            'no utterances detected (silent input)') from None

    # time alignment: crude global delay (envelope-scale waveform
    # correlation), then utterance splitting on the reference envelope
    # and a fine per-utterance delay searched around the crude one —
    # the P.862 utterance machinery without the bad-interval
    # realignment refinement
    global_delay = _estimate_delay(ref_f, deg_f, cfg)
    utterances = _split_utterances(
        ref_f, cfg, pad_front, pad_front + n_samples)
    utt_delays = [
        _utterance_delay(ref_f, deg_f, a, b, global_delay, cfg)
        for a, b in utterances
    ]

    # perceptual model over the active region (+ data padding)
    region = slice(pad_front,
                   pad_front + n_samples + DATAPADDING_MS * fs // 1000)
    ref_a = ref_f[region]
    n_frames = (len(ref_a) - cfg.nf) // cfg.hop + 1
    if n_frames < 1:
        raise PesqError('signal too short for PESQ analysis')

    # per-frame degraded-signal offsets: frames inside an utterance
    # follow its delay, frames outside follow the crude global delay
    frame_centre = pad_front + np.arange(n_frames) * cfg.hop \
        + cfg.nf // 2
    offsets = np.full(n_frames, pad_front + global_delay)
    for (a, b), d in zip(utterances, utt_delays):
        inside = (frame_centre >= a) & (frame_centre < b)
        offsets[inside] = pad_front + d

    pp_ref = SP * (_power_spectra(ref_a, cfg, n_frames) @ cfg.group.T)
    pp_deg = SP * (_power_spectra(deg_f, cfg, n_frames, offsets)
                   @ cfg.group.T)

    tot_ref = _total_audible(pp_ref, cfg.abs_thresh, 1.0)
    tot_deg = _total_audible(pp_deg, cfg.abs_thresh, 1.0)

    # partial frequency compensation of the reference: per-band ratio
    # of time-averaged spectra over speech-active frames, bounded
    active = tot_ref > 1e7
    if not np.any(active):
        raise NoUtterancesError('no utterances detected (silent input)')
    avg_ref = pp_ref[active].mean(axis=0)
    avg_deg = pp_deg[active].mean(axis=0)
    band_comp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0),
                        0.01, 100.0)
    pp_ref_c = pp_ref * band_comp[None, :]

    # short-term gain compensation of the degraded signal, smoothed
    tot_ref_c = _total_audible(pp_ref_c, cfg.abs_thresh, 1.0)
    inst = (tot_ref_c + 5e3) / (tot_deg + 5e3)
    gains = np.empty(n_frames)
    h = 1.0
    for i in range(n_frames):
        h = inst[i] if i == 0 else 0.2 * h + 0.8 * inst[i]
        gains[i] = h
    gains = np.clip(gains, MIN_SCALE, MAX_SCALE)
    pp_deg_c = pp_deg * gains[:, None]

    weight = ((tot_ref_c + 1e5) / 1e7) ** 0.04
    frame_d, frame_da = _frame_disturbances(
        pp_ref_c, pp_deg_c, weight, cfg)

    # bad-interval realignment: where the disturbance spikes over a
    # run of frames, the utterance delay may have drifted — re-search
    # the delay over just that interval and keep the per-frame minimum
    # of the original and realigned disturbances (a wrong realignment
    # can therefore never make the score worse)
    if realign:
        # An interval can span an utterance boundary (frames with
        # different per-utterance delays); re-searching with the first
        # frame's delay alone would silently skip recovery for the
        # later frames, so split at every offset change first.
        pieces = []
        for f0, f1 in _bad_intervals(frame_d):
            cut = f0
            for f in range(f0 + 1, f1):
                if offsets[f] != offsets[cut]:
                    pieces.append((cut, f))
                    cut = f
            pieces.append((cut, f1))
        for f0, f1 in pieces:
            a = pad_front + f0 * cfg.hop
            b = pad_front + (f1 - 1) * cfg.hop + cfg.nf
            cur_delay = int(offsets[f0] - pad_front)
            new_delay = _utterance_delay(
                ref_f, deg_f, a, b, cur_delay, cfg)
            if new_delay == cur_delay:
                continue
            sub_off = np.full(f1 - f0,
                              pad_front + new_delay + f0 * cfg.hop)
            pp_sub = SP * (_power_spectra(deg_f, cfg, f1 - f0, sub_off)
                           @ cfg.group.T)
            fd_new, fda_new = _frame_disturbances(
                pp_ref_c[f0:f1], pp_sub * gains[f0:f1, None],
                weight[f0:f1], cfg)
            # P.862 accepts the realigned interval's values as a set;
            # mixing the symmetric disturbance of one alignment with
            # the asymmetric of the other would be too optimistic, so
            # both follow one per-frame criterion (fd improves).
            better = fd_new < frame_d[f0:f1]
            frame_d[f0:f1] = np.where(better, fd_new, frame_d[f0:f1])
            frame_da[f0:f1] = np.where(better, fda_new,
                                       frame_da[f0:f1])

    time_weight = np.ones(n_frames)
    d_ind = _lpq_weight(frame_d, time_weight)
    da_ind = _lpq_weight(frame_da, time_weight)

    raw = 4.5 - D_WEIGHT * d_ind - DA_WEIGHT * da_ind
    raw = float(np.clip(raw, -0.5, 4.5))
    return float(_raw_to_mos_lqo(raw, mode))


def _pesq_inner(args):
    ref, deg, fs, mode = args
    try:
        return pesq(fs, ref, deg, mode)
    except PesqError as e:
        warnings.warn(f'PESQ failed for one item: {e}')
        return np.nan


def pesq_batch(fs, ref, deg, mode='wb', lengths=None, n_processor=None):
    """PESQ of each item of a batch: 2-D ``ref``/``deg`` sliced per item
    by ``lengths`` (or one 1-D ``ref`` against each row of ``deg``),
    scored through the persistent spawn pool (:func:`_get_pool`); a list
    of MOS-LQO, NaN (with a warning) for an item that raises
    :class:`PesqError`."""
    check_fs_mode(fs, mode)
    ref = np.asarray(ref, dtype=np.float64)
    deg = np.asarray(deg, dtype=np.float64)
    if n_processor is None:
        n_processor = min(multiprocessing.cpu_count(), 8)
    if ref.ndim == 1:
        if lengths is not None:
            raise ValueError('cannot provide lengths if ref is 1D')
        if deg.ndim == 1:
            return [pesq(fs, ref, deg, mode)]
        jobs = [(ref, deg[i], fs, mode) for i in range(deg.shape[0])]
    elif ref.ndim == 2:
        if deg.shape != ref.shape:
            raise ValueError('ref and deg must have the same shape')
        if lengths is None:
            lengths = [ref.shape[-1]] * ref.shape[0]
        elif len(lengths) != ref.shape[0]:
            raise ValueError('len(lengths) does not match the batch size')
        jobs = [(ref[i, :int(lengths[i])], deg[i, :int(lengths[i])],
                 fs, mode) for i in range(ref.shape[0])]
    else:
        raise ValueError('ref must be 1D or 2D')
    if n_processor <= 1 or len(jobs) == 1:
        return [_pesq_inner(j) for j in jobs]
    pool = _get_pool(min(n_processor, len(jobs)))
    if pool is None:
        return [_pesq_inner(j) for j in jobs]
    return pool.map(_pesq_inner, jobs)


# persistent spawn-context pool: forking a process that holds a CUDA
# context is unsafe (the child inherits the CUDA runtime's state), and a
# fresh pool per batch would pay the workers' start-up every call. Spawned
# workers import numpy and scipy (this module imports no torch), and the
# start-up is paid once a process.
_POOL = None
_POOL_SIZE = 0


def _get_pool(n):
    global _POOL, _POOL_SIZE
    if multiprocessing.current_process().name != 'MainProcess':
        # never nest pools inside a worker (a spawn child re-imports
        # __main__; an unguarded script would recurse here)
        return None
    if (os.cpu_count() or 1) < 2:
        # a pool on a single-core host only adds worker-spawn latency
        # (~5 s/worker: each child re-imports numpy on the same core)
        return None
    if _POOL is not None and _POOL_SIZE >= n:
        return _POOL
    if _POOL is not None:
        _POOL.terminate()
        _POOL = None
    try:
        ctx = multiprocessing.get_context('spawn')
        _POOL = ctx.Pool(n)
        _POOL_SIZE = n
    # OSError/ValueError: no procs available; RuntimeError: spawn
    # bootstrap ("start a new process before ... bootstrapping phase")
    # when called at import time of an unguarded __main__. Scoring
    # still works, just serial.
    except (OSError, ValueError, RuntimeError):
        _POOL = None
        _POOL_SIZE = 0
    return _POOL


def close_pool():
    """Terminate the persistent pool, if any (a later call starts a new
    one)."""
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        _POOL.terminate()
        _POOL.join()
    _POOL, _POOL_SIZE = None, 0
