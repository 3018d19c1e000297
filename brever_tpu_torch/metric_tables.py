"""Constants and host-side tables of the validation metrics (the port's own
copy of what ``brever_tpu/stoi.py`` and ``brever_tpu/pesq.py`` define):
STOI's framing, third-octave band matrix, window and Octave-compatible
resampling window; PESQ's P.862 constants, Bark band layout, absolute
thresholds and input filters. numpy only: the device twins
(:mod:`brever_tpu_torch.metrics_device`) build their tensors from these.
"""

import numpy as np

# ---------------------------------------------------------------------------
# STOI / ESTOI (pystoi's numerics)

#: pystoi uses np.finfo("float").eps (float64) throughout
EPS = np.finfo(np.float64).eps

STOI_FS = 10000
STOI_FRAME = 256
STOI_NFFT = 512
STOI_HOP = 128
STOI_NBANDS = 15
STOI_MINFREQ = 150.0
STOI_SEG = 30           # frames per 384 ms segment
STOI_BETA = -15.0       # lower SDR bound (dB)
STOI_DYN_RANGE = 40.0   # VAD dynamic range (dB)


def third_octave_bands(fs, nfft, num_bands, min_freq):
    """One-third octave band matrix over rFFT bins."""
    f = np.linspace(0, fs, nfft + 1)[:nfft // 2 + 1]
    k = np.arange(num_bands)
    freq_low = min_freq * 2.0**((2 * k - 1) / 6)
    freq_high = min_freq * 2.0**((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin((f - freq_low[i])**2)
        hi = np.argmin((f - freq_high[i])**2)
        obm[i, lo:hi] = 1
    return obm


OBM = third_octave_bands(STOI_FS, STOI_NFFT, STOI_NBANDS, STOI_MINFREQ)
WIN = np.hanning(STOI_FRAME + 2)[1:-1]


def resample_window_oct(p, q):
    """Octave-compatible anti-aliasing window (pystoi's resampler)."""
    gcd = np.gcd(int(p), int(q))
    p, q = int(p) // gcd, int(q) // gcd
    log10_rejection = -3.0
    stopband_cutoff_f = 1.0 / (2 * max(p, q))
    roll_off_width = stopband_cutoff_f / 10
    rejection_db = -20 * log10_rejection
    half = np.ceil(rejection_db / (22 * roll_off_width))
    t = np.arange(-half, half + 1)
    ideal_filter = 2 * p * stopband_cutoff_f * np.sinc(
        2 * stopband_cutoff_f * t)
    if 21 < rejection_db <= 50:
        chi = (0.5842 * (rejection_db - 21) ** 0.4
               + 0.07886 * (rejection_db - 21))
    elif rejection_db > 50:
        chi = 0.1102 * (rejection_db - 8.7)
    else:
        chi = 0.0
    return np.kaiser(int(2 * half + 1), chi) * ideal_filter


# ---------------------------------------------------------------------------
# PESQ (the repo's own P.862 / P.862.2 perceptual model)

TARGET_AVG_POWER = 1e7
DATAPADDING_MS = 320
SEARCHBUFFER = 75          # in Downsample-sized units
SP = 6.910853e-6           # power scaling (P.862 reference constant)
SL = 1.866055e-1           # loudness scaling (P.862 reference constant)
N_BARK_BANDS = 49
MIN_SCALE = 3e-4           # gain compensation bounds
MAX_SCALE = 5.0
ZWICKER_POWER = 0.23
SYLLABLE_FRAMES = 20       # 20 half-overlapping frames ~ 320 ms
D_WEIGHT = 0.1
DA_WEIGHT = 0.0309

#: IRS receive characteristic, (Hz, dB) breakpoints (P.862 Annex A)
IRS_FILTER_DB = np.array([
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12),
    (700, 12), (800, 12), (1000, 12), (1300, 12), (1600, 12), (2000, 12),
    (2500, 12), (3000, 12), (3250, 12), (3500, 4), (4000, -200),
    (5000, -200), (6300, -200), (8000, -200),
], dtype=np.float64)

#: P.862.2 wideband input prefilter, one second-order section at 16 kHz
#: (b0, b1, b2, a1, a2)
WB_IIR_16K = (2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487459)


def bark(f):
    """Zwicker-style Bark scale used to lay out the band grid."""
    return 7.0 * np.arcsinh(np.asarray(f, dtype=np.float64) / 650.0)


def bark_to_hz(z):
    return 650.0 * np.sinh(np.asarray(z, dtype=np.float64) / 7.0)


def terhardt_threshold_db(f):
    """Absolute threshold of hearing (dB SPL), Terhardt 1979."""
    f = np.maximum(np.asarray(f, dtype=np.float64), 20.0) / 1000.0
    return (3.64 * f**-0.8 - 6.5 * np.exp(-0.6 * (f - 3.3)**2)
            + 1e-3 * f**4)


class PesqConfig:
    """Per-(fs, mode) constants: frame sizes and Bark band layout (one
    instance per pair)."""

    _cache = {}

    def __new__(cls, fs, mode):
        key = (fs, mode)
        if key not in cls._cache:
            cls._cache[key] = super().__new__(cls)
            cls._cache[key]._init(fs, mode)
        return cls._cache[key]

    def _init(self, fs, mode):
        self.fs = fs
        self.mode = mode
        self.downsample = fs // 250        # 4 ms envelope granularity
        self.nf = int(fs * 0.032)          # 32 ms frames (256 / 512)
        self.hop = self.nf // 2
        self.window = 0.5 * (1.0 - np.cos(
            2.0 * np.pi * np.arange(self.nf) / self.nf))
        self.n_bins = self.nf // 2         # DC..just below Nyquist
        bin_hz = np.arange(self.n_bins) * fs / self.nf

        # 49 bands uniform on the Bark grid over the mode's band, from
        # ~100 Hz up to the IRS cutoff (nb) or 8 kHz (wb)
        fmax = 3500.0 if mode == 'nb' else 8000.0
        edges_bark = np.linspace(bark(100.0), bark(fmax), N_BARK_BANDS + 1)
        edges_hz = bark_to_hz(edges_bark)
        self.band_of_bin = np.digitize(bin_hz, edges_hz) - 1
        self.valid_bin = (self.band_of_bin >= 0) \
            & (self.band_of_bin < N_BARK_BANDS)
        self.centre_bark = 0.5 * (edges_bark[:-1] + edges_bark[1:])
        self.width_bark = np.diff(edges_bark)
        centre_hz = bark_to_hz(self.centre_bark)

        # absolute threshold in internal power units, anchored so the flat
        # mid-band threshold sits at ~0.23 units (offset -6.4 dB at the
        # Terhardt minimum)
        thresh_db = terhardt_threshold_db(centre_hz)
        offset = -6.4 - thresh_db.min()
        self.abs_thresh = 10.0 ** ((thresh_db + offset) / 10.0)

        # grouping matrix: (bands, bins) 0/1, summing
        self.group = np.zeros((N_BARK_BANDS, self.n_bins))
        self.group[self.band_of_bin[self.valid_bin],
                   np.arange(self.n_bins)[self.valid_bin]] = 1.0


def check_fs_mode(fs, mode):
    if mode not in ('nb', 'wb'):
        raise ValueError(f"mode must be 'nb' or 'wb', got '{mode}'")
    if mode == 'nb' and fs not in (8000, 16000):
        raise ValueError('narrowband PESQ requires fs 8000 or 16000')
    if mode == 'wb' and fs != 16000:
        raise ValueError('wideband PESQ requires fs 16000')
