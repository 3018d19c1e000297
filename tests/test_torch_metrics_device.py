"""The port's validation-metric twins (brever_tpu_torch.metrics_device,
.metric_tables) against the JAX package's (``brever_tpu/metrics_device.py``)
on the CPU, both float32, on the JAX test's enhancement-style signals
(a modulated multi-tone reference plus noise at 20, 5, 0 and -5 dB, ragged
lengths in one padded batch).

* The tables (STOI's band matrix, window and resampling window; PESQ's
  window, grouping, thresholds and Bark layout per mode) bit for bit.
* The resampler against the JAX twin at 1e-5 of the largest value and
  against ``scipy.signal.resample_poly`` (the host metric's) at 2e-5.
* STOI and ESTOI within 2e-3, PESQ (wb and nb) within 5e-3 MOS: the JAX
  twin's own bounds against the host metric, on the JAX test's batch, and
  STOI on its ragged boundary lengths (0.25 s, both sides of a 10 kHz frame
  edge), where PESQ of the padded batch is held against each item alone;
  the sentinel 1e-5 for signals too short for STOI; the identity score of
  wideband PESQ at the published bound 4.643888749336258 within 2e-3;
  ``snr``/``sisnr`` at rtol 2e-4, atol 1e-4. A float64 run of each twin
  agrees with the float32 run within the same bounds.
* The trainer scores ``stoi``/``estoi``/``pesq`` with the twins when
  ``device_val_metrics`` is true and with the host twins when it is false;
  it refuses a name that no registry knows.

JAX compiles only shapes that tests/test_metrics_device.py compiles too,
one PESQ graph a mode.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import brever_tpu.metrics_device as jax_twins
from brever_tpu import pesq as jax_pesq
from brever_tpu import stoi as jax_stoi
from brever_tpu_torch import metric_tables as mt
from brever_tpu_torch import metrics
from brever_tpu_torch import metrics_device as twins
from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.training import BreverTrainer
from test_metrics_device import _pairs, _speechy
from utils import DummyDataset

BOUND = {'stoi': 2e-3, 'estoi': 2e-3, 'pesq': 5e-3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pairs():
    deg, ref, lengths = _pairs()
    return deg.astype(np.float32), ref.astype(np.float32), lengths


def _ragged():
    """The JAX test's boundary lengths: 0.25 s, both sides of a 10 kHz
    frame edge, mid-range, full."""
    rng = np.random.RandomState(7)
    lengths = np.array([4000, 6400, 6401, 8192, 12800, 16000])
    ref = np.zeros((6, 16000), np.float32)
    deg = np.zeros((6, 16000), np.float32)
    for i, n in enumerate(lengths):
        c = _speechy(rng, int(n))
        ref[i, :n] = c
        deg[i, :n] = c + 0.2 * rng.randn(int(n))
    return deg, ref, lengths


def test_tables_are_the_jax_packages():
    np.testing.assert_array_equal(mt.OBM, jax_stoi._OBM)
    np.testing.assert_array_equal(mt.WIN, jax_stoi._WIN)
    np.testing.assert_array_equal(mt.resample_window_oct(10000, 16000),
                                  jax_stoi._resample_window_oct(10000, 16000))
    for name in ('FS', 'FRAME', 'NFFT', 'HOP', 'SEG', 'BETA', 'DYN_RANGE'):
        assert getattr(mt, f'STOI_{name}') == getattr(jax_stoi,
                                                      f'_STOI_{name}')
    for name in ('TARGET_AVG_POWER', 'DATAPADDING_MS', 'SEARCHBUFFER', 'SP',
                 'SL', 'MIN_SCALE', 'MAX_SCALE', 'ZWICKER_POWER',
                 'SYLLABLE_FRAMES', 'D_WEIGHT', 'DA_WEIGHT'):
        assert getattr(mt, name) == getattr(jax_pesq, name)
    np.testing.assert_array_equal(mt.IRS_FILTER_DB, jax_pesq._IRS_FILTER_DB)
    assert mt.WB_IIR_16K == jax_pesq._WB_IIR_16K
    for fs, mode in ((16000, 'wb'), (16000, 'nb'), (8000, 'nb')):
        mine, theirs = mt.PesqConfig(fs, mode), jax_pesq._Config(fs, mode)
        for name in ('downsample', 'nf', 'hop', 'n_bins', 'window',
                     'band_of_bin', 'centre_bark', 'width_bark',
                     'abs_thresh', 'group'):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(theirs, name))
    plan = twins.pesq_plan(16000, 'wb', 24000)
    theirs = jax_twins._pesq_plan(16000, 'wb', 24000)
    for name in ('pad_front', 'length', 'n_frames', 'span', 'xcorr_nfft'):
        assert plan[name] == theirs[name]
    np.testing.assert_array_equal(plan['fir'], theirs['fir'])
    with pytest.raises(ValueError, match='wideband'):
        twins.pesq_device(np.zeros(8000), np.zeros(8000), fs=8000)


def test_resample_matches_jax_and_scipy():
    x = np.random.RandomState(1).randn(3, 16000)
    got = twins.resample_poly(torch.from_numpy(x.astype(np.float32)), 16000,
                              10000).numpy()
    want = np.asarray(jax_twins._resample_poly_jnp(x.astype(np.float32),
                                                   16000, 10000))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    h = jax_stoi._resample_window_oct(10000, 16000)
    for i in range(3):
        ref = scipy.signal.resample_poly(x[i], 10000, 16000,
                                         window=h / np.sum(h))
        np.testing.assert_allclose(got[i], ref, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize('name', ['stoi', 'estoi'])
def test_stoi_matches_jax(pairs, name):
    deg, ref, lengths = pairs
    want = np.asarray(jax_twins.DEVICE_METRICS[name](deg, ref,
                                                     lengths=lengths))
    got = twins.DEVICE_METRICS[name](deg, ref, lengths=lengths)
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, atol=BOUND[name])
    got64 = twins.DEVICE_METRICS[name](deg.astype(np.float64),
                                       ref.astype(np.float64),
                                       lengths=lengths)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), got.numpy(), atol=BOUND[name])
    one = twins.DEVICE_METRICS[name](deg[1, :lengths[1]], ref[1, :lengths[1]])
    assert one.shape == ()
    np.testing.assert_allclose(float(one), want[1], atol=BOUND[name])


def test_stoi_too_short_returns_sentinel():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4000)
    out = twins.stoi_device(x, x + 0.1 * rng.randn(2, 4000),
                            lengths=[4000, 3000])
    np.testing.assert_allclose(out.numpy(), 1e-5)


def test_snr_and_sisnr_match_jax(pairs):
    deg, ref, lengths = pairs
    for name in ('snr', 'sisnr'):
        want = np.asarray(jax_twins.DEVICE_METRICS[name](deg, ref,
                                                         lengths=lengths))
        got = twins.DEVICE_METRICS[name](deg, ref, lengths=lengths)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize('mode', ['wb', 'nb'])
def test_pesq_matches_jax(pairs, mode):
    deg, ref, lengths = pairs
    if mode == 'nb':    # the JAX test's nb batch
        deg, ref, lengths = deg[:2], ref[:2], lengths[:2]
    want = np.asarray(jax_twins.pesq_device(deg, ref, lengths=lengths,
                                            mode=mode))
    got = twins.pesq_device(deg, ref, lengths=lengths, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=BOUND['pesq'])
    got64 = twins.pesq_device(deg.astype(np.float64), ref.astype(np.float64),
                              lengths=lengths, mode=mode)
    np.testing.assert_allclose(got64.numpy(), got.numpy(),
                               atol=BOUND['pesq'])
    if mode == 'wb':
        assert got[0] > got[2] > got[3]


def test_ragged_boundary_lengths():
    """STOI of the padded batch against the JAX twin; PESQ of the padded
    batch against each item scored alone (its own, unpadded graph), so that
    JAX compiles one PESQ graph a mode."""
    deg, ref, lengths = _ragged()
    want = np.asarray(jax_twins.stoi_device(deg, ref, lengths=lengths))
    got = twins.stoi_device(deg, ref, lengths=lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=BOUND['stoi'])
    got = twins.pesq_device(deg, ref, lengths=lengths)
    alone = [float(twins.pesq_device(deg[i, :n], ref[i, :n]))
             for i, n in enumerate(lengths)]
    np.testing.assert_allclose(got.numpy(), alone, atol=BOUND['pesq'])


def test_pesq_identity_and_silence():
    x = _speechy(np.random.RandomState(3), 20000)[None].astype(np.float32)
    score = float(twins.pesq_device(x, x)[0])
    np.testing.assert_allclose(score, 4.643888749336258, atol=2e-3)
    silent = twins.pesq_device(np.ones((1, 8000)), np.zeros((1, 8000)))
    assert torch.isnan(silent).all()


def _trainer(tmp_path, **kwargs):
    model = ModelRegistry.get('ffnn')(hidden_layers=[16], device='cpu')
    return BreverTrainer(
        model, DummyDataset(n_items=2, min_length=0.5, max_length=0.6),
        DummyDataset(n_items=2, min_length=0.5, max_length=0.6, seed=7),
        model_dirpath=str(tmp_path), epochs=1, device='cpu',
        batch_size=2.0, val_period=1, **kwargs)


def test_trainer_scores_with_the_twins_and_refuses_without(tmp_path):
    names = {'estoi', 'pesq', 'snr'}
    trainer = _trainer(tmp_path, val_metrics=names)
    assert trainer.device_val_metrics
    trainer.init_state()
    rng = np.random.RandomState(4)
    clean = 0.3 * rng.randn(2, 1, 2, 9000)
    batch = torch.from_numpy(np.concatenate(
        [clean + 0.1 * rng.randn(*clean.shape), clean], axis=1)
        .astype(np.float32))
    lengths = torch.tensor([9000, 8000])
    got = trainer.compute_metrics(batch, lengths, 2)
    enhanced = trainer.model.enhance(batch[:, 0])
    target = batch[:, 1].mean(dim=-2)
    for name in names:
        want = twins.DEVICE_METRICS[name](enhanced, target, lengths).mean()
        assert got[name] == float(want)
    # without device_val_metrics the host twins score them (they were
    # refused before the host twins were ported); an unknown name raises
    host = _trainer(tmp_path, val_metrics={'stoi', 'snr'},
                    device_val_metrics=False)
    host.init_state()
    got = host.compute_metrics(batch, lengths, 2)
    enhanced = host.model.enhance(batch[:, 0])
    want = metrics.MetricRegistry.get('stoi')(enhanced, target,
                                              lengths=lengths)
    assert got['stoi'] == float(np.mean(want))
    with pytest.raises(KeyError, match='no_such_metric'):
        _trainer(tmp_path, val_metrics={'no_such_metric', 'snr'},
                 device_val_metrics=False)
    _trainer(tmp_path, val_metrics={'snr', 'sisnr'}, device_val_metrics=False)
    metrics.check_metrics({'pesq', 'stoi', 'pesq_approx'},
                          device_val_metrics=True)
