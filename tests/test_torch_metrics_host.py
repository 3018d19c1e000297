"""The port's host metric twins (``brever_tpu_torch.stoi``, ``.pesq`` and the
``stoi``/``estoi``/``pesq`` of ``brever_tpu_torch.metrics``) against the JAX
package's (``brever_tpu/stoi.py``, ``pesq.py``, ``metrics.py``) on a seeded
ragged batch: tone-in-noise items of 0.19 to 1.5 s at 20 to -5 dB, two of
them under STOI's 30 frames after silence removal (1e-5) and one under
PESQ's 0.25 s (NaN), and a silent one (PESQ: no utterances).

Tolerance: bitwise. The port's twins are the JAX package's float64 numpy
code on the same tables (``metric_tables.py``, held bit for bit since the
device twins' slice), so every score, NaN included, is the same float.
The device twins against these host twins: STOI and ESTOI within 2e-3,
PESQ within 5e-3 MOS (their own bounds; PESQ's device twin aligns by one
global delay).
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from brever_tpu import metrics as jax_metrics
from brever_tpu import pesq as jax_pesq
from brever_tpu import stoi as jax_stoi
from brever_tpu_torch import metrics
from brever_tpu_torch import pesq as port_pesq
from brever_tpu_torch import stoi as port_stoi

FS = 16000
LENGTHS = (24000, 20000, 16001, 6000, 3000, 16000, 12000)
SILENT = 5
SNRS = (20, 10, 5, 0, -5)


@pytest.fixture(scope='module', autouse=True)
def _pools():
    torch.set_num_threads(1)
    yield
    port_pesq.close_pool()
    if jax_pesq._POOL is not None:
        jax_pesq._POOL.terminate()
        jax_pesq._POOL = None
        jax_pesq._POOL_SIZE = 0


def _batch(seed=0):
    """``(deg, ref, lengths)``: a padded float32 batch of voiced tones in
    noise, zero past each item's length; item ``SILENT`` is silence."""
    rng = np.random.RandomState(seed)
    lengths = np.array(LENGTHS)
    n_max = int(lengths.max())
    t = np.arange(n_max) / FS
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    ref = np.zeros((len(lengths), n_max), np.float32)
    deg = np.zeros((len(lengths), n_max), np.float32)
    for i, n in enumerate(lengths):
        if i == SILENT:
            continue
        f0 = rng.uniform(120, 260)
        clean = env[:n] * (np.sin(2 * np.pi * f0 * t[:n])
                           + 0.5 * np.sin(2 * np.pi * 3.9 * f0 * t[:n]))
        clean += 0.01 * rng.randn(n)
        snr = SNRS[i % len(SNRS)]
        ref[i, :n] = clean
        deg[i, :n] = clean + rng.randn(n) * np.sqrt(
            np.mean(clean ** 2) / 10 ** (snr / 10))
    return deg, ref, lengths


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


@pytest.mark.parametrize('extended', [False, True])
def test_stoi_single_is_the_jax_one(extended):
    deg, ref, lengths = _batch()
    for i, n in enumerate(lengths):
        # the items under 30 frames warn and score 1e-5 in both packages
        with np.errstate(all='ignore'), warnings.catch_warnings():
            warnings.simplefilter('ignore')
            got = port_stoi.stoi_single(deg[i, :n], ref[i, :n], FS,
                                        extended)
            want = jax_stoi.stoi_single(deg[i, :n], ref[i, :n], FS,
                                        extended)
        _equal(got, want)
        assert (got == 1e-5) == (n < 7000)


@pytest.mark.parametrize('extended', [False, True])
def test_stoi_batch_vectorized_is_the_jax_one(extended):
    deg, ref, lengths = _batch()
    with np.errstate(all='ignore'), pytest.warns(UserWarning):
        got = port_stoi.stoi_batch_vectorized(deg, ref, FS, extended,
                                              lengths)
    with np.errstate(all='ignore'), pytest.warns(UserWarning):
        want = jax_stoi.stoi_batch_vectorized(deg, ref, FS, extended,
                                              lengths)
    _equal(got, want)
    assert np.isfinite(got).all() and (got[3:5] == 1e-5).all()


@pytest.mark.parametrize('name', ['stoi', 'estoi'])
def test_stoi_metrics_are_the_jax_ones(name, monkeypatch):
    """The registry's batched (per item through the pool), unbatched and
    ``BREVER_STOI_VEC=1`` paths, and tensors of any device in."""
    deg, ref, lengths = _batch(1)
    port, jax = metrics.MetricRegistry.get(name), \
        jax_metrics.MetricRegistry.get(name)
    with np.errstate(all='ignore'):
        got = port(deg, ref, lengths=lengths)
        _equal(got, jax(deg, ref, lengths=lengths))
        _equal(port(torch.from_numpy(deg), torch.from_numpy(ref),
                    lengths=torch.from_numpy(lengths)), got)
        _equal(port(deg, ref, batched=False, lengths=lengths), got)
        monkeypatch.setenv('BREVER_STOI_VEC', '1')
        _equal(port(deg, ref, lengths=lengths),
               jax(deg, ref, lengths=lengths))
        one = port(deg[0], ref[0])
    assert isinstance(one, float) and one == got[0]
    with pytest.raises(ValueError, match='lengths'):
        port(deg[0], ref[0], batched=False, lengths=[10])


@pytest.mark.parametrize('mode', ['wb', 'nb'])
def test_pesq_is_the_jax_one(mode):
    """Item by item, utterance realignment on and off; the short item
    raises ``PesqError`` and the silent one ``NoUtterancesError`` in both
    packages."""
    deg, ref, lengths = _batch(2)
    for i, n in enumerate(lengths):
        if n < FS // 4:
            for pesq_fn, error in ((port_pesq.pesq, port_pesq.PesqError),
                                   (jax_pesq.pesq, jax_pesq.PesqError)):
                with pytest.raises(error, match='too short'):
                    pesq_fn(FS, ref[i, :n], deg[i, :n], mode)
            continue
        if i == SILENT:
            with pytest.raises(port_pesq.NoUtterancesError):
                port_pesq.pesq(FS, ref[i, :n], deg[i, :n], mode)
            continue
        for realign in (True, False):
            got = port_pesq.pesq(FS, ref[i, :n], deg[i, :n], mode, realign)
            want = jax_pesq.pesq(FS, ref[i, :n], deg[i, :n], mode, realign)
            _equal(got, want)
            assert 1.0 < got < 4.65


@pytest.mark.parametrize('mode', ['wb', 'nb'])
def test_pesq_metric_normalized_is_the_jax_one(mode):
    """``pesq`` normalised by the mode's published bounds, batched through
    the spawn pool (NaN where an item fails) and serially."""
    deg, ref, lengths = _batch(3)
    keep = [i for i, n in enumerate(lengths) if n >= FS // 4]
    # the failing items warn in the pool's workers
    got = metrics.pesq(deg, ref, mode=mode, normalized=True, lengths=lengths)
    want = jax_metrics.pesq(deg, ref, mode=mode, normalized=True,
                            lengths=lengths)
    _equal(got, want)
    assert np.isnan(got[[4, SILENT]]).all()
    ok = [i for i in keep if i != SILENT]
    assert ((got[ok] > 0) & (got[ok] <= 1)).all()
    serial = metrics.pesq(deg[ok], ref[ok], mode=mode, normalized=True,
                          batched=False, lengths=lengths[ok])
    _equal(serial, got[ok])
    assert metrics.MetricRegistry.get('pesq_approx') is metrics.pesq
    identity = metrics.pesq(ref[0], ref[0], mode=mode, normalized=True)
    assert identity == pytest.approx(1.0, abs=1e-12)


def test_pesq_out_of_bounds_raises(monkeypatch):
    """A normalised score outside [0, 1] raises ``RuntimeError`` in both
    packages; an unknown mode ``ValueError``."""
    for module, pesq_mod in ((metrics, port_pesq), (jax_metrics, jax_pesq)):
        monkeypatch.setattr(pesq_mod, 'pesq_batch',
                            lambda *a, **k: [0.5, 2.0])
        with pytest.raises(RuntimeError, match='out of bounds'):
            module.pesq(np.zeros((2, 8)), np.zeros((2, 8)), normalized=True)
        with pytest.raises(ValueError, match="'nb' or 'wb'"):
            module.pesq(np.zeros(8), np.zeros(8), mode='xx', batched=False)


def test_pesq_batch_layouts():
    """``pesq_batch``: one 1-D reference against each row, the length
    checks, and the serial path with one processor."""
    deg, ref, lengths = _batch(4)
    n = int(lengths[0])
    rows = port_pesq.pesq_batch(FS, ref[0, :n], deg[:2, :n], n_processor=1)
    _equal(rows, jax_pesq.pesq_batch(FS, ref[0, :n], deg[:2, :n],
                                     n_processor=1))
    with pytest.raises(ValueError, match='lengths'):
        port_pesq.pesq_batch(FS, ref[0], deg[0], lengths=[3])
    with pytest.raises(ValueError, match='batch size'):
        port_pesq.pesq_batch(FS, ref, deg, lengths=[3])


def test_check_metrics_without_device_val_metrics():
    """Every name of the JAX registry is the port's, host metrics
    included, so nothing is refused without ``device_val_metrics``."""
    assert set(metrics.MetricRegistry.keys()) \
        == set(jax_metrics.MetricRegistry.keys())
    metrics.check_metrics(set(jax_metrics.MetricRegistry.keys()),
                          device_val_metrics=False)


def test_trainer_scores_host_pesq(tmp_path):
    """A trainer built with ``pesq``, ``stoi`` and ``snr`` and
    ``device_val_metrics: false`` scores the enhanced rows with the host
    twins: the JAX package's host metrics of the same rows."""
    from brever_tpu_torch.models import ModelRegistry
    from brever_tpu_torch.profile_train import _Items
    from brever_tpu_torch.training import BreverTrainer
    model = ModelRegistry.get('convtasnet')(
        filters=16, filter_length=16, bottleneck_channels=8,
        hidden_channels=16, skip_channels=8, layers=1, repeats=1,
        device='cpu')
    items = _Items(2, 1.0)
    trainer = BreverTrainer(model, items, items, str(tmp_path),
                            device='cpu', val_metrics={'pesq', 'stoi', 'snr'},
                            device_val_metrics=False)
    trainer.init_state()
    deg, ref, lengths = _batch(5)
    batch = torch.from_numpy(np.stack([np.stack([deg[:3]] * 2, 1),
                                       np.stack([ref[:3]] * 2, 1)], 1))
    lengths = torch.from_numpy(lengths[:3])
    got = trainer.compute_metrics(batch, lengths, 2)
    enhanced = trainer.model.enhance(batch[:2, 0]).numpy()
    target = batch[:2, 1].mean(dim=-2).numpy()
    n = lengths[:2].numpy()
    for name in ('pesq', 'stoi'):
        want = jax_metrics.MetricRegistry.get(name)(enhanced, target,
                                                    lengths=n)
        assert got[name] == float(np.mean(want))
    assert set(got) == {'pesq', 'stoi', 'snr'}


def test_host_twins_import_no_torch():
    """The pool's spawned workers import the host twins: they load numpy
    and scipy, never torch."""
    code = ('import sys, brever_tpu_torch.stoi, brever_tpu_torch.pesq; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("torch", "jax", "brever_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == '[]'


@pytest.mark.parametrize('name,atol', [('stoi', 2e-3), ('estoi', 2e-3),
                                       ('pesq', 5e-3)])
def test_device_twins_are_within_their_bounds_of_the_host_twins(name,
                                                                 atol):
    """The device twins (float32, here on the CPU) against the host twins
    on the batch's time-aligned items, where the host scores them: STOI and
    ESTOI within 2e-3, PESQ within 5e-3 MOS, the twins' bounds (the smoke
    holds the card's to the same)."""
    from brever_tpu_torch import metrics_device as twins
    deg, ref, lengths = _batch(6)
    with np.errstate(all='ignore'), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        host = metrics.MetricRegistry.get(name)(deg, ref, lengths=lengths)
    device = twins.DEVICE_METRICS[name](
        torch.from_numpy(deg), torch.from_numpy(ref),
        torch.from_numpy(lengths)).double().numpy()
    scored = np.isfinite(host)
    assert scored.sum() >= len(LENGTHS) - 2
    np.testing.assert_allclose(device[scored], host[scored], rtol=0,
                               atol=atol)
