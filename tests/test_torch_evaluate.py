"""``python -m brever_tpu_torch.test_model`` (and ``evaluate.py``) against the
JAX package's ``scripts/test_model.py`` on the CPU: one small Conv-TasNet
model directory, trained for an epoch by the port (a checkpoint both
packages read), scored on a WAV test set by both scripts into their own
copies of the directory.

Tolerances: the ``scores.hdf5`` layout, labels, scales and attributes are
the same; the input columns of ``pesq``, ``stoi`` and ``estoi`` are bitwise
equal (both packages' float64 host twins on the same float32 mixtures), of
``snr`` and ``sisnr`` within 1e-5 dB (float32 criteria, other summation
orders); the output columns within 1e-4 (STOI, ESTOI), 1e-3 MOS (PESQ) and
1e-3 dB (SNR, SI-SNR): the two models' outputs differ by float32 rounding
(~1e-7 of the signal).
"""

import importlib.util
import os
import shutil
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from brever_tpu_torch import test_model as port_test_model
from brever_tpu_torch import train as train_cli
from brever_tpu_torch.pesq import close_pool
from test_torch_data import write_wav_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(filters=16, filter_length=16, bottleneck_channels=8,
             hidden_channels=16, skip_channels=8, layers=2, repeats=2)
METRICS = ['pesq', 'stoi', 'estoi', 'snr', 'sisnr']
OUTPUT_ATOL = {'pesq': 1e-3, 'stoi': 1e-4, 'estoi': 1e-4, 'snr': 1e-3,
               'sisnr': 1e-3}


@pytest.fixture(scope='module', autouse=True)
def _threads():
    torch.set_num_threads(1)
    yield
    close_pool()


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """``(model_dir, test_set)``: a Conv-TasNet directory trained one epoch
    (``last.ckpt`` and a best-``snr`` checkpoint) and a test set of five
    mixtures of 0.4 to 1.5 s."""
    tmp = tmp_path_factory.mktemp('evaluate')
    with open(os.path.join(ROOT, 'config', 'models', 'convtasnet.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    config['model'].update(SMALL)
    config['train_path'] = write_wav_dataset(str(tmp / 'train'),
                                             [4000, 5000, 6000, 3000])
    config['val_path'] = write_wav_dataset(str(tmp / 'val'), [4000, 3500],
                                           seed=1)
    model_dir = tmp / 'model'
    model_dir.mkdir()
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump(config, f)
    train_cli.main([str(model_dir), '--device', 'cpu', '--epochs', '1',
                    '--use_amp', 'false', '--val_metrics', 'snr',
                    '--val_period', '1'])
    test_set = write_wav_dataset(str(tmp / 'test_set'),
                                 [24000, 16000, 9000, 12001, 6400], seed=2)
    return str(model_dir), test_set


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_test_model', os.path.join(ROOT, 'scripts', 'test_model.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['test_model.py'] + argv)
    _jax_script().main()


def _read(path):
    with h5py.File(path, 'r') as f:
        out = {}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], [d.label for d in obj.dims],
                             [[s.name for s in d.values()]
                              for d in obj.dims])
        f.visititems(visit)
        return out, dict(f.attrs)


def test_scores_file_is_the_jax_scripts(trained, tmp_path, monkeypatch):
    """Both scripts on copies of the directory: the same datasets, labels,
    scales and attributes; input scores equal, output scores within the
    module's bounds."""
    model_dir, test_set = trained
    dirs = [str(tmp_path / name) for name in ('port', 'jax')]
    for d in dirs:
        shutil.copytree(model_dir, d)
    port_test_model.main(['-i', dirs[0], '-t', test_set, '--device', 'cpu'])
    _run_jax(['-i', dirs[1], '-t', test_set], monkeypatch)
    port, port_attrs = _read(os.path.join(dirs[0], 'scores.hdf5'))
    jax, jax_attrs = _read(os.path.join(dirs[1], 'scores.hdf5'))
    assert sorted(port) == sorted(jax) == [
        'last.ckpt/test_set', 'metrics', 'which']
    assert port_attrs == jax_attrs
    assert 'pesq_implementation' in port_attrs
    for name in ('metrics', 'which'):
        np.testing.assert_array_equal(port[name][0], jax[name][0])
    scores, labels, scales = port['last.ckpt/test_set']
    want, want_labels, want_scales = jax['last.ckpt/test_set']
    assert labels == want_labels == ['mixture', 'metric', 'which']
    assert scales == want_scales
    assert scores.shape == want.shape == (5, len(METRICS), 2)
    for i, name in enumerate(METRICS):
        if name in ('snr', 'sisnr'):
            np.testing.assert_allclose(scores[:, i, 0], want[:, i, 0],
                                       rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(scores[:, i, 0], want[:, i, 0])
        np.testing.assert_allclose(scores[:, i, 1], want[:, i, 1], rtol=0,
                                   atol=OUTPUT_ATOL[name], err_msg=name)
    assert np.isfinite(scores).all()


def test_best_checkpoint_and_idempotence(trained, tmp_path):
    """``--best snr`` scores the best-snr checkpoint under its own name; a
    second run leaves the file as it is unless ``--force``."""
    model_dir, test_set = trained
    work = str(tmp_path / 'model')
    shutil.copytree(model_dir, work)
    args = ['-i', work, '-t', test_set, '--device', 'cpu', '--metrics',
            'stoi', 'snr', '--best', 'snr']
    port_test_model.main(args)
    path = os.path.join(work, 'scores.hdf5')
    best = port_test_model.find_best_checkpoint(
        os.path.join(work, 'checkpoints'), 'snr')
    scores, _ = _read(path)
    key = f'{os.path.basename(best)}/test_set'
    assert key in scores and key.startswith('epoch=0_snr=')
    with h5py.File(path, 'a') as f:
        f[key][...] = -1.0
    port_test_model.main(args)
    assert (_read(path)[0][key][0] == -1.0).all()
    port_test_model.main(args + ['--force'])
    assert np.isfinite(_read(path)[0][key][0]).all()
    assert (_read(path)[0][key][0] != -1.0).any()


def test_device_metrics_and_write_false(trained):
    """``--device_metrics`` scores STOI, ESTOI, PESQ and SNR with the device
    twins (on the CPU here), within their bounds of the host twins (STOI
    2e-3, PESQ 5e-3 MOS); ``write=False`` returns the scores and writes
    nothing."""
    model_dir, test_set = trained
    cfg = port_test_model.get_config(os.path.join(model_dir, 'config.yaml'))
    ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    model = port_test_model.load_model(model_dir, ckpt, cfg, 'cpu')
    names = ['stoi', 'estoi', 'pesq', 'snr']
    scores = {}
    for device_metrics in (False, True):
        args = port_test_model.parse_args(
            ['-i', model_dir, '-t', test_set, '--device', 'cpu']
            + (['--device_metrics'] if device_metrics else []))
        scores[device_metrics] = port_test_model.test_model(
            args, model, cfg, test_set, '/nonexistent/scores.hdf5', ckpt,
            names, write=False)
    assert not os.path.exists(os.path.join(model_dir, 'scores.hdf5'))
    for i, atol in enumerate((2e-3, 2e-3, 5e-3, 1e-4)):
        np.testing.assert_allclose(scores[True][:, i], scores[False][:, i],
                                   rtol=0, atol=atol, err_msg=names[i])


def test_refuses_without_h5py(trained, monkeypatch):
    """Without h5py the command refuses before any model is loaded."""
    model_dir, test_set = trained
    monkeypatch.setitem(sys.modules, 'h5py', None)
    monkeypatch.setattr(port_test_model, 'load_model',
                        lambda *a, **k: pytest.fail('model loaded'))
    with pytest.raises(ImportError, match='h5py'):
        port_test_model.main(['-i', model_dir, '-t', test_set, '--device',
                              'cpu'])
