"""The port imports no JAX: every module of brever_tpu_torch loads in a
fresh interpreter without jax, flax, optax or the JAX package itself, and
without nvcc or triton; and the two entry points that read a model
directory's ``config.yaml`` (``python -m brever_tpu_torch.train`` and
``EnhanceService(model_dir)``) run in a fresh interpreter without loading
any module of the JAX package, at import time or at call time: the port
reads configs through its own ``brever_tpu_torch.config``. The entry
points are run on a Conv-TasNet, a DCCRN, a (narrowed) MANNER, an IDMSE and
an FFNN model directory (FFNN's from its default config, its validation
metrics scored by the device twins of ``metrics_device``), and a MetricGAN+
one (from its default config: host PESQ targets through the spawn pool),
which ``python -m brever_tpu_torch.test_model`` then scores."""

import os
import pkgutil
import subprocess
import sys

import brever_tpu_torch
from brever_tpu_torch import train as train_cli
from test_torch_data import write_wav_dataset
from test_torch_ffnn import _model_dir as _ffnn_model_dir
from test_torch_metricgan import _model_dir as _metricgan_model_dir
from test_torch_training import _model_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
heavy = sorted(m for m in ('jax', 'flax', 'optax', 'triton', 'brever_tpu')
               if m in sys.modules)
assert not heavy, heavy
print('ok', len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
    modules = ['brever_tpu_torch'] + [
        m.name for m in pkgutil.walk_packages(brever_tpu_torch.__path__,
                                              'brever_tpu_torch.')]
    for name in ('serve', 'ops.tcn_block', 'criterion', 'metrics',
                 'batching', 'data', 'optim', 'training', 'train',
                 'profile_train', 'models.dccrn', 'ops.lstm_scan',
                 'models.manner', 'ops.batchnorm', 'ops.stft_kernel',
                 'numerics', 'ops.fma_chain', 'bench_alu_dtype',
                 'models.ffnn', 'ops.features', 'metrics_device',
                 'metric_tables', 'stoi', 'pesq', 'evaluate', 'test_model',
                 'models.metricgan', 'probe_conv_grads'):
        assert f'brever_tpu_torch.{name}' in modules
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_HOME='')
    proc = subprocess.run([sys.executable, '-c', _SCRIPT, *modules],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f'ok {len(modules)}'


#: after the call: no module of the JAX package (nor jax) is loaded
_NO_JAX_PACKAGE = """
left = sorted(m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'optax', 'brever_tpu'))
assert not left, left
print('ok')
"""

_TRAIN_ARGS = ['--device', 'cpu', '--epochs', '1', '--use_amp', 'false',
               '--val_metrics', 'snr', '--batch_size', '2',
               '--dynamic_batch_size', 'false', '--batch_sampler', 'random',
               '--val_period', '1']


def _fresh(code, *args):
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_HOME='')
    proc = subprocess.run([sys.executable, '-c', code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def test_train_main_loads_no_jax_package(tmp_path):
    model_dir = _model_dir(tmp_path)
    code = ('import sys\n'
            'from brever_tpu_torch import train\n'
            'train.main(sys.argv[1:])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir, *_TRAIN_ARGS)[-1] == 'ok'
    assert os.path.exists(os.path.join(model_dir, 'checkpoints',
                                       'last.ckpt'))


def test_enhance_service_loads_no_jax_package(tmp_path):
    model_dir = _model_dir(tmp_path)
    train_cli.main([model_dir, *_TRAIN_ARGS])
    code = ('import sys\n'
            'import numpy as np\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["checkpoint"])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir) == ['last.ckpt', 'ok']


def test_dccrn_entry_points_load_no_jax_package(tmp_path):
    """``train.main`` trains a small DCCRN model directory and
    ``EnhanceService`` serves it, each in a fresh interpreter that loads
    nothing of the JAX package."""
    model_dir = _model_dir(tmp_path, 'dccrn')
    code = ('import sys\n'
            'import numpy as np\n'
            'from brever_tpu_torch import train\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'train.main(sys.argv[1:])\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["arch"])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir, *_TRAIN_ARGS) == ['dccrn', 'ok']


def test_manner_entry_points_load_no_jax_package(tmp_path):
    """``train.main`` trains a MANNER model directory (its network narrowed:
    the family has no size options) and ``EnhanceService`` serves it, in a
    fresh interpreter that loads nothing of the JAX package."""
    model_dir = _model_dir(tmp_path, 'manner')
    code = ('import sys, functools\n'
            'import numpy as np\n'
            'from brever_tpu_torch import train\n'
            'from brever_tpu_torch.models import manner\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'manner._MannerModule = functools.partial(\n'
            '    manner._MannerModule, hidden=12, depth=2, segment_len=8)\n'
            'train.main(sys.argv[1:])\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["arch"])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir, *_TRAIN_ARGS) == ['manner', 'ok']


def test_idmse_entry_points_load_no_jax_package(tmp_path):
    """``train.main`` trains a small idmse model directory (ADM blocks) and
    ``EnhanceService`` serves it, in a fresh interpreter that loads nothing
    of the JAX package."""
    model_dir = _model_dir(tmp_path, 'idmse')
    code = ('import sys\n'
            'import numpy as np\n'
            'from brever_tpu_torch import train\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'train.main(sys.argv[1:])\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["arch"])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir, *_TRAIN_ARGS) == ['idmse', 'ok']


def test_ffnn_entry_points_load_no_jax_package(tmp_path):
    """``train.main`` trains an FFNN model directory from the default config
    (64 hidden units) with no option but the device, scoring ``estoi``,
    ``pesq`` and ``snr`` with the device twins, and ``EnhanceService`` serves
    it, in a fresh interpreter that loads nothing of the JAX package."""
    model_dir = _ffnn_model_dir(tmp_path)
    code = ('import sys\n'
            'import numpy as np\n'
            'from brever_tpu_torch import train\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'trainer = train.main(sys.argv[1:])\n'
            'print(sorted(trainer.loss_logger.metrics[-1]))\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["arch"])\n' + _NO_JAX_PACKAGE)
    assert _fresh(code, model_dir, '--device', 'cpu', '--epochs', '1',
                  '--val_period', '1')[-3:] == [
        "['estoi', 'pesq', 'snr']", 'ffnn', 'ok']


def test_metricgan_and_test_model_load_no_jax_package(tmp_path):
    """``train.main`` trains a MetricGAN+ model directory from its default
    config (widths cut) with its host PESQ targets, ``EnhanceService``
    serves it and ``test_model.main`` scores a test set with the host
    twins, in a fresh interpreter that loads nothing of the JAX
    package."""
    model_dir = _metricgan_model_dir(tmp_path)
    test_set = write_wav_dataset(str(tmp_path / 'test'), [9000, 6000],
                                 seed=3)
    code = ('import sys\n'
            'import numpy as np\n'
            'from brever_tpu_torch import test_model, train\n'
            'from brever_tpu_torch.pesq import close_pool\n'
            'from brever_tpu_torch.serve import EnhanceService\n'
            'trainer = train.main(sys.argv[1:6])\n'
            'print(sorted(trainer.loss_logger.train_loss[-1]))\n'
            'service = EnhanceService(sys.argv[1], "cpu")\n'
            'out = service.enhance(np.zeros(1600, np.float32))\n'
            'assert out.shape == (1600,), out.shape\n'
            'print(service.health()["arch"])\n'
            'test_model.main(["-i", sys.argv[1], "-t", sys.argv[6],\n'
            '                 "--device", "cpu", "--metrics", "pesq",\n'
            '                 "stoi", "snr"])\n'
            'close_pool()\n' + _NO_JAX_PACKAGE)
    out = _fresh(code, model_dir, '--device', 'cpu', '--epochs', '1',
                 test_set)
    assert [line for line in out if line.startswith(("['", 'metricgan'))] \
        == ["['loss_d', 'loss_g']", 'metricganp']
    assert out[-1] == 'ok'
    assert os.path.exists(os.path.join(model_dir, 'scores.hdf5'))
