"""The port imports no JAX: every module of brever_tpu_torch loads in a
fresh interpreter without jax, flax, optax or the JAX package itself, and
without nvcc or triton; and the two entry points that read a model
directory's ``config.yaml`` (``python -m brever_tpu_torch.train`` and
``EnhanceService(model_dir)``) run in a fresh interpreter without loading
any module of the JAX package, at import time or at call time: the port
reads configs through its own ``brever_tpu_torch.config``. The entry
points are run on a Conv-TasNet and on a DCCRN model directory."""

import os
import pkgutil
import subprocess
import sys

import brever_tpu_torch
from brever_tpu_torch import train as train_cli
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
                 'profile_train', 'models.dccrn', 'ops.lstm_scan'):
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
