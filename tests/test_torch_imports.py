"""The port imports no JAX: every module of brever_tpu_torch loads in a
fresh interpreter without jax, flax, optax or the JAX package itself
(only ``EnhanceService`` on a model directory and the training command
line read a config through ``brever_tpu.config``, at call time), and
without nvcc or triton."""

import os
import pkgutil
import subprocess
import sys

import brever_tpu_torch

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
                 'profile_train'):
        assert f'brever_tpu_torch.{name}' in modules
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_HOME='')
    proc = subprocess.run([sys.executable, '-c', _SCRIPT, *modules],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f'ok {len(modules)}'
