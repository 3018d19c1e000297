"""Where the time of the port's train step goes, on one CUDA device.

Builds a full-width default model of ``--arch`` (Conv-TasNet, 4,935,217
parameters; TF-GridNet, 3,735,344; SGMSE+ ``sgmsep``, 65,590,694, or
``sgmsepm``, 27,756,186; drawn from ``--seed``) and its ``BreverTrainer``
on the device, float32 with TF32 off (as ``chip_smoke.py`` runs it), and
times ``train_step`` (forward, the kernels' backward, global-norm clip
where the family clips, Adam) on a batch of ``--batch`` x 4 s (default
16; random mixture and target, the family's own criterion: ``snr``,
``multiresyu`` and SGMSE+'s weighted ``mse``):

* ms per step over ``--steps`` steps (CUDA events) with the profiler off
  and on, and the peak device memory of a step;
* from a ``torch.profiler`` trace of those steps: device time per kernel
  per step, and the device's idle share, one minus the device's busy time
  (the union of its activity) over the steps' wall time.

Prints the card (``nvidia-smi`` name and power limit) and one JSON
object; ``--trace`` also writes the Chrome trace.

    python -m brever_tpu_torch.profile_train [--arch convtasnet]
        [--device cuda] [--batch 16] [--steps 5] [--cudnn-benchmark]
        [--trace PATH]

SGMSE+ is profiled at its reference batch, ``--arch sgmsep --batch 4``.
``--cudnn-benchmark`` lets cuDNN time its convolution algorithms for each
new shape and keep the fastest (``torch.backends.cudnn.benchmark``); the
port's entry points leave it off.
"""

import argparse
import json
import subprocess
import tempfile

import numpy as np
import torch

from .models import ModelRegistry
from .profile_enhance import ARCHS, _cuda_ms, _device_time, _setup
from .training import BreverTrainer

FS = 16000


class _Items:
    """The few dataset methods the trainer's samplers read: ``n`` items
    of ``seconds`` each (the batches are built here, not loaded)."""

    def __init__(self, n, seconds):
        self.n, self.length = n, int(seconds * FS)
        self._duration = n * seconds

    def __len__(self):
        return self.n

    def get_segment_length(self, i):
        return self.length

    def get_max_segment_length(self):
        return self.length

    def set_epoch(self, epoch):
        pass


def make_trainer(device, model_dir, seed=0, batch=16, seconds=4.0,
                 arch='convtasnet'):
    """A trainer of the default model of ``arch`` on ``device`` (state
    drawn from ``seed``) and one padded batch ``(batch, lengths)`` on the
    device."""
    model = ModelRegistry.get(arch)(device='cpu')
    items = _Items(batch, seconds)
    trainer = BreverTrainer(model, items, items, model_dir, device=device,
                            val_metrics={'snr'}, seed=seed)
    trainer.init_state()
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    target = 0.1 * rng.randn(batch, 1, 2, n)
    mix = target + 0.1 * rng.randn(batch, 1, 2, n)
    data = torch.from_numpy(np.concatenate([mix, target], axis=1)
                            .astype(np.float32)).to(trainer.device)
    lengths = torch.full((batch,), n, dtype=torch.int32,
                         device=trainer.device)
    return trainer, data, lengths


def profile(device, steps=5, seed=0, trace=None, arch='convtasnet',
            batch=16, cudnn_benchmark=False):
    _setup(cudnn_benchmark)
    with tempfile.TemporaryDirectory() as model_dir:
        trainer, data, lengths = make_trainer(device, model_dir, seed,
                                              batch=batch, arch=arch)

        def step():
            return trainer.train_step(data, lengths)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms_off = _cuda_ms(step, steps)
        peak = torch.cuda.max_memory_allocated(device)
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            ms_on = _cuda_ms(step, steps)
    if trace:
        prof.export_chrome_trace(trace)

    busy_us, kernels = _device_time(prof)
    per_step = {name: {'ms': us / 1e3 / steps, 'count': n / steps}
                for name, (us, n) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])}
    return {
        'arch': arch,
        'batch': batch,
        'cudnn_benchmark': cudnn_benchmark,
        'train_step_batch_x4s_ms': ms_off,
        'train_step_batch_x4s_ms_profiled': ms_on,
        'peak_memory_mib': peak / 2 ** 20,
        'device_busy_ms_per_step': busy_us / 1e3 / steps,
        'device_idle_share': 1 - busy_us / 1e3 / (ms_on * steps),
        'kernels_per_step': per_step,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='convtasnet', choices=ARCHS)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--cudnn-benchmark', action='store_true')
    parser.add_argument('--trace', default=None)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    print(json.dumps(profile(device, args.steps, args.seed, args.trace,
                             args.arch, args.batch, args.cudnn_benchmark)),
          flush=True)


if __name__ == '__main__':
    main()
