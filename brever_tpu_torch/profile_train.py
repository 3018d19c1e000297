"""Where the time of the port's train step goes, on one CUDA device.

Builds a full-width default model of ``--arch`` (Conv-TasNet, 4,935,217
parameters, or TF-GridNet, 3,735,344; drawn from ``--seed``) and its
``BreverTrainer`` on the device, float32 with TF32 off (as
``chip_smoke.py`` runs it), and times ``train_step`` (forward, the
kernels' backward, global-norm clip, Adam) on a batch of 16 x 4 s (random
mixture and target, the family's own criterion: ``snr`` and
``multiresyu``):

* ms per step over ``--steps`` steps (CUDA events) with the profiler off
  and on, and the peak device memory of a step;
* from a ``torch.profiler`` trace of those steps: device time per kernel
  per step, and the device's idle share, one minus the summed device
  activity over the steps' wall time (one stream, so nothing overlaps).

Prints the card (``nvidia-smi`` name and power limit) and one JSON
object; ``--trace`` also writes the Chrome trace.

    python -m brever_tpu_torch.profile_train [--arch convtasnet]
        [--device cuda] [--steps 5] [--trace PATH]
"""

import argparse
import json
import subprocess
import tempfile
from collections import defaultdict

import numpy as np
import torch

from .models import ModelRegistry
from .profile_enhance import _cuda_ms, _kernel_name
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


def profile(device, steps=5, seed=0, trace=None, arch='convtasnet'):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as model_dir:
        trainer, data, lengths = make_trainer(device, model_dir, seed,
                                              arch=arch)

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

    busy_us = 0.0
    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy_us += us
        entry = kernels[_kernel_name(evt.name)]
        entry[0] += us
        entry[1] += 1
    if busy_us == 0:
        raise RuntimeError('the profiler recorded no device activity')
    per_step = {name: {'ms': us / 1e3 / steps, 'count': n / steps}
                for name, (us, n) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])}
    return {
        'arch': arch,
        'train_step_16x4s_ms': ms_off,
        'train_step_16x4s_ms_profiled': ms_on,
        'peak_memory_mib': peak / 2 ** 20,
        'device_busy_ms_per_step': busy_us / 1e3 / steps,
        'device_idle_share': 1 - busy_us / 1e3 / (ms_on * steps),
        'kernels_per_step': per_step,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='convtasnet',
                        choices=('convtasnet', 'tfgridnet'))
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--seed', type=int, default=0)
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
                             args.arch)), flush=True)


if __name__ == '__main__':
    main()
