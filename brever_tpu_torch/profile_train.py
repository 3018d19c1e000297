"""Where the time of the port's train step goes, on one CUDA device.

Builds a full-width default model of ``--arch`` (Conv-TasNet, 4,935,217
parameters; TF-GridNet, 3,735,344; SGMSE+ ``sgmsep``, 65,590,694, or
``sgmsepm``, 27,756,186; IDMSE ``idmse``, 16,613,378, or ``idmselarge``,
70,995,586; DCCRN, 3,671,053; MANNER, 21,253,921; FFNN, 1,509,440;
MetricGAN ``metricganp``, 1,914,524, or ``metricganokd``, 2,172,329; drawn
from ``--seed``) and its ``BreverTrainer`` on the device, float32 with TF32 off
(as ``chip_smoke.py`` runs it), or with the trainer's bf16 amp
(``--use_amp true``, the option of the trainer and of the default configs
that set it; Conv-TasNet's blocks then take K1/K2's bf16 route,
TF-GridNet's BLSTMs K3/K4's, DCCRN's complex LSTM K5/K6's, SGMSE+'s and
IDMSE's GroupNorms K7/K8's, MANNER's BatchNorms K7-BN/K8-BN's), and times
``train_step`` (forward, the
kernels' backward, global-norm clip where the family clips, Adam) on a
batch of ``--batch`` x 4 s (default 16; random mixture and target, the
family's own criterion: ``snr``, ``multiresyu``, SGMSE+'s weighted ``mse``,
MANNER's L1 + STFT loss and FFNN's ``mse`` of the mel mask; DCCRN's and
MANNER's batch norms in train mode, MANNER's through the flash-BN kernels;
FFNN's dropout on; MetricGAN's GAN step on the batch as its loader gives it
with ``precompute_metric``, the mono pair and the noisy signal's host
score):

* ms per step over ``--steps`` steps (CUDA events) with the profiler off
  and on, and the peak device memory of a step;
* from a ``torch.profiler`` trace of those steps: device time per kernel
  per step, the norm kernels' (K7/K8, K7-BN/K8-BN) sum a step, and the
  device's idle share, one minus the device's busy time (the union of its
  activity) over the steps' wall time;
* for MetricGAN, the step's three parts on the host clock (each ended by a
  synchronize): the candidates, their scoring (host PESQ of the enhanced
  and the augmented signals through the spawn pool, whose start-up is paid
  before the timing), and the generators' and the discriminator's updates.

Prints the card (``nvidia-smi`` name and power limit) and one JSON
object; ``--trace`` also writes the Chrome trace.

    python -m brever_tpu_torch.profile_train [--arch convtasnet]
        [--device cuda] [--batch 16] [--steps 5] [--use_amp true|false]
        [--cudnn-benchmark] [--trace PATH]

SGMSE+ and IDMSE are profiled at SGMSE+'s reference batch, ``--arch
sgmsep --batch 4`` (``idmse``, ``idmselarge``); MetricGAN at its config's
32 s of audio a batch, ``--arch metricganp --batch 8``.
``--cudnn-benchmark`` lets cuDNN time its convolution algorithms for each
new shape and keep the fastest (``torch.backends.cudnn.benchmark``); the
port's entry points leave it off.
"""

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from .models import ModelRegistry
from .profile_enhance import ARCHS, _cuda_ms, _device_time, _setup
from .train import _bool
from .training import BreverTrainer

FS = 16000
#: the norm kernels' names (K7/K8 and K7-BN/K8-BN, either route)
NORM_KERNELS = ('gn_fwd_cluster', 'gn_bwd_cluster', 'gn_bwd_channels',
                'gn_fwd16', 'gn_bwd16', 'gn_bwd_rows', 'bn_bwd_partials',
                'bn_bwd_dx')


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
                 arch='convtasnet', use_amp=False):
    """A trainer of the default model of ``arch`` on ``device`` (state
    drawn from ``seed``; bf16 amp with ``use_amp``) and one padded batch
    ``(batch, lengths)`` on the device."""
    model = ModelRegistry.get(arch)(device='cpu')
    items = _Items(batch, seconds)
    trainer = BreverTrainer(model, items, items, model_dir, device=device,
                            val_metrics={'snr'}, seed=seed, use_amp=use_amp)
    trainer.init_state()
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    target = 0.1 * rng.randn(batch, 1, 2, n)
    mix = target + 0.1 * rng.randn(batch, 1, 2, n)
    data = torch.from_numpy(np.concatenate([mix, target], axis=1)
                            .astype(np.float32)).to(trainer.device)
    lengths = torch.full((batch,), n, dtype=torch.int32,
                         device=trainer.device)
    if model.loader_transform is not None:
        # the loader's items: the mono pair and the noisy signal's score
        items = [model.loader_transform(x) for x in data.cpu().numpy()]
        data = [torch.from_numpy(np.stack(part)).to(trainer.device)
                for part in zip(*items)]
        lengths = torch.tensor([[n, data[1].shape[1]]] * batch,
                               dtype=torch.int32, device=trainer.device)
    return trainer, data, lengths


def gan_step_parts(trainer, data, lengths, steps):
    """MetricGAN's step in its three parts, ms each on the host clock
    (each part ended by a synchronize), averaged over ``steps`` steps."""
    model, parts = trainer.model, {'candidates': 0.0, 'scoring': 0.0,
                                   'updates': 0.0}
    for _ in range(steps):
        t0 = time.perf_counter()
        candidates = model.make_candidates(data, trainer.generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = model.score_candidates(data, lengths, candidates)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        model.update(trainer, data, scores, candidates[3])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, ms in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[name] += 1e3 * ms / steps
    return parts


def profile(device, steps=5, seed=0, trace=None, arch='convtasnet',
            batch=16, cudnn_benchmark=False, use_amp=False):
    _setup(cudnn_benchmark)
    with tempfile.TemporaryDirectory() as model_dir:
        trainer, data, lengths = make_trainer(device, model_dir, seed,
                                              batch=batch, arch=arch,
                                              use_amp=use_amp)

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
        parts = gan_step_parts(trainer, data, lengths, steps) \
            if trainer.model.loader_transform is not None else None
    if trace:
        prof.export_chrome_trace(trace)
    busy_us, kernels = _device_time(prof)
    per_step = {name: {'ms': us / 1e3 / steps, 'count': n / steps}
                for name, (us, n) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])}
    return {
        'arch': arch,
        'batch': batch,
        'use_amp': use_amp,
        'cudnn_benchmark': cudnn_benchmark,
        'train_step_batch_x4s_ms': ms_off,
        'train_step_batch_x4s_ms_profiled': ms_on,
        'peak_memory_mib': peak / 2 ** 20,
        'device_busy_ms_per_step': busy_us / 1e3 / steps,
        'device_idle_share': 1 - busy_us / 1e3 / (ms_on * steps),
        'kernels_per_step': per_step,
        'norm_kernels_ms_per_step': sum(
            v['ms'] for name, v in per_step.items()
            if any(k in name for k in NORM_KERNELS)),
        'step_parts_ms': parts,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='convtasnet', choices=ARCHS)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--use_amp', type=_bool, default=False)
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
                             args.arch, args.batch, args.cudnn_benchmark,
                             args.use_amp)), flush=True)


if __name__ == '__main__':
    main()
