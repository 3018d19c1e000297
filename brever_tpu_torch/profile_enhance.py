"""Where the time of the port's serving path goes, on one CUDA device.

Builds a full-width default model of ``--arch`` (Conv-TasNet, 4,935,217
parameters, or TF-GridNet, 3,735,344; random weights from ``--seed``) on
the device, float32 with TF32 off (as ``chip_smoke.py`` runs it), and
measures:

* request latency: ``EnhanceService.enhance`` of one mono request of
  0.05, 4 and 10 s, host clock around the synchronous call, median of
  ``--repeats`` after two warm-up calls;
* ``enhance`` of a batch of 16 x 4 s: ms per call (CUDA events) with the
  profiler off and on;
* from a ``torch.profiler`` trace of ``--calls`` such calls: device time
  per kernel per call, and the device's idle share, one minus the summed
  device activity (kernels, copies, fills; one stream, so they do not
  overlap) over the calls' wall time between two CUDA events.

Prints the card (``nvidia-smi`` name and power limit) and one JSON
object; ``--trace`` also writes the Chrome trace.

    python -m brever_tpu_torch.profile_enhance [--arch convtasnet]
        [--device cuda] [--calls 5] [--repeats 10] [--trace PATH]
"""

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from .models import ModelRegistry
from .serve import EnhanceService

FS = 16000


def _kernel_name(name):
    """A kernel's name without namespace and argument list."""
    name = name.replace('(anonymous namespace)::', '')
    return name.split('(')[0].split('<')[0][:80] or name[:80]


def _cuda_ms(fn, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def profile(device, calls=5, repeats=10, seed=0, trace=None,
            arch='convtasnet'):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(seed)
    model = ModelRegistry.get(arch)(device='cpu')
    service = EnhanceService.from_params(
        arch, {}, model.to_flax(model.state_dict()), device)

    latency = {}
    rng = np.random.RandomState(seed)
    for seconds in (0.05, 4, 10):
        audio = (0.1 * rng.randn(int(seconds * FS))).astype(np.float32)
        times = []
        for _ in range(repeats + 2):
            t0 = time.perf_counter()
            service.enhance(audio)
            times.append(1e3 * (time.perf_counter() - t0))
        latency[str(seconds)] = statistics.median(times[2:])

    batch = torch.from_numpy((0.1 * rng.randn(16, 2, 4 * FS))
                             .astype(np.float32)).to(device)

    def enhance():
        return service.model.enhance(batch)

    enhance()
    ms_off = _cuda_ms(enhance, calls)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        ms_on = _cuda_ms(enhance, calls)
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
    per_call = {name: {'ms': us / 1e3 / calls, 'count': n / calls}
                for name, (us, n) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])}
    return {
        'arch': arch,
        'request_ms': latency,
        'enhance_16x4s_ms': ms_off,
        'enhance_16x4s_ms_profiled': ms_on,
        'device_busy_ms_per_call': busy_us / 1e3 / calls,
        'device_idle_share': 1 - busy_us / 1e3 / (ms_on * calls),
        'kernels_per_call': per_call,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='convtasnet',
                        choices=('convtasnet', 'tfgridnet'))
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--calls', type=int, default=5)
    parser.add_argument('--repeats', type=int, default=10)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--trace', default=None)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        raise SystemExit('profile_enhance needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    print(json.dumps(profile(device, args.calls, args.repeats, args.seed,
                             args.trace, args.arch)), flush=True)


if __name__ == '__main__':
    main()
