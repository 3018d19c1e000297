"""Where the time of the port's serving path goes, on one CUDA device.

Builds a full-width default model of ``--arch`` (Conv-TasNet, 4,935,217
parameters; TF-GridNet, 3,735,344; SGMSE+ ``sgmsep``, 65,590,694, or
``sgmsepm``, 27,756,186; random weights from ``--seed``) on the device,
float32 with TF32 off (as ``chip_smoke.py`` runs it), and measures:

* request latency: ``EnhanceService.enhance`` of one mono request of each
  length of ``--requests`` (default 0.05, 4 and 10 s), host clock around
  the synchronous call, median of ``--repeats`` after two warm-up calls;
* ``enhance`` of a batch of ``--batch`` x 4 s (default 16): ms per call
  (CUDA events) with the profiler off and on;
* from a ``torch.profiler`` trace of ``--calls`` such calls: device time
  per kernel per call, and the device's idle share, one minus the device's
  busy time (the union of its kernels, copies and fills) over the calls'
  wall time between two CUDA events.

``--cudnn-benchmark`` lets cuDNN time its convolution algorithms for each
new shape and keep the fastest (``torch.backends.cudnn.benchmark``); the
port's entry points leave it off.

Prints the card (``nvidia-smi`` name and power limit) and one JSON
object; ``--trace`` also writes the Chrome trace.

    python -m brever_tpu_torch.profile_enhance [--arch convtasnet]
        [--device cuda] [--batch 16] [--calls 5] [--repeats 10]
        [--requests 0.05,4,10] [--cudnn-benchmark] [--trace PATH]

SGMSE+'s enhance runs its solver's 32 U-Net evaluations: ask for
``--batch 1 --calls 1 --repeats 1 --requests 0.05,4`` to keep the run to
a few minutes.
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
ARCHS = ('convtasnet', 'tfgridnet', 'sgmsep', 'sgmsepm')


def _kernel_name(name):
    """A kernel's name without its return type, the anonymous namespace,
    template arguments and argument list: ``std::enable_if<...>::type
    internal::gemvx::kernel<...>(...)`` is ``internal::gemvx::kernel``."""
    depth, head = 0, []
    for ch in name.replace('(anonymous namespace)::', ''):
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth -= 1
        elif depth == 0:
            if ch == '(':
                break
            head.append(ch)
    words = ''.join(head).split()
    if len(words) > 1 and (words[0] == 'void'
                           or words[0].startswith('std::enable_if')):
        words = words[1:]
    return ' '.join(words)[:80] or name[:80]


def _setup(cudnn_benchmark):
    """float32 with TF32 off, as ``chip_smoke.py`` runs; cuDNN's
    algorithm search (``torch.backends.cudnn.benchmark``) as asked."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = cudnn_benchmark


def _device_time(prof):
    """``(busy_us, {kernel: [us, count]})`` of a trace's device events.
    ``busy_us`` is the union of their intervals: cuDNN may run kernels on
    streams of its own, so device events can overlap."""
    spans, kernels = [], defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        entry = kernels[_kernel_name(evt.name)]
        entry[0] += evt.time_range.elapsed_us()
        entry[1] += 1
    if not spans:
        raise RuntimeError('the profiler recorded no device activity')
    busy_us, last = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    return busy_us, kernels


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
            arch='convtasnet', batch=16, requests=(0.05, 4, 10),
            cudnn_benchmark=False):
    _setup(cudnn_benchmark)
    torch.manual_seed(seed)
    model = ModelRegistry.get(arch)(device='cpu')
    state = model.state_dict()
    service = EnhanceService.from_params(
        arch, {}, model.to_flax(state), device, model.flax_aux(state))

    latency = {}
    rng = np.random.RandomState(seed)
    for seconds in requests:
        audio = (0.1 * rng.randn(int(seconds * FS))).astype(np.float32)
        times = []
        for _ in range(repeats + 2):
            t0 = time.perf_counter()
            service.enhance(audio)
            times.append(1e3 * (time.perf_counter() - t0))
        latency[str(seconds)] = statistics.median(times[2:])

    items = torch.from_numpy((0.1 * rng.randn(batch, 2, 4 * FS))
                             .astype(np.float32)).to(device)

    def enhance():
        return service.model.enhance(items)

    enhance()
    ms_off = _cuda_ms(enhance, calls)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        ms_on = _cuda_ms(enhance, calls)
    if trace:
        prof.export_chrome_trace(trace)

    busy_us, kernels = _device_time(prof)
    per_call = {name: {'ms': us / 1e3 / calls, 'count': n / calls}
                for name, (us, n) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])}
    return {
        'arch': arch,
        'request_ms': latency,
        'batch': batch,
        'cudnn_benchmark': cudnn_benchmark,
        'enhance_batch_x4s_ms': ms_off,
        'enhance_batch_x4s_ms_profiled': ms_on,
        'device_busy_ms_per_call': busy_us / 1e3 / calls,
        'device_idle_share': 1 - busy_us / 1e3 / (ms_on * calls),
        'kernels_per_call': per_call,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='convtasnet', choices=ARCHS)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--requests', default='0.05,4,10',
                        help='request lengths in seconds, comma-separated')
    parser.add_argument('--calls', type=int, default=5)
    parser.add_argument('--repeats', type=int, default=10)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--cudnn-benchmark', action='store_true')
    parser.add_argument('--trace', default=None)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        raise SystemExit('profile_enhance needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    requests = [float(v) for v in args.requests.split(',') if v]
    print(json.dumps(profile(device, args.calls, args.repeats, args.seed,
                             args.trace, args.arch, args.batch, requests,
                             args.cudnn_benchmark)), flush=True)


if __name__ == '__main__':
    main()
