"""Short-request latency of the port's serving path on one CUDA device, and
what the LSTM scan kernels take of it.

For each ``--arch`` (default DCCRN and TF-GridNet, whose short requests
scan under the 128-row floor: the projection, then K5) builds the
full-width default model with random weights from ``--seed`` on the
device, float32 with TF32 off, as ``profile_enhance`` does, and serves
mono requests of ``--seconds`` (default 0.05) through
``EnhanceService.enhance``:

* host latency of ``--repeats`` requests after ``--warmup``: median,
  quartiles, minimum (host clock around the synchronous call);
* K3 and K5 launches a request (the wrappers' counts);
* from a ``torch.profiler`` trace of ``--traced`` requests: per request the
  device's busy time, the kernels launched, and the LSTM scan kernels'
  device time (kernels whose name holds ``lstm``) and launches;
* K5's wrapper ``lstm_scan_fwd`` on the request's first K5 inputs, called
  ``--repeats`` times back to back: the host's time a call (the issue
  cost, which paces the queue when it passes the kernel's device time) and
  the time a call between two CUDA events.

The measurement uses only what the port has had since its LSTM kernels
landed, so the same file can time an earlier checkout of the port (copy it
into that tree's package): run the two in turns, one process each, to
compare them on one card.

    python -m brever_tpu_torch.profile_requests [--arch dccrn,tfgridnet]
        [--seconds 0.05] [--repeats 300] [--warmup 20] [--traced 20]
        [--seed 0] [--device cuda]

Prints the card (``nvidia-smi`` name and power limit) and one JSON object.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .models import ModelRegistry
from .numerics import disable_tf32
from .ops import lstm_scan as lstm
from .profile_enhance import FS, _device_time
from .serve import EnhanceService


def _quantiles(values):
    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return {'median': float(med), 'q1': float(q1), 'q3': float(q3),
            'min': float(np.min(values)), 'n': len(values)}


def _wrapper_us(gates_x, w_hh, calls):
    """``(host_us, event_us)`` a call of ``lstm_scan_fwd`` on these
    inputs, ``calls`` calls back to back after one warm-up call."""
    lstm.lstm_scan_fwd(gates_x, w_hh)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        lstm.lstm_scan_fwd(gates_x, w_hh)
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    end.record()
    torch.cuda.synchronize()
    return host_us, 1e3 * start.elapsed_time(end) / calls


def measure(arch, device, seconds=0.05, repeats=300, warmup=20, traced=20,
            seed=0):
    """The numbers of one arch at one request length (see the module
    docstring)."""
    model = ModelRegistry.get(arch)(device='cpu')
    model.init_parameters(seed)
    state = model.state_dict()
    service = EnhanceService.from_params(
        arch, {}, model.to_flax(state), device, model.flax_aux(state))
    audio = (0.1 * np.random.RandomState(seed).randn(int(seconds * FS))
             ).astype(np.float32)
    for _ in range(warmup):
        service.enhance(audio)
    counts = lstm.lstm_scan_x.launches, lstm.lstm_scan.launches
    k5_inputs, k5 = [], lstm.lstm_scan_fwd

    def capture(gates_x, w_hh):
        if not k5_inputs:
            k5_inputs.extend((gates_x.clone(), w_hh.clone()))
        return k5(gates_x, w_hh)

    lstm.lstm_scan_fwd = capture
    try:
        service.enhance(audio)
    finally:
        lstm.lstm_scan_fwd = k5
    launches = {'k3': lstm.lstm_scan_x.launches - counts[0],
                'k5': lstm.lstm_scan.launches - counts[1]}
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        service.enhance(audio)
        times.append(1e3 * (time.perf_counter() - t0))
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(traced):
            service.enhance(audio)
        torch.cuda.synchronize(device)
    busy_us, kernels = _device_time(prof)
    wrapper = None
    if k5_inputs:
        host_us, event_us = _wrapper_us(*k5_inputs, repeats)
        wrapper = {'shape': list(k5_inputs[0].shape), 'host_us': host_us,
                   'event_us': event_us}
    scan = {name: {'us_per_launch': us / n, 'launches_per_request':
                   n / traced}
            for name, (us, n) in kernels.items() if 'lstm' in name.lower()}
    return {
        'arch': arch,
        'seconds': seconds,
        'latency_ms': _quantiles(times),
        'launches_per_request': launches,
        'device_busy_ms_per_request': busy_us / 1e3 / traced,
        'kernels_per_request': sum(n for _, n in kernels.values()) / traced,
        'lstm_device_ms_per_request': sum(
            us for name, (us, _) in kernels.items()
            if 'lstm' in name.lower()) / 1e3 / traced,
        'lstm_kernels': scan,
        'k5_wrapper': wrapper,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--arch', default='dccrn,tfgridnet',
                        help='comma-separated')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seconds', type=float, default=0.05)
    parser.add_argument('--repeats', type=int, default=300)
    parser.add_argument('--warmup', type=int, default=20)
    parser.add_argument('--traced', type=int, default=20)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        raise SystemExit('profile_requests needs a CUDA device')
    disable_tf32()
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    out = [measure(arch, device, args.seconds, args.repeats, args.warmup,
                   args.traced, args.seed)
           for arch in args.arch.split(',') if arch]
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
