"""How much of a trace's start ``torch.profiler`` drops on one CUDA device,
against the time since the process's first trace.

The process takes its first trace at once, then keeps the card busy with
untraced K4-bf16 calls (TF-GridNet's intra BLSTM at 16 x 4 s, inputs from
``--seed``) and, every ``--every`` seconds up to ``--until`` seconds after
that first trace, takes two traces:

* 200 spin kernels of 0.5 ms each (``torch.cuda._sleep``): the spins the
  trace lacks, times 0.5 ms, is the span the profiler dropped at its start;
* three K4-bf16 calls, as ``profile_lstm.k4_parts`` traces them: K4's
  launches the trace holds, of 18, by part (gates, the first launch of a
  call, 3; sums, the last two, 6).

Prints the card (``nvidia-smi`` name and power limit), a line a
checkpoint and one JSON object.

    python -m brever_tpu_torch.profile_trace_loss [--every 60] [--until 240]
"""

import argparse
import json
import time

import torch

from .numerics import disable_tf32
from .ops import lstm_scan as L
from .profile_enhance import _kernel_name
from .profile_lstm import K4_PARTS, SHAPES, card, inputs

ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
SPINS, SPIN_MS = 200, 0.5


def device_kernels(prof):
    """The names of a trace's device events."""
    return [_kernel_name(e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def spins_dropped():
    """The spins of a trace of ``SPINS`` spins of ``SPIN_MS`` each that its
    device events lack."""
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(int(SPIN_MS * 2e6))
        torch.cuda.synchronize()
    return SPINS - sum('spin_kernel' in n for n in device_kernels(prof))


def k4_kept(fn, calls=3):
    """``{part: launches}`` of K4's parts (``K4_PARTS``) that a trace of
    ``calls`` calls of ``fn`` holds."""
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = device_kernels(prof)
    return {part: sum(kernel in n for n in names)
            for part, kernel, _ in K4_PARTS}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--every', type=float, default=60.0)
    parser.add_argument('--until', type=float, default=240.0)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_trace_loss: needs a CUDA device')
    disable_tf32()
    print(card(), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    x, w_ih, bias, w_hh, dh = inputs(gen, *SHAPES['intra'], torch.bfloat16,
                                     'cuda')
    rows = []
    with torch.no_grad():
        h, c = L.lstm_scan_x_fwd(x, w_ih, bias, w_hh)

        def k4():
            return L.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)

        k4()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            since = time.perf_counter() - t0
            parts = k4_kept(k4)
            row = {'s_since_first_trace': since,
                   'dropped_ms': spins_dropped() * SPIN_MS,
                   'k4_kept_of_18': sum(parts.values()), 'k4_parts': parts}
            rows.append(row)
            print(f'{since:7.1f} s: spins dropped {row["dropped_ms"]:.1f} '
                  f'ms; K4 launches kept {row["k4_kept_of_18"]}/18 ('
                  + ', '.join(f'{p} {n}' for p, n in parts.items())
                  + ')', flush=True)
            if since + args.every > args.until:
                break
            while time.perf_counter() - t0 < since + args.every:
                for _ in range(20):
                    k4()
                torch.cuda.synchronize()
    print(json.dumps({'card': card(), 'rows': rows}), flush=True)


if __name__ == '__main__':
    main()
