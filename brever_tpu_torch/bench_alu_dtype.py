"""Micro-benchmark: the card's elementwise multiply-add rate, float32
against bfloat16 (counterpart of ``benchmarks/bench_vpu_dtype.py``).

Runs the chain of :mod:`.ops.fma_chain` (K10) over the JAX benchmark's
input, ``RandomState(0).rand(8, 1024, 512) * 0.001 + 0.5`` cast to each
dtype, with its ``K = 64`` chained steps a pass and 8 passes: 256 dependent
``acc * x + x`` an element, 2,147,483,648 operations a call (a multiply and
an add count as two). It answers whether bfloat16 elementwise work runs at
twice the float32 rate on the card's non-tensor pipes, which decides
whether bfloat16 elementwise passes can pay.

For each dtype it prints ms a call (CUDA events around 20 calls after one
warm call, queued behind a sleep kernel so that the window holds the card's
time and not the host's time to issue the calls, which it prints beside),
Top/s, the seconds of the first call (the kernels' build and load included,
as the JAX benchmark reports its compile), and the share of the bound: the
larger of the bytes (the input read once, the output written once) at the
memory rate and the operations at the dtype's non-tensor rate. Then the
bfloat16:float32 ratio of the times. ``--windows N`` repeats the timed
window N times a dtype and reads the card's SM clock after each window;
the times are then the windows' medians.

    python -m brever_tpu_torch.bench_alu_dtype [--device cuda] [--windows N]

``--device cpu`` runs the plain version (:func:`.ops.fma_chain.
fma_chain_reference`) at a small shape and exists for the tests: its
numbers are the CPU's, never the card's.
"""

import argparse
import functools
import json
import re
import subprocess
import time

import numpy as np
import torch

from .ops import build
from .ops.fma_chain import K, PASSES, fma_chain, fma_chain_reference

#: the JAX benchmark's shape, and its timed calls
ROWS, T, H = 8, 1024, 512
REPS = 20
#: the H100 SXM's published rates (NVIDIA H100 data sheet; NVIDIA Hopper
#: architecture white paper, table of H100 SXM5 peaks): device memory bytes
#: a second, and non-tensor float32 and bfloat16 operations a second
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_FLOPS = {torch.float32: 67e12, torch.bfloat16: 133.8e12}
DTYPES = (torch.float32, torch.bfloat16)
#: the inputs, ``rand * scale + offset`` from ``RandomState(0)``: the
#: benchmark's (bfloat16 rounds it to 0.5, whose chain is 1.0 everywhere), a
#: wider one, and one near 1, whose chain converges slowly
INPUTS = {'bench': (0.001, 0.5), 'wide': (0.5, 0.1), 'near': (0.01, 0.98)}
#: the chain at run-time arguments off the benchmark's, ``(input, k,
#: passes, dtypes)``: on each the chain has not converged, so a comparison
#: within ``fma_chain_limit`` tells its step count from one fewer (1 to 3
#: steps on the wide input, and 4 in float32, short of the kernel's 16-deep
#: unroll; 256, 32 and 51 steps in float32 near 1, where bfloat16's chain
#: stalls in its own rounding)
STEP_CASES = [('wide', 2, 1, DTYPES), ('wide', 4, 1, DTYPES),
              ('wide', 2, 3, DTYPES), ('wide', 8, 1, DTYPES[:1]),
              ('near', 64, 8, DTYPES[:1]), ('near', 64, 1, DTYPES[:1]),
              ('near', 34, 3, DTYPES[:1])]
#: clock cycles of the first sleep kernel that a timed window is queued
#: behind (about 2 ms on the card); quadrupled until the host has issued
#: the window's calls before the card reaches it
SLEEP_CYCLES = 1 << 22


def probe_input(dtype, device='cuda', shape=(ROWS, T, H), kind='bench'):
    """The input ``kind`` of :data:`INPUTS` (the JAX benchmark's by
    default), cast to ``dtype``."""
    scale, offset = INPUTS[kind]
    x = np.random.RandomState(0).rand(*shape) * scale + offset
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def n_ops(numel, k=K, passes=PASSES):
    """Operations of one call: a multiply and an add a step."""
    return numel * k * passes


def bound(numel, dtype, k=K, passes=PASSES):
    """``(ms, 'bytes' or 'operations')``: the least time the card takes
    for one call over ``numel`` elements of ``dtype``."""
    nbytes = 2 * numel * torch.finfo(dtype).bits // 8
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops(numel, k, passes) / NON_TENSOR_FLOPS[dtype] * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops \
        else (by_ops, 'operations')


def time_calls(fn, device, reps=REPS):
    """``(ms, host_ms)`` a call of ``fn``: on a card, CUDA events around
    ``reps`` calls queued behind a sleep kernel, and the host's time to
    issue them; on the CPU, the host clock for both."""
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        return ms, ms
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = SLEEP_CYCLES
    while True:
        torch.cuda.synchronize(device)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps, host_ms
        cycles *= 4


def sm_clock_mhz():
    """The card's SM clock now, from ``nvidia-smi``."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm',
                          '--format=csv,noheader,nounits', '--id=0'],
                         check=True, capture_output=True, text=True)
    return float(out.stdout.split()[0])


def bench(dtype, device, shape=(ROWS, T, H), reps=REPS, windows=1):
    """One dtype's row: ms a call and the host's ms to issue one (the
    medians of ``windows`` windows, each listed with the SM clock after
    it), Top/s, first-call seconds, bound and its share. On a card the
    kernel runs; on the CPU the plain version."""
    x = probe_input(dtype, device, shape)
    on_card = device.type == 'cuda'
    run = fma_chain if on_card else fma_chain_reference
    t0 = time.perf_counter()
    run(x)
    if on_card:
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    timed = [time_calls(lambda: run(x), device, reps) + (
        sm_clock_mhz() if on_card else None,) for _ in range(windows)]
    window_ms, window_host_ms, window_sm_mhz = map(list, zip(*timed))
    ms = float(np.median(window_ms))
    bound_ms, bound_by = bound(x.numel(), dtype)
    return {'dtype': str(dtype).replace('torch.', ''), 'ms': ms,
            'host_ms': float(np.median(window_host_ms)),
            'tops': n_ops(x.numel()) / (ms * 1e-3) / 1e12,
            'first_call_s': first_s, 'bound_ms': bound_ms,
            'bound_by': bound_by,
            'bound_share': bound_ms / ms if on_card else None,
            'window_ms': window_ms, 'window_host_ms': window_host_ms,
            'window_sm_mhz': window_sm_mhz}


def cuobjdump():
    """The toolkit's ``cuobjdump``, beside ``nvcc``."""
    return re.sub(r'nvcc$', 'cuobjdump', build.find_nvcc())


@functools.lru_cache(maxsize=None)
def sass(library_path):
    """``cuobjdump -sass`` of the built library (its name holds its sources'
    hash), dumped once a process: the whole library takes tens of
    seconds."""
    return subprocess.run([cuobjdump(), '-sass', library_path], check=True,
                          capture_output=True, text=True).stdout


#: an instruction line of ``cuobjdump -sass``: its opcode, after the
#: address comment and an optional predicate
_OPCODE = r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)'
#: opcodes of a conversion or an unpacking, and of float32 arithmetic:
#: either in the bfloat16 instance would show its chain widened to float32
_CONVERSIONS = ('F2F', 'F2FP', 'PRMT')
_F32_ARITHMETIC = ('FFMA', 'FMUL', 'FADD')


def sass_report(library_path):
    """The opcodes of K10's two instances in the built library
    (``cuobjdump -sass``): ``{'float32': {...}, 'bfloat16': {...}}``, each
    with its instruction count, its FFMA and HFMA2.BF16 counts, and the
    conversion opcodes it holds. Raises unless the float32 instance chains
    FFMA and the bfloat16 one HFMA2.BF16 with no conversion and no float32
    arithmetic."""
    found = {}
    for block in sass(library_path).split('Function : ')[1:]:
        name = block.split()[0]
        if 'fma_chain_kernel' not in name:
            continue
        ops = re.findall(_OPCODE, block)
        dtype = 'bfloat16' if 'Bf16x8' in name else 'float32'
        found[dtype] = {
            'instructions': len(ops),
            'ffma': sum(op.startswith('FFMA') for op in ops),
            'hfma2_bf16': sum(op.startswith('HFMA2') and 'BF16' in op
                              for op in ops),
            'f32_arithmetic': sum(op.split('.')[0] in _F32_ARITHMETIC
                                  for op in ops),
            'conversions': sorted({op for op in ops
                                   if op.split('.')[0] in _CONVERSIONS}),
        }
    f32, bf16 = found.get('float32'), found.get('bfloat16')
    if f32 is None or bf16 is None:
        raise AssertionError(f'fma_chain_kernel instances not found in '
                             f'{library_path}: {sorted(found)}')
    if f32['ffma'] < 4 or f32['hfma2_bf16']:
        raise AssertionError(f'float32 instance: {f32}')
    if bf16['hfma2_bf16'] < 4 or bf16['f32_arithmetic'] \
            or bf16['conversions']:
        raise AssertionError(f'bfloat16 instance does not chain HFMA2.BF16 '
                             f'alone: {bf16}')
    return found


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--windows', type=int, default=1,
                        help='timed windows of 20 calls a dtype')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('bench_alu_dtype: no CUDA device')
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        shape = (ROWS, T, H)
    else:
        card, shape = 'cpu (plain version)', (2, 16, 128)
    print(card, flush=True)
    rows = [bench(dtype, device, shape, windows=args.windows)
            for dtype in DTYPES]
    for r in rows:
        share = 'not a card run' if r['bound_share'] is None \
            else f'{100 * r["bound_share"]:.1f} % of it'
        spread = '' if args.windows == 1 else (
            f' [{args.windows} windows {min(r["window_ms"]):.4f}-'
            f'{max(r["window_ms"]):.4f} ms]')
        if r['bound_share'] is not None:
            spread += (f' [SM clock {min(r["window_sm_mhz"]):.0f}-'
                       f'{max(r["window_sm_mhz"]):.0f} MHz]')
        print(f'{r["dtype"]}: {r["ms"]:.4f} ms/iter, {r["tops"]:.3f} Top/s '
              f'(first call {r["first_call_s"]:.1f} s, host issue '
              f'{r["host_ms"]:.4f} ms a call), card bound '
              f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}): {share}{spread}',
              flush=True)
    ratio = rows[1]['ms'] / rows[0]['ms']
    print(f'bf16:f32 time ratio {ratio:.3f} (0.5 = twice the rate)',
          flush=True)
    result = {'device': card, 'shape': list(shape), 'rows': rows,
              'bf16_f32_time_ratio': ratio}
    if device.type == 'cuda':
        result['sass'] = sass_report(build.library_path())
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
