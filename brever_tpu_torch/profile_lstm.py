"""K3 and K4 (the flash-LSTM-x forward and backward) on one CUDA device,
at TF-GridNet's BLSTM shapes, K4 launch by launch, beside cuDNN's LSTM.

For each shape of ``--shapes`` (default TF-GridNet's intra and inter
BLSTMs at 16 x 4 s), on inputs drawn on the card from ``--seed`` in
``--dtype`` (bf16 or float32, TF32 off):

* ms of a K3 call (``lstm_scan_x_fwd``) and of a K4 call
  (``lstm_scan_x_bwd``), CUDA events around ``--calls`` calls after one;
* K4's launches split by kernel (:func:`k4_parts`, from a
  ``torch.profiler`` trace): the gates GEMM, the reverse scan, the dx GEMM,
  the weight GEMM, the partial sums, and ``other`` (the wrapper's copies
  and casts);
* cuDNN's bidirectional ``nn.LSTM`` in the same dtype over the first
  direction's input, forward and backward (:func:`library_ms`, the
  library's yardstick, which ``chip_smoke.py`` times too; the port never
  calls it).

With ``--dtype bf16`` it also counts the bf16 tensor-core products
(``HMMA ... BF16``) in the SASS of K3-bf16's and K4-bf16's kernels in the
built library (:func:`mma_sass`). Prints the card (``nvidia-smi`` name and
power limit) and one JSON object.

    python -m brever_tpu_torch.profile_lstm [--dtype bf16] [--calls 5]
        [--shapes 33x2x8064x128x128,126x2x2112x128x128] [--seed 0]
"""

import argparse
import json
import re
import subprocess

import torch

from .numerics import disable_tf32
from .ops import build
from .ops import lstm_scan as L
from .profile_enhance import _cuda_ms, _device_time

#: TF-GridNet's BLSTM scans at 16 x 4 s: (T, D, R, E, H)
SHAPES = {'intra': (33, 2, 16 * 504, 128, 128),
          'inter': (126, 2, 16 * 132, 128, 128)}
#: K4's launches, by a piece of their kernels' names on both routes, in
#: the order they run, with their launches a call
K4_PARTS = (('gates', 'lstm_bwd_gates', 1), ('scan', 'lstm_bwd_rscan', 1),
            ('dx', 'lstm_bwd_dx', 1), ('weights', 'lstm_bwd_wgrad', 1),
            ('sums', 'sum_partials', 2))
DTYPES = {'bf16': torch.bfloat16, 'float32': torch.float32}
#: an instruction line of ``cuobjdump -sass``: its opcode, after the address
#: comment (4 hex digits or more) and an optional predicate
_OPCODE = r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)'
#: K3-bf16's and K4-bf16's kernels (csrc/lstm_scan_bf16.cu), by a piece of
#: their names
MMA_KERNELS = ('lstm_fwd_ring_mma', 'lstm_bwd_gates_mma', 'lstm_bwd_rscan_mma',
               'lstm_bwd_dx_mma', 'lstm_bwd_wgrad_mma')


def mma_sass(library_path, kernels=MMA_KERNELS):
    """``{kernel: n}``: the bf16 tensor-core instructions (``HMMA`` with
    ``BF16`` operands) in the SASS of each of ``kernels``' template
    instances in the built library (``cuobjdump -sass``), summed a kernel;
    a kernel is named by a piece of its name (K3-bf16's and K4-bf16's by
    default; ``profile_tcn_bwd.MMA_KERNELS``: K1-bf16's and K2-bf16's).
    Raises if a kernel is not in the library."""
    from .bench_alu_dtype import sass
    counts = {}
    for block in sass(library_path).split('Function : ')[1:]:
        name = block.split()[0]
        kernel = next((k for k in kernels if k in name), None)
        if kernel is not None:
            counts[kernel] = counts.get(kernel, 0) + sum(
                op.startswith('HMMA') and 'BF16' in op
                for op in re.findall(_OPCODE, block))
    if set(counts) != set(kernels):
        raise AssertionError(f'{library_path} lacks '
                             f'{sorted(set(kernels) - set(counts))}')
    return counts


def k4_parts(fn, calls=3):
    """Device ms a call of each of K4's launches (``K4_PARTS``; ``other``:
    the wrapper's copies and casts), from a ``torch.profiler`` trace of
    ``calls`` calls of ``fn``. The profiler drops a trace's first device
    events, more the longer the process has traced (``profile_trace_loss``),
    so a launch's ms is its mean over the launches the trace holds times its
    launches a call, and ``other`` is the trace's sum of the rest over the
    calls it holds, the most calls of a part's launches. Raises RuntimeError
    (lost device events) if the trace holds no launch of a part."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {part: [0.0, 0] for part, _, _ in K4_PARTS}
    other = 0.0
    for name, (us, count) in _device_time(prof)[1].items():
        part = next((p for p, kernel, _ in K4_PARTS if kernel in name), None)
        if part is None:
            other += us / 1e3
        else:
            seen[part][0] += us / 1e3
            seen[part][1] += count
    if not all(n for _, n in seen.values()):
        raise RuntimeError(f'K4\'s trace lost device events: {seen}')
    parts = {part: seen[part][0] / seen[part][1] * per_call
             for part, _, per_call in K4_PARTS}
    parts['other'] = other / max(seen[part][1] / per_call
                                 for part, _, per_call in K4_PARTS)
    return parts


def cuda_ms(fn, calls):
    """ms a call of ``fn``: CUDA events around ``calls`` calls, after one."""
    fn()
    return _cuda_ms(fn, calls)


def inputs(gen, steps, n_dir, rows, feat, hidden, dtype, device):
    """x, w_ih, bias, w_hh and dh drawn on the card from ``gen``."""
    def arr(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=device)
                ).to(dtype)

    return (arr(steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(steps, n_dir, rows, hidden))


def library_ms(x, feat, hidden, calls):
    """(forward, backward) ms of cuDNN's bidirectional LSTM over x[:, 0] in
    x's dtype, or (None, None) where this PyTorch runs none."""
    try:
        lstm = torch.nn.LSTM(feat, hidden, bidirectional=True).to(
            x.device, x.dtype)
        xl = x[:, 0].clone().requires_grad_()
        with torch.no_grad():
            fwd = cuda_ms(lambda: lstm(xl), calls)
        out, _ = lstm(xl)
    except RuntimeError:
        return None, None
    dout = torch.randn_like(out)
    bwd = cuda_ms(lambda: torch.autograd.grad(
        out, [xl, *lstm.parameters()], dout, retain_graph=True), calls)
    return fwd, bwd


def profile(device, dtype=torch.bfloat16, calls=5, shapes=None, seed=0):
    """``{label: {'shape', 'k3_ms', 'k4_ms', 'k4_parts', 'lib_fwd_ms',
    'lib_bwd_ms'}}`` at each (T, D, R, E, H) of ``shapes`` (default
    ``SHAPES``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for label, shape in (shapes or SHAPES).items():
        x, w_ih, bias, w_hh, dh = inputs(gen, *shape, dtype, device)
        with torch.no_grad():
            h, c = L.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
            k3 = cuda_ms(lambda: L.lstm_scan_x_fwd(x, w_ih, bias, w_hh),
                         calls)

            def k4():
                return L.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)

            k4_ms = cuda_ms(k4, calls)
            parts = k4_parts(k4)
        lib_fwd, lib_bwd = library_ms(x, shape[3], shape[4], calls)
        out[label] = {'shape': list(shape), 'k3_ms': k3, 'k4_ms': k4_ms,
                      'k4_parts': parts, 'lib_fwd_ms': lib_fwd,
                      'lib_bwd_ms': lib_bwd}
        del x, w_ih, bias, w_hh, dh, h, c
        torch.cuda.empty_cache()
    return out


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dtype', choices=sorted(DTYPES), default='bf16')
    parser.add_argument('--calls', type=int, default=5)
    parser.add_argument('--shapes', default=None,
                        help='comma-separated TxDxRxExH (default: '
                             'TF-GridNet\'s intra and inter BLSTMs)')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_lstm: no CUDA device')
    disable_tf32()
    shapes = None
    if args.shapes:
        shapes = {s: tuple(int(v) for v in s.split('x'))
                  for s in args.shapes.split(',')}
    result = profile(torch.device('cuda', 0), DTYPES[args.dtype], args.calls,
                     shapes, args.seed)
    out = {'dtype': args.dtype, 'device': torch.cuda.get_device_name(0),
           'shapes': result}
    if args.dtype == 'bf16':
        out['hmma_bf16'] = mma_sass(build.build())
    print(card())
    print(json.dumps(out))


if __name__ == '__main__':
    main()
