"""The TCN block backward (K2), or with ``--forward`` its forward (K1),
launch by launch, on one CUDA device.

At Conv-TasNet's block shape (B=16, T=3999, C=Cs=128, H=512; ``--batch``
and ``--steps`` change B and T), for each dilation of ``--dilations``
(default 1 and 128), float32 with TF32 off, or on the bf16 route with
``--bf16`` (x, parameters and cotangents rounded to bfloat16):

* the kernel's time a call: CUDA events around ``--calls`` calls after
  two warm-up calls, the mean;
* each of its launches' device time a call, grouped by kernel name, from a
  ``torch.profiler`` trace of ``--calls`` calls, and the launches a call.

Random inputs and parameters from a numpy seed, as ``chip_smoke.py``
makes them. With ``--bf16`` it also counts the bf16 tensor-core products
(``HMMA ... BF16``) in the SASS of K1-bf16's and K2-bf16's GEMM kernels in
the built library (``profile_lstm.mma_sass`` over :data:`MMA_KERNELS`).
Prints the card (``nvidia-smi`` name and power limit), a table and one
JSON object.

    python -m brever_tpu_torch.profile_tcn_bwd [--dilations 1,128]
        [--batch 16] [--steps 3999] [--calls 5] [--forward] [--bf16]

Without ``--bf16`` it calls only ``ops.tcn_block.tcn_block_fwd`` and
``tcn_block_bwd``, so it runs unchanged in a checkout of an earlier commit
of the port: copy it into that tree's ``brever_tpu_torch/`` and run the
two trees in turns.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from .numerics import disable_tf32
from .ops import build
from .ops import tcn_block as tcn
from .profile_enhance import _cuda_ms, _device_time

#: K1-bf16's and K2-bf16's GEMM kernels (csrc/tcn_block_bf16.cu), by a piece
#: of their names
MMA_KERNELS = ('tcn_in_mma', 'tcn_out_mma', 'tcn_bwd_z1_mma',
               'tcn_bwd_gy2_mma', 'tcn_bwd_wout_mma', 'tcn_bwd_dx_mma',
               'tcn_bwd_win_mma')


def block_inputs(rng, batch, t_total, device, c=128, h=512, cs=128):
    """Random block input, parameters (2-D weights in the torch Linear
    layout) and cotangents of the residual and skip outputs."""
    def arr(*s, scale=0.1, center=0.0):
        return torch.from_numpy(
            (center + scale * rng.randn(*s)).astype(np.float32)).to(device)

    x = arr(batch, t_total, c, scale=1.0)
    params = (arr(h, c, scale=c ** -0.5), arr(h), arr(1, center=0.25),
              arr(h, center=1.0), arr(h), arr(3, h, scale=0.5), arr(h),
              arr(1, center=0.25), arr(h, center=1.0), arr(h),
              arr(c, h, scale=h ** -0.5), arr(c), arr(cs, h, scale=h ** -0.5),
              arr(cs))
    return x, params, arr(batch, t_total, c, scale=1.0), \
        arr(batch, t_total, cs, scale=1.0)


def profile(dilation, batch=16, t_total=3999, calls=5, device='cuda',
            forward=False, dtype=torch.float32):
    """``{'ms', 'launches', 'parts'}`` of K2 (with ``forward``, K1) at one
    dilation, its inputs in ``dtype`` (float32, or bfloat16 for the bf16
    route): the mean ms a call, the device launches a call, and
    ``{kernel: ms a call}``."""
    x, params, g_res, g_skip = block_inputs(
        np.random.RandomState(dilation), batch, t_total, device)
    x, g_res, g_skip = (t.to(dtype) for t in (x, g_res, g_skip))
    params = tuple(p.to(dtype) for p in params)
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, dilation, False)

    @torch.no_grad()
    def call():
        if forward:
            tcn.tcn_block_fwd(x, params, dilation, False)
        else:
            tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                              False)

    for _ in range(2):
        call()
    ms = _cuda_ms(call, calls)
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kernels = _device_time(prof)[1]
        # a trace that lost device events (seen on the card with several
        # traces in one process) has a kernel whose count is not a whole
        # number of launches a call: take another
        if all(count % calls == 0 for _, count in kernels.values()):
            break
    else:
        raise RuntimeError('profile_tcn_bwd: three traces lost device events')
    parts = {name: us / 1e3 / calls for name, (us, _) in kernels.items()}
    launches = sum(count for _, count in kernels.values()) / calls
    return {'ms': ms, 'launches': launches, 'parts': parts}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dilations', default='1,128')
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--steps', type=int, default=3999)
    parser.add_argument('--calls', type=int, default=5)
    parser.add_argument('--forward', action='store_true',
                        help='profile K1, the forward, instead')
    parser.add_argument('--bf16', action='store_true',
                        help='the bf16 route')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_tcn_bwd: needs a CUDA device')
    disable_tf32()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out = {'card': card, 'batch': args.batch, 'steps': args.steps,
           'kernel': ('K1' if args.forward else 'K2')
           + ('-bf16' if args.bf16 else '')}
    for dilation in map(int, args.dilations.split(',')):
        run = profile(dilation, args.batch, args.steps, args.calls,
                      forward=args.forward, dtype=torch.bfloat16 if args.bf16
                      else torch.float32)
        out[f'd{dilation}'] = run
        print(f'd={dilation}: {run["ms"]:.3f} ms a call (CUDA events), '
              f'{run["launches"]:g} launches a call; device ms a call:',
              flush=True)
        for name, ms in sorted(run['parts'].items(), key=lambda kv: -kv[1]):
            print(f'  {ms:8.3f}  {100 * ms / run["ms"]:5.1f} %  {name}',
                  flush=True)
    if args.bf16:
        from .profile_lstm import mma_sass
        out['hmma_bf16'] = mma_sass(build.build(), MMA_KERNELS)
        print(f'bf16 HMMA in the SASS: {out["hmma_bf16"]}', flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
