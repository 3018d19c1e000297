"""K7 and K8 (the flash-GN forward and backward) at the GroupNorm calls of
one U-Net evaluation: the calls, recorded from the model's own, and each
call's times on the card, which ``chip_smoke.py`` phase 21 sums over an
SGMSE+ evaluation at 4 x 4 s.

For each GroupNorm shape :func:`time_unet_calls` times K7 and K8 three
ways: the card's time (CUDA events around calls queued behind a sleep
kernel, ``bench_alu_dtype.time_calls``), the host's time to issue a call,
and the paced time (CUDA events around calls issued one after another, the
host's pace included); then the sums over the evaluation beside the bound
(x read and y written once, 8 bytes an element; x and dy read and dx
written once, 12) and the plan's route and cluster.
"""

import numpy as np
import torch

from .bench_alu_dtype import time_calls
from .ops import groupnorm as gn

#: the H100 SXM's published memory rate (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
FS = 16000


def bound_ms(shape):
    """(K7, K8) bounds in ms: 8 and 12 bytes an element at the memory
    rate (a few flops an element are far below the card's rate)."""
    n = int(np.prod(shape))
    return 1e3 * 8 * n / HBM_BYTES_PER_S, 1e3 * 12 * n / HBM_BYTES_PER_S


def paced_ms(fn, iters=5, warmup=1):
    """ms a call of calls issued one after another (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unet_calls(model, device, batch=4, seconds=4):
    """``{(shape, groups, silu): count}``: the GroupNorm calls without the
    external affine of one evaluation of ``model``'s denoiser on a (batch,
    1, 256, frames) spectrogram of ``seconds``, each passed on to the
    U-Net's ``group_norm_silu`` (on the meta device, one that only passes
    x back gives the calls without arithmetic)."""
    from .models.sgmse import net
    frames = seconds * FS // 128 + 1
    rng = np.random.RandomState(0)
    xs, ys = (torch.complex(*(torch.from_numpy(
        (0.3 * rng.randn(batch, 1, 256, frames)).astype(np.float32))
        for _ in range(2))).to(device) for _ in range(2))
    t = torch.full((batch, 1, 1, 1), 0.5, device=device)
    calls = {}
    inner = net.group_norm_silu

    def record(x, scale, bias, groups, eps=1e-6, apply_silu=True,
               ext_scale=None, ext_shift=None):
        if ext_scale is None:
            key = (tuple(x.shape), groups, apply_silu)
            calls[key] = calls.get(key, 0) + 1
        return inner(x, scale, bias, groups, eps, apply_silu,
                     ext_scale=ext_scale, ext_shift=ext_shift)

    net.group_norm_silu = record
    try:
        with torch.no_grad():
            model.model(xs, ys, model.sde.sigma(t), t)
    finally:
        net.group_norm_silu = inner
    return calls


def time_unet_calls(calls, device, seed=22, reps=20):
    """Each call's K7 and K8 times (card, host, paced), bounds and plan,
    and their sums over the calls' counts: ``{'rows': [...], 'sum':
    {...}}``; ``host`` in the sum is the mean a call."""
    # drawn on the device: a numpy draw of the largest shapes takes
    # seconds on the host
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, total = [], {}
    for (shape, groups, silu), count in sorted(calls.items()):
        act = 'silu' if silu else 'none'

        def arr(*s, scale=1.0, center=0.0):
            return center + scale * torch.randn(*s, generator=gen,
                                                device=device)

        x, dy = arr(*shape, scale=2.0, center=0.3), arr(*shape)
        scale, bias = arr(shape[1], scale=0.1, center=1.0), \
            arr(shape[1], scale=0.1)
        with torch.no_grad():
            _, mean, rstd = gn.group_norm_act_fwd(x, scale, bias, groups,
                                                  1e-6, act)
            fns = {'k7': lambda: gn.group_norm_act_fwd(
                       x, scale, bias, groups, 1e-6, act),
                   'k8': lambda: gn.group_norm_act_bwd(
                       x, dy, scale, bias, mean, rstd, groups, act)}
            row = {'shape': list(shape), 'groups': groups, 'act': act,
                   'count': count}
            for name, fn in fns.items():
                card, host = time_calls(fn, device, reps)
                row[name] = {'card': card, 'host': host,
                             'paced': paced_ms(fn)}
        row['bound_k7'], row['bound_k8'] = bound_ms(shape)
        plan = gn.plan_info(shape[0], shape[1],
                            x.numel() // (shape[0] * shape[1]), groups)
        row.update(route=plan['route'], cluster=plan['cluster'],
                   clusters=plan['clusters'])
        rows.append(row)
        for name in ('k7', 'k8'):
            for key in ('card', 'host', 'paced'):
                total[f'{name}_{key}'] = (total.get(f'{name}_{key}', 0.0)
                                          + count * row[name][key])
            total[f'bound_{name}'] = (total.get(f'bound_{name}', 0.0)
                                      + count * row[f'bound_{name}'])
        del x, dy, scale, bias, mean, rstd
    n_calls = sum(calls.values())
    total['k7_host'] /= n_calls
    total['k8_host'] /= n_calls
    total['calls'] = n_calls
    return {'rows': rows, 'sum': total}
