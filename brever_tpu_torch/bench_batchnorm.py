"""K7-BN and K8-BN (the flash-BN forward and backward) at the BatchNorm
calls of one MANNER train step: the calls, recorded from the model's own,
and each call's times on the card, which ``chip_smoke.py`` phase 32 sums
over a step at 16 x 4 s.

For each (shape, activation) class :func:`time_manner_calls` times K7-BN
and K8-BN three ways, as ``bench_groupnorm`` does K7 and K8: the card's
time (CUDA events around calls queued behind a sleep kernel,
``bench_alu_dtype.time_calls``), the host's time to issue a call, and the
paced time (calls issued one after another, the host's pace included);
then the sums over the step beside the bound (x read and y written once, 8
bytes an element; x and dy read and dx written once, 12) and, where the
wrapper has a plan, each class's routes and cluster.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from .bench_alu_dtype import time_calls
from .bench_groupnorm import bound_ms, paced_ms
from .ops import batchnorm as bn
from .ops import build
from .ops.groupnorm import ACTS

FS = 16000


def manner_calls(model, device, batch=16, seconds=4):
    """``{(shape, act): count}``: the train-mode BatchNorm calls of one
    forward of ``model``'s network on a (batch, 1, samples) mixture of
    ``seconds``, each passed on to ``models.common.batch_norm_act`` (on the
    meta device, one that only passes x back gives the calls without
    arithmetic)."""
    from .models import common
    x = torch.from_numpy((0.1 * np.random.RandomState(0).randn(
        batch, 1, int(seconds * FS))).astype(np.float32)).to(device)
    calls = {}
    inner = common.batch_norm_act

    def record(x, scale, bias, eps=1e-5, act='none'):
        key = (tuple(x.shape), act)
        calls[key] = calls.get(key, 0) + 1
        return inner(x, scale, bias, eps, act)

    common.batch_norm_act = record
    training = model.net.training
    model.net.train()
    try:
        with torch.no_grad():
            model.net(x)
    finally:
        common.batch_norm_act = inner
        model.net.train(training)
    return calls


#: the shapes :func:`launches_a_call` traces: one block (N = 1000 and N =
#: 249, 4-byte loads), an 8-block cluster, past a 16-block cluster
TRACE_SHAPES = ((16, 480, 1000), (16, 320, 249), (16, 120, 16020),
                (16, 60, 64084))
#: the kernels one K7-BN and one K8-BN call launch on each route
KERNELS = {
    'fwd': {'block': ['gn_fwd_cluster'], 'cluster': ['gn_fwd_cluster'],
            'partial': ['gn_fwd_cluster']},
    'bwd': {'block': ['gn_bwd_cluster'], 'cluster': ['gn_bwd_cluster'],
            'partial': ['gn_bwd_cluster'],
            'passes': ['bn_bwd_partials', 'bn_bwd_dx']}}

_TRACE = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import batchnorm as bn
from brever_tpu_torch.bench_batchnorm import TRACE_SHAPES

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(0)


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # a trace without one device event lost its events (seen on the card
    # once in many runs), as the calls launch kernels: trace them again
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got:
            break
    return got


out = []
with torch.no_grad():
    for shape in TRACE_SHAPES:
        x, dy = (torch.randn(*shape, generator=gen, device=dev)
                 for _ in range(2))
        scale = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
        bias = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
        _, mean, _, rstd = bn.batch_norm_act_fwd(x, scale, bias, 1e-5,
                                                 'relu')
        plan = bn.plan_info(*shape)
        out.append({
            'shape': shape, 'fwd_route': plan['route_fwd'],
            'bwd_route': plan['route_bwd'],
            'fwd': names(lambda: [bn.batch_norm_act_fwd(
                x, scale, bias, 1e-5, 'relu') for _ in range(3)]),
            'bwd': names(lambda: [bn.batch_norm_act_bwd(
                x, dy, scale, bias, mean, rstd, 'relu') for _ in range(3)])})
        del x, dy
print(json.dumps(out))
"""


def launches_a_call():
    """``{'fwd': {route: n}, 'bwd': {route: n}}``: the kernels one K7-BN
    and one K8-BN call launch on each route of :data:`TRACE_SHAPES`, from
    a ``torch.profiler`` trace of three calls a shape in a fresh
    interpreter (the profiler loses events after other traces in one
    process). Raises unless each call launches its route's kernels
    (:data:`KERNELS`) once each and nothing else."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, '-c', _TRACE], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(f'flash-BN trace: {run.stderr[-3000:]}')
    out = {'fwd': {}, 'bwd': {}}
    for case in json.loads(run.stdout.strip().splitlines()[-1]):
        for key in ('fwd', 'bwd'):
            route, names = case[f'{key}_route'], case[key]
            kernels = KERNELS[key][route]
            if len(names) != 3 * len(kernels) or any(
                    sum(k in n for n in names) != 3 for k in kernels):
                raise AssertionError(f'{key} at {case["shape"]} ({route}) '
                                     f'launched {names} in 3 calls')
            out[key][route] = len(kernels)
    return out


def time_bwd_routes(shape, act, device, seed=32, reps=20,
                    dtype=torch.float32):
    """``{route: ms}``: K8-BN's card time at ``shape`` on the plan's cluster
    (which holds the channel, or part of it) and on the passes, each
    launched through the library's entry point as the wrapper launches its
    plan's route, x and dy of ``dtype`` (bfloat16: the bf16 route); the two
    routes' gradients agree within the card tests' bounds."""
    lib = build.load_library()
    batch, channels, n = shape
    bf16 = int(dtype == torch.bfloat16)
    x, scale, bias, dy = _inputs(np.random.RandomState(seed), shape, device)
    x, dy = x.to(dtype), dy.to(dtype)
    plan = bn.plan_info(batch, channels, n, x.element_size())
    held = ('partial' if plan['remainder'] else
            'cluster' if plan['cluster'] > 1 else 'block')
    with torch.no_grad():
        _, mean, _, rstd = bn.batch_norm_act_fwd(x, scale, bias, 1e-5, act)
    stream = torch.cuda.current_stream(device).cuda_stream
    work = torch.empty(16 * batch * channels * -(-n // bn._SEG),
                       dtype=torch.uint8, device=device)
    out, grads = {}, []
    for route in (held, 'passes'):
        dx, g = torch.empty_like(x), torch.empty(2, channels, device=device)
        args = (bn.ROUTES.index(route), plan['cluster'],
                min(channels, plan['clusters']), bf16, stream)

        def bwd():
            build.check(lib, lib.bn_bwd(
                x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
                work.data_ptr(), batch, channels, n, ACTS[act], *args),
                'bn_bwd')

        bwd()
        out[route] = time_calls(bwd, device, reps)[0]
        grads.append((dx, g))
    # (bf16 dx: a rounding apart, 2^-8 relative)
    tol = 2 ** -7 if bf16 else 1e-3
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=0.1 * tol * b.abs().max().item())
    return out


def _inputs(rng, shape, device):
    """x, scale, bias and dy drawn on the device from a generator seeded by
    ``rng`` (a numpy draw of MANNER's largest class takes seconds)."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.randint(2 ** 31)))

    def arr(*s, scale=1.0, center=0.0):
        return center + scale * torch.randn(*s, generator=gen, device=device)

    c = shape[1]
    return (arr(*shape, scale=2.0, center=0.5), arr(c, scale=0.1, center=1.0),
            arr(c, scale=0.1), arr(*shape))


def time_manner_calls(calls, device, seed=32, reps=20):
    """Each class's K7-BN and K8-BN times (card, host, paced), bounds and,
    where the wrapper has ``plan_info``, routes; and their sums over the
    calls' counts: ``{'rows': [...], 'sum': {...}}``; ``host`` in the sum
    is the mean a call."""
    rng = np.random.RandomState(seed)
    plan_info = getattr(bn, 'plan_info', None)
    rows, total = [], {}
    for (shape, act), count in sorted(calls.items()):
        x, scale, bias, dy = _inputs(rng, shape, device)
        with torch.no_grad():
            _, mean, _, rstd = bn.batch_norm_act_fwd(x, scale, bias, 1e-5,
                                                     act)
            fns = {'k7': lambda: bn.batch_norm_act_fwd(x, scale, bias, 1e-5,
                                                       act),
                   'k8': lambda: bn.batch_norm_act_bwd(x, dy, scale, bias,
                                                       mean, rstd, act)}
            row = {'shape': list(shape), 'act': act, 'count': count}
            for name, fn in fns.items():
                card, host = time_calls(fn, device, reps)
                row[name] = {'card': card, 'host': host,
                             'paced': paced_ms(fn)}
        row['bound_k7'], row['bound_k8'] = bound_ms(shape)
        if plan_info is not None:
            plan = plan_info(shape[0], shape[1],
                             x.numel() // (shape[0] * shape[1]))
            row.update(route_fwd=plan['route_fwd'],
                       route_bwd=plan['route_bwd'], cluster=plan['cluster'],
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
