"""Train-mode BatchNorm with an optional ReLU or SiLU (flash-BN), forward
and backward: the plain versions and the CUDA kernels.

Counterpart of the train-mode branch of ``batch_norm_act`` in
``brever_tpu/models/common.py``, and of ``gn_act_stats_pallas``
(``ops/pallas/groupnorm.py``), the Pallas kernels it reaches as a GroupNorm
with ``num_groups = C`` over a ``(1, N, C)`` view. The layout here is
channels first: ``x (B, C, *spatial)``, contiguous, so that channel c of
batch row b is one contiguous slab of ``N`` floats (``N`` the spatial size)
and the channel's statistics span the B slabs. ``scale`` and ``bias`` are
``(C,)``; the statistics are per channel over the batch and spatial axes,
in float32 in the fast-variance form ``E[x^2] - mean^2``, not clipped at 0,
as the JAX package's XLA branch computes them:

    y = act((x - mean) (scale rsqrt(var + eps)) + bias)

:func:`batch_norm_act` is what the models call. Under grad mode with an input
that requires grad it goes through :class:`BatchNormActFunction`, whose
forward saves only x and the ``(C,)`` mean and rstd and whose backward
returns dx, dscale and dbias; the statistics it returns for the running
update are detached (``gn_act_stats_pallas`` drops their cotangents without
saying so). A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels (``csrc/groupnorm.cu`` ``bn_fwd``: K7-BN, replacing
``_fwd_kernel``; ``bn_bwd``: K8-BN, replacing ``_bwd_kernel``) or raises.
Both are K7's and K8's cluster kernels over the C channels, each channel's
B rows held in the shared memory of one cluster of 1-16 blocks: one launch
each. A channel past a 16-block cluster takes the route :func:`bn_plan`
names for it (part held, or two passes through device memory);
:func:`plan_info` checks the library's plan against that mirror once a
shape. There is no channel cap and no byte floor: the JAX package's
``_FUSED_BN_MAX_C`` and ``_FUSED_BN_MIN_BYTES`` are Mosaic's.

The plain versions: :func:`batch_norm_act_reference`, the XLA branch's
arithmetic, and :func:`batch_norm_act_bwd_plain`, its memory-lean backward,
which recomputes the normalised tensor and the activation's derivative from
x and the statistics.

bf16 (amp): x of bfloat16 takes the kernels' bf16 route (``csrc/
groupnorm_bf16.cu``). Its twins, the bf16 mode of the plain versions, are
the Pallas kernels at bf16 I/O (the JAX package's ``BREVER_BN_FUSED=1``
branch, the affine cast to the trunk's dtype): x and dy widened to float32,
float32 statistics, ``y = act(x a + b)`` with the affine folded as
``_fwd_kernel`` folds it and rounded to bf16 once, after the activation
(the XLA branch rounds before the activation: ReLU gives the same bits,
SiLU may differ by a bf16 ulp); dx rounded once; dscale and dbias float32,
cast at the autograd boundary to the affine's dtype. The statistics (mean,
var, rstd) are float32 on both routes, for the float32 running update. The
bf16 launches are counted apart as well, in ``launches_bf16``.
"""

import torch

from . import build
from . import groupnorm as gn
from .groupnorm import ACTS, _act, _act_grad, _wide, affine32


def _channel(v, x):
    """A ``(C,)`` vector as ``(1, C, 1, ...)`` for broadcasting."""
    return v.reshape(1, -1, *([1] * (x.ndim - 2)))


def _dims(x):
    return (0,) + tuple(range(2, x.ndim))


def _pre_activation(x, scale, bias, mean, rstd):
    """``(xhat, z)``: ``z = (x - mean) (scale rstd) + bias``, the XLA
    branch's order."""
    centred = x - _channel(mean, x)
    return (centred * _channel(rstd, x),
            centred * _channel(scale * rstd, x) + _channel(bias, x))


def _folded(x, scale, bias, mean, rstd):
    """``z = x a + b``, ``a = scale rstd``, ``b = bias - mean a``: the
    Pallas kernel's (and the bf16 route's) fold of the affine, one rounding
    of ``x a + b`` (:func:`.groupnorm.fma`)."""
    a = scale * rstd
    return gn.fma(x, _channel(a, x), _channel(bias - mean * a, x))


def batch_norm_act_reference(x, scale, bias, eps, act):
    """Plain forward: ``(y, mean, var, rstd)``, the statistics ``(C,)``. A
    bfloat16 x: the bf16 route's twin (module docstring), y bfloat16 and
    the statistics float32."""
    xs = _wide(x)
    dims = _dims(x)
    mean = xs.mean(dim=dims)
    var = (xs * xs).mean(dim=dims) - mean * mean
    rstd = torch.rsqrt(var + eps)
    if x.dtype == torch.bfloat16:
        z = _folded(xs, _wide(scale), _wide(bias), mean, rstd)
        return _act(z, act).to(x.dtype), mean, var, rstd
    _, z = _pre_activation(x, scale, bias, mean, rstd)
    return _act(z, act), mean, var, rstd


def batch_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd, act):
    """Plain backward from x and the statistics: ``(dx, dscale, dbias)``.
    A bfloat16 x: the bf16 route's twin, dx bfloat16 and dscale, dbias
    float32."""
    bf16 = x.dtype == torch.bfloat16
    xs, scale, dy = _wide(x), _wide(scale), _wide(dy)
    if bf16:
        xhat = (xs - _channel(mean, xs)) * _channel(rstd, xs)
        z = _folded(xs, scale, _wide(bias), mean, rstd)
    else:
        xhat, z = _pre_activation(x, scale, bias, mean, rstd)
    dz = _act_grad(z, dy, act)
    dims = _dims(x)
    dbias = dz.sum(dim=dims)
    dscale = (dz * xhat).sum(dim=dims)
    n = x.numel() // x.shape[1]
    dx = _channel(rstd, xs) * (dz * _channel(scale, xs)
                               - _channel(scale * dbias / n, xs)
                               - xhat * _channel(scale * dscale / n, xs))
    return dx.to(x.dtype), dscale, dbias


def batch_norm_act_fwd(x, scale, bias, eps, act):
    """``(y, mean, var, rstd)``: the plain version on the CPU, else K7-BN
    (its bf16 route for a bfloat16 x; counted in
    ``batch_norm_act_fwd.launches``, the bf16 route's also in
    ``.launches_bf16``)."""
    if x.device.type == 'cpu':
        return batch_norm_act_reference(x, scale, bias, eps, act)
    out = _launch_fwd(x, scale, bias, eps, act)
    batch_norm_act_fwd.launches += 1
    if x.dtype == torch.bfloat16:
        batch_norm_act_fwd.launches_bf16 += 1
    return out


batch_norm_act_fwd.launches = 0
batch_norm_act_fwd.launches_bf16 = 0


def batch_norm_act_bwd(x, dy, scale, bias, mean, rstd, act):
    """The VJP ``(dx, dscale, dbias)``: the plain version on the CPU, else
    K8-BN (counted in ``batch_norm_act_bwd.launches``, the bf16 route's
    also in ``.launches_bf16``)."""
    if x.device.type == 'cpu':
        return batch_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd, act)
    out = _launch_bwd(x, dy, scale, bias, mean, rstd, act)
    batch_norm_act_bwd.launches += 1
    if x.dtype == torch.bfloat16:
        batch_norm_act_bwd.launches_bf16 += 1
    return out


batch_norm_act_bwd.launches = 0
batch_norm_act_bwd.launches_bf16 = 0


class BatchNormActFunction(torch.autograd.Function):
    """Train-mode BatchNorm + activation with its memory-lean VJP: saves x
    and the ``(C,)`` mean and rstd. ``apply(x, scale, bias, eps, act,
    plain)`` returns ``(y, mean, var)``, the statistics without gradient;
    with ``plain`` the plain versions on every device, else the kernels on
    CUDA."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, act, plain):
        fwd = batch_norm_act_reference if plain else batch_norm_act_fwd
        y, mean, var, rstd = fwd(x, scale, bias, eps, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.act, ctx.plain = act, plain
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        bwd = batch_norm_act_bwd_plain if ctx.plain else batch_norm_act_bwd
        dx, dscale, dbias = bwd(x, dy.contiguous(), scale, bias, mean, rstd,
                                ctx.act)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
                None)


def _batch_norm_act(x, scale, bias, eps, act, plain):
    if act not in ACTS:
        raise ValueError(f'batch_norm_act: activation {act!r}, not one of '
                         f'{sorted(ACTS)}')
    if x.ndim < 2 or not x.is_contiguous():
        raise ValueError(f'batch_norm_act: x {tuple(x.shape)} must be '
                         'contiguous channels first (B, C, *spatial), got '
                         f'strides {x.stride()}')
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, scale, bias)):
        y, mean, var = BatchNormActFunction.apply(x, scale, bias, float(eps),
                                                  act, plain)
        return y, mean, var
    fwd = batch_norm_act_reference if plain else batch_norm_act_fwd
    y, mean, var, _ = fwd(x, scale, bias, float(eps), act)
    return y, mean.detach(), var.detach()


def batch_norm_act(x, scale, bias, eps=1e-5, act='none'):
    """Train-mode BatchNorm of ``x (B, C, *spatial)``, contiguous (any other
    layout raises, on every device), with the affine ``scale, bias (C,)``,
    then ``act`` (``none``, ``relu`` or ``silu``): ``(y, mean, var)``, the
    batch statistics ``(C,)`` detached, for the running update.
    Differentiable in y through :class:`BatchNormActFunction` when grad mode
    is on and an input requires grad. A tensor on the CPU takes the plain
    versions; a CUDA tensor launches K7-BN (and K8-BN in the backward) or
    raises."""
    return _batch_norm_act(x, scale, bias, eps, act, False)


def batch_norm_act_plain(x, scale, bias, eps=1e-5, act='none'):
    """:func:`batch_norm_act` through the plain versions on any device."""
    return _batch_norm_act(x, scale, bias, eps, act, True)


# ---------------------------------------------------------------------------
# the kernels

def _tensor(t, name, device, shape, dtypes=(torch.float32,)):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'batch_norm_act: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'batch_norm_act: {name} is on {t.device}, x on '
                         f'{device}')
    if t.dtype not in dtypes:
        raise TypeError(f'batch_norm_act: {name} must be one of {dtypes}, '
                        f'got {t.dtype}')
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'batch_norm_act: {name} must be a contiguous '
                         f'{shape} tensor (channels first), got '
                         f'{tuple(t.shape)} with strides {t.stride()}')
    return t


def _check(x, scale, bias, act):
    """Check what the kernels take (x float32, or bfloat16 for the bf16
    route, the affine float32 or bfloat16); returns ``(B, C, N)``."""
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'batch_norm_act: no kernel for device {device}')
    if x.ndim < 2 or 0 in x.shape:
        raise ValueError('batch_norm_act: x must be a non-empty (B, C, ...) '
                         f'tensor, got {tuple(x.shape)}')
    _tensor(x, 'x', device, tuple(x.shape), gn.DTYPES)
    batch, channels = x.shape[:2]
    n = x.numel() // (batch * channels)
    _tensor(scale, 'scale', device, (channels,), gn.DTYPES)
    _tensor(bias, 'bias', device, (channels,), gn.DTYPES)
    if act not in ACTS:
        raise ValueError(f'batch_norm_act: activation {act!r}, not one of '
                         f'{sorted(ACTS)}')
    if max(batch, channels, n) >= 2 ** 31:
        raise ValueError(f'batch_norm_act: {tuple(x.shape)} passes the '
                         'kernels\' int range')
    return batch, channels, n


#: csrc/groupnorm.cu's flash-BN routes (``enum Route``), by code: one
#: block a channel, a cluster that holds it, a cluster that holds part of
#: it, two passes through device memory
ROUTES = ('block', 'cluster', 'partial', 'passes')
#: the routes of a channel past the largest cluster, K7-BN's and K8-BN's
#: (``kBnFwdPast``, ``kBnBwdPast``); K8-BN's off the vector grid too
_FWD_PAST, _BWD_PAST = 'partial', 'passes'
#: floats of a row one warp of the passes takes (``kSeg``); the shared
#: memory of an SM, and of it the system's a block (``kSmemSm``,
#: ``kSmemReserved``)
_SEG, _SMEM_SM, _SMEM_RESERVED = 4096, 233472, 1024


def channel_shares(batch, n, cluster):
    """``(first element, elements)`` of each block's share of a channel
    (its B rows of N elements end to end) at ``cluster`` blocks a cluster:
    block r
    takes tasks ``[r T / n, (r + 1) T / n)`` of the channel's T, as K7's
    blocks take a group's."""
    return gn.group_shares(batch, n, 1, cluster)


def _plan_at(batch, channels, n, cluster, itemsize):
    widths = [w for _, w in channel_shares(batch, n, cluster)]
    held = min(-(-max(widths) // 4) * 4, gn.held_most(itemsize))
    remainder = sum(max(w - held, 0) for w in widths)
    route = 'cluster' if cluster > 1 else 'block'
    fwd, bwd = (_FWD_PAST, _BWD_PAST) if remainder else (route, route)
    if n % 4 or (itemsize == 2 and cluster == gn._MOST_CLUSTER):
        bwd = 'passes'
    tasks = batch * -(-n // gn._TASK)
    smem = gn._SCRATCH + itemsize * held
    two = gn._SCRATCH + 2 * itemsize * held   # a ring of two buffers
    half = cluster == 1 and tasks <= gn._THREADS // 32
    stages = 2 if half and 2 * (two + _SMEM_RESERVED) <= _SMEM_SM else 1
    return {'cluster': cluster, 'resident': held, 'smem': smem,
            'threads': gn._THREADS // 2 if half else gn._THREADS,
            'tasks': tasks, 'remainder': remainder,
            'blocks': channels * cluster, 'route_fwd': fwd,
            'route_bwd': bwd,
            'workspace': (batch * channels * -(-n // _SEG) * 16
                          if bwd == 'passes' else 0),
            'stages': stages, 'block_smem': two if stages == 2 else smem}


def bn_plan(batch, channels, n, most=gn._MOST_CLUSTER, itemsize=4):
    """K7-BN's and K8-BN's plan at ``(B, C, N)`` for x of ``itemsize``
    bytes an element (4, or 2 on the bf16 route), as ``bn_plan`` of
    csrc/groupnorm.cu gives it: K7's cluster plan (:func:`.groupnorm.
    gn_plan`) over a channel's B rows, the smallest cluster (1, 2, 4, ...
    ``most`` blocks) whose blocks hold their shares of the channel, a
    cluster a channel; each kernel's route (``route_fwd``, ``route_bwd``):
    ``block`` or ``cluster`` where the channel is held, else ``partial``
    (K7-BN) and ``passes`` (K8-BN), and ``passes`` in K8-BN wherever N is
    off the vector grid and, on the bf16 route, where only the largest
    cluster (16 blocks) holds the channel; the bytes of the passes' workspace
    (``workspace``, 0 off the passes). Where one block takes a channel of
    at most 16 tasks (``bn_ring``) its blocks have half the threads (two or
    three an SM) and a ring of two buffers (``stages``; the next channel
    copied in while this one is reduced and written) where two such blocks
    fit an SM's shared memory; ``block_smem``: a block's dynamic shared
    memory."""
    cluster = 1
    while cluster < most and _plan_at(batch, channels, n, cluster,
                                      itemsize)['remainder']:
        cluster *= 2
    return _plan_at(batch, channels, n, cluster, itemsize)


#: the library's plan at each (B, C, N) checked so far
_plans = {}

_PLAN_KEYS = ('cluster', 'resident', 'smem', 'threads', 'tasks', 'remainder',
              'blocks', 'clusters', 'route_fwd', 'route_bwd', 'workspace',
              'stages', 'block_smem')


def plan_info(batch, channels, n, itemsize=4):
    """The library's plan (``bn_plan``, with ``clusters``: how many
    clusters of its size the card holds at once, of K7-BN's and K8-BN's
    kernels alike) for x of ``itemsize`` bytes an element; raises where it
    is not the wrapper's mirror :func:`bn_plan`
    (:func:`.groupnorm.library_plan`)."""
    key = (batch, channels, n, itemsize)
    if key not in _plans:
        _plans[key] = gn.library_plan(
            'bn_plan', key[:3], bn_plan, _PLAN_KEYS, 'batch_norm_act',
            {'route_fwd': ROUTES, 'route_bwd': ROUTES}, itemsize)
    return _plans[key]


def _route_args(plan, route, channels):
    """``(route code, cluster, clusters)`` of a launch: as many clusters as
    the card holds at once, at most one a channel."""
    return (ROUTES.index(route), plan['cluster'],
            min(channels, plan['clusters']))


def _launch_fwd(x, scale, bias, eps, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, act)
    device = x.device
    scale, bias = affine32(scale), affine32(bias)
    with torch.cuda.device(device):
        plan = plan_info(batch, channels, n, x.element_size())
        route = plan['route_fwd']
        y = torch.empty_like(x)
        # mean, var and rstd: the rows of one allocation
        stats = torch.empty(3, channels, dtype=torch.float32, device=device)
        ptr = stats.data_ptr()
        build.check(lib, lib.bn_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            ptr, ptr + 4 * channels, ptr + 8 * channels, batch, channels, n,
            eps, ACTS[act], *_route_args(plan, route, channels),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream), 'bn_fwd')
    return (y, *stats.unbind())


def _launch_bwd(x, dy, scale, bias, mean, rstd, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, act)
    device = x.device
    _tensor(dy, 'dy', device, tuple(x.shape), (x.dtype,))
    _tensor(mean, 'mean', device, (channels,))
    _tensor(rstd, 'rstd', device, (channels,))
    scale, bias = affine32(scale), affine32(bias)
    with torch.cuda.device(device):
        plan = plan_info(batch, channels, n, x.element_size())
        route = plan['route_bwd']
        dx = torch.empty_like(x)
        # dscale and dbias: the rows of one allocation
        grads = torch.empty(2, channels, dtype=torch.float32, device=device)
        ptr = grads.data_ptr()
        # the passes' segment sums
        work = (torch.empty(plan['workspace'], dtype=torch.uint8,
                            device=device) if route == 'passes' else None)
        build.check(lib, lib.bn_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), ptr,
            ptr + 4 * channels, None if work is None else work.data_ptr(),
            batch, channels, n, ACTS[act],
            *_route_args(plan, route, channels),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream), 'bn_bwd')
    return (dx, *grads.unbind())
