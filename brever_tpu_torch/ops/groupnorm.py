"""GroupNorm with an optional SiLU or ReLU (flash-GN), forward and
backward: the plain versions and the CUDA kernels.

Counterpart of ``group_norm_silu`` in ``brever_tpu/ops/normalization.py``
and its Pallas kernels ``gn_silu_pallas`` (``ops/pallas/groupnorm.py``).
The layout is channels first: ``x (B, C, *spatial)``, contiguous, so that
one group of one batch row is one contiguous slab of ``(C / G) * N`` floats
(``N`` the spatial size); the diffusion U-Net runs its trunk in that
layout. ``scale`` and ``bias`` are ``(C,)``; statistics are per ``(B, G)``
in the fast-variance form ``E[x^2] - mean^2``, as ``nn.GroupNorm`` and the
Pallas kernel compute them.

:func:`group_norm_silu` is what the models call. Under grad mode with an
input that requires grad it goes through :class:`GroupNormActFunction`,
whose forward saves only x and the per-(b, g) mean and rstd (as
``_make_gn_act_pallas`` does) and whose backward returns dx, dscale and
dbias (cast to the affine's dtype, as its VJP casts them); otherwise
(serving) it is the forward alone. A tensor on the CPU
takes the plain versions; a CUDA tensor launches the kernels
(``csrc/groupnorm.cu``: K7, the forward, one launch, replaces
``_fwd_kernel``; K8, the backward, two launches, ``_bwd_kernel``) or
raises. Both run one thread-block cluster a (b, g) group that holds the
group's slab of x in shared memory; :func:`gn_plan` mirrors the library's plan
of it, which :func:`plan_info` checks once a shape. There is no
channel-count gate: the Pallas path's ``C % 128`` is the TPU's lane rule,
and the kernels take any C that the group count divides.

The plain versions: :func:`group_norm_act_reference`, the twin of
``_make_gn_silu`` without the external affine (f32 statistics, then the
affine, then the activation), and :func:`group_norm_act_bwd_plain`, its
memory-lean backward, which recomputes the normalised tensor and the
activation's derivative from x.

bf16 (amp): x of bfloat16 takes the kernels' bf16 route (``csrc/
groupnorm_bf16.cu``: on the 16-byte grid, N a multiple of 8 and every
tensor 16-byte aligned, kernels of its own that copy the held slab with
TMA bulk copies, hold dy beside it in K8 and store through TMA; off it the
templates at bf16), whose twins are the bf16 mode of the plain versions,
the Pallas kernels at bf16 I/O as written: x and dy widened to float32,
float32 statistics, ``y = act(x a + b)`` with the affine folded as
``_fwd_kernel`` folds it (``a = scale rstd``, ``b = bias - mean a``) and
rounded to bf16 once, after the activation; dx rounded once; dscale and
dbias float32 sums over the per-(b, c) sums, cast at the autograd boundary
to the affine's dtype. The affine may be bfloat16 or float32 (the kernels
take it widened to float32, exactly); y and dx have x's dtype. The
launches of the bf16 route are counted apart as well, in
``launches_bf16``.

With the external per-(batch, channel) affine of the ADM blocks
(``ext_scale``/``ext_shift`` ``(B, C)``, ``z = (xhat scale + bias)
ext_scale + ext_shift``, then the activation) every device takes
:class:`GroupNormExtFunction`, the twin of ``_make_gn_silu(..., has_ext=
True)``: the JAX package never sends that case to its Pallas kernel, so
there is no TPU kernel to port for it. Its forward saves x, the ``(B, G)``
statistics and the affine terms; its backward recomputes ``xhat`` and ``z``
and returns the five gradients. A bfloat16 input is computed in float32
as the JAX package's jnp path does (``brever_tpu/ops/normalization.py``
``_make_gn_silu``): y cast to the result type of x and the affine, dx to
x's dtype and each parameter's gradient to that parameter's.
"""

import contextlib
import ctypes

import torch

from . import build

#: the activations, by the Pallas kernel's names, and the kernels' codes
ACTS = {'none': 0, 'silu': 1, 'relu': 2}


def _act(z, act):
    if act == 'silu':
        return z * torch.sigmoid(z)
    if act == 'relu':
        return torch.relu(z)
    return z


def _act_grad(z, dy, act):
    """``dy * act'(z)``."""
    if act == 'silu':
        s = torch.sigmoid(z)
        return dy * (s * (1.0 + z * (1.0 - s)))
    if act == 'relu':
        return torch.where(z > 0, dy, torch.zeros_like(dy))
    return dy


def _per_channel(stat, x):
    """``(B, G)`` statistics as ``(B, C, 1, ...)`` for broadcasting."""
    reps = x.shape[1] // stat.shape[1]
    return stat.repeat_interleave(reps, dim=1).reshape(
        stat.shape[0], x.shape[1], *([1] * (x.ndim - 2)))


def _param(p, x):
    return p.reshape(1, -1, *([1] * (x.ndim - 2)))


def _normalized(x, scale, bias, mean, rstd):
    """``(xhat, z)`` of the forward from its statistics."""
    xhat = (x - _per_channel(mean, x)) * _per_channel(rstd, x)
    return xhat, xhat * _param(scale, x) + _param(bias, x)


def _statistics(x, num_groups, eps):
    """``(mean, rstd)`` per ``(B, G)``, the fast-variance form."""
    xg = x.reshape(x.shape[0], num_groups, -1)
    mean = xg.mean(dim=-1)
    var = (xg * xg).mean(dim=-1) - mean * mean
    return mean, torch.rsqrt(var + eps)


def _wide(t):
    """A bfloat16 tensor as float32 (exact); any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def fma(x, a, b):
    """``x a + b`` rounded once to float32, as a fused multiply-add (the
    kernels' ``__fmaf_rn``, and XLA's contraction of the Pallas kernel's
    ``x * a + b``): the float32 product is exact in float64."""
    return (x.double() * a.double() + b.double()).float()


def _folded(x, scale, bias, mean, rstd):
    """``z = x a + b`` with ``a = scale rstd``, ``b = bias - mean a`` per
    ``(b, c)``: the Pallas kernel's fold of the affine (float32 inputs),
    one rounding of ``x a + b``."""
    a = _param(scale, x) * _per_channel(rstd, x)
    return fma(x, a, _param(bias, x) - _per_channel(mean, x) * a)


def group_norm_act_reference(x, scale, bias, num_groups, eps, act):
    """Plain forward: ``(y, mean, rstd)``, the statistics ``(B, G)``. A
    bfloat16 x: the bf16 route's twin (module docstring), y bfloat16 and
    the statistics float32."""
    if x.dtype == torch.bfloat16:
        x32 = x.float()
        mean, rstd = _statistics(x32, num_groups, eps)
        z = _folded(x32, _wide(scale), _wide(bias), mean, rstd)
        return _act(z, act).to(x.dtype), mean, rstd
    mean, rstd = _statistics(x, num_groups, eps)
    _, z = _normalized(x, scale, bias, mean, rstd)
    return _act(z, act), mean, rstd


def group_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd, num_groups,
                             act):
    """Plain backward from x and the statistics: ``(dx, dscale, dbias)``.
    A bfloat16 x: the bf16 route's twin, dx bfloat16, dscale and dbias
    float32."""
    if x.dtype == torch.bfloat16:
        return _bwd_bf16(x, dy, scale, bias, mean, rstd, num_groups, act)
    xhat, z = _normalized(x, scale, bias, mean, rstd)
    return _affine_bwd(x, xhat, _act_grad(z, dy, act), scale, rstd,
                       num_groups)


def _bwd_bf16(x, dy, scale, bias, mean, rstd, num_groups, act):
    """``_bwd_kernel`` at bf16 I/O: per-(b, c) sums of ``dz`` and ``dz
    xhat`` over the spatial axes, their scale-weighted group means ``m1``
    and ``m2``, ``dx = rstd (dz scale - m1 - xhat m2)`` rounded to bf16
    once; dscale and dbias the float32 sums of the per-(b, c) sums."""
    x32, scale32 = x.float(), _wide(scale)
    dz = _act_grad(_folded(x32, scale32, _wide(bias), mean, rstd),
                   dy.float(), act)
    xhat = (x32 - _per_channel(mean, x32)) * _per_channel(rstd, x32)
    spatial = tuple(range(2, x.ndim))
    s_dz, s_dzx = dz.sum(dim=spatial), (dz * xhat).sum(dim=spatial)
    batch = x.shape[0]
    n = x.numel() // (batch * num_groups)

    def group_mean(t):
        g = (t * scale32).reshape(batch, num_groups, -1).sum(dim=-1) \
            * (1.0 / n)
        return _per_channel(g, x32)

    dx = _per_channel(rstd, x32) * (dz * _param(scale32, x32)
                                    - group_mean(s_dz)
                                    - xhat * group_mean(s_dzx))
    return dx.to(x.dtype), s_dzx.sum(dim=0), s_dz.sum(dim=0)


def _affine_bwd(x, xhat, dz, scale, rstd, num_groups):
    """``(dx, dscale, dbias)`` from ``dz``, the gradient of ``z = xhat scale
    + bias``."""
    dims = (0,) + tuple(range(2, x.ndim))
    dscale = (dz * xhat).sum(dim=dims)
    dbias = dz.sum(dim=dims)
    dxhat = dz * _param(scale, x)

    def group_mean(t):
        return _per_channel(t.reshape(t.shape[0], num_groups, -1)
                            .mean(dim=-1), t)

    dx = _per_channel(rstd, x) * (dxhat - group_mean(dxhat)
                                  - xhat * group_mean(dxhat * xhat))
    return dx, dscale, dbias


def _per_item(t, x):
    """``(B, C)`` terms as ``(B, C, 1, ...)`` for broadcasting."""
    return t.reshape(*t.shape, *([1] * (x.ndim - 2)))


def group_norm_ext_reference(x, scale, bias, ext_scale, ext_shift,
                             num_groups, eps, act):
    """Plain forward with the external affine ``ext_scale, ext_shift (B,
    C)``: ``(y, mean, rstd)``, the statistics ``(B, G)``; bfloat16 terms
    in float32, y cast to the result type of x and the affine."""
    inputs = (x, scale, bias, ext_scale, ext_shift)
    if any(t.dtype == torch.bfloat16 for t in inputs):
        y, mean, rstd = group_norm_ext_reference(
            *(_wide(t) for t in inputs), num_groups, eps, act)
        return y.to(torch.result_type(x, scale)), mean, rstd
    mean, rstd = _statistics(x, num_groups, eps)
    _, z = _normalized(x, scale, bias, mean, rstd)
    z = z * _per_item(ext_scale, x) + _per_item(ext_shift, x)
    return _act(z, act), mean, rstd


def group_norm_ext_bwd_plain(x, dy, scale, bias, ext_scale, ext_shift, mean,
                             rstd, num_groups, act):
    """Plain backward with the external affine, from x and the
    statistics: ``(dx, dscale, dbias, d_ext_scale, d_ext_shift)``, the last
    two ``(B, C)`` sums over the spatial axes of ``dz z0`` and ``dz`` (``z0 =
    xhat scale + bias``, ``dz`` the gradient of the activation's input).
    bfloat16 terms in float32, each gradient cast to its input's dtype."""
    inputs = (x, scale, bias, ext_scale, ext_shift)
    if any(t.dtype == torch.bfloat16 for t in inputs):
        grads = group_norm_ext_bwd_plain(
            _wide(x), _wide(dy), *(_wide(t) for t in inputs[1:]), mean,
            rstd, num_groups, act)
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))
    xhat, z0 = _normalized(x, scale, bias, mean, rstd)
    gain = _per_item(ext_scale, x)
    dz = _act_grad(z0 * gain + _per_item(ext_shift, x), dy, act)
    spatial = tuple(range(2, x.ndim))
    d_ext_scale = (dz * z0).sum(dim=spatial)
    d_ext_shift = dz.sum(dim=spatial)
    return (*_affine_bwd(x, xhat, dz * gain, scale, rstd, num_groups),
            d_ext_scale, d_ext_shift)


class GroupNormExtFunction(torch.autograd.Function):
    """GroupNorm + external affine + activation with its memory-lean VJP
    (``_make_gn_silu(..., has_ext=True)``'s custom VJP): saves x, the ``(B,
    G)`` statistics, the affine terms and ``ext_scale``/``ext_shift``; the
    plain versions on every device. ``apply(x, scale, bias, ext_scale,
    ext_shift, num_groups, eps, act)``."""

    @staticmethod
    def forward(ctx, x, scale, bias, ext_scale, ext_shift, num_groups, eps,
                act):
        y, mean, rstd = group_norm_ext_reference(
            x, scale, bias, ext_scale, ext_shift, num_groups, eps, act)
        ctx.save_for_backward(x, scale, bias, ext_scale, ext_shift, mean,
                              rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, ext_scale, ext_shift, mean, rstd = ctx.saved_tensors
        grads = group_norm_ext_bwd_plain(x, dy, scale, bias, ext_scale,
                                         ext_shift, mean, rstd,
                                         ctx.num_groups, ctx.act)
        return (*grads, None, None, None)


#: set while torch.utils.checkpoint recomputes a block (:func:`recomputing`)
_recomputing = False


@contextlib.contextmanager
def recomputing():
    """K7 launches in the block are counted in
    ``group_norm_act_fwd.recompute_launches`` as well: the launches a
    rematerialised block's backward adds."""
    global _recomputing
    saved, _recomputing = _recomputing, True
    try:
        yield
    finally:
        _recomputing = saved


def group_norm_act_fwd(x, scale, bias, num_groups, eps, act):
    """``(y, mean, rstd)``: the plain version on the CPU, else K7 (its bf16
    route for a bfloat16 x). ``group_norm_act_fwd.launches`` counts every
    K7 launch, the recomputes of rematerialised blocks included;
    ``.recompute_launches`` counts those alone, ``.launches_bf16`` the bf16
    route's."""
    if x.device.type == 'cpu':
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    out = _launch_fwd(x, scale, bias, num_groups, eps, act)
    group_norm_act_fwd.launches += 1
    if x.dtype == torch.bfloat16:
        group_norm_act_fwd.launches_bf16 += 1
    if _recomputing:
        group_norm_act_fwd.recompute_launches += 1
    return out


group_norm_act_fwd.launches = 0
group_norm_act_fwd.launches_bf16 = 0
group_norm_act_fwd.recompute_launches = 0


def group_norm_act_bwd(x, dy, scale, bias, mean, rstd, num_groups, act):
    """The VJP ``(dx, dscale, dbias)``: the plain version on the CPU, else
    K8 (counted in ``group_norm_act_bwd.launches``, the bf16 route's also
    in ``.launches_bf16``)."""
    if x.device.type == 'cpu':
        return group_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd,
                                        num_groups, act)
    out = _launch_bwd(x, dy, scale, bias, mean, rstd, num_groups, act)
    group_norm_act_bwd.launches += 1
    if x.dtype == torch.bfloat16:
        group_norm_act_bwd.launches_bf16 += 1
    return out


group_norm_act_bwd.launches = 0
group_norm_act_bwd.launches_bf16 = 0


class GroupNormActFunction(torch.autograd.Function):
    """GroupNorm + activation with its memory-lean VJP: saves x and the
    ``(B, G)`` statistics. ``apply(x, scale, bias, num_groups, eps, act,
    plain)``: with ``plain`` the plain versions on every device, else the
    kernels on CUDA."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, plain):
        fwd = group_norm_act_reference if plain else group_norm_act_fwd
        y, mean, rstd = fwd(x, scale, bias, num_groups, eps, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.num_groups, ctx.act, ctx.plain = num_groups, act, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        bwd = group_norm_act_bwd_plain if ctx.plain else group_norm_act_bwd
        dx, dscale, dbias = bwd(x, dy.contiguous(), scale, bias, mean, rstd,
                                ctx.num_groups, ctx.act)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
                None, None)


def _group_norm(x, scale, bias, num_groups, eps, apply_silu, ext_scale,
                ext_shift, plain):
    if (ext_scale is None) != (ext_shift is None):
        raise ValueError('group_norm_silu: ext_scale and ext_shift must be '
                         'given together')
    if x.ndim < 2 or x.shape[1] % num_groups:
        raise ValueError(f'group_norm_silu: channels of {tuple(x.shape)} '
                         f'not divisible by {num_groups} groups')
    if not x.is_contiguous():
        raise ValueError(f'group_norm_silu: x {tuple(x.shape)} must be '
                         'contiguous channels first (B, C, *spatial), got '
                         f'strides {x.stride()}')
    act = 'silu' if apply_silu else 'none'
    if ext_scale is not None:
        # the plain route on every device, as the JAX package's; a (1, C)
        # term (the solver's one noise level for a batch) is broadcast
        ext_scale = ext_scale.reshape(-1, x.shape[1]).expand(x.shape[:2])
        ext_shift = ext_shift.reshape(-1, x.shape[1]).expand(x.shape[:2])
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, scale, bias, ext_scale,
                                          ext_shift)):
            return GroupNormExtFunction.apply(x, scale, bias, ext_scale,
                                              ext_shift, num_groups,
                                              float(eps), act)
        return group_norm_ext_reference(x, scale, bias, ext_scale, ext_shift,
                                        num_groups, float(eps), act)[0]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, scale, bias)):
        return GroupNormActFunction.apply(x, scale, bias, num_groups,
                                          float(eps), act, plain)
    fwd = group_norm_act_reference if plain else group_norm_act_fwd
    return fwd(x, scale, bias, num_groups, float(eps), act)[0]


def group_norm_silu(x, scale, bias, num_groups, eps=1e-6, apply_silu=True,
                    ext_scale=None, ext_shift=None):
    """GroupNorm of ``x (B, C, *spatial)``, contiguous (any other layout
    raises, on every device), with the affine ``scale, bias (C,)``, then
    the external affine ``ext_scale, ext_shift (B, C)`` or ``(1, C)`` if
    given (both or neither), then SiLU if ``apply_silu``; differentiable
    when grad mode is on and an input requires grad. Without the external
    affine a tensor on the CPU takes the plain versions and a CUDA tensor
    launches K7 (and K8 in the backward, :class:`GroupNormActFunction`) or
    raises; with it every device takes :class:`GroupNormExtFunction`."""
    return _group_norm(x, scale, bias, num_groups, eps, apply_silu,
                       ext_scale, ext_shift, False)


def group_norm_silu_plain(x, scale, bias, num_groups, eps=1e-6,
                          apply_silu=True, ext_scale=None, ext_shift=None):
    """:func:`group_norm_silu` through the plain versions on any device."""
    return _group_norm(x, scale, bias, num_groups, eps, apply_silu,
                       ext_scale, ext_shift, True)


# ---------------------------------------------------------------------------
# the kernels

#: the storage types the kernels take: float32, and bfloat16 (the bf16
#: route)
DTYPES = (torch.float32, torch.bfloat16)


def _tensor(t, name, device, shape, dtypes=(torch.float32,)):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'group_norm: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'group_norm: {name} is on {t.device}, x on '
                         f'{device}')
    if t.dtype not in dtypes:
        raise TypeError(f'group_norm: {name} must be one of {dtypes}, got '
                        f'{t.dtype}')
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'group_norm: {name} must be a contiguous {shape} '
                         f'tensor (channels first), got {tuple(t.shape)} '
                         f'with strides {t.stride()}')
    return t


def _check(x, scale, bias, num_groups, act):
    """Check what the kernels take (x float32, or bfloat16 for the bf16
    route, the affine float32 or bfloat16); returns ``(B, C, N)``."""
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'group_norm: no kernel for device {device}')
    if x.ndim < 2 or 0 in x.shape:
        raise ValueError('group_norm: x must be a non-empty (B, C, ...) '
                         f'tensor, got {tuple(x.shape)}')
    _tensor(x, 'x', device, tuple(x.shape), DTYPES)
    batch, channels = x.shape[:2]
    n = x.numel() // (batch * channels)
    _tensor(scale, 'scale', device, (channels,), DTYPES)
    _tensor(bias, 'bias', device, (channels,), DTYPES)
    if channels % num_groups:
        raise ValueError(f'group_norm: {channels} channels in {num_groups} '
                         'groups')
    if act not in ACTS:
        raise ValueError(f'group_norm: activation {act!r}, not one of '
                         f'{sorted(ACTS)}')
    if max(batch, channels, n) >= 2 ** 31:
        raise ValueError(f'group_norm: {tuple(x.shape)} passes the kernels\' '
                         'int range')
    return batch, channels, n


#: csrc/groupnorm.cuh's constants of K7/K8's cluster plan: elements of a
#: row one task (a warp) takes, threads a block, shared memory a block may
#: have and the bytes of it ahead of the slab, the largest cluster
_TASK, _THREADS, _SMEM_MOST, _SCRATCH, _MOST_CLUSTER = 1024, 512, 232448, \
    2048, 16


def _task_start(task, n, segs):
    """The first element of a task (row ``task // segs``, segment ``task %
    segs``) in its group's slab."""
    return task // segs * n + task % segs * _TASK


def group_shares(channels, n, num_groups, cluster):
    """``(first element, elements)`` of each block's share of a group's
    slab at ``cluster`` blocks a cluster: block r takes tasks ``[r T / n, (r
    + 1) T / n)`` of the group's T (rows of N elements cut into segments of
    ``_TASK``); the same at either storage type."""
    segs = -(-n // _TASK)
    tasks = channels // num_groups * segs
    starts = [_task_start(r * tasks // cluster, n, segs)
              for r in range(cluster + 1)]
    return [(a, b - a) for a, b in zip(starts, starts[1:])]


def held_most(itemsize):
    """Elements of a slab a cluster block can hold (``held_most``): whole
    vectors of four, ``itemsize`` bytes each (on the bf16 route 115,200, a
    whole number of the 16-byte route's vectors of eight as well)."""
    return (_SMEM_MOST - _SCRATCH) // itemsize // 4 * 4


def _plan_at(batch, channels, n, num_groups, cluster, itemsize):
    segs = -(-n // _TASK)
    widths = [w for _, w in group_shares(channels, n, num_groups, cluster)]
    # whole vectors: of four elements, of eight on the bf16 route's 16-byte
    # grid
    vec = 16 // itemsize
    held = min(-(-max(widths) // vec) * vec, held_most(itemsize))
    remainder = sum(max(w - held, 0) for w in widths)
    # the bf16 route's K8 holds dy in the shared memory x leaves
    held_dy = min(held, held_most(itemsize) - held) if itemsize == 2 else 0
    return {'cluster': cluster, 'resident': held,
            'smem': _SCRATCH + itemsize * (held + held_dy),
            'threads': _THREADS,
            'tasks': channels // num_groups * segs, 'remainder': remainder,
            'blocks': batch * num_groups * cluster, 'dy_resident': held_dy,
            'route': ('partial' if remainder else
                      'cluster' if cluster > 1 else 'block')}


def gn_plan(batch, channels, n, num_groups, most=_MOST_CLUSTER, itemsize=4):
    """K7's and K8's cluster plan at ``(B, C, N)`` in G groups, as
    ``gn_plan`` of csrc/groupnorm.cu gives it, for x of ``itemsize`` bytes
    an element (4, or 2 on the bf16 route): the smallest cluster (1, 2, 4,
    ... ``most`` blocks) whose blocks' shared memory holds each block's
    share of the group's slab of x, else ``most`` with the rest of each
    share (``remainder`` elements a group) read from device memory in both
    passes; elements a block holds (``resident``: the widest share in
    whole 16-byte vectors), shared memory a block (K8's), threads, tasks a
    group, blocks (a cluster a group), the elements of dy a block holds
    (``dy_resident``: on the bf16 route K8 holds its share of dy in the
    shared memory x leaves, ``csrc/groupnorm_bf16.cu`` ``plan16``; 0 on
    the float32 route) and the ``route``: one ``block``, a ``cluster`` that
    holds the slab, or ``partial``. K7 holds x alone (``smem`` less
    ``itemsize * dy_resident``). The bf16 route off the 16-byte grid takes
    the same cluster with its own held elements."""
    cluster = 1
    while cluster < most and _plan_at(batch, channels, n, num_groups,
                                      cluster, itemsize)['remainder']:
        cluster *= 2
    return _plan_at(batch, channels, n, num_groups, cluster, itemsize)


def library_plan(entry, key, mirror, keys, what, names=None, itemsize=4):
    """The plan that the library's ``entry`` gives at ``key`` (its values
    ``keys``; ``names`` turns a key's code into the mirror's name) for
    ``itemsize`` bytes an element (2: the bf16 route), with the mirror's
    other keys, and ``clusters``: how many clusters of its size the card
    holds at once of the forward's and the backward's kernels alike. Raises
    where it is not the wrapper's ``mirror(*key, most, itemsize)``. Where
    the card cannot place a cluster of the plan's size, the plan at half
    that size, and so on."""
    lib = build.load_library()
    most = _MOST_CLUSTER
    while True:
        info = (ctypes.c_longlong * len(keys))()
        build.check(lib, getattr(lib, entry)(*key, most,
                                             int(itemsize == 2), info),
                    f'{entry}{key}')
        want = mirror(*key, most, itemsize)
        out = {**want, **dict(zip(keys, info))}
        for k, table in (names or {}).items():
            out[k] = table[out[k]]
        if {k: v for k, v in out.items() if k != 'clusters'} != want:
            raise RuntimeError(f'{what}: the library\'s plan at {key} is '
                               f'{out}, the wrapper\'s {want}')
        if out['clusters'] or out['cluster'] == 1:
            break
        most = out['cluster'] // 2
    if not out['clusters']:
        raise RuntimeError(f'{what}: the card places no block of '
                           f'{out["smem"]} bytes of shared memory')
    return out


#: the library's plan at each (B, C, N, G) checked so far
_plans = {}

_PLAN_KEYS = ('cluster', 'resident', 'smem', 'threads', 'tasks', 'remainder',
              'blocks', 'clusters', 'dy_resident')


def plan_info(batch, channels, n, num_groups, itemsize=4):
    """The library's plan (``gn_plan``, with ``clusters``: how many
    clusters of its size the card holds at once, of K7's and K8's kernels
    alike) for x of ``itemsize`` bytes an element; raises where it is not
    the wrapper's mirror :func:`gn_plan` (:func:`library_plan`)."""
    key = (batch, channels, n, num_groups, itemsize)
    if key not in _plans:
        _plans[key] = library_plan('gn_plan', key[:4], gn_plan, _PLAN_KEYS,
                                   'group_norm', itemsize=itemsize)
    return _plans[key]


def _launch_plan(batch, channels, n, num_groups, itemsize):
    """``(cluster, clusters)``: the plan's blocks a cluster, and the
    clusters to launch: as many as the card holds at once, at most one a
    group (each walks the groups that many apart)."""
    plan = plan_info(batch, channels, n, num_groups, itemsize)
    return plan['cluster'], min(batch * num_groups, plan['clusters'])


def affine32(t):
    """A ``(C,)`` affine term as the kernels take it: float32, contiguous
    (a bfloat16 one widened exactly)."""
    return t.float().contiguous()


#: gn_bwd_workspace's bytes at each (B, C, N, G) so far
_workspaces = {}


def _launch_fwd(x, scale, bias, num_groups, eps, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, num_groups, act)
    device = x.device
    scale, bias = affine32(scale), affine32(bias)
    with torch.cuda.device(device):
        cluster, clusters = _launch_plan(batch, channels, n, num_groups,
                                         x.element_size())
        y = torch.empty_like(x)
        stats = torch.empty(2, batch, num_groups, dtype=torch.float32,
                            device=device)
        build.check(lib, lib.gn_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), batch, channels, n,
            num_groups, eps, ACTS[act], cluster, clusters,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream), 'gn_fwd')
    return y, stats[0], stats[1]


def _launch_bwd(x, dy, scale, bias, mean, rstd, num_groups, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, num_groups, act)
    device = x.device
    _tensor(dy, 'dy', device, tuple(x.shape), (x.dtype,))
    scale, bias = affine32(scale), affine32(bias)
    _tensor(mean, 'mean', device, (batch, num_groups))
    _tensor(rstd, 'rstd', device, (batch, num_groups))
    key = (batch, channels, n, num_groups)
    if key not in _workspaces:
        _workspaces[key] = lib.gn_bwd_workspace(*key)
    with torch.cuda.device(device):
        cluster, clusters = _launch_plan(batch, channels, n, num_groups,
                                         x.element_size())
        dx = torch.empty_like(x)
        grads = torch.empty(2, channels, dtype=torch.float32, device=device)
        work = torch.empty(_workspaces[key], dtype=torch.uint8,
                           device=device)
        build.check(lib, lib.gn_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            grads[0].data_ptr(), grads[1].data_ptr(), work.data_ptr(), batch,
            channels, n, num_groups, ACTS[act], cluster, clusters,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream), 'gn_bwd')
    return dx, grads[0], grads[1]
