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
dbias; otherwise (serving) it is the forward alone. A tensor on the CPU
takes the plain versions; a CUDA tensor launches the kernels
(``csrc/groupnorm.cu``: K7, the forward, replaces ``_fwd_kernel``; K8, the
backward, ``_bwd_kernel``) or raises. There is no channel-count gate: the
Pallas path's ``C % 128`` is the TPU's lane rule, and the kernels take any
C that the group count divides.

The plain versions: :func:`group_norm_act_reference`, the twin of
``_make_gn_silu`` without the external affine (f32 statistics, then the
affine, then the activation), and :func:`group_norm_act_bwd_plain`, its
memory-lean backward, which recomputes the normalised tensor and the
activation's derivative from x. The external per-(batch, channel) affine of
the ADM blocks (``ext_scale``/``ext_shift``) is not ported: it raises on
every device.
"""

import contextlib

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


def group_norm_act_reference(x, scale, bias, num_groups, eps, act):
    """Plain forward: ``(y, mean, rstd)``, the statistics ``(B, G)``."""
    xg = x.reshape(x.shape[0], num_groups, -1)
    mean = xg.mean(dim=-1)
    var = (xg * xg).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    _, z = _normalized(x, scale, bias, mean, rstd)
    return _act(z, act), mean, rstd


def group_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd, num_groups,
                             act):
    """Plain backward from x and the statistics: ``(dx, dscale, dbias)``."""
    xhat, z = _normalized(x, scale, bias, mean, rstd)
    dz = _act_grad(z, dy, act)
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
    """``(y, mean, rstd)``: the plain version on the CPU, else K7.
    ``group_norm_act_fwd.launches`` counts every K7 launch, the recomputes
    of rematerialised blocks included; ``.recompute_launches`` counts those
    alone."""
    if x.device.type == 'cpu':
        return group_norm_act_reference(x, scale, bias, num_groups, eps, act)
    out = _launch_fwd(x, scale, bias, num_groups, eps, act)
    group_norm_act_fwd.launches += 1
    if _recomputing:
        group_norm_act_fwd.recompute_launches += 1
    return out


group_norm_act_fwd.launches = 0
group_norm_act_fwd.recompute_launches = 0


def group_norm_act_bwd(x, dy, scale, bias, mean, rstd, num_groups, act):
    """The VJP ``(dx, dscale, dbias)``: the plain version on the CPU, else
    K8 (counted in ``group_norm_act_bwd.launches``)."""
    if x.device.type == 'cpu':
        return group_norm_act_bwd_plain(x, dy, scale, bias, mean, rstd,
                                        num_groups, act)
    out = _launch_bwd(x, dy, scale, bias, mean, rstd, num_groups, act)
    group_norm_act_bwd.launches += 1
    return out


group_norm_act_bwd.launches = 0


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
        return dx, dscale, dbias, None, None, None, None


def _group_norm(x, scale, bias, num_groups, eps, apply_silu, ext_scale,
                ext_shift, plain):
    if ext_scale is not None or ext_shift is not None:
        raise NotImplementedError(
            'group_norm_silu with ext_scale/ext_shift (the ADM blocks of '
            'idmse and idmselarge) is not ported yet (ROADMAP.md, Queue 1 '
            'item 9)')
    if x.ndim < 2 or x.shape[1] % num_groups:
        raise ValueError(f'group_norm_silu: channels of {tuple(x.shape)} '
                         f'not divisible by {num_groups} groups')
    if not x.is_contiguous():
        raise ValueError(f'group_norm_silu: x {tuple(x.shape)} must be '
                         'contiguous channels first (B, C, *spatial), got '
                         f'strides {x.stride()}')
    act = 'silu' if apply_silu else 'none'
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
    SiLU if ``apply_silu``; differentiable through
    :class:`GroupNormActFunction` when grad mode is on and an input
    requires grad. A tensor on the CPU takes the plain versions; a CUDA
    tensor launches K7 (and K8 in the backward) or raises."""
    return _group_norm(x, scale, bias, num_groups, eps, apply_silu,
                       ext_scale, ext_shift, False)


def group_norm_silu_plain(x, scale, bias, num_groups, eps=1e-6,
                          apply_silu=True, ext_scale=None, ext_shift=None):
    """:func:`group_norm_silu` through the plain versions on any device."""
    return _group_norm(x, scale, bias, num_groups, eps, apply_silu,
                       ext_scale, ext_shift, True)


# ---------------------------------------------------------------------------
# the kernels

def _tensor(t, name, device, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'group_norm: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'group_norm: {name} is on {t.device}, x on '
                         f'{device}')
    if t.dtype != torch.float32:
        raise TypeError(f'group_norm: {name} must be float32, got {t.dtype}')
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'group_norm: {name} must be a contiguous {shape} '
                         f'tensor (channels first), got {tuple(t.shape)} '
                         f'with strides {t.stride()}')
    return t


def _check(x, scale, bias, num_groups, act):
    """Check what the kernels take; returns ``(B, C, N)``."""
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'group_norm: no kernel for device {device}')
    if x.ndim < 2 or 0 in x.shape:
        raise ValueError('group_norm: x must be a non-empty (B, C, ...) '
                         f'tensor, got {tuple(x.shape)}')
    _tensor(x, 'x', device, tuple(x.shape))
    batch, channels = x.shape[:2]
    n = x.numel() // (batch * channels)
    _tensor(scale, 'scale', device, (channels,))
    _tensor(bias, 'bias', device, (channels,))
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


def _launch_fwd(x, scale, bias, num_groups, eps, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, num_groups, act)
    device = x.device
    with torch.cuda.device(device):
        y = torch.empty_like(x)
        mean = torch.empty(batch, num_groups, dtype=torch.float32,
                           device=device)
        rstd = torch.empty_like(mean)
        work = torch.empty(lib.gn_workspace(batch, channels, n, num_groups),
                           dtype=torch.uint8, device=device)
        build.check(lib, lib.gn_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), work.data_ptr(), batch,
            channels, n, num_groups, eps, ACTS[act],
            torch.cuda.current_stream(device).cuda_stream), 'gn_fwd')
    return y, mean, rstd


def _launch_bwd(x, dy, scale, bias, mean, rstd, num_groups, act):
    lib = build.load_library()
    batch, channels, n = _check(x, scale, bias, num_groups, act)
    device = x.device
    _tensor(dy, 'dy', device, tuple(x.shape))
    _tensor(mean, 'mean', device, (batch, num_groups))
    _tensor(rstd, 'rstd', device, (batch, num_groups))
    with torch.cuda.device(device):
        dx = torch.empty_like(x)
        dscale = torch.empty(channels, dtype=torch.float32, device=device)
        dbias = torch.empty_like(dscale)
        work = torch.empty(lib.gn_workspace(batch, channels, n, num_groups),
                           dtype=torch.uint8, device=device)
        build.check(lib, lib.gn_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), work.data_ptr(), batch,
            channels, n, num_groups, ACTS[act],
            torch.cuda.current_stream(device).cuda_stream), 'gn_bwd')
    return dx, dscale, dbias
