"""Conv-TasNet TCN block, forward and backward: the plain versions and
the CUDA kernels.

Counterpart of ``brever_tpu/ops/pallas/tcn_block.py``:
:func:`tcn_block_plain` mirrors ``tcn_block_reference``, the forward
kernel (``csrc/tcn_block.cu``) replaces the Pallas ``_fwd_kernel`` and the
backward kernel (``csrc/tcn_block_bwd.cu``) replaces ``_bwd_kernel`` and
``_bwd_kernel_rc``. Parameters are those of the JAX package's block,
with the 2-D weights in torch ``Linear`` layout, ``(out, in)``::

    (w_in (H, C), b_in (H,), a1 (1,), g1 (H,), be1 (H,),
     w_dw (3, H), b_dw (H,), a2 (1,), g2 (H,), be2 (H,),
     w_res (C, H), b_res (C,), w_skip (Cs, H), b_skip (Cs,))

with ``w_res``/``b_res`` unused (may be None) on the last block.

:func:`tcn_block` is what the model calls. Under grad mode with an input
that requires grad it goes through :class:`TCNBlockFunction`, as the JAX
package differentiates the fused call through ``jax.custom_vjp``: the
forward saves x, the parameters and the per-row gLN statistics ``(B, 4)``
= (mean1, rstd1, mean2, rstd2), and the backward is
:func:`tcn_block_bwd`. Otherwise (serving, ``torch.inference_mode``) it
is the forward alone. A tensor on the CPU takes the plain versions; a
CUDA tensor launches the kernels or raises.

On the H100 the forward is three hand-written launches and two per-row
merges, split at the two global-norm barriers because a (T, H) row of
intermediates no longer fits on chip as it does in the TPU's VMEM. It
is bound by bytes: h1 and h2 make one round trip through device memory
each (about 16 MB a batch row of 4 s at H=512 in f32), against
2*T*H*(2C + Cs) flops a row. The design keeps z1, z2, y1 and y2 out of
device memory by normalizing on load and fusing the biases, activations
and residual into the epilogues, and it carries only three floats per
tile across each barrier (merged once per row in a fixed order, so the
result is deterministic). The backward (its source says how) is bound
by GEMM work and splits at its own two barriers the same way.
"""

import ctypes

import torch
from torch.nn.functional import linear

from . import build
from .functional import depthwise_conv1d, gln_stats, prelu

_EPS = 1e-8


def tcn_block_fwd_plain(x, params, dilation, last):
    """Plain twin of the forward kernel with its statistics: ``(res or
    None, skip, stats (B, 4))``."""
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = params
    h1 = prelu(linear(x, w_in, b_in), a1)
    mean1, rstd1 = gln_stats(h1, _EPS)
    y1 = ((h1 - mean1) * rstd1 * g1 + be1).to(x.dtype)
    pad = (w_dw.shape[0] - 1) * dilation
    h2 = prelu(depthwise_conv1d(y1, w_dw, b_dw, dilation,
                                (pad // 2, pad - pad // 2)), a2)
    mean2, rstd2 = gln_stats(h2, _EPS)
    y2 = ((h2 - mean2) * rstd2 * g2 + be2).to(x.dtype)
    skip = linear(y2, w_skip, b_skip)
    stats = torch.cat([mean1, rstd1, mean2, rstd2], dim=1)[:, :, 0] \
        .float()
    res = None if last else x + linear(y2, w_res, b_res)
    return res, skip, stats


def tcn_block_plain(x, params, dilation, last):
    """Plain PyTorch twin of the forward kernel; x is channels-last
    (B, T, C)."""
    return tcn_block_fwd_plain(x, params, dilation, last)[:2]


def tcn_block_bwd_plain(x, params, g_res, g_skip, dilation, last):
    """Plain twin of the backward kernel: ``(dx, dparams)``, the VJP of
    :func:`tcn_block_plain` by autograd (``dparams`` None for the unused
    ``w_res``/``b_res`` of the last block)."""
    used = [p is not None and not (last and i in (10, 11))
            for i, p in enumerate(params)]
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        live = [p.detach().requires_grad_() if u else None
                for p, u in zip(params, used)]
        res, skip = tcn_block_plain(x, live, dilation, last)
        outs, grads = [skip], [g_skip]
        if not last:
            outs.append(res)
            grads.append(g_res)
        got = torch.autograd.grad(
            outs, [x] + [p for p in live if p is not None], grads)
    it = iter(got[1:])
    return got[0], tuple(next(it) if u else None for u in used)


def _on_kernel_device(x):
    """Whether x's device takes the CUDA kernels (anything but the CPU,
    which takes the plain versions; a device without kernels raises in
    the launch)."""
    return x.device.type != 'cpu'


def tcn_block_fwd(x, params, dilation, last):
    """The block forward with the statistics the backward needs:
    ``(res or None, skip, stats (B, 4))``, from the plain version on the
    CPU, else from the kernel (counted in ``tcn_block.launches``)."""
    if not _on_kernel_device(x):
        return tcn_block_fwd_plain(x, params, dilation, last)
    out, _ = _launch(x, params, dilation, last)
    tcn_block.launches += 1
    return out


class TCNBlockFunction(torch.autograd.Function):
    """The block with its hand-written VJP. ``apply(x, dilation, last,
    *params)`` returns ``skip`` on the last block, else ``(res, skip)``.
    """

    @staticmethod
    def forward(ctx, x, dilation, last, *params):
        res, skip, stats = tcn_block_fwd(x, params, dilation, last)
        ctx.dilation, ctx.last = dilation, last
        ctx.save_for_backward(x, stats, *params)
        return skip if last else (res, skip)

    @staticmethod
    def backward(ctx, *grads):
        x, stats, *params = ctx.saved_tensors
        g_res, g_skip = (None, grads[0]) if ctx.last \
            else (grads[0].contiguous(), grads[1])
        dx, dparams = tcn_block_bwd(x, tuple(params), stats, g_res,
                                    g_skip.contiguous(), ctx.dilation,
                                    ctx.last)
        return (dx, None, None, *dparams)


def tcn_block(x, params, dilation, last):
    """One TCN block: ``(res, skip)``, ``res`` None when last.

    Differentiable through :class:`TCNBlockFunction` when grad mode is on
    and x or a parameter requires grad; otherwise the forward alone. A
    tensor on the CPU takes :func:`tcn_block_plain`; a CUDA tensor
    launches the kernel or raises. ``tcn_block.launches`` counts the
    forward kernel's block calls."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *params)):
        out = TCNBlockFunction.apply(x, dilation, last, *params)
        return (None, out) if last else out
    return tcn_block_fwd(x, params, dilation, last)[:2]


tcn_block.launches = 0


def tcn_block_bwd(x, params, stats, g_res, g_skip, dilation, last):
    """The block's VJP: ``(dx, dparams)`` from x, the forward's ``stats``
    and the cotangents (``g_res`` None on the last block, whose
    ``dparams`` then hold None for ``w_res``/``b_res``).

    A tensor on the CPU takes :func:`tcn_block_bwd_plain` (which
    recomputes the statistics); a CUDA tensor launches the kernel or
    raises. ``tcn_block_bwd.launches`` counts its calls."""
    if not _on_kernel_device(x):
        return tcn_block_bwd_plain(x, params, g_res, g_skip, dilation, last)
    out = _launch_bwd(x, params, stats, g_res, g_skip, dilation, last)
    tcn_block_bwd.launches += 1
    return out


tcn_block_bwd.launches = 0


def _vector(t, n, name, device):
    _check_tensor(t, name, device)
    if t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f'tcn_block: {name} must be a contiguous ({n},) '
                         f'tensor, got {tuple(t.shape)}')
    return t.data_ptr()


def _matrix(t, n, k, name, device):
    """Pointer of a contiguous (out, in) = (n, k) Linear weight."""
    _check_tensor(t, name, device)
    if t.shape != (n, k) or not t.is_contiguous():
        raise ValueError(f'tcn_block: {name} must be a contiguous ({n}, '
                         f'{k}) tensor, got {tuple(t.shape)} with strides '
                         f'{t.stride()}')
    if t.numel() >= 2 ** 31:   # the kernel indexes weights with int
        raise ValueError(f'tcn_block: {name} has {t.numel()} elements')
    return t.data_ptr()


def _check_tensor(t, name, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'tcn_block: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'tcn_block: {name} is on {t.device}, x on '
                         f'{device}')
    if t.dtype != torch.float32:
        raise TypeError(f'tcn_block: {name} must be float32, got {t.dtype}')


def _block_pointers(x, params, dilation, last):
    """Check what the kernels take and return ``(dims, pointers)``: dims
    (B, T, C, H, Cs) and the parameters' data pointers by name (None
    for ``w_res``/``b_res`` on the last block)."""
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = params
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'tcn_block: no kernel for device {device}')
    _check_tensor(x, 'x', device)
    if x.ndim != 3 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError('tcn_block: x must be a contiguous non-empty '
                         f'(B, T, C) tensor, got {tuple(x.shape)}')
    if w_dw.shape[0] != 3:
        raise NotImplementedError(
            f'tcn_block: the CUDA kernel takes kernel_size 3, got '
            f'{w_dw.shape[0]}')
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f'tcn_block: bad dilation {dilation!r}')
    batch, t_total, c_in = x.shape
    hidden = w_in.shape[0]
    c_skip = w_skip.shape[0]
    _check_tensor(w_dw, 'w_dw', device)
    if w_dw.shape != (3, hidden) or not w_dw.is_contiguous():
        raise ValueError(f'tcn_block: w_dw must be a contiguous (3, '
                         f'{hidden}) tensor, got {tuple(w_dw.shape)}')
    ptr = {
        'w_in': _matrix(w_in, hidden, c_in, 'w_in', device),
        'b_in': _vector(b_in, hidden, 'b_in', device),
        'a1': _vector(a1, 1, 'a1', device),
        'g1': _vector(g1, hidden, 'g1', device),
        'be1': _vector(be1, hidden, 'be1', device),
        'w_dw': w_dw.data_ptr(),
        'b_dw': _vector(b_dw, hidden, 'b_dw', device),
        'a2': _vector(a2, 1, 'a2', device),
        'g2': _vector(g2, hidden, 'g2', device),
        'be2': _vector(be2, hidden, 'be2', device),
        'w_skip': _matrix(w_skip, c_skip, hidden, 'w_skip', device),
        'b_skip': _vector(b_skip, c_skip, 'b_skip', device),
        'w_res': None if last else _matrix(w_res, c_in, hidden, 'w_res',
                                           device),
        'b_res': None if last else _vector(b_res, c_in, 'b_res', device),
    }
    return (batch, t_total, c_in, hidden, c_skip), ptr


def _launch(x, params, dilation, last):
    """The forward kernel: ``(res or None, skip, stats (B, 4))`` and the
    activations ``(h1, h2)`` it kept in device memory between its
    launches."""
    (batch, t_total, c_in, hidden, c_skip), p = _block_pointers(
        x, params, dilation, last)
    device = x.device
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        f32 = dict(dtype=torch.float32, device=device)
        h1 = torch.empty(batch, t_total, hidden, **f32)
        h2 = torch.empty(batch, t_total, hidden, **f32)
        n_part1 = lib.tcn_in_partials(t_total, hidden)
        n_part2 = lib.tcn_dw_partials(t_total, hidden)
        part1 = torch.empty(batch, n_part1, 3, **f32)
        part2 = torch.empty(batch, n_part2, 3, **f32)
        stats = torch.empty(batch, 4, **f32)
        skip = torch.empty(batch, t_total, c_skip, **f32)
        res = None if last else torch.empty(batch, t_total, c_in, **f32)
        build.check(lib, lib.tcn_in_gemm_prelu_stats(
            x.data_ptr(), p['w_in'], p['b_in'], p['a1'], h1.data_ptr(),
            part1.data_ptr(), batch, t_total, c_in, hidden, stream),
            'tcn_in_gemm_prelu_stats')
        build.check(lib, lib.tcn_row_stats(
            part1.data_ptr(), n_part1, stats.data_ptr(), 0, batch, _EPS,
            stream), 'tcn_row_stats')
        build.check(lib, lib.tcn_dw_prelu_stats(
            h1.data_ptr(), stats.data_ptr(), p['g1'], p['be1'], p['w_dw'],
            p['b_dw'], p['a2'], h2.data_ptr(), part2.data_ptr(), batch,
            t_total, hidden, dilation, stream), 'tcn_dw_prelu_stats')
        build.check(lib, lib.tcn_row_stats(
            part2.data_ptr(), n_part2, stats.data_ptr(), 1, batch, _EPS,
            stream), 'tcn_row_stats')
        build.check(lib, lib.tcn_out_gemm(
            h2.data_ptr(), stats.data_ptr(), p['g2'], p['be2'], p['w_res'],
            p['b_res'], p['w_skip'], p['b_skip'], x.data_ptr(),
            None if last else res.data_ptr(), skip.data_ptr(), batch,
            t_total, hidden, c_in, c_skip, int(last), stream),
            'tcn_out_gemm')
    return (res, skip, stats), (h1, h2)


def _launch_bwd(x, params, stats, g_res, g_skip, dilation, last):
    """The backward kernel: ``(dx, dparams)``."""
    (batch, t_total, c_in, hidden, c_skip), p = _block_pointers(
        x, params, dilation, last)
    device = x.device

    def dense(t, shape, name):
        _check_tensor(t, name, device)
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f'tcn_block_bwd: {name} must be a contiguous '
                             f'{shape} tensor, got {tuple(t.shape)}')
        return t.data_ptr()

    args = build.TcnBwdArgs(
        x=x.data_ptr(),
        g_res=None if last else dense(g_res, (batch, t_total, c_in),
                                      'g_res'),
        g_skip=dense(g_skip, (batch, t_total, c_skip), 'g_skip'),
        stats=dense(stats, (batch, 4), 'stats'),
        B=batch, T=t_total, C=c_in, H=hidden, Cs=c_skip, last=int(last),
        dilation=dilation,
        **{k: v for k, v in p.items() if k not in ('b_res', 'b_skip')})
    n_out = (0 if last else c_in) + c_skip
    lib = build.load_library()
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        dx = torch.empty(batch, t_total, c_in, **f32)
        dw_in = torch.empty(hidden, c_in, **f32)
        db_in = torch.empty(hidden, **f32)
        da = torch.empty(2, **f32)
        dgb1 = torch.empty(2, hidden, **f32)
        dwb_dw = torch.empty(4, hidden, **f32)
        dgb2 = torch.empty(2, hidden, **f32)
        dw_out = torch.empty(n_out, hidden, **f32)
        db_out = torch.empty(n_out, **f32)
        work = torch.empty(lib.tcn_bwd_workspace(
            batch, t_total, c_in, hidden, c_skip, int(last)), **f32)
        for name, t in (('dx', dx), ('dw_in', dw_in), ('db_in', db_in),
                        ('da', da), ('dgb1', dgb1), ('dwb_dw', dwb_dw),
                        ('dgb2', dgb2), ('dw_out', dw_out),
                        ('db_out', db_out), ('work', work)):
            setattr(args, name, t.data_ptr())
        build.check(lib, lib.tcn_block_bwd(
            ctypes.byref(args),
            torch.cuda.current_stream(device).cuda_stream), 'tcn_block_bwd')
    n_res = n_out - c_skip
    dparams = (dw_in, db_in, da[:1], dgb1[0], dgb1[1], dwb_dw[:3],
               dwb_dw[3], da[1:], dgb2[0], dgb2[1],
               None if last else dw_out[:n_res],
               None if last else db_out[:n_res],
               dw_out[n_res:], db_out[n_res:])
    return dx, dparams
