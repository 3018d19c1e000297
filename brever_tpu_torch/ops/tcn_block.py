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
intermediates no longer fits on chip as it does in the TPU's VMEM. Its
two products (x W_in^T, and y2 [W_res; W_skip]^T) run on the 128 x 128
SIMT tiles of the backward's GEMMs, and the first is the very product
the backward recomputes, so the backward's z1 is the forward's bit for
bit. The design keeps z1, z2, y1 and y2 out of device memory by
normalizing on load and fusing the biases, activations and residual into
the epilogues, and it carries only three floats per tile across each
barrier (merged once per row in a fixed order, so the result is
deterministic; the tiles a row: :func:`fwd_partials`). The backward (its
source says how) is bound by GEMM work and splits at its own two
barriers the same way: eleven launches, five of them GEMMs on 128 x 128
tiles (the plan: :func:`bwd_plan`, checked against the library's by
:func:`plan_info` before a shape's first launch). Both move float4s where
C, H and Cs are multiples of 4, and single floats through the same
kernels at any other width.

Both kernels have a bf16 route, the one the JAX package's TPU path takes
(it engages the fused kernel only in bf16, under amp): x, the parameters,
the cotangents and every output but the float32 statistics in bfloat16,
every sum in float32 at the Pallas kernel's rounding points (its forward
and backward kernels': bf16 matmul operands, float32 intermediates and
statistics, the gLN2 affine folded into bf16 output weights, bf16 h2 in
the output products, gz1 rounded before dW_in and dx, parameter
gradients summed in float32 and rounded at the end). On the card its
products run on the bf16 tensor cores (``csrc/tcn_block_bf16.cu``:
``mma.sync`` with float32 accumulators; K1-bf16's depthwise stage too),
the statistics and K2's elementwise stages are the float32 route's
kernels on bf16 parameters, and h2 and gz1 cross device memory as bf16
rows of :func:`bf16_ld` elements. Its plain
twins, :func:`_fwd_plain_bf16` and :func:`_bwd_plain_bf16`, compute the
same in float32 on the bf16 values on any device; a bfloat16 tensor on
CUDA launches the bf16 kernels (never the float32 ones), and x, the
parameters and the cotangents must share one dtype.
"""

import ctypes

import torch
from torch.nn.functional import linear

from . import build
from .functional import depthwise_conv1d, gln_stats, prelu

_EPS = 1e-8
#: K2's plan (csrc/tcn_block_bwd.cu): the GEMMs' block tile and k slice,
#: the elementwise stages' tile, the H100 SXM's SMs, and the weight GEMMs'
#: least chunk of time steps
_GEMM_TILE, _GEMM_SLICE, _EW_ROWS, _EW_COLS = 128, 16, 64, 128
_SMS, _WG_MIN_CHUNK = 132, 256
#: K1's depthwise tile (``kDwRows``, ``kDwCols`` of csrc/tcn_common.cuh)
_DW_ROWS, _DW_COLS = 32, 128
#: the bf16 route's rows of h2, gz1 and the folded output weights: H
#: rounded up to a multiple of this (``kLdBf16`` of csrc/tcn_block_bf16.cu)
_LD_BF16 = 8


def _cdiv(a, b):
    return -(-a // b)


def _split(batch, t_total, tiles):
    """``(chunks, steps a chunk)`` of a K2 weight GEMM over each batch row's
    T steps: the most chunks whose blocks (``tiles`` output tiles over the
    batch and the chunks) fill no more than two waves of 2 blocks on each
    of the 132 SMs, and no more than T has pieces of 256 steps; a chunk is
    a multiple of the k slice. The partials are summed in (row, chunk)
    order."""
    chunks = max(1, min(4 * _SMS // (tiles * batch),
                        _cdiv(t_total, _WG_MIN_CHUNK)))
    chunk = _cdiv(_cdiv(t_total, chunks), _GEMM_SLICE) * _GEMM_SLICE
    return _cdiv(t_total, chunk), chunk


def bf16_ld(hidden):
    """The bf16 route's row of h2, gz1 and the folded output weights at
    hidden width H (elements), as ``tcn_bf16_ld`` gives it: H rounded up to
    a multiple of 8, so that each row is whole 16-byte pieces."""
    return _cdiv(hidden, _LD_BF16) * _LD_BF16


def bwd_plan(batch, t_total, c_in, hidden, c_skip, last):
    """K2's plan at ``(B, T, C, H, Cs, last)``, as ``tcn_bwd_plan`` and
    ``tcn_bwd_workspace`` of csrc/tcn_block_bwd.cu give it, on either route
    (the bf16 route's tensor-core GEMMs take the same 128 x 128 tiles and
    chunks): the GEMMs' row tiles a batch row (128 steps), the elementwise
    stages' tiles a batch row (64 steps) and column tiles (128 channels),
    the output weight GEMM's ([dW_res; dW_skip]) and the input weight GEMM's
    (dW_in) chunks and steps a chunk, and the workspace in floats (z1, z2,
    gy2 and gy1 of (B, T, H), gy2's and gy1's rooms also holding the bf16
    route's (B, T, :func:`bf16_ld`) gz1 and h2, and the partials, each
    buffer rounded up to 32 floats)."""
    n_res = 0 if last else c_in
    m_out = n_res + c_skip
    h_tiles = _cdiv(hidden, _GEMM_TILE)
    out = _split(batch, t_total,
                 (_cdiv(n_res, _GEMM_TILE) + _cdiv(c_skip, _GEMM_TILE))
                 * h_tiles)
    inp = _split(batch, t_total, h_tiles * _cdiv(c_in, _GEMM_TILE))
    gtiles, tiles = _cdiv(t_total, _GEMM_TILE), _cdiv(t_total, _EW_ROWS)
    ctiles = _cdiv(hidden, _EW_COLS)
    bt = batch * tiles
    bth = batch * t_total * hidden
    room = max(bth, _cdiv(batch * t_total * bf16_ld(hidden), 2))
    buffers = [bth, bth, room, room] + [
        batch * gtiles * 2 * hidden, 2 * batch, batch * 2 * hidden,
        bt * 4 * hidden, 2 * bt * ctiles, batch * out[0] * m_out * hidden,
        batch * out[0] * m_out, bt * 2 * hidden, 2 * batch,
        batch * 2 * hidden, bt * hidden, 2 * bt * ctiles,
        batch * inp[0] * hidden * c_in]
    return {'gemm_tiles': gtiles, 'tiles': tiles, 'ctiles': ctiles,
            'out_chunks': out[0], 'out_chunk': out[1],
            'in_chunks': inp[0], 'in_chunk': inp[1],
            'workspace': sum(_cdiv(n, 32) * 32 for n in buffers)}


def fwd_partials(t_total, hidden):
    """``(in, dw)``: the (count, mean, M2) partials a batch row that K1's
    input GEMM (one a 128 x 128 tile of (T, H)) and its depthwise stage
    (one a 32 x 128 tile) write on either route, as ``tcn_in_partials``
    and ``tcn_dw_partials`` of csrc/tcn_block.cu count them."""
    return (_cdiv(t_total, _GEMM_TILE) * _cdiv(hidden, _GEMM_TILE),
            _cdiv(t_total, _DW_ROWS) * _cdiv(hidden, _DW_COLS))


def tcn_block_fwd_plain(x, params, dilation, last):
    """Plain twin of the forward kernel with its statistics: ``(res or
    None, skip, stats (B, 4))``. A bfloat16 x (with bfloat16 parameters)
    takes :func:`_fwd_plain_bf16`, the kernels' bf16 route."""
    if x.dtype == torch.bfloat16:
        return _fwd_plain_bf16(x, params, dilation, last)
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


def _f32(tensors):
    return [None if t is None else t.float() for t in tensors]


def _bf16_round(t):
    """t rounded to bfloat16, kept as float32."""
    return t.to(torch.bfloat16).float()


def _trunk_bf16(xf, params, dilation):
    """The bf16 route's recompute in float32 arithmetic on bf16-rounded
    operands (float32 x and parameters): ``(z1, h1, y1, z2, h2, stats
    (mean1, rstd1, mean2, rstd2) each (B, 1, 1))``. The products of two
    bf16 values are exact in float32, so this is the Pallas kernel's
    float32-accumulated bf16 matmul up to the order of the sums."""
    w_in, b_in, a1, g1, be1, w_dw, b_dw, a2 = params[:8]
    z1 = linear(xf, w_in, b_in)
    h1 = prelu(z1, a1)
    mean1, rstd1 = gln_stats(h1, _EPS)
    y1 = (h1 - mean1) * rstd1 * g1 + be1
    pad = (w_dw.shape[0] - 1) * dilation
    z2 = depthwise_conv1d(y1, w_dw, b_dw, dilation,
                          (pad // 2, pad - pad // 2))
    h2 = prelu(z2, a2)
    mean2, rstd2 = gln_stats(h2, _EPS)
    return z1, h1, y1, z2, h2, (mean1, rstd1, mean2, rstd2)


def _fwd_plain_bf16(x, params, dilation, last):
    """The forward's bf16 route, at the Pallas kernel's rounding points
    (``brever_tpu/ops/pallas/tcn_block.py`` ``_fwd_kernel``), not at
    ``tcn_block_reference``'s: z1 from bf16 operands with a float32 sum;
    h1, the gLN statistics, the depthwise taps and h2 in float32; the
    gLN2 affine folded into the output weights in float32 (``w_f = W
    hs2``, ``hs2 = g2 rstd2``, and the bias ``cv2 W^T + b``, ``cv2 = be2 -
    mean2 hs2``), w_f and h2 rounded to bf16 for the output products, and
    res/skip stored in bf16. The PReLU slopes stay float32, as the kernel
    keeps ``alphas`` (they hold bf16 values). Any kernel size; the
    statistics are float32."""
    f = _f32(params)
    w_res, b_res, w_skip, b_skip = f[10:]
    xf = x.float()
    _, _, _, _, h2, (mean1, rstd1, mean2, rstd2) = _trunk_bf16(xf, f,
                                                               dilation)
    hs2 = f[8] * rstd2                        # (B, 1, H)
    cv2 = f[9] - mean2 * hs2
    h2c = _bf16_round(h2)

    def out(w, b):
        w_f = _bf16_round(w * hs2)            # (B, N, H)
        return torch.matmul(h2c, w_f.transpose(1, 2)) \
            + (torch.matmul(cv2, w.t()) + b)

    skip = out(w_skip, b_skip).to(torch.bfloat16)
    res = None if last else (xf + out(w_res, b_res)).to(torch.bfloat16)
    stats = torch.cat([mean1, rstd1, mean2, rstd2], dim=1)[:, :, 0]
    return res, skip, stats


def tcn_block_plain(x, params, dilation, last):
    """Plain PyTorch twin of the forward kernel; x is channels-last
    (B, T, C)."""
    return tcn_block_fwd_plain(x, params, dilation, last)[:2]


def tcn_block_bwd_plain(x, params, g_res, g_skip, dilation, last):
    """Plain twin of the backward kernel: ``(dx, dparams)``, the VJP of
    :func:`tcn_block_plain` by autograd (``dparams`` None for the unused
    ``w_res``/``b_res`` of the last block). A bfloat16 x takes
    :func:`_bwd_plain_bf16`, the kernels' bf16 route."""
    if x.dtype == torch.bfloat16:
        return _bwd_plain_bf16(x, params, g_res, g_skip, dilation, last)
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


def _bwd_plain_bf16(x, params, g_res, g_skip, dilation, last):
    """The backward's bf16 route, at the Pallas kernel's rounding points
    (``_bwd_kernel``): every pass in float32 from bf16 x, cotangents and
    parameters; h2 rounded to bf16 in the output weight products (``dW =
    hs2 (h2_bf16^T g) + cv2 (sum g)``), gz1 rounded to bf16 before dW_in =
    gz1^T x and dx = gz1 W_in, dx stored in bf16, and every parameter
    gradient summed in float32 and rounded to bf16 (the parameters'
    dtype) at the end. The gLN backward keeps K2's centred form ``gh = hs
    gy - A - B (h - mean)``; the PReLU slopes' gradients are summed in
    float64, as K2 sums them. Any kernel size, padded as the forward
    pads."""
    f = _f32(params)
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = f
    xf, gs = x.float(), g_skip.float()
    gr = None if last else g_res.float()
    z1, h1, y1, z2, h2, (mean1, rstd1, mean2, rstd2) = _trunk_bf16(
        xf, f, dilation)
    inv_n = 1.0 / (h1.shape[1] * h1.shape[2])

    def gln_bwd(gy, h, mean, rstd, gamma):
        """(gh, dgamma, dbeta) of a gLN with its float32 sums a row."""
        acc_gh, acc_g = (gy * h).sum(1), gy.sum(1)           # (B, H)
        dg_rows = rstd[:, 0] * (acc_gh - mean[:, 0] * acc_g)
        sa = (gamma * acc_g).sum(1)[:, None, None]
        sb = (gamma * dg_rows).sum(1)[:, None, None]
        gh = gamma * rstd * gy - rstd * inv_n * sa \
            - rstd * rstd * inv_n * sb * (h - mean)
        return gh, dg_rows.sum(0), acc_g.sum(0)

    def slope_grad(gh, z):
        return (gh.double() * z.clamp_max(0).double()).sum().float()

    gy2 = torch.matmul(gs, w_skip)
    if not last:
        gy2 = gy2 + torch.matmul(gr, w_res)
    hs2 = g2 * rstd2
    cv2 = be2 - mean2 * hs2
    h2c = _bf16_round(h2)

    def out_grads(g):
        m = torch.matmul(g.transpose(1, 2), h2c)           # (B, N, H)
        v = g.sum(1)                                       # (B, N)
        return (m * hs2 + v[:, :, None] * cv2).sum(0), v.sum(0)

    dw_skip, db_skip = out_grads(gs)
    dw_res, db_res = (None, None) if last else out_grads(gr)
    gh2, dg2, dbe2 = gln_bwd(gy2, h2, mean2, rstd2, g2)
    da2 = slope_grad(gh2, z2)
    gz2 = torch.where(z2 >= 0, gh2, a2 * gh2)
    k = w_dw.shape[0]
    lo = (k - 1) * dilation // 2
    hi = (k - 1) * dilation - lo
    t_total = x.shape[1]
    y1p = torch.nn.functional.pad(y1, (0, 0, lo, hi))
    gz2p = torch.nn.functional.pad(gz2, (0, 0, hi, lo))
    dw_dw = torch.stack([
        (gz2 * y1p[:, j * dilation:j * dilation + t_total]).sum((0, 1))
        for j in range(k)])
    gy1 = sum(w_dw[j] * gz2p[:, (k - 1 - j) * dilation:
                             (k - 1 - j) * dilation + t_total]
              for j in range(k))
    gh1, dg1, dbe1 = gln_bwd(gy1, h1, mean1, rstd1, g1)
    da1 = slope_grad(gh1, z1)
    gz1 = torch.where(z1 >= 0, gh1, a1 * gh1)
    gz1c = _bf16_round(gz1)
    dx = torch.matmul(gz1c, w_in)
    if not last:
        dx = dx + gr
    dw_in = torch.matmul(gz1c.reshape(-1, gz1.shape[2]).t(),
                         xf.reshape(-1, xf.shape[2]))
    grads = (dw_in, gz1.sum((0, 1)), da1.reshape(1), dg1, dbe1, dw_dw,
             gz2.sum((0, 1)), da2.reshape(1), dg2, dbe2, dw_res, db_res,
             dw_skip, db_skip)
    return dx.to(torch.bfloat16), tuple(
        None if g is None else g.to(torch.bfloat16) for g in grads)


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
    tcn_block.launches_bf16 += x.dtype == torch.bfloat16
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
    forward kernel's block calls, ``tcn_block.launches_bf16`` those of them
    on the bf16 route."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *params)):
        out = TCNBlockFunction.apply(x, dilation, last, *params)
        return (None, out) if last else out
    return tcn_block_fwd(x, params, dilation, last)[:2]


tcn_block.launches = tcn_block.launches_bf16 = 0


def tcn_block_bwd(x, params, stats, g_res, g_skip, dilation, last):
    """The block's VJP: ``(dx, dparams)`` from x, the forward's ``stats``
    and the cotangents (``g_res`` None on the last block, whose
    ``dparams`` then hold None for ``w_res``/``b_res``).

    A tensor on the CPU takes :func:`tcn_block_bwd_plain` (which
    recomputes the statistics); a CUDA tensor launches the kernel or
    raises. ``tcn_block_bwd.launches`` counts its calls,
    ``tcn_block_bwd.launches_bf16`` those on the bf16 route."""
    if not _on_kernel_device(x):
        return tcn_block_bwd_plain(x, params, g_res, g_skip, dilation, last)
    out = _launch_bwd(x, params, stats, g_res, g_skip, dilation, last)
    tcn_block_bwd.launches += 1
    tcn_block_bwd.launches_bf16 += x.dtype == torch.bfloat16
    return out


tcn_block_bwd.launches = tcn_block_bwd.launches_bf16 = 0


def _vector(t, n, name, device, dtype):
    _check_tensor(t, name, device, dtype)
    if t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f'tcn_block: {name} must be a contiguous ({n},) '
                         f'tensor, got {tuple(t.shape)}')
    return t.data_ptr()


def _matrix(t, n, k, name, device, dtype):
    """Pointer of a contiguous (out, in) = (n, k) Linear weight."""
    _check_tensor(t, name, device, dtype)
    if t.shape != (n, k) or not t.is_contiguous():
        raise ValueError(f'tcn_block: {name} must be a contiguous ({n}, '
                         f'{k}) tensor, got {tuple(t.shape)} with strides '
                         f'{t.stride()}')
    if t.numel() >= 2 ** 31:   # the kernel indexes weights with int
        raise ValueError(f'tcn_block: {name} has {t.numel()} elements')
    return t.data_ptr()


#: the kernels' routes: float32, and bfloat16 I/O (``bf16_io``)
_DTYPES = (torch.float32, torch.bfloat16)


def _check_tensor(t, name, device, dtype=torch.float32):
    """t is a tensor on device of dtype: x's on the kernels' route (float32
    or bfloat16, one dtype for x, the parameters and the cotangents; a mix
    raises), float32 for the statistics."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'tcn_block: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'tcn_block: {name} is on {t.device}, x on '
                         f'{device}')
    if t.dtype != dtype:
        raise TypeError(f'tcn_block: {name} must be {dtype}, got {t.dtype}')


def _block_pointers(x, params, dilation, last):
    """Check what the kernels take and return ``(dims, pointers)``: dims
    (B, T, C, H, Cs) and the parameters' data pointers by name (None
    for ``w_res``/``b_res`` on the last block)."""
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = params
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'tcn_block: no kernel for device {device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'tcn_block: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    dtype = x.dtype
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
    _check_tensor(w_dw, 'w_dw', device, dtype)
    if w_dw.shape != (3, hidden) or not w_dw.is_contiguous():
        raise ValueError(f'tcn_block: w_dw must be a contiguous (3, '
                         f'{hidden}) tensor, got {tuple(w_dw.shape)}')
    on = (device, dtype)
    ptr = {
        'w_in': _matrix(w_in, hidden, c_in, 'w_in', *on),
        'b_in': _vector(b_in, hidden, 'b_in', *on),
        'a1': _vector(a1, 1, 'a1', *on),
        'g1': _vector(g1, hidden, 'g1', *on),
        'be1': _vector(be1, hidden, 'be1', *on),
        'w_dw': w_dw.data_ptr(),
        'b_dw': _vector(b_dw, hidden, 'b_dw', *on),
        'a2': _vector(a2, 1, 'a2', *on),
        'g2': _vector(g2, hidden, 'g2', *on),
        'be2': _vector(be2, hidden, 'be2', *on),
        'w_skip': _matrix(w_skip, c_skip, hidden, 'w_skip', *on),
        'b_skip': _vector(b_skip, c_skip, 'b_skip', *on),
        'w_res': None if last else _matrix(w_res, c_in, hidden, 'w_res',
                                           *on),
        'b_res': None if last else _vector(b_res, c_in, 'b_res', *on),
    }
    return (batch, t_total, c_in, hidden, c_skip), ptr


#: K1's partial counts at each (T, H) checked so far
_partials = {}


def partials_info(t_total, hidden):
    """The library's K1 partial counts a batch row at ``(T, H)``; raises
    where they are not :func:`fwd_partials`, or where the library's bf16
    row at H is not :func:`bf16_ld`."""
    key = (t_total, hidden)
    if key not in _partials:
        lib = build.load_library()
        out = (lib.tcn_in_partials(t_total, hidden),
               lib.tcn_dw_partials(t_total, hidden))
        if out != fwd_partials(t_total, hidden):
            raise RuntimeError(
                f'tcn_block: the library\'s partials at T={t_total} '
                f'H={hidden} are {out}, the wrapper\'s '
                f'{fwd_partials(t_total, hidden)}')
        if lib.tcn_bf16_ld(hidden) != bf16_ld(hidden):
            raise RuntimeError(
                f'tcn_block: the library\'s bf16 row at H={hidden} is '
                f'{lib.tcn_bf16_ld(hidden)}, the wrapper\'s '
                f'{bf16_ld(hidden)}')
        _partials[key] = out
    return _partials[key]


def _launch(x, params, dilation, last):
    """The forward kernel: ``(res or None, skip, stats (B, 4))`` and the
    activations ``(h1, h2)`` it kept in device memory between its
    launches (h1 float32 on both routes; h2 float32, or on the bf16 route
    bf16 rows of :func:`bf16_ld`; res and skip in x's dtype)."""
    x, *params = (_aligned(t) for t in (x, *params))
    (batch, t_total, c_in, hidden, c_skip), p = _block_pointers(
        x, params, dilation, last)
    device = x.device
    lib = build.load_library()
    n_part1, n_part2 = partials_info(t_total, hidden)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        f32 = dict(dtype=torch.float32, device=device)
        io = dict(dtype=x.dtype, device=device)
        h1 = torch.empty(batch, t_total, hidden, **f32)
        part1 = torch.empty(batch, n_part1, 3, **f32)
        part2 = torch.empty(batch, n_part2, 3, **f32)
        stats = torch.empty(batch, 4, **f32)
        skip = torch.empty(batch, t_total, c_skip, **io)
        res = None if last else torch.empty(batch, t_total, c_in, **io)
        if x.dtype == torch.bfloat16:
            n_out = (0 if last else c_in) + c_skip
            ld = bf16_ld(hidden)
            h2 = torch.empty(batch, t_total, ld, **io)
            wf = torch.empty(batch, n_out, ld, **io)
            fb = torch.empty(batch, n_out, **f32)
            args = build.TcnFwdBf16Args(
                x=x.data_ptr(), h1=h1.data_ptr(), part1=part1.data_ptr(),
                part2=part2.data_ptr(), stats=stats.data_ptr(),
                fb=fb.data_ptr(), h2=h2.data_ptr(), wf=wf.data_ptr(),
                res=None if last else res.data_ptr(), skip=skip.data_ptr(),
                B=batch, T=t_total, C=c_in, H=hidden, Cs=c_skip,
                last=int(last), dilation=dilation, eps=_EPS, **p)
            build.check(lib, lib.tcn_block_fwd_bf16(ctypes.byref(args),
                                                    stream),
                        'tcn_block_fwd_bf16')
            return (res, skip, stats), (h1, h2)
        h2 = torch.empty(batch, t_total, hidden, **f32)
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


#: K2's plan at each (B, T, C, H, Cs, last) checked so far
_plans = {}


def plan_info(batch, t_total, c_in, hidden, c_skip, last):
    """The library's K2 plan at a shape, keyed as :func:`bwd_plan`'s;
    raises where it is not the wrapper's mirror."""
    key = (batch, t_total, c_in, hidden, c_skip, bool(last))
    if key not in _plans:
        lib = build.load_library()
        info = (ctypes.c_int * 7)()
        build.check(lib, lib.tcn_bwd_plan(*key[:5], int(last), info),
                    f'tcn_bwd_plan{key}')
        out = dict(zip(('gemm_tiles', 'tiles', 'ctiles', 'out_chunks',
                        'out_chunk', 'in_chunks', 'in_chunk'), info))
        out['workspace'] = lib.tcn_bwd_workspace(*key[:5], int(last))
        if out != bwd_plan(*key):
            raise RuntimeError(f'tcn_block_bwd: the library\'s plan at {key} '
                               f'is {out}, the wrapper\'s {bwd_plan(*key)}')
        _plans[key] = out
    return _plans[key]


def _aligned(t):
    """t, or a copy of it where its storage is not 16-byte aligned (K1 and
    K2 stage float4s, or groups of 4 bfloat16 in 8 bytes; a parameter may
    be a view at any float of the trainer's flat buffer). Anything but a
    tensor is returned for the checks to refuse."""
    return t if not isinstance(t, torch.Tensor) or t.data_ptr() % 16 == 0 \
        else t.clone()


def recompute_z1(x, params):
    """K2's first launch alone on a CUDA tensor: z1 = x W_in^T + b_in
    ``(B, T, H)``, the bits K2 recomputes (PReLU of it is the forward's
    h1, bitwise), float32 from a float32 or bfloat16 x and parameters. Not
    counted as a K2 launch."""
    w_in, b_in = params[0], params[1]
    device = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f'tcn_block: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    batch, t_total, c_in = x.shape
    hidden = w_in.shape[0]
    _matrix(w_in, hidden, c_in, 'w_in', device, x.dtype)
    _vector(b_in, hidden, 'b_in', device, x.dtype)
    lib = build.load_library()
    with torch.cuda.device(device):
        x, w_in, b_in = (_aligned(t) for t in (x.contiguous(), w_in, b_in))
        z1 = torch.empty(batch, t_total, hidden, dtype=torch.float32,
                         device=device)
        build.check(lib, lib.tcn_bwd_z1(
            x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(), z1.data_ptr(),
            batch, t_total, c_in, hidden, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream), 'tcn_bwd_z1')
    return z1


def _launch_bwd(x, params, stats, g_res, g_skip, dilation, last):
    """The backward kernel: ``(dx, dparams)``, in x's dtype (on the bf16
    route each parameter gradient is summed in float32 and rounded)."""
    x, g_res, g_skip, *params = (_aligned(t) for t in (x, g_res, g_skip,
                                                       *params))
    (batch, t_total, c_in, hidden, c_skip), p = _block_pointers(
        x, params, dilation, last)
    plan = plan_info(batch, t_total, c_in, hidden, c_skip, last)
    device = x.device

    def dense(t, shape, name, dtype=x.dtype):
        _check_tensor(t, name, device, dtype)
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f'tcn_block_bwd: {name} must be a contiguous '
                             f'{shape} tensor, got {tuple(t.shape)}')
        return t.data_ptr()

    args = build.TcnBwdArgs(
        x=x.data_ptr(),
        g_res=None if last else dense(g_res, (batch, t_total, c_in),
                                      'g_res'),
        g_skip=dense(g_skip, (batch, t_total, c_skip), 'g_skip'),
        stats=dense(stats, (batch, 4), 'stats', torch.float32),
        B=batch, T=t_total, C=c_in, H=hidden, Cs=c_skip, last=int(last),
        dilation=dilation, bf16_io=int(x.dtype == torch.bfloat16),
        **{k: v for k, v in p.items() if k not in ('b_res', 'b_skip')})
    n_out = (0 if last else c_in) + c_skip
    lib = build.load_library()
    with torch.cuda.device(device):
        io = dict(dtype=x.dtype, device=device)
        dx = torch.empty(batch, t_total, c_in, **io)
        dw_in = torch.empty(hidden, c_in, **io)
        db_in = torch.empty(hidden, **io)
        da = torch.empty(2, **io)
        dgb1 = torch.empty(2, hidden, **io)
        dwb_dw = torch.empty(4, hidden, **io)
        dgb2 = torch.empty(2, hidden, **io)
        dw_out = torch.empty(n_out, hidden, **io)
        db_out = torch.empty(n_out, **io)
        work = torch.empty(plan['workspace'], dtype=torch.float32,
                           device=device)
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
