"""Conv-TasNet TCN block forward: the plain version and the CUDA kernel.

Counterpart of ``brever_tpu/ops/pallas/tcn_block.py``:
:func:`tcn_block_plain` mirrors ``tcn_block_reference`` and
:func:`tcn_block` replaces the Pallas forward ``tcn_block_fused``
(``_fwd_kernel``). Parameters are those of the JAX package's block,
with the 2-D weights in torch ``Linear`` layout, ``(out, in)``::

    (w_in (H, C), b_in (H,), a1 (1,), g1 (H,), be1 (H,),
     w_dw (3, H), b_dw (H,), a2 (1,), g2 (H,), be2 (H,),
     w_res (C, H), b_res (C,), w_skip (Cs, H), b_skip (Cs,))

with ``w_res``/``b_res`` unused (may be None) on the last block.

On the H100 the block is three hand-written launches
(``csrc/tcn_block.cu``), split at the two global-norm barriers because a
(T, H) row of intermediates no longer fits on chip as it does in the
TPU's VMEM. It is bound by bytes: h1 and h2 make one round trip through
device memory each (about 16 MB a batch row of 4 s at H=512 in f32),
against 2*T*H*(2C + Cs) flops a row. The design keeps z1, z2, y1 and y2
out of device memory by normalizing on load and fusing the biases,
activations and residual into the epilogues, and it carries only three
floats per tile across each barrier (merged in a fixed order, so the
result is deterministic).
"""

import torch
from torch.nn.functional import linear

from . import build
from .functional import depthwise_conv1d, global_layer_norm, prelu

_EPS = 1e-8


def tcn_block_plain(x, params, dilation, last):
    """Plain PyTorch twin of the kernel; x is channels-last (B, T, C)."""
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = params
    h1 = prelu(linear(x, w_in, b_in), a1)
    y1 = global_layer_norm(h1, g1, be1, _EPS)
    pad = (w_dw.shape[0] - 1) * dilation
    h2 = prelu(depthwise_conv1d(y1, w_dw, b_dw, dilation,
                                (pad // 2, pad - pad // 2)), a2)
    y2 = global_layer_norm(h2, g2, be2, _EPS)
    skip = linear(y2, w_skip, b_skip)
    if last:
        return None, skip
    return x + linear(y2, w_res, b_res), skip


def tcn_block(x, params, dilation, last):
    """One TCN block forward: ``(res, skip)``, ``res`` None when last.

    A tensor on the CPU takes :func:`tcn_block_plain`; a CUDA tensor
    launches the kernel or raises. ``tcn_block.launches`` counts the
    kernel's block calls."""
    if x.device.type == 'cpu':
        return tcn_block_plain(x, params, dilation, last)
    out = _launch(x, params, dilation, last)
    tcn_block.launches += 1
    return out


tcn_block.launches = 0


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


def _launch(x, params, dilation, last):
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

    p_w_in = _matrix(w_in, hidden, c_in, 'w_in', device)
    p_b_in = _vector(b_in, hidden, 'b_in', device)
    p_a1 = _vector(a1, 1, 'a1', device)
    p_g1 = _vector(g1, hidden, 'g1', device)
    p_be1 = _vector(be1, hidden, 'be1', device)
    _check_tensor(w_dw, 'w_dw', device)
    if w_dw.shape != (3, hidden) or not w_dw.is_contiguous():
        raise ValueError(f'tcn_block: w_dw must be a contiguous (3, '
                         f'{hidden}) tensor, got {tuple(w_dw.shape)}')
    p_b_dw = _vector(b_dw, hidden, 'b_dw', device)
    p_a2 = _vector(a2, 1, 'a2', device)
    p_g2 = _vector(g2, hidden, 'g2', device)
    p_be2 = _vector(be2, hidden, 'be2', device)
    p_w_skip = _matrix(w_skip, c_skip, hidden, 'w_skip', device)
    p_b_skip = _vector(b_skip, c_skip, 'b_skip', device)
    if last:
        p_w_res, p_b_res, res = None, None, None
    else:
        p_w_res = _matrix(w_res, c_in, hidden, 'w_res', device)
        p_b_res = _vector(b_res, c_in, 'b_res', device)

    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        f32 = dict(dtype=torch.float32, device=device)
        h1 = torch.empty(batch, t_total, hidden, **f32)
        h2 = torch.empty(batch, t_total, hidden, **f32)
        part1 = torch.empty(
            batch, lib.tcn_in_partials(t_total, hidden), 3, **f32)
        part2 = torch.empty(
            batch, lib.tcn_dw_partials(t_total, hidden), 3, **f32)
        skip = torch.empty(batch, t_total, c_skip, **f32)
        if not last:
            res = torch.empty(batch, t_total, c_in, **f32)
        build.check(lib, lib.tcn_in_gemm_prelu_stats(
            x.data_ptr(), p_w_in, p_b_in, p_a1, h1.data_ptr(),
            part1.data_ptr(), batch, t_total, c_in, hidden, stream),
            'tcn_in_gemm_prelu_stats')
        build.check(lib, lib.tcn_dw_prelu_stats(
            h1.data_ptr(), part1.data_ptr(), p_g1, p_be1, w_dw.data_ptr(),
            p_b_dw, p_a2, h2.data_ptr(), part2.data_ptr(), batch, t_total,
            hidden, dilation, _EPS, stream), 'tcn_dw_prelu_stats')
        build.check(lib, lib.tcn_out_gemm(
            h2.data_ptr(), part2.data_ptr(), p_g2, p_be2, p_w_res, p_b_res,
            p_w_skip, p_b_skip, x.data_ptr(),
            None if last else res.data_ptr(), skip.data_ptr(), batch,
            t_total, hidden, c_in, c_skip, int(last), _EPS, stream),
            'tcn_out_gemm')
    return res, skip
