"""LSTM recurrence, forward and backward: the plain versions and the CUDA
kernels, with the input projection fused in (flash-LSTM-x, K3/K4) and over
precomputed input gates (K5/K6).

Counterpart of ``lstm_scan_fused_x`` in
``brever_tpu/ops/pallas/lstm_scan.py``: over ``x_seq (T, D, R, E)`` with
``D`` directions stacked (a backward direction's input already flipped in
time) and ``R`` rows,

    gates[t] = (x[t] w_ih + bias) + h[t-1] w_hh        (i | f | g | o)
    c[t] = sig(f) c[t-1] + sig(i) tanh(g),   h[t] = sig(o) tanh(c[t])

from zero state, with ``w_ih (D, E, 4H)``, ``bias (D, 4H)`` (``b_ih +
b_hh``) and ``w_hh (D, H, 4H)``, the JAX package's layout: this wrapper
takes the weights in that one layout, contiguous, and checks it.

:func:`lstm_scan_x` is what the models call. Under grad mode with an input
that requires grad it goes through :class:`LSTMScanXFunction`, whose
forward saves x, h and c (as ``_fused_x_fwd`` does) and whose backward
returns dx, dW_ih, db and dW_hh; otherwise (serving) it is the forward
alone. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels (``csrc/lstm_scan.cu``: K3, the forward, replaces
``_fwd_x_kernel``; K4, the backward, ``_bwd_x_kernel``) or raises.

The plain versions: :func:`lstm_scan_x_reference`, a time loop in the JAX
package's order of operations (``rnn._lstm_scan_impl`` after the einsum
projection), and :func:`lstm_scan_x_bwd_plain`, the memory-lean backward
of ``rnn._lstm_scan_bwd``: it keeps h and c only and recomputes the gates
in one product. Autograd through the time loop would keep about six
gate-sized tensors a step, more than the card holds for TF-GridNet at
16 x 4 s. :func:`lstm_scan_x_plain` is the whole plain path, with that
backward, on any device.
"""

import torch

from . import build


def _cell(gates, c_prev):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _projection(x_seq, w_ih, bias):
    """``x w_ih + bias`` for every step at once: ``(T, D, R, 4H)``."""
    return torch.einsum('tdre,dek->tdrk', x_seq, w_ih) + bias[None, :, None, :]


def lstm_scan_reference(gates_x, w_hh):
    """Plain forward of the gates-in scan, in ``rnn._lstm_scan_impl``'s
    order: ``(h_seq, c_seq)``, each ``(T, D, R, H)``."""
    h = gates_x.new_zeros(w_hh.shape[0], gates_x.shape[2], w_hh.shape[1])
    c = torch.zeros_like(h)
    hs, cs = [], []
    for gx in gates_x:
        h, c = _cell(gx + torch.matmul(h, w_hh), c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_bwd_plain(gates_x, w_hh, h_seq, c_seq, dh_seq):
    """Plain backward of the gates-in scan from the saved h and c, as
    ``rnn._lstm_scan_bwd``: ``(dgates, dw_hh)``. The gates of every step are
    recomputed in one product from ``h[t-1]``; a reverse loop carries (dh,
    dc)."""
    zero = torch.zeros_like(h_seq[:1])
    h_prev = torch.cat([zero, h_seq[:-1]])
    c_prev = torch.cat([zero, c_seq[:-1]])
    pre = gates_x + torch.matmul(h_prev, w_hh)
    i, f, g, o = pre.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)
    tc = torch.tanh(c_seq)
    del pre
    w_hh_t = w_hh.transpose(-1, -2)
    dgates = dh_seq.new_empty(dh_seq.shape[:-1] + (w_hh.shape[-1],))
    dh_rec = torch.zeros_like(dh_seq[0])
    dc_rec = torch.zeros_like(dh_seq[0])
    for t in range(dh_seq.shape[0] - 1, -1, -1):
        dh = dh_seq[t] + dh_rec
        do = dh * tc[t] * o[t] * (1 - o[t])
        dc = dh * o[t] * (1 - tc[t] * tc[t]) + dc_rec
        di = dc * g[t] * i[t] * (1 - i[t])
        df = dc * c_prev[t] * f[t] * (1 - f[t])
        dg = dc * i[t] * (1 - g[t] * g[t])
        dgates[t] = torch.cat([di, df, dg, do], dim=-1)
        dh_rec = torch.matmul(dgates[t], w_hh_t)
        dc_rec = dc * f[t]
    return dgates, torch.einsum('tdrh,tdrk->dhk', h_prev, dgates)


def lstm_scan_x_reference(x_seq, w_ih, bias, w_hh):
    """Plain forward: ``(h_seq, c_seq)``, each ``(T, D, R, H)``."""
    return lstm_scan_reference(_projection(x_seq, w_ih, bias), w_hh)


def lstm_scan_x_bwd_plain(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    """Plain backward from the saved h and c: ``(dx, dw_ih, db, dw_hh)``:
    :func:`lstm_scan_bwd_plain` through the projection."""
    dgates, dw_hh = lstm_scan_bwd_plain(_projection(x_seq, w_ih, bias), w_hh,
                                        h_seq, c_seq, dh_seq)
    dx = torch.einsum('tdrk,dek->tdre', dgates, w_ih)
    dw_ih = torch.einsum('tdre,tdrk->dek', x_seq, dgates)
    return dx, dw_ih, dgates.sum(dim=(0, 2)), dw_hh


def _on_kernel_device(x):
    """Whether x's device takes the CUDA kernels (anything but the CPU,
    which takes the plain versions; a device without kernels raises in
    the launch)."""
    return x.device.type != 'cpu'


def lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh):
    """The forward with its cell states, ``(h_seq, c_seq)``: the plain
    version on the CPU, else K3 (counted in ``lstm_scan_x.launches``)."""
    if not _on_kernel_device(x_seq):
        return lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)
    out = _launch_fwd(x_seq, w_ih, bias, w_hh)
    lstm_scan_x.launches += 1
    return out


def lstm_scan_x_bwd(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    """The VJP ``(dx, dw_ih, db, dw_hh)``: the plain version on the CPU,
    else K4 (counted in ``lstm_scan_x_bwd.launches``)."""
    if not _on_kernel_device(x_seq):
        return lstm_scan_x_bwd_plain(x_seq, w_ih, bias, w_hh, h_seq, c_seq,
                                     dh_seq)
    out = _launch_bwd(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq)
    lstm_scan_x_bwd.launches += 1
    return out


lstm_scan_x_bwd.launches = 0


class LSTMScanXFunction(torch.autograd.Function):
    """The recurrence with its memory-lean VJP: saves x, h and c.
    ``apply(x_seq, w_ih, bias, w_hh, plain)``: with ``plain`` the plain
    versions on every device, else the kernels on CUDA."""

    @staticmethod
    def forward(ctx, x_seq, w_ih, bias, w_hh, plain):
        if plain:
            h_seq, c_seq = lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)
        else:
            h_seq, c_seq = lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh)
        ctx.plain = plain
        ctx.save_for_backward(x_seq, w_ih, bias, w_hh, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        bwd = lstm_scan_x_bwd_plain if ctx.plain else lstm_scan_x_bwd
        return (*bwd(*ctx.saved_tensors, dh_seq.contiguous()), None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_scan_x(x_seq, w_ih, bias, w_hh):
    """``h_seq (T, D, R, H)`` of the recurrence; differentiable through
    :class:`LSTMScanXFunction` when grad mode is on and an input requires
    grad, else the forward alone. A tensor on the CPU takes the plain
    versions; a CUDA tensor launches K3 (and K4 in the backward) or
    raises. ``lstm_scan_x.launches`` counts K3's calls."""
    if _needs_grad(x_seq, w_ih, bias, w_hh):
        return LSTMScanXFunction.apply(x_seq, w_ih, bias, w_hh, False)
    return lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh)[0]


lstm_scan_x.launches = 0


def lstm_scan_x_plain(x_seq, w_ih, bias, w_hh):
    """The plain path on any device: :func:`lstm_scan_x_reference`, with
    the memory-lean plain backward under grad mode."""
    if _needs_grad(x_seq, w_ih, bias, w_hh):
        return LSTMScanXFunction.apply(x_seq, w_ih, bias, w_hh, True)
    return lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)[0]


def lstm_scan_fwd(gates_x, w_hh):
    """The gates-in forward with its cell states, ``(h_seq, c_seq)``: the
    plain version on the CPU, else K5 (counted in ``lstm_scan.launches``)."""
    if not _on_kernel_device(gates_x):
        return lstm_scan_reference(gates_x, w_hh)
    out = _launch_scan_fwd(gates_x, w_hh)
    lstm_scan.launches += 1
    return out


def lstm_scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq):
    """The gates-in VJP ``(dgates, dw_hh)``: the plain version on the CPU,
    else K6 (counted in ``lstm_scan_bwd.launches``)."""
    if not _on_kernel_device(gates_x):
        return lstm_scan_bwd_plain(gates_x, w_hh, h_seq, c_seq, dh_seq)
    out = _launch_scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq)
    lstm_scan_bwd.launches += 1
    return out


lstm_scan_bwd.launches = 0


class LSTMScanFunction(torch.autograd.Function):
    """The gates-in recurrence with its memory-lean VJP: saves gates_x,
    w_hh, h and c. ``apply(gates_x, w_hh, plain)``: with ``plain`` the plain
    versions on every device, else the kernels on CUDA."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, plain):
        if plain:
            h_seq, c_seq = lstm_scan_reference(gates_x, w_hh)
        else:
            h_seq, c_seq = lstm_scan_fwd(gates_x, w_hh)
        ctx.plain = plain
        ctx.save_for_backward(gates_x, w_hh, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        bwd = lstm_scan_bwd_plain if ctx.plain else lstm_scan_bwd
        return (*bwd(*ctx.saved_tensors, dh_seq.contiguous()), None)


def lstm_scan(gates_x, w_hh):
    """``h_seq (T, D, R, H)`` of the gates-in recurrence; differentiable
    through :class:`LSTMScanFunction` when grad mode is on and an input
    requires grad, else the forward alone. A tensor on the CPU takes the
    plain versions; a CUDA tensor launches K5 (and K6 in the backward) or
    raises. ``lstm_scan.launches`` counts K5's calls."""
    if _needs_grad(gates_x, w_hh):
        return LSTMScanFunction.apply(gates_x, w_hh, False)
    return lstm_scan_fwd(gates_x, w_hh)[0]


lstm_scan.launches = 0


def lstm_scan_plain(gates_x, w_hh):
    """The plain gates-in path on any device: :func:`lstm_scan_reference`,
    with the memory-lean plain backward under grad mode."""
    if _needs_grad(gates_x, w_hh):
        return LSTMScanFunction.apply(gates_x, w_hh, True)
    return lstm_scan_reference(gates_x, w_hh)[0]


# ---------------------------------------------------------------------------
# the kernels

#: shared memory a block may take on the H100 (bytes)
_MAX_SMEM = 227 * 1024


def _tensor(t, name, device, shape, what='lstm_scan_x'):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{what}: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'{what}: {name} is on {t.device}, the input on '
                         f'{device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{what}: {name} must be float32, got {t.dtype}')
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'{what}: {name} must be a contiguous {shape} '
                         f'tensor, got {tuple(t.shape)} with strides '
                         f'{t.stride()}')
    return t


def _check_hidden(hidden, what):
    if hidden % 32 or not 32 <= hidden <= 256:
        raise NotImplementedError(
            f'{what}: the CUDA kernels take a hidden size that is a '
            f'multiple of 32 up to 256, got {hidden}')


def _check(x_seq, w_ih, bias, w_hh, lib, backward):
    """Check what the kernels take; returns ``(T, D, R, E, H)``."""
    device = x_seq.device
    if device.type != 'cuda':
        raise ValueError(f'lstm_scan_x: no kernel for device {device}')
    if x_seq.ndim != 4 or 0 in x_seq.shape:
        raise ValueError('lstm_scan_x: x must be a non-empty (T, D, R, E) '
                         f'tensor, got {tuple(x_seq.shape)}')
    steps, n_dir, rows, feat = x_seq.shape
    _tensor(x_seq, 'x', device, tuple(x_seq.shape))
    if w_hh.ndim != 3:
        raise ValueError('lstm_scan_x: w_hh must be (D, H, 4H), got '
                         f'{tuple(w_hh.shape)}')
    hidden = w_hh.shape[1]
    _tensor(w_hh, 'w_hh', device, (n_dir, hidden, 4 * hidden))
    _tensor(w_ih, 'w_ih', device, (n_dir, feat, 4 * hidden))
    _tensor(bias, 'bias', device, (n_dir, 4 * hidden))
    _check_hidden(hidden, 'lstm_scan_x')
    e_pad = feat + (-feat % 4)
    smem = (lib.lstm_bwd_smem if backward else lib.lstm_fwd_smem)(e_pad,
                                                                 hidden)
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f'lstm_scan_x: E={feat} with H={hidden} needs {smem} bytes of '
            f'shared memory a block, more than {_MAX_SMEM}')
    if steps * n_dir * rows * 4 * hidden >= 2 ** 31:
        raise ValueError(f'lstm_scan_x: {tuple(x_seq.shape)} with H={hidden}'
                         ' passes the kernels\' int range')
    return steps, n_dir, rows, feat, hidden


def _aligned(*tensors):
    """The tensors with 16-byte aligned storage (the kernels load float4
    and float2): a view at another offset, such as a parameter in the
    trainer's flat buffer, is copied."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def _pad_feature(x_seq, w_ih):
    """Zero-pad E to a multiple of 4 (the kernels load x as float4);
    padded columns add nothing to the projection or its gradients."""
    pad = -x_seq.shape[-1] % 4
    if pad:
        x_seq = torch.nn.functional.pad(x_seq, (0, pad))
        w_ih = torch.nn.functional.pad(w_ih, (0, 0, 0, pad))
    return x_seq, w_ih


def _launch_fwd(x_seq, w_ih, bias, w_hh):
    lib = build.load_library()
    steps, n_dir, rows, _, hidden = _check(x_seq, w_ih, bias, w_hh, lib,
                                           False)
    x_seq, w_ih = _pad_feature(x_seq, w_ih)
    x_seq, w_ih, bias, w_hh = _aligned(x_seq, w_ih, bias, w_hh)
    device = x_seq.device
    with torch.cuda.device(device):
        h_seq = torch.empty(steps, n_dir, rows, hidden, dtype=torch.float32,
                            device=device)
        c_seq = torch.empty_like(h_seq)
        build.check(lib, lib.lstm_fwd(
            x_seq.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
            w_hh.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(), steps,
            n_dir, rows, x_seq.shape[-1], hidden,
            torch.cuda.current_stream(device).cuda_stream), 'lstm_fwd')
    return h_seq, c_seq


def _launch_bwd(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    lib = build.load_library()
    steps, n_dir, rows, feat, hidden = _check(x_seq, w_ih, bias, w_hh, lib,
                                              True)
    device = x_seq.device
    for name, t in (('h_seq', h_seq), ('c_seq', c_seq), ('dh', dh_seq)):
        _tensor(t, name, device, (steps, n_dir, rows, hidden))
    x_seq, w_ih = _pad_feature(x_seq, w_ih)
    x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq = _aligned(
        x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq)
    e_pad = x_seq.shape[-1]
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        w_hh_t = w_hh.transpose(1, 2).contiguous()   # (D, 4H, H)
        dx = torch.empty(steps, n_dir, rows, e_pad, **f32)
        dw = torch.empty(n_dir, e_pad + hidden, 4 * hidden, **f32)
        db = torch.empty(n_dir, 4 * hidden, **f32)
        work = torch.empty(lib.lstm_bwd_workspace(steps, n_dir, rows, e_pad,
                                                  hidden), **f32)
        build.check(lib, lib.lstm_bwd(
            x_seq.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
            w_hh.data_ptr(), w_hh_t.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr(), dh_seq.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), work.data_ptr(), steps, n_dir,
            rows, e_pad, hidden,
            torch.cuda.current_stream(device).cuda_stream), 'lstm_bwd')
    return (dx[..., :feat], dw[:, :feat], db, dw[:, e_pad:])


def _check_scan(gates_x, w_hh):
    """Check what K5 and K6 take; returns ``(T, D, R, H)``."""
    device = gates_x.device
    if device.type != 'cuda':
        raise ValueError(f'lstm_scan: no kernel for device {device}')
    if gates_x.ndim != 4 or 0 in gates_x.shape:
        raise ValueError('lstm_scan: gates_x must be a non-empty (T, D, R, '
                         f'4H) tensor, got {tuple(gates_x.shape)}')
    steps, n_dir, rows, gdim = gates_x.shape
    _tensor(gates_x, 'gates_x', device, tuple(gates_x.shape), 'lstm_scan')
    if w_hh.ndim != 3:
        raise ValueError('lstm_scan: w_hh must be (D, H, 4H), got '
                         f'{tuple(w_hh.shape)}')
    hidden = w_hh.shape[1]
    _tensor(w_hh, 'w_hh', device, (n_dir, hidden, 4 * hidden), 'lstm_scan')
    if gdim != 4 * hidden:
        raise ValueError(f'lstm_scan: gates_x has {gdim} gate columns, w_hh '
                         f'{4 * hidden}')
    _check_hidden(hidden, 'lstm_scan')
    if steps * n_dir * rows * 4 * hidden >= 2 ** 31:
        raise ValueError(f'lstm_scan: {tuple(gates_x.shape)} passes the '
                         'kernels\' int range')
    return steps, n_dir, rows, hidden


def _launch_scan_fwd(gates_x, w_hh):
    lib = build.load_library()
    steps, n_dir, rows, hidden = _check_scan(gates_x, w_hh)
    gates_x, w_hh = _aligned(gates_x, w_hh)
    device = gates_x.device
    with torch.cuda.device(device):
        h_seq = torch.empty(steps, n_dir, rows, hidden, dtype=torch.float32,
                            device=device)
        c_seq = torch.empty_like(h_seq)
        build.check(lib, lib.lstm_scan_fwd(
            gates_x.data_ptr(), w_hh.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr(), steps, n_dir, rows, hidden,
            torch.cuda.current_stream(device).cuda_stream), 'lstm_scan_fwd')
    return h_seq, c_seq


def _launch_scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq):
    lib = build.load_library()
    steps, n_dir, rows, hidden = _check_scan(gates_x, w_hh)
    device = gates_x.device
    for name, t in (('h_seq', h_seq), ('c_seq', c_seq), ('dh', dh_seq)):
        _tensor(t, name, device, (steps, n_dir, rows, hidden), 'lstm_scan')
    gates_x, w_hh, h_seq, c_seq, dh_seq = _aligned(gates_x, w_hh, h_seq,
                                                   c_seq, dh_seq)
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        w_hh_t = w_hh.transpose(1, 2).contiguous()   # (D, 4H, H)
        dgates = torch.empty(steps, n_dir, rows, 4 * hidden, **f32)
        dw_hh = torch.empty(n_dir, hidden, 4 * hidden, **f32)
        work = torch.empty(lib.lstm_scan_bwd_workspace(steps, n_dir, rows,
                                                       hidden), **f32)
        build.check(lib, lib.lstm_scan_bwd(
            gates_x.data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(),
            h_seq.data_ptr(), c_seq.data_ptr(), dh_seq.data_ptr(),
            dgates.data_ptr(), dw_hh.data_ptr(), work.data_ptr(), steps,
            n_dir, rows, hidden,
            torch.cuda.current_stream(device).cuda_stream), 'lstm_scan_bwd')
    return dgates, dw_hh
