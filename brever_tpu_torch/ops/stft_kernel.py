"""The fused STFT forward (K9): framing, the window and the onesided DFT in
one kernel; the plain version and the CUDA kernel's two routes.

Counterpart of ``PallasSTFT`` in ``brever_tpu/ops/pallas/stft_kernel.py``,
reached through ``STFT(backend='pallas')`` (``ops/stft.py``) where ``hop``
divides ``n_fft``. :func:`stft_basis` builds the basis as ``PallasSTFT``
does: ``W (n_fft, 2 bins)``, the window times ``rfft(eye(n_fft))``, real
parts then imaginary parts. :func:`stft_fused` takes a signal ``(rows, n)``
already padded as ``STFT.forward`` pads it and returns ``(rows, frames,
2 bins)``; a tensor on the CPU takes :func:`stft_basis_plain` (framing,
then the product against the same basis), a CUDA tensor launches the kernel
(``csrc/stft.cu``, replacing ``_stft_kernel``) or raises. The kernel's
route is chosen from ``n_fft`` before any launch (:func:`fft_route`): a
power of two from 16 to 4096 takes a real FFT a frame in shared memory
(the window, which it reads from the basis's column 0, applied on load;
the twiddles from
:func:`fft_twiddles`, the passes :func:`fft_radices`), any other ``n_fft``
the dense product against the basis. The JAX package defines no backward
for its kernel, and neither is there one here.
"""

import numpy as np
import torch

from . import build

#: rows one launch takes (a grid axis)
_MAX_ROWS = 65535
#: the FFT route's n_fft: powers of two from 16 to 4096
_FFT_SIZES = tuple(2 ** i for i in range(4, 13))


def fft_route(n_fft):
    """``'fft'`` where K9 takes ``n_fft`` on its FFT route (a power of two
    from 16 to 4096), else ``'dense'``."""
    return 'fft' if n_fft in _FFT_SIZES else 'dense'


def fft_twiddles(n_fft):
    """The FFT route's twiddle table: ``(n_fft, 2)`` float32, row m the real
    and imaginary parts of ``exp(-2 pi i m / n_fft)``, computed in float64."""
    angle = -2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(angle), np.sin(angle)], axis=1) \
        .astype(np.float32)


def fft_radices(n_fft):
    """The FFT route's passes over the ``n_fft / 2``-point complex FFT, in
    order: radix 8 while a factor 8 is left, then one pass of radix 4 or 2
    (8, 8, 4 at n_fft 512), as ``stft_fft_kernel`` runs them."""
    log_n = (n_fft // 2).bit_length() - 1
    return [8] * (log_n // 3) + ([2 ** (log_n % 3)] if log_n % 3 else [])


def stft_basis(n_fft, window):
    """The windowed onesided DFT basis ``(n_fft, 2 (n_fft // 2 + 1))``,
    float32 numpy, from a float32 ``window`` of ``n_fft`` taps."""
    windowed = np.asarray(window, np.float64)[:, None] \
        * np.fft.rfft(np.eye(n_fft), axis=1)
    return np.concatenate([windowed.real, windowed.imag],
                          axis=1).astype(np.float32)


def stft_basis_plain(x, basis, hop_length):
    """Plain version: the frames of ``x (rows, n)`` at ``n_fft =
    basis.shape[0]`` and ``hop_length``, times the basis: ``(rows, frames,
    2 bins)``."""
    return torch.matmul(x.unfold(-1, basis.shape[0], hop_length), basis)


def stft_fused(x, basis, hop_length):
    """``(rows, frames, 2 bins)`` of ``x (rows, n)``: the plain version on
    the CPU, else K9 on the route :func:`fft_route` picks (one launch of at
    most 65,535 rows each, counted in ``stft_fused.launches`` on the FFT
    route and ``stft_fused.dense_launches`` on the dense one)."""
    if x.device.type == 'cpu':
        return stft_basis_plain(x, basis, hop_length)
    lib = build.load_library()
    rows, n, n_fft, width = _check(x, basis, hop_length)
    fft = fft_route(n_fft) == 'fft'
    frames = (n - n_fft) // hop_length + 1
    device = x.device
    with torch.cuda.device(device):
        out = torch.empty(rows, frames, width, dtype=torch.float32,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        if fft:
            twiddles = _twiddles(n_fft, device)
        for lo in range(0, rows, _MAX_ROWS):
            hi = min(lo + _MAX_ROWS, rows)
            if fft:
                build.check(lib, lib.stft_fft(
                    x[lo:hi].data_ptr(), basis.data_ptr(),
                    twiddles.data_ptr(), out[lo:hi].data_ptr(), hi - lo, n,
                    n_fft, hop_length, stream), 'stft_fft')
                stft_fused.launches += 1
            else:
                build.check(lib, lib.stft_basis(
                    x[lo:hi].data_ptr(), basis.data_ptr(),
                    out[lo:hi].data_ptr(), hi - lo, n, n_fft, hop_length,
                    width, stream), 'stft_basis')
                stft_fused.dense_launches += 1
    return out


stft_fused.launches = 0
stft_fused.dense_launches = 0

#: the FFT route's twiddle tables on the card, by (n_fft, device)
_twiddle_cache = {}


def _twiddles(n_fft, device):
    key = (n_fft, device)
    if key not in _twiddle_cache:
        _twiddle_cache[key] = torch.from_numpy(fft_twiddles(n_fft)).to(device)
    return _twiddle_cache[key]


def _check(x, basis, hop_length):
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'stft_fused: no kernel for device {device}')
    for name, t in (('x', x), ('basis', basis)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2 or 0 in t.shape:
            raise ValueError(f'stft_fused: {name} must be a non-empty 2-D '
                             'tensor')
        if t.device != device:
            raise ValueError(f'stft_fused: {name} is on {t.device}, x on '
                             f'{device}')
        if t.dtype != torch.float32:
            raise TypeError(f'stft_fused: {name} must be float32, got '
                            f'{t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'stft_fused: {name} must be contiguous, got '
                             f'strides {t.stride()}')
    rows, n = x.shape
    n_fft, width = basis.shape
    if width != 2 * (n_fft // 2 + 1) or n_fft % hop_length or n < n_fft:
        raise ValueError(f'stft_fused: basis {tuple(basis.shape)} with hop '
                         f'{hop_length} over {n} samples: the kernel takes '
                         'the (n_fft, 2 bins) basis, hop | n_fft and at '
                         'least one frame')
    if n >= 2 ** 31:
        raise ValueError(f'stft_fused: x {tuple(x.shape)} passes the '
                         'kernel\'s int range')
    return rows, n, n_fft, width
