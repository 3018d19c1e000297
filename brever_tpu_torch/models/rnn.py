"""Recurrent layers (counterpart of ``brever_tpu/models/rnn.py``).

Parameters are the JAX package's: ``w_ih (in, 4H)``, ``w_hh (H, 4H)``,
``b_ih``, ``b_hh`` with gate order i|f|g|o, direction-stacked on a leading
axis of 2 in :class:`BLSTM`; the backward direction sees the time-flipped
input, and both directions run as one scan over ``(T, 2, R, E)``.

Every call goes through :func:`_dispatch_scan_x`, the JAX package's
routing under its names. A scan of at least ``_MIN_FUSED_ROWS`` rows takes
:func:`..ops.lstm_scan.lstm_scan_x` (K3/K4 on CUDA, the input projection
inside the scan); a narrower one computes ``gates_x = x w_ih + bias`` for
every step in one product (cuBLAS on CUDA) and scans it with
:func:`..ops.lstm_scan.lstm_scan` (K5/K6 on CUDA) through
:func:`_dispatch_scan`. On the CPU both take the plain versions. The JAX
package also gates its fused kernels on the hidden size being a multiple of
the TPU's 128 lanes; the CUDA kernels take any hidden size up to 256 (one
off their grid of multiples of 32 is zero-padded to it), so that condition
is dropped. In its place, an (E, H) whose projection-fused kernels would
pass the card's shared memory takes the projection outside the scan, decided
from the shape before any launch (``ops.lstm_scan.fused_x_fits``).

Under bf16 amp the parameters and inputs are bfloat16 and the scans take
the kernels' bf16 route; the unfused route's projection is a bfloat16
product, then ``+ bias`` in bfloat16 (two roundings, as the JAX package's
einsum fallback), where K3 rounds ``x w_ih + bias`` once.
"""

import torch
from torch import nn

# looked up at call time: a run may put lstm_scan_x_plain and
# lstm_scan_plain in their places
from ..ops.lstm_scan import (fused_x_fits, kernel_hidden, lstm_scan,
                              lstm_scan_x)

#: the scan's row floor for the projection-fused kernel, the JAX package's
#: default (``BREVER_LSTM_MIN_ROWS``): DCCRN's complex LSTM (2B rows) and
#: short TF-GridNet requests fall under it
_MIN_FUSED_ROWS = 128


def _use_fused_scan_x(n_rows, feat, hidden):
    """Whether a scan of ``n_rows`` rows over ``feat`` inputs with ``hidden``
    units takes the projection-fused K3: from the row floor up, where its
    shared memory fits."""
    return n_rows >= _MIN_FUSED_ROWS \
        and fused_x_fits(feat, kernel_hidden(hidden))


def _dispatch_scan(gates_x, w_hh):
    """The gates-in scan over ``gates_x (T, D, R, 4H)`` with ``w_hh (D, H,
    4H)``, or ``(T, R, 4H)`` with ``(H, 4H)`` for one direction."""
    if gates_x.ndim == 3:
        return lstm_scan(gates_x[:, None].contiguous(), w_hh[None])[:, 0]
    return lstm_scan(gates_x.contiguous(), w_hh)


def _dispatch_scan_x(x_seq, w_ih, bias, w_hh):
    """The scan over ``x_seq (T, D, R, E)`` with direction-stacked weights:
    K3 from the row floor up where it fits, else the projection outside the
    scan, then :func:`_dispatch_scan`."""
    if _use_fused_scan_x(x_seq.shape[-2], x_seq.shape[-1], w_hh.shape[-2]):
        return lstm_scan_x(x_seq.contiguous(), w_ih, bias, w_hh)
    gates_x = torch.einsum('tdrf,dfk->tdrk', x_seq, w_ih) \
        + bias[None, :, None, :]
    return _dispatch_scan(gates_x, w_hh)


def _uniform(shape, hidden):
    scale = hidden ** -0.5
    return nn.Parameter(torch.empty(shape).uniform_(-scale, scale))


class LSTM(nn.Module):
    """Unidirectional single-layer LSTM over ``(batch, time, features)``
    from zero state; returns the hidden-state sequence."""

    def __init__(self, input_size, hidden_size, reverse=False):
        super().__init__()
        self.reverse = reverse
        self.w_ih = _uniform((input_size, 4 * hidden_size), hidden_size)
        self.w_hh = _uniform((hidden_size, 4 * hidden_size), hidden_size)
        self.b_ih = _uniform((4 * hidden_size,), hidden_size)
        self.b_hh = _uniform((4 * hidden_size,), hidden_size)

    def forward(self, x):
        xs = x.flip(1) if self.reverse else x
        xs = xs.transpose(0, 1)[:, None]                 # (T, 1, B, F)
        bias = (self.b_ih + self.b_hh)[None]
        hidden = _dispatch_scan_x(xs, self.w_ih[None], bias,
                                  self.w_hh[None])[:, 0].transpose(0, 1)
        return hidden.flip(1) if self.reverse else hidden


class BLSTM(nn.Module):
    """Bidirectional LSTM: forward and backward hidden states concatenated
    (torch ``nn.LSTM(bidirectional=True)`` layout), both directions in one
    scan."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.w_ih = _uniform((2, input_size, 4 * hidden_size), hidden_size)
        self.w_hh = _uniform((2, hidden_size, 4 * hidden_size), hidden_size)
        self.b_ih = _uniform((2, 4 * hidden_size), hidden_size)
        self.b_hh = _uniform((2, 4 * hidden_size), hidden_size)

    def forward(self, x):
        # (B, T, F) -> (T, 2, B, F), the backward direction flipped in time
        x_seq = torch.stack([x, x.flip(1)]).permute(2, 0, 1, 3)
        hidden = _dispatch_scan_x(x_seq, self.w_ih, self.b_ih + self.b_hh,
                                  self.w_hh)                # (T, 2, B, H)
        fwd = hidden[:, 0].transpose(0, 1)
        bwd = hidden[:, 1].transpose(0, 1).flip(1)
        return torch.cat([fwd, bwd], dim=-1)
