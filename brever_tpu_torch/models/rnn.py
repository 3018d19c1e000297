"""Recurrent layers (counterpart of ``brever_tpu/models/rnn.py``).

Parameters are the JAX package's: ``w_ih (in, 4H)``, ``w_hh (H, 4H)``,
``b_ih``, ``b_hh`` with gate order i|f|g|o, direction-stacked on a leading
axis of 2 in :class:`BLSTM`. Every call goes through
:func:`..ops.lstm_scan.lstm_scan_x` (the hand-written kernels on CUDA, the
plain versions on the CPU) with the bias ``b_ih + b_hh``; the backward
direction sees the time-flipped input, and both directions run as one
scan over ``(T, 2, R, E)``.
"""

import torch
from torch import nn

# looked up at call time: a run may put lstm_scan_x_plain in its place
from ..ops.lstm_scan import lstm_scan_x


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
        xs = xs.transpose(0, 1)[:, None].contiguous()   # (T, 1, B, F)
        bias = (self.b_ih + self.b_hh)[None]
        hidden = lstm_scan_x(xs, self.w_ih[None], bias,
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
        x_seq = torch.stack([x, x.flip(1)]).permute(2, 0, 1, 3).contiguous()
        hidden = lstm_scan_x(x_seq, self.w_ih, self.b_ih + self.b_hh,
                             self.w_hh)                     # (T, 2, B, H)
        fwd = hidden[:, 0].transpose(0, 1)
        bwd = hidden[:, 1].transpose(0, 1).flip(1)
        return torch.cat([fwd, bwd], dim=-1)
