"""DCCRN: deep complex convolution recurrent network (counterpart of
``brever_tpu/models/dccrn.py``; Hu et al. 2020).

A complex U-Net over the STFT (frame 512, hop 128, the DC bin dropped):
complex conv encoder (stride 2 over frequency, time-VALID), a complex LSTM
bottleneck, a complex transposed-conv decoder with skip connections, and a
polar mask with a tanh-bounded magnitude. The default geometry has
3,671,053 parameters.

Channels first inside, ``(B, 2 C, F, T)`` with the real parts in the first
C channels (the JAX package keeps them last). A complex conv is one real
convolution against the block kernel ``[[W_r, -W_i], [W_i, W_r]]`` with
the torch-style double bias ``[b_r - b_i | b_r + b_i]``, as the JAX model
computes it. The JAX decoder is ``lax.conv_transpose`` with
``transpose_kernel=False`` and the padding ``(k - 1 - p, k - 1 - p + op)``:
a correlation of the stride-dilated input with the kernel unflipped, which
is ``conv_transpose2d`` of the kernel flipped in both axes, in and out
swapped, with ``padding=p`` and ``output_padding=op``.

The complex LSTM stacks the real and imaginary inputs on the row axis (2B
rows) and the real and imaginary weight sets on the direction axis (both
run forward in time), one scan through ``rnn._dispatch_scan_x``: under the
128-row floor, as at any batch up to 63, the projection is one product and
the scan is K5/K6 on CUDA. Convolutions, norms and the STFT are plain
torch, as the JAX package leaves them to XLA.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import dccrn_flax_to_state_dict, dccrn_state_dict_to_flax
from ..criterion import init_criterion
from ..ops.stft import STFT
from ..optim import Adam
from .base import BreverBaseModel, ModelRegistry
from .common import BatchNorm, ComplexBatchNorm, PReLU
from .rnn import _dispatch_scan_x, _uniform


class _ConvParams(nn.Module):
    """One real convolution's ``weight (out, in, kh, kw)`` and ``bias``
    (flax's ``kernel`` and ``bias`` of ``real`` or ``imag``)."""

    def __init__(self, in_channels, features, kernel_size):
        super().__init__()
        fan_in = in_channels * kernel_size[0] * kernel_size[1]
        self.weight = nn.Parameter(
            torch.randn(features, in_channels, *kernel_size) / fan_in ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))


class _ComplexConv(nn.Module):
    """Complex conv ``(a + ib)(W_r + iW_i)`` of a ``(B, 2 cin, F, T)``
    tensor as one real (transposed) convolution against the block kernel."""

    def __init__(self, in_channels, features, kernel_size, stride, padding,
                 output_padding=(0, 0), transpose=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding, self.transpose = output_padding, transpose
        self.real = _ConvParams(in_channels, features, kernel_size)
        self.imag = _ConvParams(in_channels, features, kernel_size)

    def forward(self, x):
        wr, wi = self.real.weight, self.imag.weight
        kernel = torch.cat([torch.cat([wr, -wi], dim=1),    # -> out_r
                            torch.cat([wi, wr], dim=1)])    # -> out_i
        bias = torch.cat([self.real.bias - self.imag.bias,
                          self.real.bias + self.imag.bias])
        if self.transpose:
            return F.conv_transpose2d(
                x, kernel.transpose(0, 1).flip(2, 3), bias, self.stride,
                self.padding, self.output_padding)
        return F.conv2d(x, kernel, bias, self.stride, self.padding)


class _LSTMParams(nn.Module):
    """One real LSTM's weights, the JAX package's names and layout."""

    def __init__(self, in_features, hidden):
        super().__init__()
        self.w_ih = _uniform((in_features, 4 * hidden), hidden)
        self.w_hh = _uniform((hidden, 4 * hidden), hidden)
        self.b_ih = _uniform((4 * hidden,), hidden)
        self.b_hh = _uniform((4 * hidden,), hidden)


class _ComplexLSTMLayer(nn.Module):
    """One complex LSTM layer: the four real passes (two weight sets over
    the real and the imaginary input) as one scan of ``(T, 2, 2B, F)``;
    returns ``(rr - ii, ri + ir)``."""

    def __init__(self, in_features, hidden):
        super().__init__()
        self.real = _LSTMParams(in_features, hidden)
        self.imag = _LSTMParams(in_features, hidden)

    def forward(self, real, imag):
        batch = real.shape[0]
        xs = torch.cat([real, imag]).transpose(0, 1)        # (T, 2B, F)
        xs = xs[:, None].expand(xs.shape[0], 2, *xs.shape[1:])
        nets = (self.real, self.imag)
        out = _dispatch_scan_x(
            xs, torch.stack([n.w_ih for n in nets]),
            torch.stack([n.b_ih + n.b_hh for n in nets]),
            torch.stack([n.w_hh for n in nets]))            # (T, 2, 2B, H)
        out_r = out[:, 0].transpose(0, 1)                   # (2B, T, H)
        out_i = out[:, 1].transpose(0, 1)
        rr, ri = out_r[:batch], out_r[batch:]
        ir, ii = out_i[:batch], out_i[batch:]
        return rr - ii, ri + ir


@ModelRegistry.register('dccrn')
class DCCRN(BreverBaseModel):
    """DCCRN on binaural input (the channel mean is enhanced).
    ``criterion``, ``optimizer`` and ``learning_rate`` are the training
    settings of the model's config; the gradient is clipped at 5."""

    grad_clip = 5.0

    def __init__(
        self,
        stft_frame_length: int = 512,
        stft_hop_length: int = 128,
        stft_window: str = 'hann',
        channels: list[int] = [16, 32, 64, 128, 128, 128],
        kernel_size: tuple[int, int] = (5, 2),
        stride: tuple[int, int] = (2, 1),
        padding: tuple[int, int] = (2, 0),
        output_padding: tuple[int, int] = (1, 0),
        lstm_channels: int = 128,
        lstm_layers: int = 2,
        use_complex_batchnorm: bool = False,
        criterion: str = 'snr',
        optimizer: str = 'adam',
        learning_rate: float = 0.0001,
        *,
        device,
    ):
        super().__init__()
        kernel_size, stride = tuple(kernel_size), tuple(stride)
        padding, output_padding = tuple(padding), tuple(output_padding)
        self.hparams = dict(
            stft_frame_length=stft_frame_length,
            stft_hop_length=stft_hop_length, stft_window=stft_window,
            channels=list(channels), kernel_size=kernel_size, stride=stride,
            padding=padding, output_padding=output_padding,
            lstm_channels=lstm_channels, lstm_layers=lstm_layers,
            use_complex_batchnorm=use_complex_batchnorm,
            criterion=criterion, optimizer=optimizer,
            learning_rate=learning_rate)
        self.criterion = init_criterion(criterion)
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.kernel_size, self.stride = kernel_size, stride
        self.channels = list(channels)
        self.stft = STFT(frame_length=stft_frame_length,
                         hop_length=stft_hop_length, window=stft_window)

        def norm(complex_channels):
            if use_complex_batchnorm:
                return ComplexBatchNorm(complex_channels)
            return BatchNorm(2 * complex_channels, momentum=0.9, eps=1e-5)

        freqs = stft_frame_length // 2     # the DC bin dropped
        kf, sf, pf = kernel_size[0], stride[0], padding[0]
        for i, ch in enumerate(self.channels):
            cin = 1 if i == 0 else self.channels[i - 1]
            self.add_module(f'enc_conv_{i}', _ComplexConv(
                cin, ch, kernel_size, stride, padding))
            self.add_module(f'enc_norm_{i}', norm(ch))
            self.add_module(f'enc_prelu_{i}', PReLU())
            freqs = (freqs + 2 * pf - kf) // sf + 1
        width = self.channels[-1] * freqs
        for i in range(lstm_layers):
            self.add_module(f'lstm_{i}', _ComplexLSTMLayer(
                width if i == 0 else lstm_channels, lstm_channels))
        self.lstm_proj_real = nn.Linear(lstm_channels, width)
        self.lstm_proj_imag = nn.Linear(lstm_channels, width)
        for j, i in enumerate(reversed(range(len(self.channels)))):
            out_ch = 1 if i == 0 else self.channels[i - 1]
            self.add_module(f'dec_conv_{j}', _ComplexConv(
                2 * self.channels[i], out_ch, kernel_size, stride, padding,
                output_padding, transpose=True))
            if i != 0:
                self.add_module(f'dec_norm_{j}', norm(out_ch))
                self.add_module(f'dec_prelu_{j}', PReLU())
        self.lstm_layers = lstm_layers
        self.to(device)

    @property
    def latency(self):
        """Analytic latency: the STFT frame plus the decoder's time
        lookahead accumulated across the layers."""
        _, kt = self.kernel_size
        _, st = self.stride
        enc_dec = (kt - 1) * sum(st ** i for i in range(len(self.channels)))
        return self.stft.frame_length + enc_dec * self.stft.hop_length

    def transform(self, sources):
        return sources.mean(dim=-2)    # binaural -> monaural

    def _to_input(self, x):
        """Waveform ``(B, n)`` -> ``(B, 2, F - 1, T)``: real and imaginary
        parts, the DC bin dropped."""
        spec = self.stft(x)[..., 1:, :]
        return torch.stack([spec.real, spec.imag], dim=1)

    def _layer(self, kind, i):
        return getattr(self, f'{kind}_{i}')

    def _mask(self, spec):
        """The complex mask ``(B, 2, F - 1, T)`` of the network."""
        skips, h = [], spec
        for i in range(len(self.channels)):
            h = self._layer('enc_conv', i)(h)
            h = self._layer('enc_prelu', i)(self._layer('enc_norm', i)(h))
            skips.append(h)
        batch, ch2, freqs, frames = h.shape
        ch = ch2 // 2

        def to_seq(v):       # (B, C, F, T) -> (B, T, C F): channel-major
            return v.permute(0, 3, 1, 2).reshape(batch, frames, ch * freqs)

        def from_seq(v):
            return v.reshape(batch, frames, ch, freqs).permute(0, 2, 3, 1)

        seq_r, seq_i = to_seq(h[:, :ch]), to_seq(h[:, ch:])
        for i in range(self.lstm_layers):
            seq_r, seq_i = self._layer('lstm', i)(seq_r, seq_i)
        h = torch.cat([from_seq(self.lstm_proj_real(seq_r)),
                       from_seq(self.lstm_proj_imag(seq_i))], dim=1)
        for j, i in enumerate(reversed(range(len(self.channels)))):
            hr, hi = h.chunk(2, dim=1)
            sr, si = skips[i].chunk(2, dim=1)
            h = self._layer('dec_conv', j)(torch.cat([hr, sr, hi, si], dim=1))
            if i != 0:
                h = self._layer('dec_prelu', j)(self._layer('dec_norm', j)(h))
        return h

    @staticmethod
    def _apply_mask(spec, mask):
        """Polar mask: tanh-bounded magnitude, additive phase; the guards
        keep the JAX package's form (and its gradients)."""
        in_mag = torch.sqrt(spec[:, 0] ** 2 + spec[:, 1] ** 2)
        in_phase = torch.atan2(spec[:, 1], spec[:, 0])
        mask_mag = torch.tanh(torch.sqrt(mask[:, 0] ** 2 + mask[:, 1] ** 2
                                         + 1e-7))
        mask_real = mask[:, 0] + (mask[:, 0] == 0) * 1e-7
        mask_phase = torch.atan2(mask[:, 1], mask_real)
        out_mag = in_mag * mask_mag
        out_phase = in_phase + mask_phase
        return out_mag * torch.cos(out_phase), out_mag * torch.sin(out_phase)

    def forward(self, x):
        """Mono ``(B, n)`` -> enhanced ``(B, n)``."""
        length = x.shape[-1]
        x = x.to(self.lstm_proj_real.weight.dtype)  # float64 in references
        spec = self._to_input(x)
        real, imag = self._apply_mask(spec, self._mask(spec))
        # the DC bin back in, as 0
        out = torch.complex(F.pad(real, (0, 0, 1, 0)),
                            F.pad(imag, (0, 0, 1, 0)))
        return self.stft.backward(out)[..., :length]

    def to_flax(self, state_dict):
        return dccrn_state_dict_to_flax(state_dict)[0]

    def flax_aux(self, state_dict):
        return dccrn_state_dict_to_flax(state_dict)[1]

    def from_flax(self, params, aux=None):
        return dccrn_flax_to_state_dict(params, aux)

    def loss(self, batch, lengths, generator=None):
        """Per-item loss of a padded batch ``(B, sources, 2, samples)``: the
        channel means, the mixture in and the target as the label. In train
        mode the batch norms update their running statistics (padding rows
        and padded samples included, as in the JAX package)."""
        mono = self.transform(batch)
        return self.criterion(self(mono[:, 0])[:, None], mono[:, 1:2],
                              lengths)

    def optimizer(self):
        if self.optimizer_name != 'adam':
            raise NotImplementedError(
                f'optimizer {self.optimizer_name!r}: the port trains with '
                'adam only')
        return Adam(self.learning_rate)

    def _enhance(self, x):
        """Enhancement with the running statistics, whatever the module's
        mode (the JAX model enhances with ``train=False``)."""
        training = self.training
        self.eval()
        try:
            return self(x.mean(dim=-2))
        finally:
            self.train(training)
