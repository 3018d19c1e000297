"""Conv-TasNet: learned time-domain encoder/decoder + dilated TCN masks
(counterpart of ``brever_tpu/models/convtasnet.py``).

Luo & Mesgarani, IEEE/ACM TASLP 2019; the default geometry has
4,935,217 parameters. Channels-last inside the TCN, like the JAX
package. Every TCN block goes through :func:`..ops.tcn_block.tcn_block`:
the hand-written kernels on CUDA (forward, and backward when training),
their plain versions on the CPU. Encoder, bottleneck, mask and decoder
are plain torch, as the JAX package leaves them to XLA.
"""

import torch
from torch import nn

from ..convert import flax_to_state_dict, state_dict_to_flax
from ..criterion import init_criterion
from ..ops.tcn_block import tcn_block
from ..optim import Adam
from .base import BreverBaseModel, ModelRegistry
from .common import DepthwiseConv1D, GlobalLayerNorm, PReLU


class ConvBlock(nn.Module):
    """1x1 conv -> PReLU/gLN -> dilated depthwise -> PReLU/gLN ->
    residual + skip projections."""

    def __init__(self, input_channels, hidden_channels, skip_channels,
                 kernel_size, dilation, last):
        super().__init__()
        self.dilation = dilation
        self.last = last
        padding = (kernel_size - 1) * dilation
        self.conv_in = nn.Linear(input_channels, hidden_channels)
        self.prelu_1 = PReLU()
        self.norm_1 = GlobalLayerNorm(hidden_channels)
        self.depthwise = DepthwiseConv1D(
            hidden_channels, kernel_size, dilation,
            (padding // 2, padding - padding // 2))
        self.prelu_2 = PReLU()
        self.norm_2 = GlobalLayerNorm(hidden_channels)
        self.res = None if last \
            else nn.Linear(hidden_channels, input_channels)
        self.skip = nn.Linear(hidden_channels, skip_channels)

    def block_params(self):
        """The block's parameters in the order ``tcn_block`` takes them;
        the Linear weights as they are stored, (out, in)."""
        res = (None, None) if self.last else (self.res.weight, self.res.bias)
        return (self.conv_in.weight, self.conv_in.bias,
                self.prelu_1.alpha, self.norm_1.scale, self.norm_1.bias,
                self.depthwise.weight, self.depthwise.bias,
                self.prelu_2.alpha, self.norm_2.scale, self.norm_2.bias,
                *res, self.skip.weight, self.skip.bias)

    def forward(self, x):
        # x: (batch, time, bottleneck) -> (res or None, skip)
        return tcn_block(x.contiguous(), self.block_params(), self.dilation,
                         self.last)


class TCN(nn.Module):

    def __init__(self, input_channels, bottleneck_channels, hidden_channels,
                 skip_channels, kernel_size, layers, repeats, sources):
        super().__init__()
        self.input_channels = input_channels
        self.sources = sources
        self.norm = GlobalLayerNorm(input_channels)
        self.bottleneck = nn.Linear(input_channels, bottleneck_channels)
        self.blocks = nn.ModuleList(
            ConvBlock(bottleneck_channels, hidden_channels, skip_channels,
                      kernel_size, 2 ** i,
                      last=(r == repeats - 1 and i == layers - 1))
            for r in range(repeats) for i in range(layers))
        self.prelu_out = PReLU()
        self.mask = nn.Linear(skip_channels, input_channels * sources)

    def forward(self, x):
        # x: (batch, time, filters) -> masks (batch, time, sources, filters)
        x = self.bottleneck(self.norm(x))
        skip_sum = 0
        for block in self.blocks:
            x, skip = block(x)
            skip_sum = skip_sum + skip
        out = torch.sigmoid(self.mask(self.prelu_out(skip_sum)))
        batch, time, _ = out.shape
        return out.reshape(batch, time, self.sources, self.input_channels)


@ModelRegistry.register('convtasnet')
class ConvTasNet(BreverBaseModel):
    """Non-causal Conv-TasNet. ``criterion``, ``optimizer``,
    ``learning_rate`` and ``grad_clip`` are the training settings of the
    model's config: :meth:`loss` and the trainer use them, serving does
    not."""

    def __init__(
        self,
        filters: int = 512,
        filter_length: int = 32,
        bottleneck_channels: int = 128,
        hidden_channels: int = 512,
        skip_channels: int = 128,
        kernel_size: int = 3,
        layers: int = 8,
        repeats: int = 3,
        output_sources: int = 1,
        causal: bool = False,
        criterion: str = 'snr',
        optimizer: str = 'adam',
        learning_rate: float = 0.001,
        grad_clip: float = 5.0,
        *,
        device,
    ):
        super().__init__()
        if causal:
            raise NotImplementedError(
                'causal Conv-TasNet needs the cumulative layer norm, which '
                'the PyTorch port does not have yet')
        self.hparams = dict(
            filters=filters, filter_length=filter_length,
            bottleneck_channels=bottleneck_channels,
            hidden_channels=hidden_channels, skip_channels=skip_channels,
            kernel_size=kernel_size, layers=layers, repeats=repeats,
            output_sources=output_sources, causal=causal,
            criterion=criterion, optimizer=optimizer,
            learning_rate=learning_rate, grad_clip=grad_clip)
        self.filter_length = filter_length
        self.output_sources = output_sources
        self.criterion = init_criterion(criterion)
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        stride = filter_length // 2
        self.encoder = nn.Conv1d(1, filters, filter_length, stride,
                                 bias=False)
        self.tcn = TCN(filters, bottleneck_channels, hidden_channels,
                       skip_channels, kernel_size, layers, repeats,
                       output_sources)
        self.decoder = nn.ConvTranspose1d(filters, 1, filter_length, stride,
                                          bias=False)
        self.to(device)

    def forward(self, x):
        # x: (batch, samples) mono waveform -> (batch, sources, samples)
        length = x.shape[-1]
        stride = self.filter_length // 2
        pad = (self.filter_length - length) % stride
        x = nn.functional.pad(x, (0, pad))
        encoded = self.encoder(x[:, None]).transpose(1, 2)  # (B, T, F)
        masks = self.tcn(encoded)                           # (B, T, S, F)
        masked = encoded[:, :, None, :] * masks
        batch, frames, sources, filters = masked.shape
        masked = masked.permute(0, 2, 3, 1).reshape(
            batch * sources, filters, frames)
        decoded = self.decoder(masked).reshape(batch, sources, -1)
        return decoded[..., :length]

    def transform(self, sources):
        """Binaural -> monaural (mean over channels)."""
        return sources.mean(dim=-2)

    def to_flax(self, state_dict):
        return state_dict_to_flax(state_dict, self.hparams['layers'])

    def from_flax(self, params, aux=None):
        return flax_to_state_dict(params)

    def loss(self, batch, lengths, generator=None):
        """Per-item loss of a padded batch ``(B, sources, channels,
        samples)``: the mixture in, the other sources as labels."""
        mono = self.transform(batch)      # (B, sources, samples)
        return self.criterion(self(mono[:, 0]), mono[:, 1:], lengths)

    def optimizer(self):
        if self.optimizer_name != 'adam':
            raise NotImplementedError(
                f'optimizer {self.optimizer_name!r}: the port trains with '
                'adam only')
        return Adam(self.learning_rate)

    def _enhance(self, x):
        out = self(self.transform(x))
        if self.output_sources == 1:
            out = out[:, 0]
        return out
