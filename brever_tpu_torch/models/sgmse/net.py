"""Diffusion U-Net, the NCSN++ (and ADM) trunk of SGMSE+ (counterpart of
``brever_tpu/models/sgmse/net.py``).

``DiffusionUNet.forward`` takes and returns the JAX package's
channels-last ``(B, F, T, C)``; inside, the trunk runs channels first
``(B, C, F, T)``, PyTorch's convolution layout, in which one group of a
GroupNorm is one contiguous slab, the layout the GroupNorm kernels take
(:mod:`...ops.groupnorm`). Every GroupNorm goes through
:func:`...ops.groupnorm.group_norm_silu`: K7 and K8 on CUDA, their plain
versions on the CPU. Convolutions, the dense layers (1 x 1 convolutions
here) and attention's two products are plain torch, as the JAX package
leaves them to XLA.

Modules carry the flax scope names (``enc_0_0``, ``norm_1``, ``conv_1``,
...), and a GroupNorm's affine lives in a child named ``GroupNorm_0`` as in
the flax tree, so that ``convert.py`` maps a parameter by its name. The
Fourier frequencies of the noise embedding are a buffer (the flax
``buffers`` collection). ``encoder_type``/``decoder_type`` may be
``standard``, ``residual`` or ``skip``; the block type is ``ncsn`` (``adm``
needs the external GroupNorm affine, which is not ported).

Training rematerialises every block that does not resample, as the JAX
package's ``remat=True`` does (``torch.utils.checkpoint``, non-reentrant);
a rematerialised block's GroupNorms run K7 a second time in the backward,
counted in ``group_norm_act_fwd.recompute_launches``. Blocks that resample
push and pop the resampler's padding stack and are not rematerialised.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import groupnorm
from ...ops.groupnorm import group_norm_silu
from ...ops.resampling import Resampler


def _dense(linear, x):
    """A flax ``Dense`` over the channel axis of ``(B, C, F, T)``."""
    return F.conv2d(x, linear.weight[:, :, None, None], linear.bias)


def _conv3(in_ch, out_ch):
    return nn.Conv2d(in_ch, out_ch, 3, padding=1)


class _GNParams(nn.Module):
    """The affine of a GroupNorm, under flax's ``GroupNorm_0`` scope."""

    def __init__(self, channels):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class GroupNorm(nn.Module):
    """GroupNorm with the EDM group count ``min(32, C // 4)`` and eps 1e-6,
    then SiLU if ``silu``."""

    def __init__(self, channels, eps=1e-6, silu=False):
        super().__init__()
        self.groups = min(32, channels // 4)
        self.eps, self.silu = eps, silu
        self.GroupNorm_0 = _GNParams(channels)

    def forward(self, x):
        return group_norm_silu(x, self.GroupNorm_0.scale,
                               self.GroupNorm_0.bias, self.groups, self.eps,
                               apply_silu=self.silu)


class NoiseEmbedding(nn.Module):
    """Gaussian Fourier features and a 2-layer MLP (both SiLU)."""

    def __init__(self, noise_channels, emb_channels, fourier_scale=16.0):
        super().__init__()
        self.register_buffer('fourier_freqs',
                             torch.randn(noise_channels // 2) * fourier_scale)
        self.linear_1 = nn.Linear(noise_channels, emb_channels)
        self.linear_2 = nn.Linear(emb_channels, emb_channels)

    def forward(self, x):
        freqs = self.fourier_freqs
        angles = 2 * math.pi * x.reshape(-1).to(freqs.dtype)[:, None] \
            * freqs[None, :]
        h = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
        h = F.silu(self.linear_1(h))
        return F.silu(self.linear_2(h))


class AttentionBlock(nn.Module):
    """Single-head self-attention over the (freq, frames) grid."""

    def __init__(self, channels):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, x):
        batch, ch, freqs, frames = x.shape
        h = self.norm(x)

        def tokens(linear):
            return _dense(linear, h).reshape(batch, ch, -1).transpose(1, 2)

        q, k, v = tokens(self.query), tokens(self.key), tokens(self.value)
        weights = torch.softmax(
            torch.matmul(q, (k / ch ** 0.5).transpose(1, 2)), dim=-1)
        attn = torch.matmul(weights, v).transpose(1, 2).contiguous()
        return x + _dense(self.out,
                          attn.reshape(batch, ch, freqs, frames))


class UNetBlock(nn.Module):
    """Residual block with noise conditioning and optional resampling and
    attention."""

    def __init__(self, in_channels, out_channels, skip_scale, dropout,
                 emb_channels, attention=False, up_or_down='none'):
        super().__init__()
        self.skip_scale, self.dropout = skip_scale, dropout
        self.up_or_down = up_or_down
        self.norm_1 = GroupNorm(in_channels, silu=True)
        self.conv_1 = _conv3(in_channels, out_channels)
        self.linear = nn.Linear(emb_channels, out_channels)
        self.norm_2 = GroupNorm(out_channels, silu=True)
        self.conv_2 = _conv3(out_channels, out_channels)
        # ncsn blocks that resample project the skip path as well
        if in_channels != out_channels or up_or_down != 'none':
            self.skip_conv = nn.Linear(in_channels, out_channels)
        self.attn = AttentionBlock(out_channels) if attention else None

    def forward(self, x, emb, resampler=None, generator=None):
        h = self.norm_1(x)
        if resampler is not None:
            h = resampler(h, self.up_or_down)
            x = resampler(x, self.up_or_down)
        h = self.conv_1(h)
        h = self.norm_2(h + self.linear(emb)[:, :, None, None])
        if self.dropout and self.training:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) >= self.dropout
            h = h * keep / (1 - self.dropout)
        h = self.conv_2(h)
        if hasattr(self, 'skip_conv'):
            x = _dense(self.skip_conv, x)
        x = self.skip_scale * (x + h)
        if self.attn is not None:
            x = self.skip_scale * self.attn(x)
        return x


def _rematerialised(block, x, emb, generator):
    """``block(x, emb)`` under torch.utils.checkpoint. Its recompute in the
    backward counts its K7 launches as recomputes and draws dropout from the
    generator state the forward drew from (checkpoint restores only the
    default generators' states)."""
    saved = []

    def run(x, emb):
        if not saved:
            saved.append(None if generator is None else generator.get_state())
            return block(x, emb, None, generator)
        now = None if generator is None else generator.get_state()
        if now is not None:
            generator.set_state(saved[0])
        try:
            with groupnorm.recomputing():
                return block(x, emb, None, generator)
        finally:
            if now is not None:
                generator.set_state(now)

    return checkpoint(run, x, emb, use_reentrant=False)


class DiffusionUNet(nn.Module):
    """``forward(x (B, F, T, in_channels), sigma) -> (B, F, T,
    out_channels)``."""

    def __init__(self, num_freqs, base_channels=128,
                 channel_mult=(1, 1, 2, 2, 2, 2, 2), num_blocks_per_res=2,
                 noise_channel_mult=2, emb_channel_mult=4,
                 fir_kernel=(1, 3, 3, 1), attn_resolutions=(16,),
                 attn_bottleneck=True, encoder_type='skip',
                 decoder_type='skip', block_type='ncsn',
                 skip_scale=0.5 ** 0.5, dropout=0.0, aux_out_channels=4,
                 in_channels=4, out_channels=2, remat=True):
        super().__init__()
        if encoder_type not in ('standard', 'residual', 'skip') \
                or decoder_type not in ('standard', 'residual', 'skip'):
            raise ValueError(f'encoder_type {encoder_type!r}, decoder_type '
                             f'{decoder_type!r}')
        if block_type != 'ncsn':
            raise NotImplementedError(
                f'block_type {block_type!r}: the adm blocks (idmse, '
                'idmselarge) need the external GroupNorm affine, which is not '
                'ported yet (ROADMAP.md, Queue 1 item 9)')
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.fir_kernel, self.remat = tuple(fir_kernel), remat
        self.channel_mult = tuple(channel_mult)
        self.skip_scale = skip_scale
        num_res = len(channel_mult)
        channels = [base_channels * m for m in channel_mult]
        emb_ch = base_channels * emb_channel_mult
        block = dict(skip_scale=skip_scale, dropout=dropout,
                     emb_channels=emb_ch)
        self.emb = NoiseEmbedding(base_channels * noise_channel_mult, emb_ch)
        self.input_conv = _conv3(in_channels, base_channels)

        # the forward walks self.plan: (kind, name) in order
        self.plan = []
        skip_channels = [base_channels]
        aux_ch = in_channels
        for i in range(num_res):
            in_ch = base_channels if i == 0 else channels[i - 1]
            has_resample = i != num_res - 1
            n_blocks = num_blocks_per_res + (1 if has_resample else 0)
            attention = (num_freqs >> i) in attn_resolutions
            for b in range(n_blocks):
                is_down = has_resample and b == n_blocks - 1
                self._add('enc', f'enc_{i}_{b}', UNetBlock(
                    in_ch if b == 0 else channels[i], channels[i],
                    attention=False if is_down else attention,
                    up_or_down='down' if is_down else 'none', **block),
                    push=b != n_blocks - 1)
                skip_channels.append(channels[i])
            if encoder_type != 'standard' and i != num_res - 1:
                aux = nn.Linear(aux_ch, channels[i]) \
                    if encoder_type == 'skip' \
                    else _conv3(aux_ch, channels[i])
                self._add('aux_down', f'aux_down_{i}', aux)
                if encoder_type == 'residual':
                    aux_ch = channels[i]
            self.plan.append(('push', None, False, None))
        self._add('mid', 'bottleneck_1', UNetBlock(
            channels[-1], channels[-1], attention=attn_bottleneck, **block))
        self._add('mid', 'bottleneck_2', UNetBlock(
            channels[-1], channels[-1], **block))

        for i in reversed(range(num_res)):
            in_ch = channels[i] if i == num_res - 1 else channels[i + 1]
            attention = (num_freqs >> i) in attn_resolutions
            n_blocks = num_blocks_per_res + 1
            if i != num_res - 1:
                self._add('up', f'dec_{i}_up', UNetBlock(
                    in_ch, in_ch, up_or_down='up', **block))
            for b in range(n_blocks):
                self._add('dec', f'dec_{i}_{b}', UNetBlock(
                    skip_channels.pop() + (in_ch if b == 0 else channels[i]),
                    channels[i], attention=attention and b == n_blocks - 1,
                    **block))
            if decoder_type != 'standard':
                if decoder_type == 'skip' or i == num_res - 1:
                    out_ch = aux_out_channels if decoder_type == 'skip' \
                        else channels[i]
                    self.add_module(f'aux_up_norm_{i}',
                                    GroupNorm(channels[i], silu=True))
                    self._add('aux_up', f'aux_up_conv_{i}',
                              _conv3(channels[i], out_ch), level=i)
                else:
                    self._add('aux_up_res', f'aux_up_conv_{i}',
                              _conv3(channels[i], channels[i]), level=i)
        if decoder_type == 'skip':
            self.output_conv = nn.Linear(aux_out_channels, out_channels)
        else:
            last = channels[0]
            self.output_norm = GroupNorm(last)
            self.output_conv = _conv3(last, out_channels)
        self._num_res = num_res

    def _add(self, kind, name, module, push=False, level=None):
        self.add_module(name, module)
        self.plan.append((kind, name, push, level))

    def _block(self, name, x, emb, generator):
        block = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return _rematerialised(block, x, emb, generator)
        return block(x, emb, None, generator)

    def forward(self, x, sigma, generator=None):
        resampler = Resampler(self.fir_kernel)
        emb = self.emb(sigma)
        # contiguous channels first: a convolution keeps its input's
        # layout, and the GroupNorms take this one only
        x = x.permute(0, 3, 1, 2).contiguous()
        aux = x
        x = self.input_conv(x)
        skips = [x]
        num_res = self._num_res
        for step in self.plan:
            kind, name = step[0], step[1]
            if kind == 'push':
                skips.append(x)
            elif kind == 'enc':
                block = getattr(self, name)
                if block.up_or_down == 'down':
                    x = block(x, emb, resampler, generator)
                else:
                    x = self._block(name, x, emb, generator)
                if step[2]:
                    skips.append(x)
            elif kind == 'aux_down':
                aux = resampler.down(aux)
                if self.encoder_type == 'skip':
                    x = x + _dense(getattr(self, name), aux)
                else:
                    x = x + getattr(self, name)(aux)
                    aux = x = x * self.skip_scale
            elif kind == 'mid':
                x = self._block(name, x, emb, generator)
                aux = None
            elif kind == 'up':
                x = getattr(self, name)(x, emb, resampler, generator)
            elif kind == 'dec':
                x = self._block(name, torch.cat([x, skips.pop()], dim=1),
                                emb, generator)
            else:   # aux_up, aux_up_res: after a level's last block
                level = step[3]
                if level != num_res - 1 and aux is not None:
                    aux = resampler.up(aux)
                if kind == 'aux_up':
                    h = getattr(self, f'aux_up_norm_{level}')(x)
                    h = getattr(self, name)(h)
                    aux = h if aux is None else aux + h
                else:
                    x = aux = x + getattr(self, name)(aux)
        if aux is None:
            aux = x
        if self.decoder_type == 'skip':
            out = _dense(self.output_conv, aux)
        else:
            out = self.output_conv(self.output_norm(aux))
        return out.permute(0, 2, 3, 1)
