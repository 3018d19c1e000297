"""TF-GridNet V2: alternating sub-band and full-band BLSTMs plus full-band
self-attention (counterpart of ``brever_tpu/models/tfgridnet.py``).

Wang et al., IEEE/ACM TASLP 2023 (ESPnet V2 variant); the default geometry
has 3,735,344 parameters. Channels-last ``(B, T, F, C)`` inside, like the
JAX package. Every BLSTM goes through
:func:`..ops.lstm_scan.lstm_scan_x`: the hand-written kernels on CUDA
(forward, and backward when training), their plain versions on the CPU.
The STFT (``torch.fft``), convolutions, norms and attention (a plain
matmul softmax) are plain torch, as the JAX package leaves them to XLA.

The JAX model scans its identical grid blocks under one ``nn.scan`` scope
(a leading axis of ``n_layers`` on every block parameter) and
rematerialises them; neither changes a number, and here the blocks are a
``ModuleList``. ``convert.py`` splits and stacks the block axis.
"""

import math

import torch
from torch import nn

from ..convert import (tfgridnet_flax_to_state_dict,
                       tfgridnet_state_dict_to_flax)
from ..criterion import init_criterion
from ..ops.stft import STFT
from ..optim import Adam
from .base import BreverBaseModel, ModelRegistry
from .common import PReLU
from .rnn import BLSTM
from .schedulers import ReduceLROnPlateau


def _fast_norm(x, dims, eps):
    """flax's normalisation statistics: mean and ``E[x^2] - mean^2``
    (clipped at 0) over ``dims``; returns ``(x - mean, rsqrt(var + eps))``.
    """
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x * x).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0)
    return x - mean, torch.rsqrt(var + eps)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: over the last axis, eps 1e-5, per-channel
    ``scale`` and ``bias``."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        centred, rstd = _fast_norm(x, (-1,), self.eps)
        return centred * (rstd * self.scale) + self.bias


class GroupNorm1(nn.Module):
    """flax ``nn.GroupNorm(num_groups=1)`` over a channels-last tensor:
    statistics over every axis but the batch, per-channel affine."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        centred, rstd = _fast_norm(x, tuple(range(1, x.ndim)), self.eps)
        return centred * (rstd * self.scale) + self.bias


class AllHeadPReLULayerNorm(nn.Module):
    """Per-head PReLU, then a layer norm over (frequency, embedding) with a
    per-(head, frequency, embedding) affine. ``(B, T, F, heads * E)`` ->
    ``(B, heads, T, F, E)``."""

    def __init__(self, n_head, emb, n_freqs, eps=1e-5):
        super().__init__()
        self.n_head, self.emb, self.eps = n_head, emb, eps
        self.alpha = nn.Parameter(torch.full((n_head, 1, 1, 1), 0.25))
        self.gamma = nn.Parameter(torch.ones(n_head, 1, n_freqs, emb))
        self.beta = nn.Parameter(torch.zeros(n_head, 1, n_freqs, emb))

    def forward(self, x):
        batch, frames, freqs, _ = x.shape
        x = x.reshape(batch, frames, freqs, self.n_head, self.emb)
        x = x.permute(0, 3, 1, 2, 4)
        x = torch.where(x >= 0, x, self.alpha * x)
        mean = x.mean(dim=(3, 4), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(3, 4), keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.gamma \
            + self.beta


class LayerNormCF(nn.Module):
    """Layer norm over (frequency, channel) of ``(B, T, F, C)`` with a
    per-(frequency, channel) affine."""

    def __init__(self, channels, n_freqs, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, 1, n_freqs, channels))
        self.beta = nn.Parameter(torch.zeros(1, 1, n_freqs, channels))

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.gamma \
            + self.beta


class GridBlock(nn.Module):
    """Intra (sub-band, scan over frequency) BLSTM, inter (scan over time)
    BLSTM, then full-band self-attention over frames."""

    def __init__(self, emb_dim, emb_ks, emb_hs, n_freqs, hidden, n_head,
                 approx_qk_dim, eps=1e-5):
        super().__init__()
        if emb_ks != emb_hs:
            raise NotImplementedError(
                'emb_ks != emb_hs (overlapping unfolding) is not '
                'implemented; the default configuration uses emb_ks == '
                'emb_hs')
        self.ks, self.n_head = emb_ks, n_head
        width = emb_ks * emb_dim
        self.intra_norm = LayerNorm(emb_dim, eps)
        self.intra_rnn = BLSTM(width, hidden)
        self.intra_linear = nn.Linear(2 * hidden, width)
        self.inter_norm = LayerNorm(emb_dim, eps)
        self.inter_rnn = BLSTM(width, hidden)
        self.inter_linear = nn.Linear(2 * hidden, width)
        e_qk = math.ceil(approx_qk_dim / n_freqs)
        self.e_v = emb_dim // n_head
        self.attn_q = nn.Linear(emb_dim, n_head * e_qk)
        self.attn_k = nn.Linear(emb_dim, n_head * e_qk)
        self.attn_v = nn.Linear(emb_dim, n_head * self.e_v)
        self.attn_q_norm = AllHeadPReLULayerNorm(n_head, e_qk, n_freqs, eps)
        self.attn_k_norm = AllHeadPReLULayerNorm(n_head, e_qk, n_freqs, eps)
        self.attn_v_norm = AllHeadPReLULayerNorm(n_head, self.e_v, n_freqs,
                                                 eps)
        self.attn_proj = nn.Linear(n_head * self.e_v, emb_dim)
        self.attn_prelu = PReLU()
        self.attn_out_norm = LayerNormCF(emb_dim, n_freqs, eps)

    def forward(self, x):
        batch, old_t, old_f, ch = x.shape
        ks = self.ks
        x = nn.functional.pad(x, (0, 0, 0, -old_f % ks, 0, -old_t % ks))
        frames, freqs = x.shape[1], x.shape[2]

        # intra BLSTM: B*T rows scan over frequency
        h = self.intra_norm(x).reshape(batch * frames, freqs // ks, ks * ch)
        h = self.intra_linear(self.intra_rnn(h))
        x = x + h.reshape(batch, frames, freqs, ch)

        # inter BLSTM: B*F rows scan over frames
        swapped = x.transpose(1, 2)
        h = self.inter_norm(swapped).reshape(batch * freqs, frames // ks,
                                             ks * ch)
        h = self.inter_linear(self.inter_rnn(h))
        x = (swapped + h.reshape(batch, freqs, frames, ch)).transpose(1, 2)
        x = x[:, :old_t, :old_f]

        # full-band self-attention over frames
        q = self.attn_q_norm(self.attn_q(x))
        k = self.attn_k_norm(self.attn_k(x))
        v = self.attn_v_norm(self.attn_v(x))

        def flat(z):
            return z.reshape(z.shape[0] * z.shape[1], z.shape[2], -1)

        qf, kf, vf = flat(q), flat(k), flat(v)
        scale = qf.shape[-1] ** -0.5
        attn = torch.softmax(torch.matmul(qf, kf.transpose(1, 2)) * scale,
                             dim=-1)
        out = torch.matmul(attn, vf)     # (B * heads, T, F * E_v)
        out = out.reshape(batch, self.n_head, old_t, old_f, self.e_v)
        out = out.permute(0, 2, 3, 1, 4).reshape(
            batch, old_t, old_f, self.n_head * self.e_v)
        out = self.attn_out_norm(self.attn_prelu(self.attn_proj(out)))
        return x + out


@ModelRegistry.register('tfgridnet')
class TFGridNet(BreverBaseModel):
    """TF-GridNet on binaural input. ``criterion``, ``optimizer``,
    ``learning_rate`` and ``grad_clip`` are the training settings of the
    model's config; the learning rate halves on a validation plateau
    (``ReduceLROnPlateau``, factor 0.5, patience 3)."""

    #: the JAX package wraps this family's Adam in optax.inject_hyperparams,
    #: so its checkpoints carry the learning rate (training.py)
    injects_hyperparams = True

    def __init__(
        self,
        n_srcs: int = 1,
        n_fft: int = 256,
        stride: int = 128,
        window: str = 'hann',
        n_layers: int = 6,
        lstm_hidden_units: int = 128,
        attn_n_head: int = 4,
        attn_approx_qk_dim: int = 512,
        emb_dim: int = 32,
        emb_ks: int = 4,
        emb_hs: int = 4,
        activation: str = 'PReLU',
        eps: float = 1e-5,
        criterion: str = 'multiresyu',
        optimizer: str = 'adam',
        learning_rate: float = 0.001,
        grad_clip: float = 1.0,
        *,
        device,
    ):
        super().__init__()
        if activation != 'PReLU':
            raise NotImplementedError(
                f'activation {activation!r}: TF-GridNet uses PReLU')
        self.hparams = dict(
            n_srcs=n_srcs, n_fft=n_fft, stride=stride, window=window,
            n_layers=n_layers, lstm_hidden_units=lstm_hidden_units,
            attn_n_head=attn_n_head, attn_approx_qk_dim=attn_approx_qk_dim,
            emb_dim=emb_dim, emb_ks=emb_ks, emb_hs=emb_hs,
            activation=activation, eps=eps, criterion=criterion,
            optimizer=optimizer, learning_rate=learning_rate,
            grad_clip=grad_clip)
        self.n_srcs = n_srcs
        self.criterion = init_criterion(criterion)
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.scheduler = ReduceLROnPlateau(init_lr=learning_rate, factor=0.5,
                                           patience=3)
        self.stft = STFT(frame_length=n_fft, hop_length=stride,
                         window=window, normalized=False)
        n_freqs = n_fft // 2 + 1
        n_imics = 2
        self.embed = nn.Conv2d(2 * n_imics, emb_dim, 3, padding=1)
        self.embed_norm = GroupNorm1(emb_dim, eps)
        self.blocks = nn.ModuleList(
            GridBlock(emb_dim, emb_ks, emb_hs, n_freqs, lstm_hidden_units,
                      attn_n_head, attn_approx_qk_dim, eps)
            for _ in range(n_layers))
        # flax's stride-1 ConvTranspose (transpose_kernel=False, padding 1)
        # is this convolution, its kernel unflipped (convert.py)
        self.deconv = nn.Conv2d(emb_dim, 2 * n_srcs, 3, padding=1)
        self.to(device)

    @staticmethod
    def _conv(conv, x):
        """A channels-last ``(B, T, F, C)`` tensor through an NCHW conv."""
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _to_input(self, x):
        """(B, 2 mics, samples) -> (B, T, F, 4): real, then imaginary, of
        each mic."""
        spec = self.stft(x).transpose(-1, -2)             # (B, M, T, F)
        parts = torch.cat([spec.real, spec.imag], dim=1)
        return parts.permute(0, 2, 3, 1)

    def forward(self, x):
        """(B, 2, samples) -> (B, sources, samples)."""
        n_samples = x.shape[-1]
        x = x.to(self.embed.weight.dtype)   # float32 (float64 in references)
        std = x.std(dim=(1, 2), keepdim=True, correction=0)
        x = x / std.clamp_min(1e-8)
        h = self.embed_norm(self._conv(self.embed, self._to_input(x)))
        for block in self.blocks:
            h = block(h)
        out = self._conv(self.deconv, h)                  # (B, T, F, 2 S)
        batch, frames, freqs, _ = out.shape
        out = out.reshape(batch, frames, freqs, self.n_srcs, 2)
        out = out.permute(0, 3, 2, 1, 4)                  # (B, S, F, T, 2)
        spec = torch.complex(out[..., 0].contiguous(),
                             out[..., 1].contiguous())
        wav = self.stft.backward(spec)[..., :n_samples]
        return wav * std

    def to_flax(self, state_dict):
        return tfgridnet_state_dict_to_flax(state_dict)

    def from_flax(self, params):
        return tfgridnet_flax_to_state_dict(params)

    def loss(self, batch, lengths):
        """Per-item loss of a padded batch ``(B, sources, 2, samples)``:
        the mixture in, the channel mean of the other sources as labels."""
        labels = batch[:, 1:].mean(dim=-2)
        return self.criterion(self(batch[:, 0]), labels, lengths)

    def optimizer(self):
        if self.optimizer_name != 'adam':
            raise NotImplementedError(
                f'optimizer {self.optimizer_name!r}: the port trains with '
                'adam only')
        return Adam(self.learning_rate)

    def _enhance(self, x):
        out = self(x)
        return out[:, 0] if self.n_srcs == 1 else out

    def on_validate(self, val_loss):
        value = sum(val_loss.values()) if isinstance(val_loss, dict) \
            else val_loss
        new_lr = self.scheduler.step(value)
        return None if new_lr is None else {'learning_rate': new_lr}

    def extra_state(self):
        return {'scheduler': self.scheduler.state_dict()}

    def load_extra_state(self, state):
        if 'scheduler' in state:
            self.scheduler.load_state_dict(state['scheduler'])
