"""MANNER: multi-view attention network for time-domain enhancement
(counterpart of ``brever_tpu/models/manner.py``; Park et al., ICASSP 2022,
the small variant).

A convolutional U-Net over the raw waveform (depth 4, stride 4, hidden 60,
channel growth 2) with residual Conformer blocks (:class:`_ResConBlock`)
and, at the deepest encoder and decoder level, a three-branch multi-view
attention block (channel attention, chunked global self-attention, chunked
local attention); the default geometry has 21,253,921 parameters. The loss
is an energy-weighted L1 between the clean and the noise estimates plus a
three-resolution STFT loss; the learning rate follows optax's
``cosine_onecycle_schedule`` over the run, stepped per update.

The trunk is channels first, ``(B, C, T)``, PyTorch's layout (the JAX
package keeps channels last); the JAX package's space-to-depth packing
(``BREVER_MANNER_PACK``, off by default) is a TPU layout and is not ported.
Every BatchNorm is :class:`..common.BatchNormAct` (69 in a forward): in
train mode its statistics go through flash-BN, the CUDA kernels K7-BN and
K8-BN on the card; in eval mode the running statistics' affine.

bf16 (amp): the trunk runs in the parameters' dtype, the convolutions with
their weights cast to the input's dtype and every train-mode BatchNorm
through K7-BN/K8-BN's bf16 route; the input's std is taken in float32 and
cast for the division, and the output, rescaled by that float32 std, leaves
the network in float32, as the JAX package's does, so the loss's STFTs and
sums run in float32 (the JAX package's ``loss``; the batch's energies stay
bfloat16). Convolutions
are cuDNN's, the attention's products ``torch.matmul``, as the JAX package
leaves them to XLA. Module and parameter names follow the flax scopes
(``enc_0_rescon.pw1_bn``, ``dec_3_attn.global.wq``), so the weight bridge
(``convert.manner_*``) renames nothing.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import manner_flax_to_state_dict, manner_state_dict_to_flax
from ..ops.stft import STFT, overlap_add
from ..optim import Adam, cosine_onecycle_schedule
from .base import BreverBaseModel, ModelRegistry
from .common import BatchNormAct, stats_input


def _lecun(shape, fan_in):
    """flax's ``lecun_normal``: a normal truncated at two deviations, of
    variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=std,
                                              a=-2 * std, b=2 * std))


class _Conv(nn.Module):
    """flax ``nn.Conv`` (or ``DepthwiseConv1D`` with ``groups = C``) over
    ``(B, C, T)``: ``weight (out, in / groups, k)``, symmetric padding."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1,
                 bias=True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = _lecun((cout, cin // groups, kernel),
                             kernel * cin // groups)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, groups=self.groups)


class _ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``padding='VALID'``): ``weight (in, out,
    k)`` of ``conv_transpose1d``, which is the flax kernel flipped in time
    (the bridge flips it)."""

    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.stride = stride
        self.weight = _lecun((cin, cout, kernel), kernel * cin)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride)


class _BasicConv(nn.Module):
    """Conv without bias, then BatchNorm with ReLU (or no activation)."""

    def __init__(self, cin, cout, kernel=1, stride=1, padding=0, relu=True):
        super().__init__()
        self.conv = _Conv(cin, cout, kernel, stride, padding, bias=False)
        self.bn = BatchNormAct(cout, 'relu' if relu else 'none')

    def forward(self, x):
        return self.bn(self.conv(x))


class _ResConBlock(nn.Module):
    """Residual Conformer block: pointwise conv + BN + GLU, depthwise conv
    (kernel 31) + BN + SiLU, pointwise conv + BN + SiLU, a BasicConv, plus a
    BasicConv shortcut, then ReLU."""

    def __init__(self, in_channels, growth1=2, growth2=2, kernel=31):
        super().__init__()
        out1, out2 = int(in_channels * growth1), int(in_channels * growth2)
        pad = (kernel - 1) // 2
        self.pw1 = _Conv(in_channels, out1, 1)
        self.pw1_bn = BatchNormAct(out1)
        self.depthwise = _Conv(in_channels, in_channels, kernel,
                               padding=pad, groups=in_channels, bias=False)
        self.dw_bn = BatchNormAct(in_channels, 'silu')
        self.pw2 = _Conv(in_channels, out2, 1)
        self.pw2_bn = BatchNormAct(out2, 'silu')
        self.out_conv = _BasicConv(out2, out2, relu=False)
        self.shortcut = _BasicConv(in_channels, out2, relu=False)

    def forward(self, x):
        h = self.pw1_bn(self.pw1(x))
        a, b = h.chunk(2, dim=1)
        h = a * torch.sigmoid(b)                      # GLU over channels
        h = self.dw_bn(self.depthwise(h))
        h = self.pw2_bn(self.pw2(h))
        return torch.relu(self.out_conv(h) + self.shortcut(x))


def _chunk(x, chunk, hop):
    """``(B, C, T)`` -> ``(B, C, P, chunk)``: ``chunk`` zeros on both sides,
    then frames of ``chunk`` at ``hop``."""
    return F.pad(x, (chunk, chunk)).unfold(-1, chunk, hop)


def _unchunk(chunks, chunk, hop, length):
    """Inverse of :func:`_chunk`: the overlap-add of ``(B, C, P, chunk)``,
    trimmed to ``length`` and divided by ``chunk / hop``."""
    folded = overlap_add(chunks, hop, length + 2 * chunk)
    return folded[..., chunk:chunk + length] / (chunk / hop)


class _ChannelAttention(nn.Module):
    """A sigmoid gate per channel from an MLP of the max and the mean over
    time (the padded time axis, as in the JAX package)."""

    def __init__(self, channels):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // 2)
        self.Dense_1 = nn.Linear(channels // 2, channels)

    def _fc(self, v):
        return self.Dense_1(torch.relu(self.Dense_0(v)))

    def forward(self, x):
        gate = torch.sigmoid(self._fc(x.amax(dim=-1))
                             + self._fc(x.mean(dim=-1)))
        return x * gate[..., None]


class _GlobalAttention(nn.Module):
    """Multi-head self-attention across chunks (tokens = chunks, features =
    the chunk's samples), no biases, ``d_k = d_model n_head``."""

    def __init__(self, n_head, d_model):
        super().__init__()
        self.n_head, self.d_k = n_head, d_model * n_head
        width = n_head * self.d_k
        self.wq = nn.Linear(d_model, width, bias=False)
        self.wk = nn.Linear(d_model, width, bias=False)
        self.wv = nn.Linear(d_model, width, bias=False)
        self.fc = nn.Linear(width, d_model, bias=False)

    def forward(self, x):
        b, p, _ = x.shape

        def heads(z):
            return z.reshape(b, p, self.n_head, self.d_k).transpose(1, 2)

        q, k, v = heads(self.wq(x)), heads(self.wk(x)), heads(self.wv(x))
        attn = torch.softmax(torch.matmul(q / self.d_k ** 0.5,
                                          k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, p, -1)
        return self.fc(out)


class _LocalAttention(nn.Module):
    """Within each chunk: depthwise conv (kernel 31) + BN + SiLU, then a
    sigmoid gate over time from a conv of the channels' max and mean (its
    BatchNorm has one channel)."""

    def __init__(self, channels):
        super().__init__()
        self.depthwise = _Conv(channels, channels, 31, padding=15,
                               groups=channels, bias=False)
        self.dw_bn = BatchNormAct(channels, 'silu')
        self.gate_conv = _BasicConv(2, 1, kernel=7, padding=3, relu=False)

    def forward(self, x):
        # x: (B, C, P, chunk) -> one row per chunk, (B P, C, chunk)
        b, ch, p, chunk = x.shape
        h = x.transpose(1, 2).reshape(b * p, ch, chunk)
        h = self.dw_bn(self.depthwise(h))
        pooled = torch.stack([h.amax(dim=1), h.mean(dim=1)], dim=1)
        gate = torch.sigmoid(self.gate_conv(pooled))      # (B P, 1, chunk)
        return x * gate.reshape(b, p, 1, chunk).transpose(1, 2)


class _MultiviewAttention(nn.Module):
    """Channel, global and local attention over a third of the channels
    each, merged, gated, plus a shortcut."""

    def __init__(self, channels, segment_len, head):
        super().__init__()
        inter = channels // 3
        self.segment_len = segment_len
        for i in range(3):
            self.add_module(f'in{i}', _BasicConv(channels, inter))
            self.add_module(f'out{i}', _BasicConv(inter, inter, 3,
                                                  padding=1))
        self.channel = _ChannelAttention(inter)
        self.add_module('global', _GlobalAttention(head, segment_len))
        self.local = _LocalAttention(inter)
        self.merge = _BasicConv(3 * inter, channels, relu=False)
        self.shortcut = _BasicConv(channels, channels, relu=False)
        self.gate_tanh = _Conv(channels, channels, 1)
        self.gate_sig = _Conv(channels, channels, 1)
        self.gate_out = _Conv(channels, channels, 1)

    def forward(self, x):
        chunk = self.segment_len
        hop = chunk // 2
        b, _, t = x.shape
        x0 = self.channel(self.in0(x))
        c1 = _chunk(self.in1(x), chunk, hop)            # (B, C', P, chunk)
        inter, p = c1.shape[1], c1.shape[2]
        tokens = getattr(self, 'global')(c1.reshape(b * inter, p, chunk))
        x1 = _unchunk(tokens.reshape(b, inter, p, chunk), chunk, hop, t)
        c2 = self.local(_chunk(self.in2(x), chunk, hop))
        x2 = _unchunk(c2, chunk, hop, t)
        out = self.merge(torch.cat([self.out0(x0), self.out1(x1),
                                    self.out2(x2)], dim=1))
        gated = torch.tanh(self.gate_tanh(out)) \
            * torch.sigmoid(self.gate_sig(out))
        return self.shortcut(x) + torch.relu(self.gate_out(gated))


class _MannerModule(nn.Module):
    """The network: ``(B, 1, samples)`` -> ``(B, 1, samples)``."""

    def __init__(self, in_channels=1, out_channels=1, hidden=60, depth=4,
                 kernel_size=8, stride=4, growth=2, head=1, segment_len=64,
                 eps=1e-3):
        super().__init__()
        self.depth, self.kernel_size, self.stride = depth, kernel_size, stride
        self.eps = eps
        self.in_conv = _Conv(in_channels, hidden, 3, padding=1)
        self.in_bn = BatchNormAct(hidden, 'relu')
        in_ch, out_ch, cin = in_channels * hidden, out_channels * growth, \
            hidden
        enc_channels = []
        for layer in range(depth):
            self.add_module(f'enc_{layer}_down',
                            _Conv(cin, in_ch, kernel_size, stride))
            self.add_module(f'enc_{layer}_bn', BatchNormAct(in_ch, 'relu'))
            self.add_module(f'enc_{layer}_rescon', _ResConBlock(in_ch, 2, 2))
            cin = 2 * in_ch
            if layer == depth - 1:
                self.add_module(f'enc_{layer}_attn', _MultiviewAttention(
                    out_ch * hidden, segment_len, head))
            enc_channels.append((in_ch, out_ch * hidden))
            in_ch = hidden * 2 ** (layer + 1)
            out_ch *= growth
        self.linear = nn.Linear(cin, hidden * growth ** depth, bias=False)
        for layer in reversed(range(depth)):
            dec_in, dec_out = enc_channels[layer][1], enc_channels[layer][0]
            self.add_module(f'dec_{layer}_rescon',
                            _ResConBlock(dec_in, 2, 0.5))
            self.add_module(f'dec_{layer}_up', _ConvTranspose(
                int(dec_in * 0.5), dec_out, kernel_size, stride))
            self.add_module(f'dec_{layer}_up_bn',
                            BatchNormAct(dec_out, 'relu'))
            if layer == depth - 1:
                self.add_module(f'dec_{layer}_attn', _MultiviewAttention(
                    dec_out, segment_len, head))
        self.mask_tanh = _Conv(hidden, hidden, 1)
        self.mask_sig = _Conv(hidden, hidden, 1)
        self.mask_out = _Conv(hidden, hidden, 1)
        self.out_conv = _Conv(hidden, out_channels, 3, padding=1)

    def _padded_length(self, length):
        for _ in range(self.depth):
            length = math.ceil((length - self.kernel_size) / self.stride) + 1
            length = max(length, 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride + self.kernel_size
        return int(math.ceil(length))

    def forward(self, x):
        # the input's std over time, of the channel mean, in float32 (a
        # bfloat16 input widened), cast for the division
        std = stats_input(x).mean(dim=1, keepdim=True).std(
            dim=-1, keepdim=True, correction=0)
        x = x / (self.eps + std.to(x.dtype))
        length = x.shape[-1]
        x = F.pad(x, (0, self._padded_length(length) - length))
        h = self.in_bn(self.in_conv(x))
        enc_out, skips = h, []
        for layer in range(self.depth):
            h = getattr(self, f'enc_{layer}_bn')(
                getattr(self, f'enc_{layer}_down')(h))
            h = getattr(self, f'enc_{layer}_rescon')(h)
            if layer == self.depth - 1:
                h = getattr(self, f'enc_{layer}_attn')(h)
            skips.append(h)
        h = torch.relu(self.linear(h.transpose(1, 2))).transpose(1, 2)
        for layer in reversed(range(self.depth)):
            skip = skips.pop()
            h = h + skip[..., :h.shape[-1]]
            h = getattr(self, f'dec_{layer}_rescon')(h)
            h = getattr(self, f'dec_{layer}_up_bn')(
                getattr(self, f'dec_{layer}_up')(h))
            if layer == self.depth - 1:
                h = getattr(self, f'dec_{layer}_attn')(h)
        mask = torch.tanh(self.mask_tanh(h)) * torch.sigmoid(self.mask_sig(h))
        h = self.out_conv(enc_out * torch.relu(self.mask_out(mask)))
        return std * h[..., :length]


#: the kernels' std that ``rescale_convs`` aims at, the upstream default
_RESCALE_REFERENCE = 0.1


def rescale_convs(module):
    """The upstream ``rescale_module``, as the JAX package's ``_rescale``:
    every 3-D convolution kernel (the ``(k, in, out)`` kernels of the flax
    tree: convolutions, transposed and depthwise ones) and its bias divided
    by ``sqrt(std(kernel) / 0.1)``, in place."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (_Conv, _ConvTranspose)):
                scale = torch.sqrt(sub.weight.std(correction=0)
                                   / _RESCALE_REFERENCE)
                sub.weight.div_(scale)
                if sub.bias is not None:
                    sub.bias.div_(scale)


@ModelRegistry.register('manner')
class MANNER(BreverBaseModel):
    """MANNER on binaural input (the channel mean is enhanced). No
    hyperparameters, as in the JAX package. Adam over a one-cycle cosine
    schedule peaking at 1e-3, sized by ``prepare_optimizer`` (1e-5 without
    it); no gradient clipping."""

    def __init__(self, *, device):
        super().__init__()
        self.hparams = {}
        self.net = _MannerModule()
        self.learning_rate = 1e-5
        self.max_lr = 1e-3
        self.stft_loss_factors = (0.5, 0.5)   # spectral convergence, mag
        self.stft_losses = [
            STFT(frame_length=win, hop_length=hop, n_fft=fft, window='hann',
                 center=True, pad_mode='reflect', normalized=False)
            for fft, hop, win in
            [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]]
        self._schedule = None
        self.to(device)

    def init_parameters(self, seed):
        """The draw of :meth:`BreverBaseModel.init_parameters`, then
        :func:`rescale_convs`, as the JAX package's ``init_variables``."""
        super().init_parameters(seed)
        rescale_convs(self.net)

    def prepare_optimizer(self, steps_per_epoch, epochs):
        self._schedule = cosine_onecycle_schedule(
            max(steps_per_epoch * epochs, 1), self.max_lr)

    def optimizer(self):
        return Adam(self._schedule if self._schedule is not None
                    else self.learning_rate)

    def transform(self, sources):
        return sources.mean(dim=-2)     # binaural -> monaural

    def to_flax(self, state_dict):
        return manner_state_dict_to_flax(state_dict)[0]

    def flax_aux(self, state_dict):
        return manner_state_dict_to_flax(state_dict)[1]

    def from_flax(self, params, aux=None):
        return manner_flax_to_state_dict(params, aux)

    # ------------------------------------------------------------------

    def _mrstft_loss(self, x, y):
        """Per-item multi-resolution spectral convergence and log-magnitude
        L1 of the estimate ``x`` against the reference ``y``."""
        sc_total = mag_total = 0.0
        for stft in self.stft_losses:
            x_spec, y_spec = stft(x), stft(y)
            x_mag = torch.sqrt((x_spec.real ** 2 + x_spec.imag ** 2)
                               .clamp_min(1e-7))
            y_mag = torch.sqrt((y_spec.real ** 2 + y_spec.imag ** 2)
                               .clamp_min(1e-7))
            sc = torch.sqrt(((y_mag - x_mag) ** 2).sum(dim=(-2, -1))) \
                / torch.sqrt((y_mag ** 2).sum(dim=(-2, -1)))
            mag = (torch.log(y_mag) - torch.log(x_mag)).abs() \
                .mean(dim=(-2, -1))
            sc_total = sc_total + sc
            mag_total = mag_total + mag
        n = len(self.stft_losses)
        sc_f, mag_f = self.stft_loss_factors
        return sc_f * sc_total / n + mag_f * mag_total / n

    def loss(self, batch, lengths, generator=None):
        """Per-item loss of a padded batch ``(B, sources, 2, samples)``: the
        energy-weighted sum of the clean and the noise estimates' L1 plus
        multi-resolution STFT loss. ``lengths`` is not used, as in the JAX
        package: padding enters the loss. In train mode the batch norms
        update their running statistics."""
        mono = self.transform(batch)                 # (B, 2, samples)
        mix, clean = mono[:, :1], mono[:, 1]
        noise = mix[:, 0] - clean
        clean_est = self.net(mix)[:, 0]
        noise_est = mix[:, 0] - clean_est
        loss_c = (clean - clean_est).abs().mean(dim=-1) \
            + self._mrstft_loss(clean_est, clean)
        loss_n = (noise - noise_est).abs().mean(dim=-1) \
            + self._mrstft_loss(noise_est, noise)
        e_clean = (clean ** 2).sum(dim=-1)
        e_noise = (noise ** 2).sum(dim=-1)
        a = e_clean / (e_clean + e_noise + 2e-7)
        return a * loss_c + (1 - a) * loss_n

    def _enhance(self, x):
        """Enhancement with the running statistics, whatever the module's
        mode (the JAX model enhances with ``train=False``)."""
        training = self.training
        self.eval()
        x = x.to(self.net.in_conv.weight.dtype)   # float64 in references
        try:
            return self.net(x.mean(dim=-2, keepdim=True))[:, 0]
        finally:
            self.train(training)


#: the MANNER BatchNorms a forward runs (``batch_norm_act`` call sites at
#: the default depth 4: 1 + 4 x 6 encoder, 2 x 10 attention, 4 x 6 decoder)
N_BATCH_NORMS = 69


def count_batch_norms(module):
    """The :class:`BatchNormAct` modules of a MANNER network."""
    return sum(isinstance(m, BatchNormAct) for m in module.modules())

