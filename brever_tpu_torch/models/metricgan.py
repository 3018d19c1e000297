"""MetricGAN-OKD and MetricGAN+ (counterpart of
``brever_tpu/models/metricgan.py``; Shin et al., ICML 2023; Fu et al.,
INTERSPEECH 2021): N generators (BLSTM mask nets over the log-magnitude
STFT, one per target metric) and one CNN discriminator that regresses the
metric scores of (enhanced, clean) magnitude pairs. The default geometries
have 2,172,329 (``metricganokd``) and 1,914,524 (``metricganp``) parameters.

The generators' BLSTMs run through ``rnn._dispatch_scan_x``: a batch of B
items scans B rows, under the 128-row floor unless the items are shorter
than ~0.25 s, so the projection is one product and the scan K5/K6 (the
gates-in LSTM kernels) on CUDA, at H = 200 padded to 224.

The discriminator's layers are spectrally normalised as flax's
``nn.SpectralNorm`` does it (:class:`SpectralNorm`), not as
``torch.nn.utils.spectral_norm``: one power step on every call, in train and
eval mode alike, from the stored ``u``; ``u`` and ``sigma`` are stored only
in train mode. Its BatchNorm is the port's flax-semantics
:class:`~.common.BatchNorm` (momentum ``1 - batchnorm_momentum`` in flax's
terms). Both keep their state as buffers, the JAX package's
``batch_stats['discriminator']`` collection, and each discriminator call in
train mode takes the state the call before it left, in the JAX package's
order.

Training is the JAX package's GAN step (``make_step_fns``), on the trainer's
flat buffer, generators, and N + 1 optimizers (clip + Adam), one for each
generator's part of the buffer and one for the discriminator's:

1. candidates (no gradient): each generator's enhanced waveform in eval
   mode, and the clean signal with noise at an SNR drawn in
   ``[augment_snr_min, augment_snr_max]``;
2. their metric scores, the discriminator's regression targets: on the host
   by the float64 metrics (``_host_metrics``; the noisy signal's score comes
   with the batch when the loader's ``loader_transform`` computed it), or
   with ``device_metric_scoring`` by the device twins (``_device_metrics``);
3. each generator's update on its own loss (adversarial, plus ``kd_weight``
   times the distillation MSE to the other generators), all gradients taken
   at the step's parameters; the enhanced magnitudes recomputed by the
   updated generators; the discriminator's update from its step-start
   parameters.

The losses are plain means over the padded batch, as in the JAX package,
whose trainer pads every batch to a multiple of 8 rows: padding rows count.
The randomness (augmentation noise, dropout) draws from the trainer's
``torch.Generator``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import (metricgan_flax_to_state_dict,
                       metricgan_state_dict_to_flax)
from ..ops.stft import STFT
from ..optim import Adam, clip_by_global_norm
from .base import BreverBaseModel, ModelRegistry
from .common import BatchNorm
from .rnn import BLSTM, LSTM

#: the wideband PESQ bounds that map a device PESQ onto [0, 1], as the host
#: path's ``normalized``
PESQ_WB = (1.0, 4.643888749336258)


def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax ``nn.SpectralNorm`` of one layer's kernel: buffers ``u`` ``(1,
    out)`` and ``sigma`` ``()``. :meth:`forward` takes the kernel in flax's
    layout reshaped to ``(-1, out)`` and returns it divided by ``sigma``
    from one power step ``v = l2(u W^T)``, ``u = l2(v W)``, ``sigma = v W
    u^T`` (``u`` and ``v`` without gradient, eps 1e-12); it stores ``u`` and
    ``sigma`` when ``update_stats``."""

    def __init__(self, out_features, eps=1e-12):
        super().__init__()
        self.eps = eps
        self.register_buffer('u', torch.randn(1, out_features))
        self.register_buffer('sigma', torch.ones(()))

    def forward(self, kernel, update_stats):
        with torch.no_grad():
            v = _l2_normalize(self.u @ kernel.T, self.eps)
            u = _l2_normalize(v @ kernel, self.eps)
        sigma = (v @ kernel @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return kernel / torch.where(sigma != 0, sigma, 1.0)


def _dense(in_features, out_features):
    dense = nn.Linear(in_features, out_features)
    # flax's Dense initialisation: lecun normal, zero bias
    nn.init.normal_(dense.weight, std=in_features ** -0.5)
    nn.init.zeros_(dense.bias)
    return dense


class _Generator(nn.Module):
    """BLSTM (or LSTM) layers with dropout between them, leaky-ReLU dense
    layers and a learned-slope sigmoid mask, floored at ``min_mask``, over a
    ``(B, F, T)`` magnitude."""

    def __init__(self, lstm_in_size, lstm_hidden_size, lstm_num_layers,
                 lstm_dropout, lstm_bidirectional, fc_channels,
                 min_mask=0.05, sigmoid_beta=1.2):
        super().__init__()
        self.lstm_dropout = lstm_dropout
        self.min_mask = min_mask
        self.sigmoid_beta = sigmoid_beta
        self.lstm_names = []
        width = lstm_in_size
        for i in range(lstm_num_layers):
            if lstm_bidirectional:
                name = f'blstm_{i}'
                self.add_module(name, BLSTM(width, lstm_hidden_size))
                width = 2 * lstm_hidden_size
            else:
                name = f'lstm_{i}'
                self.add_module(name, LSTM(width, lstm_hidden_size))
                width = lstm_hidden_size
            self.lstm_names.append(name)
        self.n_fc = len(fc_channels)
        for i, ch in enumerate(fc_channels):
            self.add_module(f'fc_{i}', _dense(width, ch))
            width = ch
        self.fc_out = _dense(width, lstm_in_size)
        self.sigmoid_alpha = nn.Parameter(torch.ones(lstm_in_size))

    def forward(self, noisy_mag, train=False, generator=None):
        x = noisy_mag.transpose(-1, -2)                   # (B, T, F)
        for i, name in enumerate(self.lstm_names):
            x = getattr(self, name)(x)
            if i != len(self.lstm_names) - 1 and train \
                    and self.lstm_dropout > 0:
                # flax's Dropout: keep with probability 1 - p, scale
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device, dtype=x.dtype) \
                    < 1 - self.lstm_dropout
                x = torch.where(keep, x / (1 - self.lstm_dropout), 0.0)
        for i in range(self.n_fc):
            x = F.leaky_relu(getattr(self, f'fc_{i}')(x), 0.3)
        x = self.fc_out(x)
        mask = self.sigmoid_beta * torch.sigmoid(self.sigmoid_alpha * x)
        return noisy_mag * torch.clamp(mask.transpose(-1, -2),
                                       min=self.min_mask)


class _Discriminator(nn.Module):
    """The (input, clean) magnitude pair as a 2-channel ``(B, 2, T, F)``
    image: BatchNorm, spectrally normalised 5 x 5 VALID convolutions with
    leaky ReLU, a global average pool, spectrally normalised dense layers;
    ``(B, out_size)`` scores. ``spectral[k]`` normalises the k-th layer of
    ``layer_names`` (flax's ``SpectralNorm_k``)."""

    def __init__(self, out_size, conv_channels, fc_channels, batchnorm,
                 batchnorm_momentum, sigmoid_output):
        super().__init__()
        self.sigmoid_output = sigmoid_output
        self.norm = BatchNorm(2, momentum=1 - batchnorm_momentum, eps=1e-5) \
            if batchnorm else None
        self.n_conv, self.n_fc = len(conv_channels), len(fc_channels)
        width = 2
        for i, ch in enumerate(conv_channels):
            conv = nn.Conv2d(width, ch, 5)
            nn.init.normal_(conv.weight, std=(25 * width) ** -0.5)
            nn.init.zeros_(conv.bias)
            self.add_module(f'conv_{i}', conv)
            width = ch
        for i, ch in enumerate(fc_channels):
            self.add_module(f'fc_{i}', _dense(width, ch))
            width = ch
        self.fc_out = _dense(width, out_size)
        self.layer_names = ([f'conv_{i}' for i in range(self.n_conv)]
                            + [f'fc_{i}' for i in range(self.n_fc)]
                            + ['fc_out'])
        self.spectral = nn.ModuleList(
            SpectralNorm(getattr(self, name).weight.shape[0])
            for name in self.layer_names)

    def _dense(self, k, x, train):
        layer = getattr(self, self.layer_names[k])
        kernel = self.spectral[k](layer.weight.T, train)   # flax (in, out)
        return x @ kernel + layer.bias

    def forward(self, input_mag, clean_mag, train=False):
        x = torch.stack([input_mag, clean_mag], dim=1).transpose(2, 3)
        if self.norm is not None:
            self.norm.train(train)
            x = self.norm(x)
        for k in range(self.n_conv):
            conv = getattr(self, f'conv_{k}')
            out, cin, kh, kw = conv.weight.shape
            # flax's HWIO kernel as (kh kw cin, out), normalised, back
            kernel = self.spectral[k](
                conv.weight.permute(2, 3, 1, 0).reshape(-1, out), train)
            weight = kernel.reshape(kh, kw, cin, out).permute(3, 2, 0, 1)
            x = F.leaky_relu(F.conv2d(x, weight, conv.bias), 0.3)
        x = x.mean(dim=(2, 3))                              # global pool
        for k in range(self.n_conv, self.n_conv + self.n_fc):
            x = F.leaky_relu(self._dense(k, x, train), 0.3)
        x = self._dense(len(self.layer_names) - 1, x, train)
        return torch.sigmoid(x) if self.sigmoid_output else x


def _device_metrics(metric_names, fs):
    """The device scorer, twin of :func:`_host_metrics`: ``(deg, ref,
    lengths)`` tensors -> ``(B, n_metrics)`` float32 in [0, 1] on their
    device, without gradient."""

    @torch.no_grad()
    def score(deg, ref, lengths):
        from ..metrics_device import DEVICE_METRICS
        lengths = torch.clamp(torch.as_tensor(lengths, device=deg.device),
                              min=1)
        cols = []
        for name in metric_names:
            fn = DEVICE_METRICS[name]
            if name in ('pesq', 'pesq_approx'):
                lo, hi = PESQ_WB
                v = (fn(deg, ref, lengths=lengths, fs=fs) - lo) / (hi - lo)
            elif name in ('snr', 'sisnr'):
                v = fn(deg, ref, lengths=lengths)
            else:
                v = fn(deg, ref, lengths=lengths, fs=fs)
            cols.append(v)
        out = torch.stack(cols, dim=1)
        return torch.clamp(torch.nan_to_num(out), 0.0, 1.0).float()

    return score


def _host_metrics(metric_names, fs):
    """The host scorer: ``(deg, ref, lengths)`` numpy -> ``(B, n_metrics)``
    float32 in [0, 1] (PESQ normalised by its wideband bounds; a metric
    that raises scores 0 for the batch)."""
    from ..metrics import MetricRegistry

    def score(deg, ref, lengths):
        deg = np.asarray(deg, dtype=np.float64)
        ref = np.asarray(ref, dtype=np.float64)
        lengths = np.maximum(np.asarray(lengths), 1)
        cols = []
        for name in metric_names:
            metric = MetricRegistry.get(name)
            kwargs = {'normalized': True} if name == 'pesq' else {}
            try:
                values = metric(deg, ref, fs, lengths=lengths, **kwargs)
            except (RuntimeError, ValueError):
                values = np.zeros(deg.shape[0])
            cols.append(np.asarray(values, dtype=np.float32))
        out = np.stack(cols, axis=1)
        return np.clip(np.nan_to_num(out), 0.0, 1.0).astype(np.float32)

    return score


@ModelRegistry.register('metricganokd')
class MetricGANOKD(BreverBaseModel):
    """MetricGAN-OKD. ``xavier_init``, ``precompute_stft``,
    ``adversarial_loss`` and ``kd_loss`` are accepted and ignored, as in the
    JAX package (MSE losses)."""

    def __init__(
        self,
        stft_frame_length: int = 512,
        stft_hop_length: int = 256,
        stft_n_fft: int = 512,
        stft_normalized: bool = False,
        stft_window: str = 'hamming',
        generator_lstm_hidden_size: int = 200,
        generator_lstm_num_layers: int = 2,
        generator_lstm_dropout: float = 0.1,
        generator_lstm_bidirectional: bool = True,
        generator_fc_channels: list[int] = [300],
        generator_optimizer: str = 'adam',
        generator_learning_rate: float = 1e-4,
        discriminator_conv_channels: list[int] = [16, 32, 64, 128],
        discriminator_fc_channels: list[int] = [50, 10],
        discriminator_batchnorm: bool = True,
        discriminator_batchnorm_momentum: float = 0.01,
        discriminator_sigmoid_output: bool = False,
        discriminator_optimizer: str = 'adam',
        discriminator_learning_rate: float = 1e-4,
        discriminator_train_clean: bool = False,
        augment: bool = True,
        augment_snr_min: float = 15.0,
        augment_snr_max: float = 55.0,
        target_metrics: list[str] = ['pesq'],
        inference_metric: str = 'pesq',
        xavier_init: bool = True,
        precompute_stft: bool = True,
        precompute_metric: bool = True,
        mag_eps: float = 1e-14,
        min_mask: float = 0.05,
        adversarial_loss: str = 'MSELoss',
        kd_loss: str = 'MSELoss',
        kd_weight: float = 10.0,
        grad_clip: float = 5.0,
        fs: int = 16000,
        device_metric_scoring: bool = False,
        *,
        device,
    ):
        super().__init__()
        if inference_metric not in target_metrics:
            raise ValueError(
                'inference_metric must be one of target_metrics, got '
                f"'{inference_metric}' and {target_metrics}")
        self.hparams = dict(
            stft_frame_length=stft_frame_length,
            stft_hop_length=stft_hop_length, stft_n_fft=stft_n_fft,
            stft_normalized=stft_normalized, stft_window=stft_window,
            generator_lstm_hidden_size=generator_lstm_hidden_size,
            generator_lstm_num_layers=generator_lstm_num_layers,
            generator_lstm_dropout=generator_lstm_dropout,
            generator_lstm_bidirectional=generator_lstm_bidirectional,
            generator_fc_channels=list(generator_fc_channels),
            generator_optimizer=generator_optimizer,
            generator_learning_rate=generator_learning_rate,
            discriminator_conv_channels=list(discriminator_conv_channels),
            discriminator_fc_channels=list(discriminator_fc_channels),
            discriminator_batchnorm=discriminator_batchnorm,
            discriminator_batchnorm_momentum=discriminator_batchnorm_momentum,
            discriminator_sigmoid_output=discriminator_sigmoid_output,
            discriminator_optimizer=discriminator_optimizer,
            discriminator_learning_rate=discriminator_learning_rate,
            discriminator_train_clean=discriminator_train_clean,
            augment=augment, augment_snr_min=augment_snr_min,
            augment_snr_max=augment_snr_max,
            target_metrics=list(target_metrics),
            inference_metric=inference_metric, xavier_init=xavier_init,
            precompute_stft=precompute_stft,
            precompute_metric=precompute_metric, mag_eps=mag_eps,
            min_mask=min_mask, adversarial_loss=adversarial_loss,
            kd_loss=kd_loss, kd_weight=kd_weight, grad_clip=grad_clip, fs=fs,
            device_metric_scoring=device_metric_scoring)
        self.stft = STFT(frame_length=stft_frame_length,
                         hop_length=stft_hop_length, n_fft=stft_n_fft,
                         window=stft_window, normalized=stft_normalized)
        self.target_metrics = list(target_metrics)
        self.inference_metric_idx = self.target_metrics.index(
            inference_metric)
        self.n_generators = len(target_metrics)
        self.generators = nn.ModuleList(
            _Generator(
                lstm_in_size=stft_n_fft // 2 + 1,
                lstm_hidden_size=generator_lstm_hidden_size,
                lstm_num_layers=generator_lstm_num_layers,
                lstm_dropout=generator_lstm_dropout,
                lstm_bidirectional=generator_lstm_bidirectional,
                fc_channels=tuple(generator_fc_channels),
                min_mask=min_mask)
            for _ in target_metrics)
        self.discriminator = _Discriminator(
            out_size=self.n_generators,
            conv_channels=tuple(discriminator_conv_channels),
            fc_channels=tuple(discriminator_fc_channels),
            batchnorm=discriminator_batchnorm,
            batchnorm_momentum=discriminator_batchnorm_momentum,
            sigmoid_output=discriminator_sigmoid_output)
        self.generator_optimizer = generator_optimizer
        self.generator_learning_rate = generator_learning_rate
        self.discriminator_optimizer = discriminator_optimizer
        self.discriminator_learning_rate = discriminator_learning_rate
        self.augment = augment
        self.augment_snr = (augment_snr_min, augment_snr_max)
        self.kd_weight = kd_weight
        self.mag_eps = mag_eps
        self.grad_clip = grad_clip
        self.fs = fs
        self._score = _host_metrics(self.target_metrics, fs)
        self.device_metric_scoring = device_metric_scoring
        self.precompute_metric = precompute_metric
        self.to(device)

    # ------------------------------------------------------------------
    # parameters and optimizers

    def to_flax(self, state_dict):
        return metricgan_state_dict_to_flax(state_dict)[0]

    def flax_aux(self, state_dict):
        return metricgan_state_dict_to_flax(state_dict)[1]

    def from_flax(self, params, aux=None):
        return metricgan_flax_to_state_dict(params, aux)

    def optimizer_parts(self):
        parts = {f'generator_{i}': g for i, g in enumerate(self.generators)}
        parts['discriminator'] = self.discriminator
        return parts

    def optimizer(self):
        """``{'generators': [Adam, ...], 'discriminator': Adam}``, each
        naming its part (the trainer adds the ``grad_clip`` clipping to
        each, as the JAX package chains it)."""
        for name in (self.generator_optimizer, self.discriminator_optimizer):
            if name != 'adam':
                raise NotImplementedError(
                    f'optimizer {name!r}: the port trains with adam only')
        generators = []
        for i in range(self.n_generators):
            opt = Adam(self.generator_learning_rate)
            opt.part = f'generator_{i}'
            generators.append(opt)
        discriminator = Adam(self.discriminator_learning_rate)
        discriminator.part = 'discriminator'
        return {'generators': generators, 'discriminator': discriminator}

    def transform(self, sources):
        return sources.mean(dim=-2)  # binaural -> monaural

    @property
    def loader_transform(self):
        """The per-item precompute of the training loader (host numpy):
        ``sources (2, channels, T)`` -> ``(mono (2, T), score (n_metrics,))``
        with the noisy signal's score against the clean one, so that the
        step scores only the enhanced and augmented candidates; None
        without ``precompute_metric``."""
        if not self.precompute_metric:
            return None

        def fn(sources):
            mono = np.asarray(sources, dtype=np.float32).mean(axis=-2)
            score = self._score(mono[0:1], mono[1:2],
                                np.array([mono.shape[-1]]))[0]
            return mono, score

        return fn

    # ------------------------------------------------------------------
    # signal path

    def _stft_mag_phase(self, x):
        spec = self.stft(x)
        return torch.log1p(spec.abs() + self.mag_eps), torch.angle(spec)

    def _istft(self, mag, phase, orig_length):
        mag = torch.expm1(mag)
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return self.stft.backward(spec)[..., :orig_length]

    def _split_batch(self, batch):
        """``(noisy, clean)`` mono of a raw ``(B, 2, channels, T)`` batch or
        of a loader-transformed ``[mono (B, 2, T), noisy_score]``."""
        wavs = batch[0] if isinstance(batch, (list, tuple)) else batch
        mono = self.transform(wavs) if wavs.ndim == 4 else wavs
        return mono[:, 0], mono[:, 1]

    def _enhance(self, x):
        """The inference metric's generator on the channels' mean, in the
        model's dtype (float64 for reference runs)."""
        mono = x.mean(dim=-2).to(self.discriminator.fc_out.weight.dtype)
        mag, phase = self._stft_mag_phase(mono)
        enh_mag = self.generators[self.inference_metric_idx](mag)
        return self._istft(enh_mag, phase, mono.shape[-1])

    def loss(self, batch, lengths, generator=None):
        raise NotImplementedError(
            'MetricGAN uses custom train/val steps (make_step_fns)')

    # ------------------------------------------------------------------
    # the GAN step's phases

    @torch.no_grad()
    def make_candidates(self, batch, generator):
        """Phase 1: ``(noisy_wav, clean_wav, enh_wavs (N, B, T), aug_wav)``,
        everything the scorer needs."""
        noisy_wav, clean_wav = self._split_batch(batch)
        noisy_mag, noisy_phase = self._stft_mag_phase(noisy_wav)
        enh_wavs = [self._istft(g(noisy_mag), noisy_phase,
                                noisy_wav.shape[-1])
                    for g in self.generators]
        aug_wav = clean_wav
        if self.augment:
            lo, hi = self.augment_snr
            snr = torch.rand((clean_wav.shape[0], 1), generator=generator,
                             device=clean_wav.device) * (hi - lo) + lo
            noise_std = clean_wav.std(dim=1, keepdim=True, correction=0) \
                * 10 ** (-snr / 20)
            aug_wav = clean_wav + noise_std * torch.randn(
                clean_wav.shape, generator=generator,
                device=clean_wav.device)
        return noisy_wav, clean_wav, torch.stack(enh_wavs), aug_wav

    def score_candidates(self, batch, lengths, candidates):
        """Phase 2: ``{'noisy', 'enh' (N, B, n), 'aug'}`` regression
        targets on the model's device, by the host scorer (one batched call
        for each generator's candidates and one for the augmented ones; the
        noisy score from the batch when the loader computed it) or, with
        ``device_metric_scoring``, by the device twins."""
        noisy_wav, clean_wav, enh_wavs, aug_wav = candidates
        l1 = lengths[:, 0] if lengths.ndim > 1 else lengths
        precomputed = isinstance(batch, (list, tuple))
        if self.device_metric_scoring:
            score = _device_metrics(self.target_metrics, self.fs)
            scores = {'enh': torch.stack([score(e, clean_wav, l1)
                                          for e in enh_wavs])}
            scores['noisy'] = batch[1].float() if precomputed \
                else score(noisy_wav, clean_wav, l1)
            if self.augment:
                scores['aug'] = score(aug_wav, clean_wav, l1)
            return scores
        device = clean_wav.device
        clean_np = clean_wav.cpu().numpy()
        l1_np = l1.cpu().numpy()

        def host(wav):
            return torch.from_numpy(self._score(wav.cpu().numpy(), clean_np,
                                                l1_np)).to(device)

        scores = {'noisy': batch[1].float() if precomputed
                  else host(noisy_wav)}
        scores['enh'] = torch.stack([host(e) for e in enh_wavs])
        if self.augment:
            scores['aug'] = host(aug_wav)
        return scores

    def _generator_losses(self, noisy_mag, clean_mag, train, generator=None,
                          only=None):
        """Each generator's loss (adversarial against the discriminator in
        eval mode, plus the distillation MSE to the others) and the enhanced
        magnitudes; ``only`` keeps one generator's loss and runs the others
        without gradient."""
        enh_mags = []
        for i, g in enumerate(self.generators):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and only in (None, i)):
                enh_mags.append(g(noisy_mag, train, generator))
        losses = []
        for i, enh_mag in enumerate(enh_mags):
            if only is not None and i != only:
                continue
            scores = self.discriminator(enh_mag, clean_mag, train=False)
            adv = ((scores[:, i] - 1.0) ** 2).mean()
            kd = sum(((enh_mag - other) ** 2).mean()
                     for j, other in enumerate(enh_mags) if j != i)
            losses.append(adv + self.kd_weight * kd)
        return losses, enh_mags

    def _discriminator_loss(self, noisy_mag, clean_mag, enh_mags, aug_wav,
                            scores, train):
        """The discriminator's regression loss on the noisy, each enhanced
        and the augmented magnitudes; in train mode each call takes the
        BatchNorm and spectral-norm state the call before left."""
        total = 0.0
        for k, enh_mag in enumerate(enh_mags):
            enh_mag = enh_mag.detach()
            pred = self.discriminator(noisy_mag, clean_mag, train=train)
            total = total + ((pred - scores['noisy']) ** 2).mean()
            pred = self.discriminator(enh_mag, clean_mag, train=train)
            total = total + ((pred - scores['enh'][k]) ** 2).mean()
            if self.augment:
                with torch.no_grad():
                    aug_mag, _ = self._stft_mag_phase(aug_wav)
                pred = self.discriminator(aug_mag, clean_mag, train=train)
                total = total + ((pred - scores['aug']) ** 2).mean()
        return total

    def update(self, trainer, batch, scores, aug_wav):
        """Phase 3 on ``trainer``'s flat buffer and optimizers: each
        generator's update, then the discriminator's; returns ``{'loss_g':
        mean of the generators' losses, 'loss_d'}`` (device scalars)."""
        noisy_wav, clean_wav = self._split_batch(batch)
        with torch.no_grad():
            noisy_mag, _ = self._stft_mag_phase(noisy_wav)
            clean_mag, _ = self._stft_mag_phase(clean_wav)
        grads, gen_losses = [], []
        for i, g in enumerate(self.generators):
            (loss,), _ = self._generator_losses(
                noisy_mag, clean_mag, True, trainer.generator, only=i)
            grads.append(torch.cat([d.reshape(-1) for d in torch.autograd
                                    .grad(loss, list(g.parameters()))]))
            gen_losses.append(loss.detach())
        # every generator's gradient was taken at the step's parameters
        for i, grad in enumerate(grads):
            self._optimizer_step(trainer, trainer.optimizer['generators'][i],
                                 grad)
        with torch.no_grad():
            _, enh_mags = self._generator_losses(noisy_mag, clean_mag, False)
        loss_d = self._discriminator_loss(noisy_mag, clean_mag, enh_mags,
                                          aug_wav, scores, True)
        grad = torch.autograd.grad(loss_d, list(
            self.discriminator.parameters()))
        self._optimizer_step(trainer, trainer.optimizer['discriminator'],
                    torch.cat([d.reshape(-1) for d in grad]))
        return {'loss_g': torch.stack(gen_losses).mean(),
                'loss_d': loss_d.detach()}

    @staticmethod
    def _optimizer_step(trainer, optimizer, grad):
        if trainer.grad_clip:
            grad = clip_by_global_norm(grad, trainer.grad_clip)
        optimizer.step(trainer.flat[trainer.parts[optimizer.part]], grad)

    @torch.no_grad()
    def val_losses(self, batch, scores, aug_wav):
        """The validation losses: every module in eval mode, no state
        stored."""
        noisy_wav, clean_wav = self._split_batch(batch)
        noisy_mag, _ = self._stft_mag_phase(noisy_wav)
        clean_mag, _ = self._stft_mag_phase(clean_wav)
        losses, enh_mags = self._generator_losses(noisy_mag, clean_mag, False)
        loss_d = self._discriminator_loss(noisy_mag, clean_mag, enh_mags,
                                          aug_wav, scores, False)
        return {'loss_g': torch.stack(losses).mean(), 'loss_d': loss_d}

    def make_step_fns(self, trainer):
        """The GAN train and validation steps on ``trainer``: candidates,
        their scores, then the updates (or the validation losses); the
        candidates' noise from the trainer's generator (validation: its
        validation generator)."""

        def train_step(batch, lengths):
            candidates = self.make_candidates(batch, trainer.generator)
            scores = self.score_candidates(batch, lengths, candidates)
            return self.update(trainer, batch, scores, candidates[3])

        def val_step(batch, lengths):
            candidates = self.make_candidates(batch, trainer.val_generator)
            scores = self.score_candidates(batch, lengths, candidates)
            return self.val_losses(batch, scores, candidates[3])

        return train_step, val_step


@ModelRegistry.register('metricganp')
class MetricGANp(MetricGANOKD):
    """MetricGAN+ (one metric, no distillation by construction)."""

    def __init__(
        self,
        generator_lstm_dropout: float = 0.0,
        discriminator_conv_channels: list[int] = [15, 15, 15, 15],
        **kwargs,
    ):
        super().__init__(
            generator_lstm_dropout=generator_lstm_dropout,
            discriminator_conv_channels=discriminator_conv_channels,
            **kwargs,
        )
