"""FFNN mask estimator (counterpart of ``brever_tpu/models/ffnn.py``): a
binaural mel-feature stack (past-context stacking, decimation) into an MLP
that predicts an ideal ratio mask in the mel domain, taken back to the
STFT bins through the filterbank's ``backward`` when enhancing. The
default geometry has 1,509,440 parameters.

As in the JAX package the feature ``transform`` runs inside the loss, on
the model's device (the STFT is ``torch.fft``; the filterbank, the DCT and
the MLP are matrix products), and the static normaliser statistics are the
``stats`` collection: buffers ``mean`` and ``std`` of shape ``(input_size,
1)``, zeros and ones until ``pre_train`` sets them from the training set.
Dropout draws its mask from the generator the trainer hands to ``loss``
(flax's rule: keep with probability ``1 - p``, scale by ``1 / (1 - p)``).
"""

import logging

import numpy as np
import torch
from torch import nn

from ..convert import ffnn_flax_to_state_dict, ffnn_state_dict_to_flax
from ..criterion import init_criterion
from ..ops.features import FeatureExtractor, eps
from ..ops.stft import STFT, MelFilterbank
from ..optim import Adam
from .base import BreverBaseModel, ModelRegistry, param_dtype


class _MLP(nn.Module):
    """Dense layers over the feature axis of ``(batch, features, frames)``:
    ReLU and dropout after each hidden layer, a sigmoid at the end. The
    layers are ``Dense_i``, flax's names."""

    def __init__(self, input_size, hidden_layers, output_size, dropout):
        super().__init__()
        self.dropout = dropout
        sizes = [input_size, *hidden_layers, output_size]
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            dense = nn.Linear(sizes[i], sizes[i + 1])
            # flax's Dense initialisation: lecun normal, zero bias
            nn.init.normal_(dense.weight, std=sizes[i] ** -0.5)
            nn.init.zeros_(dense.bias)
            self.add_module(f'Dense_{i}', dense)

    def forward(self, x, generator=None):
        x = x.transpose(-1, -2)
        for i in range(self.n_layers):
            x = getattr(self, f'Dense_{i}')(x)
            if i == self.n_layers - 1:
                break
            x = torch.relu(x)
            if self.training and self.dropout > 0:
                # drawn in float32 whatever x's dtype: under amp the mask
                # is the float32 step's
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1 - self.dropout
                x = torch.where(keep, x / (1 - self.dropout), 0.0)
        return torch.sigmoid(x).transpose(-1, -2)


@ModelRegistry.register('ffnn')
class FFNN(BreverBaseModel):
    """FFNN on binaural input. ``criterion``, ``optimizer`` and
    ``learning_rate`` are the training settings of the model's config."""

    def __init__(
        self,
        fs: int = 16000,
        features: set[str] = {'logfbe'},
        stacks: int = 5,
        decimation: int = 1,
        stft_frame_length: int = 512,
        stft_hop_length: int = 256,
        stft_window: str = 'hann',
        mel_filters: int = 64,
        hidden_layers: list[int] = [1024, 1024],
        dropout: float = 0.2,
        normalization: str = 'static',
        criterion: str = 'mse',
        optimizer: str = 'adam',
        learning_rate: float = 0.0001,
        *,
        device,
    ):
        super().__init__()
        if normalization not in ('static', 'cumulative'):
            raise ValueError('unrecognized normalization type, got '
                             f'{normalization}')
        self.hparams = dict(
            fs=fs, features=set(features), stacks=stacks,
            decimation=decimation, stft_frame_length=stft_frame_length,
            stft_hop_length=stft_hop_length, stft_window=stft_window,
            mel_filters=mel_filters, hidden_layers=list(hidden_layers),
            dropout=dropout, normalization=normalization,
            criterion=criterion, optimizer=optimizer,
            learning_rate=learning_rate)
        self.criterion = init_criterion(criterion)
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.fs = fs
        self.stacks = stacks
        self.decimation = decimation
        self.normalization = normalization
        self.stft = STFT(frame_length=stft_frame_length,
                         hop_length=stft_hop_length, window=stft_window)
        self.mel_fb = MelFilterbank(n_filters=mel_filters,
                                    n_fft=stft_frame_length, fs=fs)
        self.feature_extractor = FeatureExtractor(
            features=features, mel_fb=self.mel_fb,
            hop_length=stft_hop_length, fs=fs)
        self.input_size = self.feature_extractor.n_features * (stacks + 1)
        self.output_size = mel_filters
        self.module = _MLP(self.input_size, hidden_layers, mel_filters,
                           dropout)
        self.register_buffer('mean', torch.zeros(self.input_size, 1))
        self.register_buffer('std', torch.ones(self.input_size, 1))
        self.to(device)

    # ------------------------------------------------------------------

    def transform(self, sources):
        """``(…, 2 sources, channels, samples)`` -> the stacked, decimated
        features and the IRM labels, concatenated on the feature axis."""
        unbatched = sources.ndim == 3
        if unbatched:
            sources = sources[None]
        spec = self.stft(sources)           # (B, S, C, bins, T)
        mix = spec[:, 0]
        foreground = spec[:, 1]
        background = mix - foreground
        feats = self.decimate(self.stack(self.feature_extractor(mix)))
        labels = self.decimate(self.irm(foreground.abs(), background.abs()))
        out = torch.cat([feats, labels], dim=-2)
        return out[0] if unbatched else out

    def irm(self, foreground_mag, background_mag):
        fg = self.mel_fb((foreground_mag ** 2).mean(dim=-3))
        bg = self.mel_fb((background_mag ** 2).mean(dim=-3))
        return (1 + bg / (fg + eps)) ** -0.5

    def stack(self, feats):
        """Append ``stacks`` past-context copies along the feature axis:
        copy ``i`` is the features ``i + 1`` frames back, frame 0 repeated
        where there is no past."""
        frames = torch.arange(feats.shape[-1], device=feats.device)
        parts = [feats]
        for i in range(self.stacks):
            parts.append(feats[..., torch.clamp(frames - (i + 1), min=0)])
        return torch.cat(parts, dim=-2)

    def decimate(self, x):
        return x[..., ::self.decimation]

    def normalize(self, x):
        if self.normalization == 'static':
            return (x - self.mean) / self.std
        count = torch.arange(1, x.shape[-1] + 1, device=x.device,
                             dtype=x.dtype)
        cum_mean = torch.cumsum(x, dim=-1) / count
        cum_var = torch.cumsum(x ** 2, dim=-1) / count - cum_mean ** 2
        return (x - cum_mean) / torch.sqrt(cum_var + 1e-4)

    def frame_lengths(self, lengths):
        """Frames of each item after decimation, ``ceil(frames /
        decimation)``."""
        frames = torch.ceil(torch.clamp(lengths - self.stft.frame_length,
                                        min=0) / self.stft.hop_length) + 1
        return torch.ceil(frames / self.decimation).to(torch.int64)

    # ------------------------------------------------------------------

    def to_flax(self, state_dict):
        return ffnn_state_dict_to_flax(state_dict)[0]

    def flax_aux(self, state_dict):
        return ffnn_state_dict_to_flax(state_dict)[1]

    def from_flax(self, params, aux=None):
        return ffnn_flax_to_state_dict(params, aux)

    def loss(self, batch, lengths, generator=None):
        """Per-item MSE of the predicted mask against the IRM labels over
        each item's frames (0 for an item of length 0); dropout in train
        mode draws from ``generator``. Under amp (a bfloat16 batch and
        parameters) the features are computed in float32 from the bf16
        batch, as the JAX package's complex STFT promotes them, and cast to
        :func:`param_dtype` at the STFT-to-network boundary, so the MLP runs
        in bfloat16; its mask is cast back to float32 for the loss."""
        data = self.transform(batch.float())
        inputs = self.normalize(data[:, :self.input_size])
        labels = data[:, self.input_size:]
        inputs = inputs.to(param_dtype(self.module))
        outputs = self.module(inputs, generator).float()
        frames = torch.where(lengths > 0, self.frame_lengths(lengths), 0)
        return self.criterion(outputs, labels, frames)

    def optimizer(self):
        if self.optimizer_name != 'adam':
            raise NotImplementedError(
                f'optimizer {self.optimizer_name!r}: the port trains with '
                'adam only')
        return Adam(self.learning_rate)

    def _enhance(self, x):
        """The mask of the channel features applied to the channels' mean
        spectrum; eval semantics (no dropout) whatever the module's mode."""
        length = x.shape[-1]
        spec = self.stft(x.to(self.mean.dtype))   # (B, 2, bins, T)
        feats = self.normalize(self.stack(self.feature_extractor(spec)))
        training = self.module.training
        self.module.eval()
        try:
            mask = self.module(feats)
        finally:
            self.module.train(training)
        out = self.stft.backward(spec.mean(dim=1) * self.mel_fb.backward(mask))
        return out[..., :length]

    # ------------------------------------------------------------------

    @torch.no_grad()
    def pre_train(self, dataset, dataloader, epochs):
        """Static normaliser statistics: the mean over the training items
        of each item's feature mean and mean power over its frames, summed
        per batch on the device and accumulated in float64 on the host;
        ``std = sqrt(E[power] - mean ** 2)`` in float64, stored float32.
        Nothing happens with ``cumulative`` normalisation."""
        if self.normalization != 'static':
            return
        logging.info('Calculating training statistics')
        device = self.mean.device
        mean_acc = np.zeros((self.input_size, 1))
        power_acc = np.zeros((self.input_size, 1))
        count = 0.0
        for batch, lengths in dataloader:
            if isinstance(batch, list):
                batch, lengths = batch[0], lengths[:, 0]
            batch = torch.as_tensor(batch, device=device,
                                    dtype=self.mean.dtype)
            lengths = torch.as_tensor(lengths, device=device)
            inputs = self.transform(batch)[:, :self.input_size]
            frames = self.frame_lengths(lengths)
            mask = (torch.arange(inputs.shape[-1], device=device)[None, None]
                    < frames[:, None, None]).to(inputs.dtype)
            denom = torch.clamp(frames, min=1)[:, None, None]
            valid = (lengths > 0).to(inputs.dtype)[:, None, None]
            mean = ((inputs * mask).sum(-1, keepdim=True) / denom
                    * valid).sum(0)
            power = ((inputs ** 2 * mask).sum(-1, keepdim=True) / denom
                     * valid).sum(0)
            mean_acc += mean.cpu().numpy()
            power_acc += power.cpu().numpy()
            count += float(valid.sum())
        mean = mean_acc / count
        std = np.sqrt(power_acc / count - mean ** 2)
        self.mean.copy_(torch.from_numpy(mean.astype(np.float32)))
        self.std.copy_(torch.from_numpy(std.astype(np.float32)))
