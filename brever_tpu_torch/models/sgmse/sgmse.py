"""SGMSE+: score-based diffusion speech enhancement (counterpart of
``brever_tpu/models/sgmse/sgmse.py``; Richter et al., IEEE/ACM TASLP 2023).

Works in the compressed complex STFT domain (``|X| ** 0.5 * 0.15``, the
Nyquist bin discarded). Training is the denoising loss with the
preconditioning's weight: t and complex noise are drawn from the trainer's
``torch.Generator``, the U-Net denoises ``x_0 - y + sigma n`` and the
``mse`` criterion compares its output with ``x_0 - y`` over each item's
frames. Inference runs the reverse-SDE solver (PC or EDM-Heun) from the
prior around the mixture. The default NCSN++ geometry (``sgmsep``) has
65,590,694 parameters, ``sgmsepm`` 27,756,186; ``idmse`` (the ADM
U-Net) 16,613,378 and ``idmselarge`` 70,995,586.

Under the trainer's bf16 amp the batch arrives in bfloat16: the mixture's
peak normalisation runs in it, the STFT widens to float32 (its window is
float32), t and the noise are drawn in float32, and the U-Net alone runs in
bfloat16 (:class:`.preconditioning.Preconditioning`), so the loss is
float32, as the JAX package's ``loss`` under its trainer's ``loss_fn``.
"""

import torch
import torch.nn.functional as F

from ...convert import sgmse_flax_to_state_dict, sgmse_state_dict_to_flax
from ...criterion import init_criterion
from ...ops.stft import STFT
from ...optim import Adam
from ..base import BreverBaseModel, ModelRegistry
from .net import DiffusionUNet
from .preconditioning import Preconditioning
from .sdes import SDERegistry, randn_like
from .solvers import SolverRegistry


@ModelRegistry.register('sgmsep')
class SGMSEp(BreverBaseModel):

    def __init__(
        self,
        stft_frame_length: int = 512,
        stft_hop_length: int = 128,
        stft_window: str = 'hann',
        stft_compression_factor: float = 0.5,
        stft_scale_factor: float = 0.15,
        stft_discard_nyquist: bool = True,
        sde_name: str = 'richter-ouve',
        sde_stiffness: float = 1.5,
        sde_ve_sigma_min: float = 0.05,
        sde_ve_sigma_max: float = 0.5,
        sde_vp_beta_min: float = 0.01,
        sde_vp_beta_max: float = 1.0,
        sde_cosine_lambda_min: float = -12.0,
        sde_cosine_lambda_max: float = float('inf'),
        sde_cosine_shift: float = 3.0,
        sde_cosine_beta_clamp: float = 10.0,
        sde_bb_scaling: float = 0.1,
        sde_bb_k: float = 10.0,
        solver_name: str = 'pc',
        solver_num_steps: int = 16,
        solver_edm_schurn: float = float('inf'),
        solver_edm_smin: float = 0.0,
        solver_edm_smax: float = float('inf'),
        solver_edm_snoise: float = 1.0,
        solver_pc_corrector_steps: int = 1,
        solver_pc_corrector_snr: float = 0.5,
        net_base_channels: int = 128,
        net_channel_mult: list[int] = [1, 1, 2, 2, 2, 2, 2],
        net_num_blocks_per_res: int = 2,
        net_noise_channel_mult: int = 2,
        net_emb_channel_mult: int = 4,
        net_fir_kernel: list[int] = [1, 3, 3, 1],
        net_attn_resolutions: list[int] = [16],
        net_attn_bottleneck: bool = True,
        net_encoder_type: str = 'skip',
        net_decoder_type: str = 'skip',
        net_block_type: str = 'ncsn',
        net_skip_scale: float = 0.5 ** 0.5,
        net_dropout: float = 0.0,
        net_aux_out_channels: int = 4,
        preconditioning_cskip: str = 'richter',
        preconditioning_cout: str = 'richter',
        preconditioning_cin: str = 'richter',
        preconditioning_cnoise: str = 'richter',
        preconditioning_cshift: str = 'richter',
        preconditioning_weight: str = 'richter',
        preconditioning_sigma_data: float = 0.1,
        t_eps: float = 0.01,
        criterion: str = 'mse',
        optimizer: str = 'adam',
        learning_rate: float = 0.0001,
        *,
        device,
    ):
        hparams = {k: v for k, v in locals().items()
                   if k not in ('self', 'device', '__class__')}
        super().__init__()
        self.hparams = hparams
        self.criterion = init_criterion(criterion)
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.t_eps = t_eps
        self.stft = STFT(frame_length=stft_frame_length,
                         hop_length=stft_hop_length, window=stft_window,
                         compression_factor=stft_compression_factor,
                         scale_factor=stft_scale_factor, normalized=False)
        self.stft_discard_nyquist = stft_discard_nyquist
        self.sde = SDERegistry.get(sde_name)(
            stiffness=sde_stiffness, sigma_min=sde_ve_sigma_min,
            sigma_max=sde_ve_sigma_max, beta_min=sde_vp_beta_min,
            beta_max=sde_vp_beta_max, lambda_min=sde_cosine_lambda_min,
            lambda_max=sde_cosine_lambda_max, shift=sde_cosine_shift,
            beta_clamp=sde_cosine_beta_clamp, scaling=sde_bb_scaling,
            k=sde_bb_k)
        self.solver = SolverRegistry.get(solver_name)(
            num_steps=solver_num_steps, schurn=solver_edm_schurn,
            smin=solver_edm_smin, smax=solver_edm_smax,
            snoise=solver_edm_snoise,
            corrector_steps=solver_pc_corrector_steps,
            corrector_snr=solver_pc_corrector_snr)
        self.net = DiffusionUNet(
            num_freqs=stft_frame_length // 2,
            base_channels=net_base_channels,
            channel_mult=tuple(net_channel_mult),
            num_blocks_per_res=net_num_blocks_per_res,
            noise_channel_mult=net_noise_channel_mult,
            emb_channel_mult=net_emb_channel_mult,
            fir_kernel=tuple(net_fir_kernel),
            attn_resolutions=tuple(net_attn_resolutions),
            attn_bottleneck=net_attn_bottleneck,
            encoder_type=net_encoder_type, decoder_type=net_decoder_type,
            block_type=net_block_type, skip_scale=net_skip_scale,
            dropout=net_dropout, aux_out_channels=net_aux_out_channels)
        self.model = Preconditioning(
            net=self.net, sde=self.sde, cskip=preconditioning_cskip,
            cout=preconditioning_cout, cin=preconditioning_cin,
            cnoise=preconditioning_cnoise, cshift=preconditioning_cshift,
            weight=preconditioning_weight,
            sigma_data=preconditioning_sigma_data)
        self.to(device)

    def to_flax(self, state_dict):
        return sgmse_state_dict_to_flax(state_dict)[0]

    def flax_aux(self, state_dict):
        return sgmse_state_dict_to_flax(state_dict)[1]

    def from_flax(self, params, aux=None):
        return sgmse_flax_to_state_dict(params, aux)

    def optimizer(self):
        if self.optimizer_name != 'adam':
            raise NotImplementedError(
                f'optimizer {self.optimizer_name!r}: the port trains with '
                'adam only')
        return Adam(self.learning_rate)

    def _spec(self, mono):
        spec = self.stft(mono)
        return spec[..., :-1, :] if self.stft_discard_nyquist else spec

    def transform(self, sources):
        """``(B, 2, channels, samples)`` -> the compressed complex STFT
        pair ``(B, 2, F, T)``, both scaled by the mixture's peak."""
        mono = sources.mean(dim=-2)
        norm = mono[:, :1].abs().amax(dim=-1, keepdim=True)
        return self._spec(mono / norm.clamp_min(1e-10))

    def _frame_lengths(self, lengths):
        """Frames of each item, with the center padding's ``n_fft //
        hop`` more; 0 for a padding row."""
        n_fft, hop = self.stft.frame_length, self.stft.hop_length
        frames = torch.ceil((lengths - n_fft).clamp_min(0) / hop) + 1
        return torch.where(lengths > 0, frames + n_fft // hop,
                           torch.zeros_like(frames)).to(torch.int32)

    def loss(self, batch, lengths, generator=None):
        """Per-item denoising loss of a padded batch ``(B, 2, channels,
        samples)`` (mixture, then target): ``t`` uniform in ``[t_eps, 1)``
        and the complex noise, both drawn in float32 from ``generator``."""
        spec = self.transform(batch)
        real = spec.real.dtype
        t = torch.rand((spec.shape[0], 1, 1, 1), generator=generator,
                       device=spec.device).to(real)
        t = t * (1 - self.t_eps) + self.t_eps
        noise = randn_like(spec[:, 1:], generator)
        return self._loss(spec, lengths, t, noise, generator)

    def loss_at(self, batch, lengths, t, noise):
        """:meth:`loss` at a given ``t (B, 1, 1, 1)`` and complex noise
        ``(B, 1, F, T)``."""
        return self._loss(self.transform(batch), lengths, t, noise, None)

    def _loss(self, spec, lengths, t, noise, generator):
        y, x_0 = spec[:, :1], spec[:, 1:]
        sigma = self.sde.sigma(t)
        weight = self.model.weight(sigma)
        d = self.model(x_0 - y + sigma * noise, y, sigma, t,
                       generator=generator)
        return self.criterion(d, x_0 - y, self._frame_lengths(lengths),
                              weight=weight.reshape(-1))

    def _enhance(self, x, generator=None):
        """``(B, 2, samples) -> (B, samples)``. The solver's noise comes
        from ``generator``, by default a generator of the model's device
        seeded with 0. The JAX package draws from ``PRNGKey(0)``: the two
        give other numbers, so the two packages' outputs are two draws."""
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        x = x.to(self.net.input_conv.weight.dtype)
        length = x.shape[-1]
        mono = x.mean(dim=-2, keepdim=True)
        norm = mono.abs().amax(dim=-1, keepdim=True)
        spec = self._spec(mono / norm.clamp_min(1e-10))
        out, _ = self.solver(self.sde, spec, self.model, generator)
        if self.stft_discard_nyquist:
            out = F.pad(out, (0, 0, 0, 1))
        wav = self.stft.backward(out) * norm
        return wav[..., :length][:, 0]


@ModelRegistry.register('sgmsepm')
class SGMSEpM(SGMSEp):
    """Lighter U-Net variant (Lemercier et al., ICASSP 2023)."""

    def __init__(self, net_channel_mult: list[int] = [1, 2, 2, 2],
                 net_num_blocks_per_res: int = 1,
                 net_attn_resolutions: list[int] = [], *, device, **kwargs):
        super().__init__(net_channel_mult=net_channel_mult,
                         net_num_blocks_per_res=net_num_blocks_per_res,
                         net_attn_resolutions=net_attn_resolutions,
                         device=device, **kwargs)


_HEUN = dict(sde_name='brever-oucosine', sde_stiffness=0.0, solver_name='edm',
             **{f'preconditioning_{k}': 'edm' for k in (
                 'cskip', 'cout', 'cin', 'cnoise', 'cshift', 'weight')})


@ModelRegistry.register('sgmsepheun')
class SGMSEpHeun(SGMSEp):
    """SGMSE+ with the cosine SDE, EDM preconditioning and Heun solver."""

    def __init__(self, *, device, **kwargs):
        super().__init__(device=device, **{**_HEUN, **kwargs})


@ModelRegistry.register('sgmsepmheun')
class SGMSEpMHeun(SGMSEpM):

    def __init__(self, *, device, **kwargs):
        super().__init__(device=device, **{**_HEUN, **kwargs})


@ModelRegistry.register('idmse')
class IDMSE(SGMSEp):
    """Interpolation diffusion with the ADM backbone: the cosine SDE, EDM
    preconditioning and Heun solver over a U-Net of ``adm`` blocks with
    ``standard`` encoder and decoder (16,613,378 parameters)."""

    def __init__(self, net_base_channels: int = 64,
                 net_channel_mult: list[int] = [1, 2, 3, 4],
                 net_num_blocks_per_res: int = 1,
                 net_noise_channel_mult: int = 1,
                 net_fir_kernel: list[int] = [1, 1],
                 net_attn_resolutions: list[int] = [], *, device, **kwargs):
        super().__init__(device=device, **{
            **_HEUN, 'net_base_channels': net_base_channels,
            'net_channel_mult': net_channel_mult,
            'net_num_blocks_per_res': net_num_blocks_per_res,
            'net_noise_channel_mult': net_noise_channel_mult,
            'net_fir_kernel': net_fir_kernel,
            'net_attn_resolutions': net_attn_resolutions,
            'net_encoder_type': 'standard', 'net_decoder_type': 'standard',
            'net_block_type': 'adm', **kwargs})


@ModelRegistry.register('idmselarge')
class IDMSELarge(IDMSE):
    """IDMSE with the NCSN++-sized backbone (70,995,586 parameters)."""

    def __init__(self, net_base_channels: int = 128,
                 net_channel_mult: list[int] = [1, 1, 2, 2, 2, 2, 2],
                 net_num_blocks_per_res: int = 2,
                 net_noise_channel_mult: int = 2,
                 net_fir_kernel: list[int] = [1, 3, 3, 1],
                 net_attn_resolutions: list[int] = [16], *, device,
                 **kwargs):
        super().__init__(net_base_channels=net_base_channels,
                         net_channel_mult=net_channel_mult,
                         net_num_blocks_per_res=net_num_blocks_per_res,
                         net_noise_channel_mult=net_noise_channel_mult,
                         net_fir_kernel=net_fir_kernel,
                         net_attn_resolutions=net_attn_resolutions,
                         device=device, **kwargs)
