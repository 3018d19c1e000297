"""Denoiser preconditioning (counterpart of
``brever_tpu/models/sgmse/preconditioning.py``): the cskip/cout/cin/
cshift/cnoise scalings that make the U-Net a denoiser ``D(x, y, sigma,
t)``, the score the solvers take, and the loss weight; ``richter``, ``edm``
and the ``edm-scaled-shift`` shift.

The U-Net runs in its parameters' dtype (bfloat16 under amp: its input
and noise conditioning are cast to it and its output back to the
spectrogram's real dtype), while the complex algebra around it and the
scalings stay float32, as ``brever_tpu/models/sgmse/preconditioning.py``
does it.
"""

import torch

from ..base import param_dtype


def _make_rules(sigma_data):
    return {
        'richter': dict(
            cskip=lambda sigma: 1.0,
            cout=lambda sigma, scaling, t: -scaling * sigma ** 2 / t,
            cin=lambda sigma, scaling: scaling,
            cshift=lambda y, cin, scaling: y,
            cnoise=lambda sigma, t: torch.log(t),
            weight=lambda sigma: 1 / sigma ** 2,
        ),
        'edm': dict(
            cskip=lambda sigma:
                sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2),
            cout=lambda sigma, scaling, t:
                sigma * sigma_data / torch.sqrt(sigma ** 2 + sigma_data ** 2),
            cin=lambda sigma, scaling:
                1 / torch.sqrt(sigma ** 2 + sigma_data ** 2),
            cshift=lambda y, cin, scaling: 0.0,
            cnoise=lambda sigma, t: torch.log(sigma) / 4,
            weight=lambda sigma:
                (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2,
        ),
        'edm-scaled-shift': dict(
            cshift=lambda y, cin, scaling: cin * y / scaling,
        ),
    }


class Preconditioning:
    """``__call__(x, y, sigma, t)``: ``x``, ``y`` complex ``(B, 1, F, T)``,
    ``sigma`` and ``t`` tensors that broadcast against them. The U-Net
    takes the channels-last stack ``[x_in.real, x_in.imag, y.real,
    y.imag]`` ``(B, F, T, 4)`` and returns ``(B, F, T, 2)``, the real and
    imaginary parts of its estimate."""

    def __init__(self, net, sde, cskip, cout, cin, cshift, cnoise, weight,
                 sigma_data):
        self.net = net
        self.sde = sde
        rules = _make_rules(sigma_data)
        for arg, choice in [('cskip', cskip), ('cout', cout), ('cin', cin),
                            ('cshift', cshift), ('cnoise', cnoise),
                            ('weight', weight)]:
            if choice not in rules or arg not in rules[choice]:
                raise ValueError(f'Invalid preconditioning {arg}: {choice}')
            setattr(self, arg, rules[choice][arg])

    def __call__(self, x, y, sigma, t, generator=None):
        scaling = self.sde.s(t)
        cin = self.cin(sigma, scaling)
        x_in = cin * x + self.cshift(y, cin, scaling)
        net_dtype = param_dtype(self.net)
        net_in = torch.stack([x_in[:, 0].real, x_in[:, 0].imag,
                              y[:, 0].real, y[:, 0].imag], dim=-1)
        net_out = self.net(net_in.to(net_dtype),
                           self.cnoise(sigma, t).to(net_dtype),
                           generator=generator).to(net_in.dtype)
        denoised = torch.complex(net_out[..., 0], net_out[..., 1])[:, None]
        return self.cskip(sigma) * x + self.cout(sigma, scaling, t) * denoised

    def score(self, x, y, sigma, t):
        d = self(x, y, sigma, t)
        return (d - x) / (self.sde.s(t) * sigma ** 2)
