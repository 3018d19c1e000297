"""Validation metrics of the port (counterpart of ``brever_tpu/metrics.py``):
``snr`` and ``sisnr``, the negated criteria, per item of a padded batch.

``pesq`` and ``estoi`` are not ported yet (ROADMAP.md, Queue 1): the
trainer refuses them when it is built (:func:`check_metrics`), as the JAX
trainer fails loudly on a metric it cannot compute.
"""

import torch

from .criterion import CriterionRegistry
from .registry import Registry

MetricRegistry = Registry('metric')


def _batched(x, y, lengths):
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if x.shape != y.shape:
        raise ValueError(f'inputs must have same shape, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    unbatched = x.ndim == 1
    if unbatched:
        x, y = x[None], y[None]
    if x.ndim != 2:
        raise ValueError(f'input must be 1 or 2 dimensional, got {x.ndim}')
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[-1], device=x.device)
    else:
        lengths = torch.as_tensor(lengths, device=x.device)
        if lengths.shape != (x.shape[0],) or (lengths > x.shape[-1]).any():
            raise ValueError(f'lengths {lengths.tolist()} do not fit a batch '
                             f'of shape {tuple(x.shape)}')
    return x, y, lengths, unbatched


def _metric(criterion):
    def metric(x, y, lengths=None):
        x, y, lengths, unbatched = _batched(x, y, lengths)
        out = -CriterionRegistry.get(criterion)(x[:, None], y[:, None],
                                                lengths)
        return float(out[0]) if unbatched else out
    metric.__name__ = criterion
    metric.__doc__ = (f'Negated ``{criterion}`` criterion of ``(B, L)`` '
                      'estimates against targets: ``(B,)`` in dB.')
    return MetricRegistry.register(criterion)(metric)


snr = _metric('snr')
sisnr = _metric('sisnr')


def check_metrics(names):
    """Raise on the metrics the port cannot compute."""
    missing = sorted(name for name in names if name not in MetricRegistry)
    if missing:
        raise NotImplementedError(
            f'validation metrics {missing} are not ported yet (ROADMAP.md, '
            f'Queue 1); the port scores {sorted(MetricRegistry.keys())}')
