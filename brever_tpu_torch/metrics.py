"""Validation metrics of the port (counterpart of ``brever_tpu/metrics.py``):
``snr`` and ``sisnr``, the negated criteria, per item of a padded batch.

``stoi``, ``estoi`` and ``pesq`` have device twins
(:mod:`brever_tpu_torch.metrics_device`), which the trainer scores with when
``device_val_metrics`` is true, as the JAX trainer does. Their host twins
(float64, PESQ with per-utterance realignment) are not ported yet
(ROADMAP.md, Queue 1): without ``device_val_metrics`` the trainer refuses
them when it is built (:func:`check_metrics`), as the JAX trainer fails
loudly on a metric it cannot compute.
"""

import torch

from .criterion import CriterionRegistry
from .registry import Registry

MetricRegistry = Registry('metric')


def _batched(x, y, lengths):
    """``(B, T)`` tensors of one dtype on ``x``'s device (float64 stays
    float64, for reference runs; anything else becomes float32), ``(B,)``
    int64 lengths and whether the input was one ``(T,)`` item."""
    x = torch.as_tensor(x)
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.to(dtype)
    y = torch.as_tensor(y).to(device=x.device, dtype=dtype)
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
        lengths = torch.as_tensor(lengths, device=x.device).to(torch.int64)
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


def check_metrics(names, device_val_metrics=False):
    """Raise on the metrics the port cannot compute: the host metrics, and
    with ``device_val_metrics`` the device twins too."""
    from .metrics_device import DEVICE_METRICS
    known = set(MetricRegistry.keys())
    if device_val_metrics:
        known |= set(DEVICE_METRICS)
    missing = sorted(name for name in names if name not in known)
    if missing:
        raise NotImplementedError(
            f'validation metrics {missing} need host twins that are not '
            f'ported yet (ROADMAP.md, Queue 1); the port scores '
            f'{sorted(MetricRegistry.keys())} on the host and '
            f'{sorted(DEVICE_METRICS)} with device_val_metrics')
