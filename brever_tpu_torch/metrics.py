"""Objective metrics of the port (counterpart of ``brever_tpu/metrics.py``),
under the JAX registry's names: ``stoi``, ``estoi``, ``pesq`` (also
``pesq_approx``), ``snr`` and ``sisnr``, per item of a padded batch.

``stoi``, ``estoi`` and ``pesq`` are the host twins, float64 numpy on the
CPU (:mod:`brever_tpu_torch.stoi`, :mod:`brever_tpu_torch.pesq`: PESQ with
its utterance alignment and bad-interval realignment), the authority for
test-set scores (``python -m brever_tpu_torch.test_model``). They take numpy
arrays or tensors of any device (copied to the host) and return numpy
arrays; ``batched`` scores the items through the spawn pool. ``snr`` and
``sisnr`` are the negated criteria in torch, on the input's device.

The device twins of ``stoi``, ``estoi`` and ``pesq``
(:mod:`brever_tpu_torch.metrics_device`) score validation batches on the
card when the trainer's ``device_val_metrics`` is true, as in the JAX
trainer; the host twins score them otherwise.
"""

import numpy as np
import torch

from .criterion import CriterionRegistry
from .registry import Registry

MetricRegistry = Registry('metric')

#: the published hard bounds of MOS-LQO, by mode, that ``normalized`` maps
#: onto [0, 1]
PESQ_BOUNDS = {'nb': (1.0, 4.548638319075995),
               'wb': (1.0, 4.643888749336258)}


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stoi(x, y, fs, extended, batched, lengths):
    """STOI or ESTOI of 1-D signals or of the rows of 2-D batches."""
    from .stoi import stoi_batch, stoi_single
    x, y, lengths = _to_numpy(x), _to_numpy(y), _to_numpy(lengths)
    if x.ndim == 1:
        if lengths is not None and not batched:
            raise ValueError('Non-batched stoi does not support lengths '
                             'argument for 1D inputs.')
        return stoi_single(x, y, fs, extended)
    if batched:
        return stoi_batch(x, y, fs, extended, lengths)
    if lengths is None:
        lengths = [x.shape[-1]] * x.shape[0]
    return np.array([
        stoi_single(xi[:n], yi[:n], fs, extended)
        for xi, yi, n in zip(x, y, lengths)
    ])


@MetricRegistry.register('stoi')
def stoi(x, y, fs=16000, batched=True, lengths=None):
    """Short-time objective intelligibility (x = estimate, y = clean)."""
    return _stoi(x, y, fs, False, batched, lengths)


@MetricRegistry.register('estoi')
def estoi(x, y, fs=16000, batched=True, lengths=None):
    """Extended STOI."""
    return _stoi(x, y, fs, True, batched, lengths)


@MetricRegistry.register('pesq')
@MetricRegistry.register('pesq_approx')
def pesq(x, y, fs=16000, mode='wb', normalized=False, batched=True,
         lengths=None):
    """PESQ MOS-LQO (x = estimate, y = clean reference), by the JAX
    package's P.862 / P.862.2 implementation (not bit-compatible with the
    ITU reference code; hence the second name, ``pesq_approx``).
    ``batched`` scores the items through the spawn pool;
    ``normalized`` maps MOS-LQO onto [0, 1] by the mode's published bounds
    and raises ``RuntimeError`` on a score outside them."""
    from . import pesq as pesq_mod

    x, y, lengths = _to_numpy(x), _to_numpy(y), _to_numpy(lengths)
    if batched:
        out = np.array(pesq_mod.pesq_batch(fs, y, x, mode=mode,
                                           lengths=lengths))
        if x.ndim == 1:
            out = out.item()
    elif x.ndim == 1:
        if lengths is not None:
            raise ValueError('Non-batched pesq does not support lengths '
                             'argument for 1D inputs.')
        out = pesq_mod.pesq(fs, y, x, mode=mode)
    else:
        if lengths is None:
            lengths = [x.shape[-1]] * x.shape[0]
        out = np.array([
            pesq_mod.pesq(fs, yi[:n], xi[:n], mode=mode)
            for xi, yi, n in zip(x, y, lengths)
        ])
    if normalized:
        if mode not in PESQ_BOUNDS:
            raise ValueError(f"mode must be 'nb' or 'wb', got '{mode}'")
        lo, hi = PESQ_BOUNDS[mode]
        out = (out - lo) / (hi - lo)
        if np.any(np.asarray(out) < 0) or np.any(np.asarray(out) > 1):
            raise RuntimeError(
                f'normalized PESQ score is out of bounds: {out}')
    return out


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
    """Raise ``KeyError`` on a metric name that the registry (and, with
    ``device_val_metrics``, the device twins) does not know, as the JAX
    trainer's registry lookup does."""
    from .metrics_device import DEVICE_METRICS
    known = set(MetricRegistry.keys())
    if device_val_metrics:
        known |= set(DEVICE_METRICS)
    missing = sorted(name for name in names if name not in known)
    if missing:
        raise KeyError(f'validation metrics {missing} are not in the metric '
                       f'registry; available: {sorted(known)}')
