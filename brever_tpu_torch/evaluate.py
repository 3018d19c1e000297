"""Model evaluation on one device (counterpart of ``brever_tpu/evaluate.py``).

The JAX package shards evaluation: batches round-robin over processes, the
forward over a local mesh, the score arrays merged by an allgather. The port
runs one process on one device, so the same functions keep their names and
reduce: :func:`make_sharded_enhance` is the model's ``enhance`` on its
device, :func:`merge_scores` returns its input. Multi-GPU evaluation waits
for the port's DDP (ROADMAP.md, Queue 1).

The enhancement runs on the model's device (the card, unless the caller
asked for the CPU). Host metrics (``metrics.MetricRegistry``: float64 STOI,
ESTOI and PESQ, the authority for test-set scores) score numpy copies, so
the enhanced rows leave the device only when a host metric or ``on_batch``
needs them; with ``device_metrics`` a metric that has a device twin
(``metrics_device.DEVICE_METRICS``) scores on the device.
"""

import numpy as np
import torch

from .metrics import MetricRegistry

__all__ = ['make_sharded_enhance', 'evaluate_dataset', 'merge_scores']


def make_sharded_enhance(model):
    """``enhance(x)``: a host batch ``(B, channels, samples)`` enhanced on
    the model's device; returns the device tensor, ``(B, samples)`` (the
    first source of a separation model)."""

    def enhance(x):
        out = model.enhance(x)
        return out[:, 0] if out.ndim == 3 else out

    return enhance


def merge_scores(scores):
    """The global score array: one process holds all of it."""
    return scores


def evaluate_dataset(model, dataloader, metrics, n_items, on_batch=None,
                     device_metrics=False):
    """Score ``n_items`` mixtures with every metric in ``metrics``.

    Returns ``(n_items, len(metrics), 2)``: each mixture's input score (the
    mixture's channel mean against the target's) and output score (the
    enhanced signal against it). ``on_batch`` (optional) receives
    ``(indices, inputs_mono, output, lengths)`` of each batch as numpy
    arrays (signal dumping). ``device_metrics`` scores with the device twins
    where a metric has one; the host metrics are the default.
    """
    enhance = make_sharded_enhance(model)
    device = model.device
    twins = {}
    if device_metrics:
        from .metrics_device import DEVICE_METRICS
        twins = DEVICE_METRICS
    metric_fns = [(twins.get(m) or MetricRegistry.get(m), m in twins)
                  for m in metrics]
    need_host_out = on_batch is not None \
        or any(not on_device for _, on_device in metric_fns)

    scores = np.zeros((n_items, len(metrics), 2))
    start = 0
    for batch, lengths in dataloader:
        batch = np.asarray(batch)
        lengths = np.asarray(lengths)
        n = batch.shape[0]
        inputs = batch[:, 0]                       # (B, ch, samples)
        target_mono = batch[:, 1].mean(-2)
        inputs_mono = inputs.mean(-2)
        out_dev = enhance(inputs)
        out = out_dev.cpu().numpy() if need_host_out else None
        host = (inputs_mono, target_mono, lengths)
        dev = None
        for i_metric, (fn, on_device) in enumerate(metric_fns):
            if on_device:
                if dev is None:
                    dev = [torch.as_tensor(a, device=device) for a in host]
                x, y, n_dev = dev
                scores[start:start + n, i_metric, 0] = \
                    fn(x, y, lengths=n_dev).cpu().numpy()
                scores[start:start + n, i_metric, 1] = \
                    fn(out_dev, y, lengths=n_dev).cpu().numpy()
            else:
                scores[start:start + n, i_metric, 0] = np.asarray(
                    fn(inputs_mono, target_mono, lengths=lengths))
                scores[start:start + n, i_metric, 1] = np.asarray(
                    fn(out, target_mono, lengths=lengths))
        if on_batch is not None:
            on_batch(np.arange(start, start + n), inputs_mono, out, lengths)
        start += n
    return merge_scores(scores)
