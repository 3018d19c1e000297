"""Evaluate trained models on test datasets into ``scores.hdf5`` on a PyTorch
device (counterpart of ``scripts/test_model.py``).

For each model directory (or checkpoint) and each test set: the checkpoint
(``last.ckpt``, or the best one by ``--best <metric>``; its EMA parameters
where it has them, and its ``aux`` collections), the test set's mixtures in
sorted dynamic batches, and each mixture's input and output score of every
metric, written to ``<model_dir>/scores.hdf5`` as the dataset
``<checkpoint>/<test_set>`` of shape ``(mixtures, metrics, 2)`` with the
dimension labels ``mixture``/``metric``/``which``, the scales ``metrics``
and ``which`` (``input``, ``output``), and the root attribute
``pesq_implementation`` when a PESQ metric is scored. A pair already in the
file is skipped unless ``--force``. The model runs on ``--device`` (the
card by default); the host twins score (``--device_metrics``: the device
twins where a metric has one).

    python -m brever_tpu_torch.test_model -i <model_dir> [...] -t <test_set>
        [...] [--device cuda] [--metrics pesq stoi estoi snr sisnr]
        [--best <metric>] [--batch_size 20] [--force] [--output_dir DIR]

Writing the scores needs ``h5py``; without it the command refuses before
any enhancing.
"""

import argparse
import logging
import os
import sys

from .audio import write_wav
from .batching import SortedBatchSampler
from .config import get_config
from .data import BreverDataLoader, BreverDataset
from .evaluate import evaluate_dataset
from .metrics import MetricRegistry
from .numerics import disable_tf32
# the server's: the checkpoint's EMA parameters where it has them, and its
# aux collections, as the JAX script loads a model
from .serve import find_best_checkpoint, load_model

__all__ = ['find_best_checkpoint', 'load_model', 'test_model',
           'write_scores', 'main']

#: the root attribute of ``scores.hdf5`` that names the PESQ scored: the JAX
#: package's implementation, which :mod:`brever_tpu_torch.pesq` follows bit
#: for bit, so both packages label their files alike
PESQ_IMPLEMENTATION = (
    'brever_tpu.pesq (from-scratch P.862 approximation; not the canonical '
    'ITU-T C library)')


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError('test_model writes scores.hdf5 with h5py, which '
                          'is not installed') from None
    return h5py


def test_model(args, model, cfg, test_path, score_file, checkpoint_path,
               metrics, write=True):
    """Score one test set with ``model`` into ``score_file``; returns the
    scores ``(mixtures, metrics, 2)``, or None when the file already has
    them. ``write=False`` stops before the file (what a machine without
    h5py can run)."""
    checkpoint_name = os.path.basename(checkpoint_path)
    test_name = os.path.basename(os.path.normpath(test_path))
    h5path = f'{checkpoint_name}/{test_name}'

    if write and os.path.exists(score_file) and not args.force:
        with _h5py().File(score_file, 'r') as h5file:
            if h5path in h5file:
                logging.info(f'Model already tested on {test_path}')
                return None

    dataset = BreverDataset(
        path=test_path,
        segment_length=0.0,
        fs=cfg.dataset.fs,
        sources=cfg.dataset.sources,
    )
    sampler = SortedBatchSampler(
        dataset, batch_size=args.batch_size, shuffle=False, dynamic=True,
        reverse=True,
    )
    pad_to_multiple = round(args.pad_quantum * cfg.dataset.fs) \
        if args.pad_quantum else None
    dataloader = BreverDataLoader(dataset, sampler, num_workers=args.workers,
                                  pad_to_multiple=pad_to_multiple)

    on_batch = None
    if args.output_dir is not None:
        os.makedirs(args.output_dir, exist_ok=True)

        def on_batch(indices, inputs_mono, output, lengths):
            for name, data in [('input', inputs_mono), ('output', output)]:
                for i, idx in enumerate(indices):
                    write_wav(
                        os.path.join(args.output_dir,
                                     f'{idx:05d}_{name}.wav'),
                        data[i][:lengths[i]], cfg.dataset.fs)

    scores = evaluate_dataset(model, dataloader, metrics, len(dataset),
                              on_batch=on_batch,
                              device_metrics=args.device_metrics)

    logging.info('Average delta scores:')
    for i_metric, metric in enumerate(metrics):
        delta = (scores[:, i_metric, 1] - scores[:, i_metric, 0]).mean()
        logging.info(f'{metric}: {delta:.2e}')

    if write:
        write_scores(score_file, h5path, scores, metrics)
    return scores


def write_scores(score_file, h5path, scores, metrics):
    """Write one (mixtures, metrics, input/output) block to scores.hdf5
    with labelled dimension scales, the JAX script's layout."""
    h5py = _h5py()
    mode = 'a' if os.path.exists(score_file) else 'w'
    with h5py.File(score_file, mode) as h5file:
        if 'metrics' not in h5file:
            h5file['metrics'] = list(metrics)
            h5file['which'] = ['input', 'output']
        if h5path in h5file:
            h5file[h5path][...] = scores
            dset = h5file[h5path]
        else:
            dset = h5file.create_dataset(h5path, data=scores)
        dset.dims[0].label = 'mixture'
        dset.dims[1].label = 'metric'
        dset.dims[2].label = 'which'
        dset.dims[1].attach_scale(h5file['metrics'])
        dset.dims[2].attach_scale(h5file['which'])
        if any(m.startswith('pesq') for m in metrics):
            h5file.attrs['pesq_implementation'] = PESQ_IMPLEMENTATION


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='test a model')
    parser.add_argument('-i', '--inputs', nargs='+', required=True,
                        help='model directories or checkpoints')
    parser.add_argument('-t', '--tests', type=lambda s: s.replace(
        '\\', '/').rstrip('/'), nargs='+', required=True,
        help='test dataset paths')
    parser.add_argument('-f', '--force', action='store_true')
    parser.add_argument('--output_dir', help='where to write signals')
    parser.add_argument('--metrics', nargs='+',
                        default=['pesq', 'stoi', 'estoi', 'snr', 'sisnr'])
    parser.add_argument('--no_train_check', action='store_true')
    parser.add_argument('--best',
                        help='metric for best-checkpoint selection')
    parser.add_argument('--batch_size', type=float, default=20)
    parser.add_argument('--workers', type=int, default=0)
    parser.add_argument('--pad_quantum', type=float, default=0.0,
                        help='round batch lengths up to multiples of '
                        'this many seconds')
    parser.add_argument('--device_metrics', action='store_true',
                        help='score with the device metric twins '
                        '(brever_tpu_torch.metrics_device) where a metric '
                        'has one, instead of the host implementations')
    parser.add_argument('--device', default='cuda',
                        help="torch device of the model (e.g. 'cuda', "
                        "'cpu')")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    metrics = list(args.metrics)
    for metric in metrics:
        MetricRegistry.get(metric)
    _h5py()
    disable_tf32()
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format='%(asctime)s %(levelname)s %(message)s')

    for input_ in args.inputs:
        if not os.path.exists(input_):
            print(f'Model {input_} does not exist')
            continue
        checkpoints_dir = os.path.join(input_, 'checkpoints')
        if input_.endswith('.ckpt'):
            model_dir = os.path.dirname(os.path.dirname(input_))
            checkpoint_path = input_
        else:
            model_dir = input_
            checkpoint_path = os.path.join(checkpoints_dir, 'last.ckpt')
        if args.best is not None:
            checkpoint_path = find_best_checkpoint(checkpoints_dir,
                                                   args.best)
        if not os.path.exists(os.path.join(model_dir, 'losses.npz')) \
                and not args.no_train_check:
            print(f'Model {input_} is not trained')
            continue
        cfg = get_config(os.path.join(model_dir, 'config.yaml'))
        handler = logging.FileHandler(os.path.join(model_dir,
                                                   'log_test.log'))
        logging.getLogger().addHandler(handler)
        try:
            logging.info(f'Testing {checkpoint_path}')
            model = load_model(model_dir, checkpoint_path, cfg, args.device)
            score_file = os.path.join(model_dir, 'scores.hdf5')
            for test_path in args.tests:
                test_model(args, model, cfg, test_path, score_file,
                           checkpoint_path, metrics)
        finally:
            logging.getLogger().removeHandler(handler)
            handler.close()


if __name__ == '__main__':
    main()
