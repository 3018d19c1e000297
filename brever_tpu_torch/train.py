"""Train a model from its hashed config directory on a PyTorch device
(counterpart of ``scripts/train_model.py``): config merge with the
command line's trainer options, seeding, the train and validation
datasets, the trainer's run.

    python -m brever_tpu_torch.train <model_dir> --device cuda [--force]
        [--<trainer option> VALUE ...]

The trainer options are built from ``BreverTrainer.__init__``'s own
signature; a value given on the command line replaces the config's
(``fs`` also sets the dataset's, as in the JAX package). Bools take
true/false, sets and lists comma-separated items. The default configs'
validation metrics (``estoi``, ``pesq``, ``snr``) are scored by the device
twins (``device_val_metrics: true``; the host twins without it). Datasets
are read as ``scripts/create_dataset.py`` writes them, FLAC (its default)
or WAV. The default configs train as they are where the trainer takes
their ``use_amp``: Conv-TasNet's ``use_amp: true`` runs bf16 amp (its TCN
blocks through K1/K2's bf16 route on CUDA), FFNN's and MetricGAN's are
float32; TF-GridNet, DCCRN, SGMSE+, IDMSE and MANNER refuse bf16 amp until
their kernels have a bf16 route (ROADMAP.md Queue 1 item 2): pass
``--use_amp false`` for them.
"""

import argparse
import inspect
import logging
import os
import random
import typing

import numpy as np
import torch

from .config import get_config
from .data import BreverDataset
from .models import ModelRegistry
from .training import BreverTrainer


def _bool(text):
    lowered = text.lower()
    if lowered in ('true', 'yes', '1'):
        return True
    if lowered in ('false', 'no', '0'):
        return False
    raise argparse.ArgumentTypeError(f'expected a bool, got {text!r}')


def _split(origin, item_type):
    def parse(text):
        return origin(item_type(v) for v in text.split(',') if v != '')
    return parse


def trainer_options():
    """``{name: argparse type}`` of every trainer option with a default
    (the model, datasets and directory are not options)."""
    options = {}
    for name, param in inspect.signature(BreverTrainer).parameters.items():
        if param.default is inspect.Parameter.empty:
            continue
        hint = param.annotation
        origin = typing.get_origin(hint)
        if origin in (list, set):
            options[name] = _split(origin, typing.get_args(hint)[0])
        elif hint is bool:
            options[name] = _bool
        elif hint in (int, float):
            options[name] = hint
        else:   # str, and int | str (device) parsed as str
            options[name] = str
    return options


def build_trainer(argv=None):
    """The trainer that :func:`main` runs, built from a model directory
    and the command line's options (nothing is trained)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('input', help='model directory')
    parser.add_argument('--force', action='store_true',
                        help='train even if already trained')
    group = parser.add_argument_group('trainer options')
    options = trainer_options()
    for name, parse in options.items():
        group.add_argument(f'--{name}', type=parse, default=None)
    args = parser.parse_args(argv)

    model_dir = args.input
    losses_path = os.path.join(model_dir, 'losses.npz')
    if os.path.exists(losses_path) and not args.force:
        raise FileExistsError(
            f'training already done: {losses_path}; use --force to retrain')

    config = get_config(os.path.join(model_dir, 'config.yaml'))
    for name in options:
        value = getattr(args, name)
        if value is None:
            continue
        config.set_field(['trainer', name], value)
        if hasattr(config.dataset, name):
            config.set_field(['dataset', name], value)

    logging.basicConfig(
        level=logging.INFO, format='%(asctime)s %(levelname)s %(message)s',
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(model_dir,
                                                   'log_train.log'))])
    logging.info(f'Training {model_dir}')
    logging.info(config.to_dict())

    random.seed(config.seed)
    np.random.seed(config.seed)
    torch.manual_seed(config.seed)

    model = ModelRegistry.get(config.arch)(**config.model.to_dict(),
                                           device='cpu')
    dataset_kwargs = config.dataset.to_dict()
    # a host-side per-item precompute (MetricGAN's noisy metric score) runs
    # in the loader of the train set only, as in the JAX package
    train_dataset = BreverDataset(path=config.train_path,
                                  transform=model.loader_transform,
                                  **dataset_kwargs)
    val_kwargs = dict(dataset_kwargs, dynamic_mixing=False,
                      dynamic_mixing_device=False)
    val_dataset = BreverDataset(path=config.val_path, **val_kwargs)
    if config.train_path == config.val_path:
        logging.warning('train_path and val_path are identical')

    trainer_kwargs = config.trainer.to_dict()
    trainer_kwargs['seed'] = config.seed
    return BreverTrainer(model=model, train_dataset=train_dataset,
                         val_dataset=val_dataset, model_dirpath=model_dir,
                         **trainer_kwargs)


def main(argv=None):
    """Train (or resume) the model directory; returns the trainer."""
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == '__main__':
    main()
