"""Training engine of the port (counterpart of ``brever_tpu/training.py``):
train and validation steps, Adam with global-norm clipping, EMA,
validation every ``val_period`` epochs, last/best/pinned checkpoints with
resume, ``TrainingTimer``, ``LossLogger``, ``CheckpointSaver`` and
``EarlyStopping``.

One process, one device, float32 with TF32 off
(``numerics.disable_tf32``). The parameters live in one flat buffer
(``optim.flatten_parameters``): a step is the model's loss, one
``torch.autograd.grad`` (the TCN blocks' backward is the hand-written
kernel on CUDA), optax's global-norm clip and Adam over that buffer, and
the EMA.

bf16 amp (``use_amp``), as the JAX trainer's ``loss_fn`` does it: the
train and validation steps run the loss with every floating parameter cast
to bfloat16 (one differentiable cast of the float32 master views, gathered
into one buffer, that the modules read in their parameters' place) and the
batch cast to bfloat16; the gradients reach the float32 masters through
the cast, and clipping, Adam, the EMA and the checkpoints stay float32. No
loss scaling: bf16 has float32's exponent range, and the JAX trainer has
none. Validation metrics enhance with the float32 parameters. A family
with steps of its own (MetricGAN) ignores ``use_amp``, as the JAX
``build_steps`` returns before it. On CUDA every other family's kernels
take their bf16 route: Conv-TasNet runs its TCN blocks through K1/K2's,
TF-GridNet its BLSTMs through K3/K4's (K5/K6's under the 128-row floor),
DCCRN its complex LSTM through K5/K6's, SGMSE+ and IDMSE their U-Net's
GroupNorms through K7/K8's (IDMSE's external-affine ``norm_2`` through the
plain route in float32, as the JAX package's) and MANNER its train-mode
BatchNorms through K7-BN/K8-BN's; DCCRN's and MANNER's running statistics
stay float32 (their batch norms take float32 statistics). Batches are
padded to a multiple of 8 rows with rows of length 0, which the loss mean
drops, as the JAX trainer pads to its mesh.

Checkpoints are the JAX trainer's msgpack layout (``training.py``
``save_checkpoint``): flax parameter trees, optax's optimizer state (below),
step, losses, timer and best-checkpoint records, so
``brever_tpu.checkpoint.load_checkpoint`` and both packages' servers read
them. The optimizer state is ``chain(clip_by_global_norm, adam)``'s,
``[clip, [adam (count, mu, nu), lr]]`` (``lr`` empty for a constant rate,
``[count]`` for a schedule's own count, MANNER's one-cycle schedule), or,
for a family that declares
``injects_hyperparams`` (the JAX package wraps its Adam in
``optax.inject_hyperparams``), ``[clip, [count, hyperparams, {}, [adam,
lr]]]`` with the learning rate in ``hyperparams``; without clipping the
outer ``[clip, ...]`` is absent. A family with steps of its own and a dict
of optimizers (MetricGAN: ``make_step_fns``, ``optimizer_parts``) keeps
that dict's layout, ``{'generators': [state, ...], 'discriminator':
state}``, each state over its part of the flat buffer, and its losses are
dicts, averaged key by key over an epoch as the JAX ``routine`` does. A
hyperparameter update that ``on_validate`` returns (TF-GridNet's plateau
halving) sets the learning rate in place and keeps Adam's moments, as the
JAX trainer's ``_apply_hyper_update`` does, and a checkpoint resumes with
it.

Randomness in the loss (SGMSE+ draws t and its noise) comes from a
``torch.Generator`` on the trainer's device, seeded from ``seed`` and
handed to ``loss``; its state goes into the checkpoint under
``torch_generator``, so a resumed run continues bitwise. The checkpoint's
``rng`` stays the JAX trainer's threefry key ``[0, seed]``, which the port
cannot continue, so that the JAX loader reads the file. Validation draws
from a generator of its own, reseeded to ``VAL_SEED`` before every
validation batch, so a fixed model has a fixed validation loss whatever
the order of the batches; the JAX trainer validates
with its running key, so the two packages' validation losses are other
draws. A family's buffers are saved in the checkpoint's ``aux``, as the
JAX trainer saves its ``buffers`` and ``batch_stats`` collections, and
restored on resume: SGMSE+'s Fourier frequencies, and DCCRN's running
statistics, which its batch norms update in the forward of each train step
(the padding rows of a batch enter them, as in the JAX trainer) and which
validation reads in eval mode. The EMA covers the parameters only, as the
JAX trainer's does.

Validation metrics: with ``device_val_metrics`` (the default) each that
has a device twin (``metrics_device.DEVICE_METRICS``: ``stoi``, ``estoi``,
``pesq``, and ``snr``/``sisnr``, the port's metrics) is scored on the card,
as in the JAX trainer, and only the per-item scores leave it; without it
the enhanced rows go to the host once a batch and the host metrics
(``metrics.MetricRegistry``: float64 STOI, ESTOI and PESQ with its
realignment) score them.

Not ported yet, and refused when the trainer is built (ROADMAP.md):
``ddp``, ``profile`` and ``use_wandb``.
``compile`` is accepted and ignored, as the JAX trainer ignores it; so is
``rank``.
"""

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from .batching import BatchSamplerRegistry
from .checkpoint import load_checkpoint, save_checkpoint
from .data import BreverDataLoader
from .metrics import MetricRegistry, check_metrics
from .metrics_device import DEVICE_METRICS
from .models import count_params
from .models.base import sample_weighted_mean
from .numerics import disable_tf32
from .optim import clip_by_global_norm, flatten_parameters


#: Adam's hyperparameters as optax.inject_hyperparams names them (its
#: ``eps_root`` is 0 and not one of the port's)
_HYPERPARAMS = ('learning_rate', 'b1', 'b2', 'eps')

#: the seed of the validation generator, set anew for every validation
#: batch
VAL_SEED = 0


def resolve_device(device):
    """The torch device of the trainer's ``device`` option: ``'cpu'``,
    ``'cuda'``/``'cuda:N'``, an index (int or digits), or the JAX config's
    default ``'tpu'``, which means ``cuda:0``."""
    if isinstance(device, torch.device):
        pass
    elif isinstance(device, int) or (isinstance(device, str)
                                     and device.isdigit()):
        device = torch.device('cuda', int(device))
    elif device in ('tpu', 'cuda'):
        device = torch.device('cuda', 0)
    else:
        device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested, but torch sees no '
                           'CUDA device')
    return device


def _refuse(what, where):
    raise NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                              f'{where})')


class _BF16Cast(torch.autograd.Function):
    """The amp cast of the float32 masters: ``apply(parts, *params)`` returns
    each parameter in bfloat16, all views of one buffer cast from ``parts``
    (the masters' storage, each followed by the zeros that start the next
    on 16 bytes, as the kernels load them) in one ``cat`` and one cast; the
    backward gathers the bfloat16 gradients and casts them to float32 in
    one launch each. A cast or a slice per parameter costs a few launches
    each (a slice's backward zero-fills the whole buffer)."""

    @staticmethod
    def forward(ctx, parts, *params):
        ctx.shapes, ctx.device = [p.shape for p in params], params[0].device
        cast = torch.cat(parts).to(torch.bfloat16)
        out, at = [], 0
        for p in params:
            out.append(cast[at:at + p.numel()].view(p.shape))
            at += p.numel() + -p.numel() % 8
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            g.reshape(-1) if g is not None
            else torch.zeros(shape.numel(), dtype=torch.bfloat16,
                             device=ctx.device)
            for g, shape in zip(grads, ctx.shapes)]).float()
        out, at = [None], 0
        for shape in ctx.shapes:
            out.append(flat[at:at + shape.numel()].view(shape))
            at += shape.numel()
        return tuple(out)


class BreverTrainer:
    """Trains a model family on one device.

    The ``__init__`` signature is the JAX trainer's, name for name and
    default for default: ``python -m brever_tpu_torch.train`` builds its
    options from it and the model directory's config hash covers it.
    """

    def __init__(
        self,
        model,
        train_dataset,
        val_dataset,
        model_dirpath: str,
        workers: int = 0,
        epochs: int = 100,
        device: int | str = 'tpu',
        batch_sampler: str = 'bucket',
        batch_size: int = 32,
        num_buckets: int = 10,
        dynamic_batch_size: bool = True,
        fs: int = 16000,
        ema: bool = False,
        ema_decay: float = 0.999,
        ignore_checkpoint: bool = False,
        preload: bool = False,
        ddp: bool = False,
        rank: int = 0,
        use_wandb: bool = False,
        profile: bool = False,
        val_metrics: set[str] = {'pesq', 'estoi', 'snr'},
        val_period: int = 10,
        device_val_metrics: bool = True,
        use_amp: bool = False,
        compile: bool = True,
        save_on_epochs: list[int] = [],
        seed: int = 0,
        pad_quantum: float = 0.5,
    ):
        if ddp:
            _refuse('ddp', 'Queue 1')
        if profile:
            _refuse('profile (use python -m brever_tpu_torch.profile_train)',
                    'Queue 1')
        if use_wandb:
            _refuse('W&B logging', 'Queue 1')
        check_metrics(val_metrics, device_val_metrics)
        if preload and workers > 0:
            logging.warning('Cannot use workers > 0 with preload=True. '
                            'Forcing workers=0.')
            workers = 0

        disable_tf32()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.model_dirpath = model_dirpath
        self.epochs = epochs
        self.ignore_checkpoint = ignore_checkpoint
        self.preload = preload
        self.val_metrics = val_metrics
        self.val_period = val_period
        self.device_val_metrics = device_val_metrics
        self.save_on_epochs = save_on_epochs
        self.seed = seed

        self.checkpoints_dir = os.path.join(model_dirpath, 'checkpoints')
        self.last_ckpt_path = os.path.join(self.checkpoints_dir, 'last.ckpt')
        self.epochs_ran = 0
        self.max_memory_allocated = 0

        sampler_cls = BatchSamplerRegistry.get(batch_sampler)
        sampler_kwargs = dict(
            batch_size=batch_size, dynamic=dynamic_batch_size, fs=fs)
        if batch_sampler == 'bucket':
            sampler_kwargs['num_buckets'] = num_buckets
        self.train_batch_sampler = sampler_cls(
            dataset=train_dataset, **sampler_kwargs)
        if dynamic_batch_size:
            val_batch_size = batch_size
        else:
            val_batch_size = \
                batch_size * train_dataset.get_max_segment_length() / fs
        self.val_batch_sampler = BatchSamplerRegistry.get('sorted')(
            dataset=val_dataset, batch_size=val_batch_size, dynamic=True,
            fs=fs)
        pad_to_multiple = round(pad_quantum * fs) if pad_quantum else None
        self.train_dataloader = BreverDataLoader(
            dataset=train_dataset, batch_sampler=self.train_batch_sampler,
            num_workers=workers, pad_to_multiple=pad_to_multiple)
        self.val_dataloader = BreverDataLoader(
            dataset=val_dataset, batch_sampler=self.val_batch_sampler,
            num_workers=workers, pad_to_multiple=pad_to_multiple)

        model.prepare_optimizer(len(self.train_batch_sampler), epochs)
        self.optimizer = model.optimizer()
        if getattr(model, 'injects_hyperparams', False):
            # optax.inject_hyperparams holds them as float32 arrays
            self._apply_hyper_update({key: getattr(self.optimizer, key)
                                      for key in _HYPERPARAMS})
        self.grad_clip = model.grad_clip
        self.use_ema = ema
        self.ema_decay = ema_decay
        self.use_amp = use_amp
        self._amp_layout = None

        # every parameter becomes a view into one flat buffer
        self._names = [name for name, _ in model.named_parameters()]
        self._param_list = list(model.parameters())
        self.flat = flatten_parameters(model)
        self.parts = self._part_slices(model.optimizer_parts())
        self._steps = model.make_step_fns(self)
        self.ema = None
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.val_generator = torch.Generator(device=self.device)

        self.loss_logger = LossLogger(model_dirpath)
        self.checkpoint_saver = CheckpointSaver(
            dirpath=self.checkpoints_dir, save_func=self.save_checkpoint)
        self.timer = TrainingTimer(epochs, val_period)

    # ------------------------------------------------------------------
    # state

    def init_state(self):
        """Parameters and buffers drawn from ``seed``, fresh Adam moments,
        step 0, the EMA a copy of the parameters, the loss's generator
        seeded with ``seed``."""
        self.model.init_parameters(self.seed)
        for _, opt, part in self._optimizers():
            opt.init(self.flat[self.parts.get(part, slice(None))])
        self.step = 0
        self.ema = self.flat.clone() if self.use_ema else None
        self.generator.manual_seed(self.seed)

    def _part_slices(self, parts):
        """``{key: slice}`` of the flat buffer for each part of the model's
        optimizer (``model.optimizer_parts()``: flax key -> submodule),
        whose parameters must lie next to each other."""
        index = {id(p): i for i, p in enumerate(self._param_list)}
        offsets = np.cumsum([0] + [p.numel() for p in self._param_list])
        slices = {}
        for key, module in parts.items():
            ids = sorted(index[id(p)] for p in module.parameters())
            if ids != list(range(ids[0], ids[-1] + 1)):
                raise ValueError(f'the parameters of part {key} are not '
                                 'contiguous')
            slices[key] = slice(int(offsets[ids[0]]),
                                int(offsets[ids[-1] + 1]))
        return slices

    def _optimizers(self):
        """``(path, optimizer, part)`` of each optimizer: the model's one
        over the whole buffer (path and part ``None``), or, for a family
        with a dict of them (MetricGAN's ``generators`` list and
        ``discriminator``), each with its path in the dict and its part's
        flax key (``part`` attribute)."""
        if not isinstance(self.optimizer, dict):
            return [(None, self.optimizer, None)]
        out = []
        for name, value in self.optimizer.items():
            if isinstance(value, (list, tuple)):
                out += [((name, i), opt, opt.part)
                        for i, opt in enumerate(value)]
            else:
                out.append(((name,), value, value.part))
        return out

    def train_step(self, batch, lengths):
        """One optimizer step on a padded device batch; returns the loss
        (a device scalar, or a family's dict of them). A family with its
        own steps (``model.make_step_fns``) runs them instead."""
        if self._steps is not None:
            loss = self._steps[0](batch, lengths)
            self.step += 1
            return loss
        self.model.train()
        with self._amp_params():
            loss = sample_weighted_mean(
                self.model.loss(self._amp_batch(batch), lengths,
                                self.generator), lengths)
            grads = torch.autograd.grad(loss, self._param_list)
        grads = torch.cat([g.reshape(-1) for g in grads])
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        self.optimizer.step(self.flat, grads)
        self.step += 1
        if self.use_ema:
            self.ema.add_(self.flat - self.ema, alpha=1 - self.ema_decay)
        return loss.detach()

    @torch.no_grad()
    def val_step(self, batch, lengths):
        """The validation loss of a padded device batch, drawn from
        ``val_generator`` reseeded to ``VAL_SEED``: the loss of a batch
        does not depend on the order the sampler gives the batches."""
        self.val_generator.manual_seed(VAL_SEED)
        if self._steps is not None:
            return self._steps[1](batch, lengths)
        self.model.eval()
        with self._eval_params(), self._amp_params():
            return sample_weighted_mean(
                self.model.loss(self._amp_batch(batch), lengths,
                                self.val_generator), lengths)

    def _amp_batch(self, batch):
        """The batch as the loss takes it: cast to bfloat16 under amp."""
        return batch.to(torch.bfloat16) if self.use_amp \
            and batch.is_floating_point() else batch

    @contextlib.contextmanager
    def _amp_params(self):
        """Under amp, every floating parameter of the model reads as its
        bfloat16 cast for the block (:class:`_BF16Cast`, over the slots and
        storage views found at first use). Without amp, nothing."""
        if not self.use_amp:
            yield
            return
        if self._amp_layout is None:
            slots = [(m, name, p) for m in self.model.modules()
                     for name, p in m._parameters.items()
                     if p is not None and p.is_floating_point()]
            pad = self.flat.new_zeros(7)
            parts = [t for _, _, p in slots
                     for t in (p.detach().reshape(-1), pad[:-p.numel() % 8])]
            self._amp_layout = slots, parts
        slots, parts = self._amp_layout
        cast = _BF16Cast.apply(parts, *(p for _, _, p in slots))
        try:
            for (module, name, _), view in zip(slots, cast):
                module._parameters[name] = view
            yield
        finally:
            for module, name, p in slots:
                module._parameters[name] = p

    @contextlib.contextmanager
    def _eval_params(self):
        """Puts the EMA in the parameters' place for the block, if any."""
        if not self.use_ema:
            yield
            return
        saved = self.flat.clone()
        self.flat.copy_(self.ema)
        try:
            yield
        finally:
            self.flat.copy_(saved)

    # ------------------------------------------------------------------
    # main loop

    def run(self):
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        logging.info(f'Device: {self.device}')
        if os.path.exists(self.last_ckpt_path) \
                and not self.ignore_checkpoint:
            logging.info('Checkpoint found')
            self.init_state()
            self.load_checkpoint()
            if self.epochs_ran == self.epochs:
                logging.info('Model is already trained')
                return
        else:
            self.init_state()
            if self.preload:
                self.train_dataset.preload(tqdm_desc='train preload')
                self.val_dataset.preload(tqdm_desc='val preload')
            pre_train_loader = BreverDataLoader(
                dataset=self.train_dataset,
                batch_sampler=BatchSamplerRegistry.get('sorted')(
                    dataset=self.train_dataset,
                    batch_size=self.val_batch_sampler.batch_size,
                    dynamic=True, shuffle=False, fs=1,
                ),
                pad_to_multiple=self.train_dataloader.pad_to_multiple,
            )
            self.model.pre_train(self.train_dataset, pre_train_loader,
                                 self.epochs)
        logging.info(f'Number of parameters: {count_params(self.model):,}')
        logging.info(
            f'Train dataset duration: {self.train_dataset._duration}')
        logging.info(f'Val dataset duration: {self.val_dataset._duration}')
        self.training_loop()

    def training_loop(self):
        logging.info('Starting training loop')
        self.timer.start()
        for epoch in range(self.epochs_ran, self.epochs):
            self.train_dataloader.set_epoch(epoch)
            train_loss = self.routine(epoch, train=True)
            validate = epoch % self.val_period == 0
            if validate:
                self.val_dataloader.set_epoch(epoch)
                val_loss, metrics = self.routine(epoch, train=False)
                update = self.model.on_validate(val_loss)
                if update is not None:
                    self._apply_hyper_update(update)
                    logging.info(f'Applied hyperparameter update: {update}')
            else:
                val_loss, metrics = None, None

            self.loss_logger.add(train_loss, val_loss, metrics)
            self.epochs_ran = epoch + 1
            self._update_memory_stats()

            log_msg = f'Epoch {epoch}: train loss: {train_loss}'
            if val_loss is not None:
                log_msg += f'; val loss: {val_loss}'
            if metrics:
                log_msg += f'; metrics: {metrics}'
            logging.info(log_msg)
            if validate:
                self.checkpoint_saver.update(epoch, val_loss, metrics)
            self.save_checkpoint(self.last_ckpt_path)
            if epoch in self.save_on_epochs:
                self.save_checkpoint(os.path.join(
                    self.checkpoints_dir, f'epoch={epoch}.ckpt'))
            self.timer.lap(validated=validate)
            logging.info(self.timer.log())

        self.loss_logger.save()
        self.loss_logger.plot()
        logging.info('Done')

    def routine(self, epoch, train=True):
        dataloader = self.train_dataloader if train else self.val_dataloader
        step = self.train_step if train else self.val_step
        # per-step losses stay on the device and are fetched once an epoch
        losses, weights = [], []
        metric_totals, metric_counts = {}, {}
        for batch, lengths in dataloader:
            batch, lengths, n_real = self._pad_batch(batch, lengths)
            if isinstance(batch, list):
                batch = [torch.from_numpy(b).to(self.device) for b in batch]
            else:
                batch = torch.from_numpy(batch).to(self.device)
            lengths = torch.from_numpy(lengths).to(self.device)
            losses.append(step(batch, lengths))
            weights.append(n_real)
            if not train and self.val_metrics:
                for k, v in self.compute_metrics(batch, lengths,
                                                 n_real).items():
                    metric_totals[k] = metric_totals.get(k, 0.0) + v * n_real
                    metric_counts[k] = metric_counts.get(k, 0) + n_real
        if not losses:
            mean_loss = 0.0
        elif isinstance(losses[0], dict):
            mean_loss = {k: float(np.average(
                torch.stack([loss[k] for loss in losses]).double().cpu()
                .numpy(), weights=weights)) for k in losses[0]}
        else:
            values = torch.stack(losses).double().cpu().numpy()
            mean_loss = float(np.average(values, weights=weights))
        if train:
            return mean_loss
        metrics = None
        if metric_counts:
            metrics = {k: metric_totals[k] / metric_counts[k]
                       for k in metric_totals}
        return mean_loss, metrics

    @torch.no_grad()
    def compute_metrics(self, batch, lengths, n_real):
        """Metrics of the enhanced first source (the mixture) against the
        channel mean of the second (the target), over the real rows: with
        ``device_val_metrics`` by the device twins where a metric has one,
        the others (all of them without it) by the host metrics on the
        rows copied to the host once; a host metric that raises
        ``RuntimeError`` is skipped with a warning, as in the JAX trainer.
        A batch that the loader transformed into a list (MetricGAN's
        training items) has no metrics."""
        if isinstance(batch, (list, tuple)):
            return {}
        inputs = batch[:, 0]
        targets = batch[:, 1].mean(dim=-2)
        self.model.eval()
        with self._eval_params():
            enhanced = self.model.enhance(inputs)
        if enhanced.ndim == 3:  # separation models: first source
            enhanced = enhanced[:, 0]
        lengths = lengths[:, 0] if lengths.ndim > 1 else lengths
        out, host = {}, None
        for name in sorted(self.val_metrics):
            device_fn = self.device_val_metrics and DEVICE_METRICS.get(name)
            if device_fn:
                out[name] = float(device_fn(enhanced, targets,
                                            lengths)[:n_real].mean())
                continue
            if host is None:
                host = [t[:n_real].cpu().numpy()
                        for t in (enhanced, targets, lengths)]
            try:
                values = MetricRegistry.get(name)(host[0], host[1],
                                                  lengths=host[2])
            except RuntimeError as e:
                logging.warning(f'skipping metric {name}: {e}')
                continue
            out[name] = float(np.mean(np.asarray(values)))
        return out

    # ------------------------------------------------------------------
    # helpers

    @staticmethod
    def _pad_batch(batch, lengths, quantum=8):
        """Round the batch axis up to a multiple of 8 with copies of the
        first row, of length 0; a list batch (a loader transform's items)
        element by element."""
        n_real = lengths.shape[0]
        pad = (-n_real) % quantum

        def pad_rows(x):
            return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])

        if pad:
            batch = [pad_rows(x) for x in batch] \
                if isinstance(batch, list) else pad_rows(batch)
            lengths = np.concatenate(
                [lengths, np.zeros((pad,) + lengths.shape[1:],
                                   lengths.dtype)])
        return batch, lengths, n_real

    def _apply_hyper_update(self, update):
        """Set the optimizer's hyperparameters that ``update`` names, in
        place: Adam's moments stay. As in the JAX trainer, only a family
        whose optimizer injects its hyperparameters takes updates, each
        value rounded to float32, and other names are ignored."""
        if not isinstance(update, dict) \
                or not getattr(self.model, 'injects_hyperparams', False):
            return
        for key, value in update.items():
            if key in _HYPERPARAMS:
                setattr(self.optimizer, key, float(np.float32(value)))

    def _update_memory_stats(self):
        if self.device.type == 'cuda':
            self.max_memory_allocated = max(
                self.max_memory_allocated,
                torch.cuda.max_memory_allocated(self.device))

    # ------------------------------------------------------------------
    # checkpointing

    def _flax(self, flat):
        """A flat parameter-shaped vector as the JAX package's flax tree."""
        flat, sd, offset = flat.detach().cpu(), {}, 0
        for name, p in zip(self._names, self._param_list):
            sd[name] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        return self.model.to_flax(sd)

    def _flat_from_flax(self, tree):
        sd = self.model.from_flax(tree)
        return torch.cat([torch.as_tensor(sd[name]).reshape(-1)
                          for name in self._names]).to(self.device)

    def _flax_part(self, vec, part):
        """A vector over a part's slice as that part's flax tree (the
        whole buffer's tree for ``part`` None)."""
        if part is None:
            return self._flax(vec)
        full = torch.zeros_like(self.flat)
        full[self.parts[part]] = vec
        return self._flax(full)[part]

    def _flat_part(self, tree, part):
        """The inverse of :meth:`_flax_part`."""
        if part is None:
            return self._flat_from_flax(tree)
        full = self._flax(torch.zeros_like(self.flat))
        full[part] = tree
        return self._flat_from_flax(full)[self.parts[part]]

    def _opt_state_tree(self):
        """The optimizer state in optax's layout (module docstring); for a
        dict of optimizers, that dict of their states, a list of them where
        the dict has a list."""
        trees = {}
        for path, opt, part in self._optimizers():
            tree = self._adam_tree(opt, part)
            if path is None:
                return tree
            if len(path) == 1:
                trees[path[0]] = tree
            else:
                trees.setdefault(path[0], []).append(tree)
        return trees

    def _adam_tree(self, optimizer, part):
        state = optimizer.state_dict()
        count = np.asarray(state['count'].cpu())
        # optax.adam's second transform: scale_by_learning_rate's state, a
        # schedule's own count (none for a constant rate)
        rate_state = [np.asarray(state['schedule_count'], np.int32)] \
            if 'schedule_count' in state else []
        inner = [[count, self._flax_part(state['mu'], part),
                  self._flax_part(state['nu'], part)], rate_state]
        if getattr(self.model, 'injects_hyperparams', False):
            hyper = {key: np.asarray(getattr(optimizer, key), np.float32)
                     for key in _HYPERPARAMS}
            hyper['eps_root'] = np.asarray(0.0, np.float32)
            inner = [count, hyper, {}, inner]
        return [[], inner] if self.grad_clip else inner

    def _load_opt_state_tree(self, tree):
        for path, opt, part in self._optimizers():
            node = tree
            for key in path or ():
                node = node[key]
            self._load_adam_tree(opt, part, node)

    def _load_adam_tree(self, optimizer, part, tree):
        """Adam's state and, where the layout has it, the learning rate."""
        inner = tree[1] if self.grad_clip else tree
        if getattr(self.model, 'injects_hyperparams', False):
            _, hyper, _, inner = inner
            for key in _HYPERPARAMS:
                setattr(optimizer, key, float(hyper[key]))
        count, mu, nu = inner[0]
        state = {'count': torch.from_numpy(np.array(count)),
                 'mu': self._flat_part(mu, part),
                 'nu': self._flat_part(nu, part)}
        if inner[1]:
            state['schedule_count'] = int(np.asarray(inner[1][0]))
        optimizer.load_state_dict(state)

    def save_checkpoint(self, path):
        state = {
            'epochs': self.epochs_ran,
            'params': self._flax(self.flat),
            'aux': self.model.flax_aux(self.model.state_dict()),
            'opt_state': self._opt_state_tree(),
            'step': np.asarray(self.step, np.int32),
            'rng': np.array([0, self.seed], np.uint32),
            'torch_generator': self.generator.get_state().numpy(),
            'losses': self.loss_logger.state_dict(),
            'max_memory_allocated': int(self.max_memory_allocated),
            'timer': self.timer.state_dict(),
            'best': self.checkpoint_saver.state_dict(),
        }
        extra = self.model.extra_state()
        if extra:
            state['model_extra'] = json.dumps(extra)
        if self.use_ema:
            state['ema'] = self._flax(self.ema)
        save_checkpoint(path, state)

    def load_checkpoint(self, path=None):
        state = load_checkpoint(path or self.last_ckpt_path)
        self.epochs_ran = int(state['epochs'])
        with torch.no_grad():
            self.flat.copy_(self._flat_from_flax(state['params']))
            self._load_opt_state_tree(state['opt_state'])
            if self.use_ema:
                self.ema = self._flat_from_flax(state['ema'])
            if state.get('aux'):   # the family's buffers
                self.model.load_state_dict(
                    self.model.from_flax({}, state['aux']), strict=False)
        if 'torch_generator' in state:
            self.generator.set_state(torch.from_numpy(
                np.array(state['torch_generator'], np.uint8)))
        self.step = int(state['step'])
        if 'model_extra' in state:
            self.model.load_extra_state(json.loads(state['model_extra']))
        self.loss_logger.load_state_dict(state['losses'])
        self.timer.load_state_dict(state['timer'])
        self.checkpoint_saver.load_state_dict(state['best'])
        self.max_memory_allocated = state.get('max_memory_allocated', 0)
        logging.info(f'Resuming training at epoch {self.epochs_ran}')


class TrainingTimer:
    """Running per-epoch/per-validation averages and ETA."""

    def __init__(self, epochs, val_period):
        self.epochs = epochs
        self.val_period = val_period
        self.epoch_time_sum = 0.0
        self.epoch_count = 0
        self.val_extra_sum = 0.0
        self.val_count = 0
        self._lap_start = None
        self.last_lap = None

    def start(self):
        self._lap_start = time.time()

    def lap(self, validated=False):
        now = time.time()
        elapsed = now - self._lap_start
        self._lap_start = now
        self.epoch_time_sum += elapsed
        self.epoch_count += 1
        self.last_lap = elapsed
        if validated:
            self.val_count += 1

    @property
    def avg_epoch_time(self):
        return self.epoch_time_sum / max(self.epoch_count, 1)

    def eta(self):
        remaining = self.epochs - self.epoch_count
        return remaining * self.avg_epoch_time

    def log(self):
        msg = ''
        if self.last_lap is not None:
            msg += f'Epoch time: {self.last_lap:.2f} s; '
        return msg + (f'Avg epoch time: {self.avg_epoch_time:.2f} s; '
                      f'ETA: {self.eta():.0f} s')

    def state_dict(self):
        return {
            'epoch_time_sum': self.epoch_time_sum,
            'epoch_count': self.epoch_count,
            'val_count': self.val_count,
        }

    def load_state_dict(self, state):
        self.epoch_time_sum = float(state['epoch_time_sum'])
        self.epoch_count = int(state['epoch_count'])
        self.val_count = int(state['val_count'])
        self._lap_start = time.time()


class LossLogger:
    """Accumulates loss/metric history; writes losses.npz and
    training_curve.png."""

    def __init__(self, dirpath):
        self.dirpath = dirpath
        self.train_loss = []
        self.val_loss = []
        self.metrics = []

    def add(self, train_loss, val_loss, metrics=None):
        self.train_loss.append(self._plain(train_loss))
        self.val_loss.append(self._plain(val_loss))
        self.metrics.append(metrics)

    @staticmethod
    def _plain(x):
        if isinstance(x, dict):
            return {k: float(v) for k, v in x.items()}
        return None if x is None else float(x)

    def save(self):
        np.savez(
            os.path.join(self.dirpath, 'losses.npz'),
            train=np.array(self.train_loss, dtype=object),
            val=np.array(self.val_loss, dtype=object),
            metrics=np.array(self.metrics, dtype=object),
            allow_pickle=True,
        )

    def plot(self):
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots()
        train = [x if isinstance(x, float) else
                 (sum(x.values()) if x else None) for x in self.train_loss]
        val = [x if isinstance(x, float) or x is None else
               sum(x.values()) for x in self.val_loss]
        ax.plot(train, label='train')
        val_epochs = [i for i, v in enumerate(val) if v is not None]
        ax.plot(val_epochs, [val[i] for i in val_epochs], label='val')
        ax.set_xlabel('epoch')
        ax.set_ylabel('loss')
        ax.legend()
        fig.savefig(os.path.join(self.dirpath, 'training_curve.png'))
        plt.close(fig)

    def state_dict(self):
        return json.dumps({
            'train': self.train_loss,
            'val': self.val_loss,
            'metrics': self.metrics,
        })

    def load_state_dict(self, state):
        data = json.loads(state)
        self.train_loss = data['train']
        self.val_loss = data['val']
        self.metrics = data['metrics']


class CheckpointSaver:
    """Keeps one best checkpoint per tracked quantity.

    Losses are minimized, metrics maximized; the superseded best file
    is deleted (reference brever/training.py:668-699).
    """

    def __init__(self, dirpath, save_func):
        self.dirpath = dirpath
        self.save_func = save_func
        self.best = {}   # name -> (value, path)

    def update(self, epoch, val_loss, metrics=None):
        quantities = {}
        if isinstance(val_loss, dict):
            for key, value in val_loss.items():
                quantities[f'loss_{key}'] = (float(value), min)
        elif val_loss is not None:
            quantities['loss'] = (float(val_loss), min)
        if metrics:
            for key, value in metrics.items():
                quantities[key] = (float(value), max)
        for name, (value, better) in quantities.items():
            current = self.best.get(name)
            if current is None or better(value, current[0]) == value:
                path = os.path.join(
                    self.dirpath, f'epoch={epoch}_{name}={value:.4f}.ckpt')
                self.save_func(path)
                if current is not None and os.path.exists(current[1]):
                    os.remove(current[1])
                self.best[name] = (value, path)

    def state_dict(self):
        return json.dumps(self.best)

    def load_state_dict(self, state):
        self.best = {k: tuple(v) for k, v in json.loads(state).items()}


class EarlyStopping:
    """Patience-based early stopping on the validation loss.

    Present for API parity (deprecated in the reference,
    brever/training.py:738-774)."""

    def __init__(self, patience=10, min_delta=0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.counter = 0

    def step(self, val_loss):
        """Returns True when training should stop."""
        if self.best is None or val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience
