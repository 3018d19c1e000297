"""The port's trainer (brever_tpu_torch.training, .optim, .train) on the
CPU: the optimizer step against optax, runs on tests/utils.DummyDataset
(finite, deterministic, resumable, EMA), checkpoints the JAX package
reads and serves, and the command line on a small model directory; for
TF-GridNet the plateau scheduler, learning-rate drops from on_validate
and the inject_hyperparams checkpoint layout; for SGMSE+ (a tiny
sgmsepm) the loss's generator (its state resumes bitwise from the
checkpoint, validation reseeds its own), the ``aux`` buffers in the
checkpoint, and both packages' servers on what the command line wrote."""

import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import brever_tpu.models.sgmse.sdes as jax_sdes
import brever_tpu.models.sgmse.solvers as jax_solvers
from brever_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.training import BreverTrainer as JaxTrainer
from brever_tpu.training import _restore_opt_state
from brever_tpu_torch import train as train_cli
from brever_tpu_torch.checkpoint import load_checkpoint
from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.models.sgmse import sdes
from brever_tpu_torch.models.schedulers import ReduceLROnPlateau
from brever_tpu_torch.optim import Adam, clip_by_global_norm
from brever_tpu_torch.serve import EnhanceService
from brever_tpu_torch.training import BreverTrainer, resolve_device
from test_torch_data import write_wav_dataset
from utils import DummyDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(filters=16, filter_length=16, bottleneck_channels=8,
             hidden_channels=16, skip_channels=8, layers=2, repeats=2)
GRID = dict(n_layers=1, lstm_hidden_units=16, emb_dim=8, attn_n_head=2,
            attn_approx_qk_dim=32)
SGM = dict(net_base_channels=16, net_channel_mult=[1, 2],
           net_num_blocks_per_res=1, solver_num_steps=2,
           net_attn_bottleneck=False, stft_frame_length=128,
           stft_hop_length=64, net_attn_resolutions=[])
SMALLS = {'convtasnet': SMALL, 'tfgridnet': GRID, 'sgmsepm': SGM}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_trainer(model_dir, arch='convtasnet', **kwargs):
    options = dict(
        train_dataset=DummyDataset(n_items=6, min_length=0.2,
                                   max_length=0.4),
        val_dataset=DummyDataset(n_items=2, min_length=0.2, max_length=0.4,
                                 seed=7),
        model_dirpath=str(model_dir), epochs=2, device='cpu',
        batch_size=0.8, val_metrics={'snr', 'sisnr'}, val_period=1, seed=0)
    options.update(kwargs)
    return BreverTrainer(ModelRegistry.get(arch)(**SMALLS[arch],
                                                 device='cpu'), **options)


@pytest.mark.parametrize('grad_scale', [0.1, 10.0], ids=['below', 'above'])
def test_optimizer_matches_optax(grad_scale):
    """Global-norm clip 5.0 and Adam over 3 steps, the same numpy
    gradients fed to both: once below the clip, once above."""
    rng = np.random.RandomState(0)
    shapes = [(7, 3), (5,), (1,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    steps = [[(grad_scale * rng.randn(*s)).astype(np.float32)
              for s in shapes] for _ in range(3)]

    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    ref = [jnp.asarray(p) for p in params]
    state = tx.init(ref)
    for grads in steps:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   ref)
        ref = optax.apply_updates(ref, updates)

    flat = torch.from_numpy(np.concatenate([p.ravel() for p in params]))
    adam = Adam(1e-3)
    adam.init(flat)
    for grads in steps:
        g = torch.from_numpy(np.concatenate([x.ravel() for x in grads]))
        adam.step(flat, clip_by_global_norm(g, 5.0))
    np.testing.assert_allclose(
        flat.numpy(), np.concatenate([np.asarray(r).ravel() for r in ref]),
        atol=1e-6, rtol=0)
    assert int(adam.count) == 3


def test_clip_leaves_small_gradients_alone():
    g = torch.tensor([3.0, 4.0])   # norm 5
    assert torch.equal(clip_by_global_norm(g, 5.01), g)
    torch.testing.assert_close(clip_by_global_norm(g, 2.5),
                               torch.tensor([1.5, 2.0]))


def test_signature_is_the_jax_trainers():
    """Names, order and defaults: the CLI and the config hash read it."""
    def spec(cls):
        return [(name, p.default) for name, p in
                inspect.signature(cls).parameters.items()]
    assert spec(BreverTrainer) == spec(JaxTrainer)


def test_training_runs_and_is_deterministic(tmp_path):
    first = make_trainer(tmp_path / 'a')
    first.init_state()
    start = first.flat.clone()
    first.run()
    losses = first.loss_logger.train_loss
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not torch.equal(first.flat, start)
    metrics = first.loss_logger.metrics[-1]
    assert set(metrics) == {'snr', 'sisnr'}
    second = make_trainer(tmp_path / 'b')
    second.run()
    assert torch.equal(second.flat, first.flat)
    assert second.loss_logger.train_loss == losses
    assert os.path.exists(tmp_path / 'a' / 'losses.npz')
    names = os.listdir(tmp_path / 'a' / 'checkpoints')
    assert 'last.ckpt' in names
    assert any(n.startswith('epoch=1_loss=') for n in names)


def test_resume_equals_uninterrupted(tmp_path):
    whole = make_trainer(tmp_path / 'whole', epochs=2)
    whole.run()
    make_trainer(tmp_path / 'split', epochs=1).run()
    resumed = make_trainer(tmp_path / 'split', epochs=2)
    resumed.run()
    assert resumed.epochs_ran == 2
    assert torch.equal(resumed.flat, whole.flat)
    assert torch.equal(resumed.optimizer.mu, whole.optimizer.mu)
    assert resumed.step == whole.step
    assert resumed.loss_logger.train_loss == whole.loss_logger.train_loss
    # a finished run is not trained again
    again = make_trainer(tmp_path / 'split', epochs=2)
    again.run()
    assert torch.equal(again.flat, whole.flat)


def test_ema(tmp_path):
    trainer = make_trainer(tmp_path, ema=True, ema_decay=0.9)
    trainer.init_state()
    before = trainer.flat.clone()
    batch = torch.from_numpy(np.stack([trainer.train_dataset[0][..., :3200],
                                       trainer.train_dataset[1][..., :3200]]))
    lengths = torch.tensor([3200, 3200])
    trainer.train_step(batch, lengths)
    torch.testing.assert_close(trainer.ema,
                               before + 0.1 * (trainer.flat - before))
    # validation scores the EMA parameters, and leaves the parameters be
    after = trainer.flat.clone()
    val = trainer.val_step(batch, lengths)
    assert torch.equal(trainer.flat, after)
    trainer.flat.copy_(trainer.ema)
    with torch.no_grad():
        plain = trainer.model.loss(batch, lengths).mean()
    torch.testing.assert_close(val, plain)
    trainer.flat.copy_(after)
    trainer.run()
    state = load_checkpoint(tmp_path / 'checkpoints' / 'last.ckpt')
    assert 'ema' in state


def test_checkpoint_is_the_jax_packages(tmp_path):
    """brever_tpu reads last.ckpt; its parameters are the port's, the JAX
    model enhances with them as the port does, and the optimizer state
    has optax's chain(clip, adam) layout."""
    trainer = make_trainer(tmp_path)
    trainer.run()
    state = jax_load_checkpoint(tmp_path / 'checkpoints' / 'last.ckpt')
    assert state['epochs'] == 2 and int(state['step']) == trainer.step
    want = trainer.model.to_flax(trainer.model.state_dict())
    leaves = jax.tree.leaves(jax.tree.map(np.array_equal, state['params'],
                                          want))
    assert leaves and all(leaves)
    clip, (adam, lr) = state['opt_state']
    assert clip == [] and lr == [] and int(adam[0]) == trainer.step
    mu = trainer.model.from_flax(adam[1])
    flat_mu = torch.cat([torch.as_tensor(mu[k]).reshape(-1)
                         for k, _ in trainer.model.named_parameters()])
    assert torch.equal(flat_mu, trainer.optimizer.mu)

    jax_model = JaxModels.get('convtasnet')(**SMALL)
    x = np.random.RandomState(1).randn(2, 2, 3000).astype(np.float32)
    ref = np.asarray(jax_model.enhance({'params': state['params']}, x))
    np.testing.assert_allclose(trainer.model.enhance(x).numpy(), ref,
                               atol=1e-4, rtol=1e-4)


def test_pad_batch_rounds_to_eight():
    batch = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4)
    padded, lengths, n_real = BreverTrainer._pad_batch(
        batch, np.array([4, 3, 2], np.int32))
    assert n_real == 3 and padded.shape == (8, 2, 4)
    assert (lengths[3:] == 0).all() and (padded[3:] == batch[0]).all()


def test_refusals(tmp_path):
    for option in ('use_amp', 'ddp', 'profile', 'use_wandb'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            make_trainer(tmp_path, **{option: True})
    with pytest.raises(NotImplementedError, match='pesq'):
        make_trainer(tmp_path, val_metrics={'pesq', 'estoi', 'snr'})
    assert resolve_device('cpu') == torch.device('cpu')
    if not torch.cuda.is_available():
        for device in ('tpu', 'cuda', 0, '1'):
            with pytest.raises(RuntimeError, match='CUDA'):
                resolve_device(device)


def _model_dir(tmp_path, arch='convtasnet'):
    """A model directory as the JAX package's initializer writes one: the
    default config of ``arch`` cut to a small model and WAV datasets."""
    with open(os.path.join(ROOT, 'config', 'models', f'{arch}.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    config['model'].update(SMALLS[arch])
    config['train_path'] = write_wav_dataset(str(tmp_path / 'train'),
                                             [4000, 5000, 6000, 3000])
    config['val_path'] = write_wav_dataset(str(tmp_path / 'val'),
                                           [4000, 3500], seed=1)
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump(config, f)
    return str(model_dir)


def test_train_cli_and_serving(tmp_path):
    """python -m brever_tpu_torch.train on a model directory; both
    packages' servers serve what it wrote."""
    model_dir = _model_dir(tmp_path)
    args = [model_dir, '--device', 'cpu', '--epochs', '2', '--use_amp',
            'false', '--val_metrics', 'snr,sisnr', '--batch_size', '2',
            '--dynamic_batch_size', 'false', '--batch_sampler', 'random',
            '--save_on_epochs', '0', '--val_period', '1']
    train_cli.main(args)
    assert os.path.exists(os.path.join(model_dir, 'losses.npz'))
    names = os.listdir(os.path.join(model_dir, 'checkpoints'))
    assert 'last.ckpt' in names and 'epoch=0.ckpt' in names
    with pytest.raises(FileExistsError):
        train_cli.main(args)

    audio = np.random.RandomState(2).randn(4000).astype(np.float32) * 0.1
    port = EnhanceService(model_dir, 'cpu')
    spec = importlib.util.spec_from_file_location(
        'serve_model', os.path.join(ROOT, 'scripts', 'serve_model.py'))
    serve_model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_model)
    ref = serve_model.EnhanceService(model_dir)
    np.testing.assert_allclose(port.enhance(audio), ref.enhance(audio),
                               atol=1e-4, rtol=1e-4)


def test_cli_options_follow_the_signature():
    options = train_cli.trainer_options()
    defaults = {name: p.default for name, p in
                inspect.signature(BreverTrainer).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert set(options) == set(defaults)
    assert options['val_metrics']('snr,sisnr') == {'snr', 'sisnr'}
    assert options['save_on_epochs']('1,3') == [1, 3]
    assert options['use_amp']('false') is False
    assert options['device']('0') == '0'
    assert options['pad_quantum']('0.25') == 0.25


def test_reduce_lr_on_plateau_sequence():
    """The sequence tests/test_training.py pins for the JAX scheduler."""
    sched = ReduceLROnPlateau(init_lr=1.0, factor=0.5, patience=2)
    assert sched.step(1.0) is None   # first -> best
    assert sched.step(1.1) is None   # bad 1
    assert sched.step(1.2) is None   # bad 2
    assert sched.step(1.3) == 0.5    # bad 3 -> drop
    assert sched.step(0.5) is None   # improvement resets
    assert sched.state_dict() == {'lr': 0.5, 'best': 0.5, 'num_bad': 0}


def _plateaued(trainer):
    """Make the next validation a plateau: the scheduler drops the
    learning rate at once."""
    trainer.model.scheduler.best = -float('inf')
    trainer.model.scheduler.patience = 0


def test_on_validate_drop_keeps_the_moments(tmp_path):
    trainer = make_trainer(tmp_path, arch='tfgridnet')
    # inject_hyperparams holds the hyperparameters as float32 from the start
    assert trainer.optimizer.learning_rate == float(np.float32(1e-3))
    assert trainer.optimizer.b2 == float(np.float32(0.999))
    trainer.init_state()
    item = trainer.train_dataset[0][..., :3200]
    trainer.train_step(torch.from_numpy(np.stack([item, item])),
                       torch.tensor([3200, 2000]))
    mu, nu = trainer.optimizer.mu.clone(), trainer.optimizer.nu.clone()
    _plateaued(trainer)
    update = trainer.model.on_validate(1.0)
    assert update == {'learning_rate': 5e-4}
    trainer._apply_hyper_update(update)
    assert trainer.optimizer.learning_rate == float(np.float32(5e-4))
    assert torch.equal(trainer.optimizer.mu, mu)
    assert torch.equal(trainer.optimizer.nu, nu)
    # a family without injected hyperparameters ignores updates, as optax
    # state without hyperparams does in the JAX trainer
    plain = make_trainer(tmp_path / 'c')
    plain._apply_hyper_update({'learning_rate': 1.0})
    assert plain.optimizer.learning_rate == 1e-3


def test_tfgridnet_checkpoint_carries_the_learning_rate(tmp_path):
    """A drop on validation goes into last.ckpt in optax's
    inject_hyperparams layout; the JAX package reads the checkpoint and
    restores its optimizer state from it; a resumed port trainer trains on
    at the dropped rate."""
    first = make_trainer(tmp_path, arch='tfgridnet', epochs=1)
    _plateaued(first)
    first.run()
    lr = float(np.float32(5e-4))
    assert first.optimizer.learning_rate == lr
    path = tmp_path / 'checkpoints' / 'last.ckpt'
    state = jax_load_checkpoint(path)
    clip, (count, hyper, hyper_states, (adam, empty)) = state['opt_state']
    assert clip == [] and hyper_states == {} and empty == []
    assert float(hyper['learning_rate']) == lr
    assert int(count) == int(adam[0]) == first.step > 0

    jax_model = JaxModels.get('tfgridnet')(**GRID)
    params = jax_model.init_variables(jax.random.PRNGKey(0))['params']
    tx = optax.chain(optax.clip_by_global_norm(jax_model.grad_clip),
                     jax_model.optimizer())
    restored = _restore_opt_state(tx.init(params), state['opt_state'])
    assert float(restored[1].hyperparams['learning_rate']) == lr
    np.testing.assert_array_equal(
        np.asarray(restored[1].inner_state[0].mu['embed']['kernel']),
        state['opt_state'][1][3][0][1]['embed']['kernel'])

    resumed = make_trainer(tmp_path, arch='tfgridnet', epochs=2)
    resumed.run()
    assert resumed.epochs_ran == 2
    assert resumed.optimizer.learning_rate == lr
    assert resumed.model.scheduler.lr == 5e-4


def test_tfgridnet_train_cli_and_serving(tmp_path):
    """python -m brever_tpu_torch.train on a small TF-GridNet model
    directory (its config's multiresyu criterion); both packages' servers
    serve what it wrote."""
    model_dir = _model_dir(tmp_path, 'tfgridnet')
    train_cli.main([model_dir, '--device', 'cpu', '--epochs', '1',
                    '--use_amp', 'false', '--val_metrics', 'snr',
                    '--batch_size', '2', '--dynamic_batch_size', 'false',
                    '--batch_sampler', 'random', '--val_period', '1'])
    state = load_checkpoint(os.path.join(model_dir, 'checkpoints',
                                         'last.ckpt'))
    assert 'learning_rate' in state['opt_state'][1][1]
    assert np.isfinite(np.load(os.path.join(model_dir, 'losses.npz'),
                               allow_pickle=True)['train'][0])
    audio = np.random.RandomState(3).randn(3000).astype(np.float32) * 0.1
    port = EnhanceService(model_dir, 'cpu')
    assert port.health()['arch'] == 'tfgridnet'
    spec = importlib.util.spec_from_file_location(
        'serve_model', os.path.join(ROOT, 'scripts', 'serve_model.py'))
    serve_model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_model)
    ref = serve_model.EnhanceService(model_dir)
    np.testing.assert_allclose(port.enhance(audio), ref.enhance(audio),
                               atol=1e-4, rtol=1e-4)


def test_sgmse_resume_continues_the_generator(tmp_path):
    """The loss draws t and its noise from the trainer's generator: a run
    resumed from last.ckpt (generator state included) equals the
    uninterrupted one bitwise."""
    whole = make_trainer(tmp_path / 'whole', arch='sgmsepm', epochs=2)
    whole.run()
    make_trainer(tmp_path / 'split', arch='sgmsepm', epochs=1).run()
    resumed = make_trainer(tmp_path / 'split', arch='sgmsepm', epochs=2)
    resumed.run()
    assert torch.equal(resumed.flat, whole.flat)
    assert torch.equal(resumed.optimizer.nu, whole.optimizer.nu)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert resumed.loss_logger.train_loss == whole.loss_logger.train_loss
    assert resumed.loss_logger.val_loss == whole.loss_logger.val_loss
    # another seed draws other t and noise
    other = make_trainer(tmp_path / 'other', arch='sgmsepm', epochs=1,
                         seed=1)
    other.init_state()
    other.flat.copy_(whole.flat)
    batch = torch.from_numpy(other.train_dataset[0][None, ..., :4000])
    n = torch.tensor([4000])
    assert not torch.equal(other.train_step(batch, n),
                           whole.train_step(batch, n))


def test_sgmse_validation_loss_is_fixed(tmp_path):
    """Validation reseeds its own generator for every batch: the same
    parameters give the same validation loss twice, whatever the training
    generator drew in between and in whatever order the sampler gives the
    batches."""
    trainer = make_trainer(tmp_path, arch='sgmsepm', val_metrics=set(),
                           val_dataset=DummyDataset(
                               n_items=4, min_length=0.2, max_length=0.4,
                               seed=7))
    trainer.init_state()
    trainer.val_dataloader.set_epoch(0)
    first, _ = trainer.routine(0, train=False)
    saved = trainer.flat.clone()
    batch = torch.from_numpy(trainer.train_dataset[0][None, ..., :4000])
    trainer.train_step(batch, torch.tensor([4000]))
    assert not torch.equal(trainer.flat, saved)
    trainer.flat.copy_(saved)
    trainer.val_dataloader.set_epoch(1)
    again, _ = trainer.routine(1, train=False)
    assert np.isfinite(first) and again == first


def _constant_noise(monkeypatch):
    """The same constant in place of every draw of both packages'
    solvers."""
    def jax_noise(key, x):
        return jnp.full(x.shape, 0.1 + 0.05j if jnp.iscomplexobj(x) else 0.1,
                        x.dtype)

    def torch_noise(x, generator=None):
        return torch.full(x.shape, 0.1 + 0.05j if x.is_complex() else 0.1,
                          dtype=x.dtype)

    monkeypatch.setattr(jax_sdes, '_randn_like', jax_noise)
    monkeypatch.setattr(jax_solvers, '_randn_like', jax_noise)
    monkeypatch.setattr(sdes, 'randn_like', torch_noise)


def test_sgmse_train_cli_and_serving(tmp_path, monkeypatch):
    """python -m brever_tpu_torch.train on a tiny sgmsepm model directory
    (its config's mse criterion and Adam): last.ckpt holds the Fourier
    frequencies in ``aux['buffers']``, the JAX package reads it, and both
    packages' servers serve it (with the solvers' noise replaced by one
    constant in both, they agree within 1e-4)."""
    model_dir = _model_dir(tmp_path, 'sgmsepm')
    train_cli.main([model_dir, '--device', 'cpu', '--epochs', '2',
                    '--use_amp', 'false', '--val_metrics', 'snr',
                    '--batch_size', '2', '--dynamic_batch_size', 'false',
                    '--batch_sampler', 'random', '--val_period', '1'])
    path = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    state = jax_load_checkpoint(path)
    freqs = state['aux']['buffers']['emb']['fourier_freqs']
    port = EnhanceService(model_dir, 'cpu')
    assert port.health()['arch'] == 'sgmsepm'
    np.testing.assert_array_equal(
        freqs, port.model.net.emb.fourier_freqs.numpy())
    assert 'torch_generator' in state and state['rng'].tolist() == [0, 0]
    losses = np.load(os.path.join(model_dir, 'losses.npz'),
                     allow_pickle=True)
    assert np.isfinite(list(losses['train'])).all()
    assert np.isfinite(list(losses['val'])).all()

    _constant_noise(monkeypatch)
    audio = np.random.RandomState(4).randn(3000).astype(np.float32) * 0.1
    spec = importlib.util.spec_from_file_location(
        'serve_model', os.path.join(ROOT, 'scripts', 'serve_model.py'))
    serve_model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_model)
    ref = serve_model.EnhanceService(model_dir)
    got = port.enhance(audio)
    assert got.shape == (3000,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.enhance(audio), atol=1e-4,
                               rtol=1e-4)
