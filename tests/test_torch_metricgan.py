"""MetricGAN (``metricganokd``, ``metricganp``) in the port against the JAX
package, one set of flax weights and ``batch_stats`` given to both through
``brever_tpu_torch.convert``. Small widths (``GOLDEN_KWARGS['metricganokd']``
of ``tests/test_training.py``: two generators, so the distillation term
runs) at dropout 0, where the two packages' random draws cannot differ.

Tolerances, float32 on both sides (the port's sums run in other orders):
enhanced audio, discriminator scores and the losses within 1e-5 of the
largest value; BatchNorm statistics, ``u`` and ``sigma`` within 1e-5; after
one GAN step with the same scores and augmented signal, every parameter
within 2e-6 (2 % of the 1e-4 learning rate: Adam's first update is
``lr g / (|g| + eps)``, which amplifies the gradients' rounding where
``|g|`` nears eps) and Adam's first moments (the clipped gradients times
0.1) within 1e-4 of their largest value. The device scorer against the JAX
one within 1e-5 (both float32 twins).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from brever_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models import metricgan as jax_metricgan
from brever_tpu.training import BreverTrainer as JaxTrainer
from brever_tpu.training import _restore_opt_state
from brever_tpu_torch import train as train_cli
from brever_tpu_torch.checkpoint import load_checkpoint
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models import metricgan
from brever_tpu_torch.pesq import close_pool
from brever_tpu_torch.serve import EnhanceService
from brever_tpu_torch.training import BreverTrainer
from test_torch_data import write_wav_dataset
from utils import DummyDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(target_metrics=['stoi', 'estoi'], inference_metric='stoi',
             generator_lstm_hidden_size=16, generator_fc_channels=[16],
             discriminator_conv_channels=[4, 8],
             discriminator_fc_channels=[8], generator_lstm_dropout=0.0)
T = 6000
N_PARAMS = {'metricganp': 1_914_524, 'metricganokd': 2_172_329}


@pytest.fixture(scope='module', autouse=True)
def _threads():
    torch.set_num_threads(1)
    yield
    close_pool()


@pytest.fixture(scope='module')
def jax_small():
    """The JAX model at the small width, its variables (numpy) and its
    jitted GAN phases."""
    model = JaxModels.get('metricganokd')(**SMALL)
    variables = jax.tree.map(np.asarray,
                             model.init_variables(jax.random.PRNGKey(0)))
    tx = model.optimizer()
    make_candidates, train_step, val_step = model.device_step_fns(tx)
    return types.SimpleNamespace(
        model=model, params=variables['params'],
        stats=variables['batch_stats'], tx=tx,
        train_step=jax.jit(train_step), val_step=jax.jit(val_step))


def _port(jax_small, arch='metricganokd', **kwargs):
    model = ModelRegistry.get(arch)(**SMALL, **kwargs, device='cpu')
    model.load_state_dict(model.from_flax(
        jax_small.params, {'batch_stats': jax_small.stats}))
    return model


def _batch(seed=0, batch=8, length=T):
    rng = np.random.RandomState(seed)
    clean = 0.3 * rng.randn(batch, 1, 2, length)
    return np.concatenate([clean + 0.2 * rng.randn(*clean.shape), clean],
                          1).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, atol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize('arch', ['metricganp', 'metricganokd'])
def test_parameter_counts_and_bridge(arch):
    """The full width's parameter count, and its flax trees (``params`` and
    ``batch_stats``, names and shapes) are the JAX init's; the bridge's
    round trip is the identity."""
    model = ModelRegistry.get(arch)(device='cpu')
    assert count_params(model) == N_PARAMS[arch]
    shapes = jax.eval_shape(JaxModels.get(arch)().init_variables,
                            jax.random.PRNGKey(0))
    sd = model.state_dict()
    params, aux = model.to_flax(sd), model.flax_aux(sd)
    for ours, theirs in ((params, shapes['params']),
                         (aux['batch_stats'], shapes['batch_stats'])):
        ours = {k: v.shape for k, v in _leaves(ours).items()}
        assert ours == {jax.tree_util.keystr(k): tuple(v.shape) for k, v
                        in jax.tree_util.tree_leaves_with_path(theirs)}
    back = model.from_flax(params, aux)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    u = aux['batch_stats']['discriminator']['SpectralNorm_0'][
        'conv_0/kernel/u']
    assert u.shape == (1, 15 if arch == 'metricganp' else 16)


@pytest.mark.parametrize('train', [False, True])
def test_generator_and_discriminator(jax_small, train):
    """Each generator's masked magnitude; the discriminator's scores and,
    in train mode, its BatchNorm statistics and every ``u``/``sigma`` after
    the call; in eval mode the power step runs (the scores use it) and
    nothing is stored."""
    port = _port(jax_small)
    jm = jax_small.model
    rng = np.random.RandomState(1)
    mag = np.abs(rng.randn(3, 257, 20)).astype(np.float32)
    clean = np.abs(rng.randn(3, 257, 20)).astype(np.float32)
    for i in range(2):
        want = np.asarray(jm._apply_generator(jax_small.params, i,
                                              jnp.asarray(mag)))
        got = port.generators[i](torch.from_numpy(mag), train).detach()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    want, stats = jm._apply_discriminator(
        jax_small.params, jax_small.stats['discriminator'],
        jnp.asarray(mag), jnp.asarray(clean), train=train)
    got = port.discriminator(torch.from_numpy(mag), torch.from_numpy(clean),
                             train=train).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    _close(port.flax_aux(port.state_dict())['batch_stats']['discriminator'],
           stats, 1e-5)
    after = port.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    if train:
        assert changed == {k for k in after if '.spectral.' in k
                           or k.startswith('discriminator.norm.')
                           and k.endswith(('mean', 'var'))}
    else:
        assert not changed


def test_spectral_norm_is_flax_power_step():
    """One layer against ``flax.linen.SpectralNorm`` over a Dense: the
    normalised output and the stored ``u``/``sigma``, for two calls that
    thread the state."""
    import flax.linen as nn
    rng = np.random.RandomState(2)
    x = rng.randn(4, 6).astype(np.float32)
    layer = nn.SpectralNorm(nn.Dense(5))
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           update_stats=False)
    kernel = np.asarray(variables['params']['layer_instance']['kernel'])
    sn = metricgan.SpectralNorm(5)
    sn.u.copy_(torch.from_numpy(np.asarray(
        variables['batch_stats']['layer_instance/kernel/u'])))
    state = variables
    for _ in range(2):
        want, updates = layer.apply(state, jnp.asarray(x), update_stats=True,
                                    mutable=['batch_stats'])
        state = {'params': variables['params'], **updates}
        got = torch.from_numpy(x) @ sn(torch.from_numpy(kernel), True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        stats = updates['batch_stats']
        np.testing.assert_allclose(
            sn.u.numpy(), np.asarray(stats['layer_instance/kernel/u']),
            atol=1e-6)
        np.testing.assert_allclose(
            float(sn.sigma),
            float(stats['layer_instance/kernel/sigma']),
            rtol=1e-6)


def test_enhance_and_losses(jax_small):
    """``enhance`` of the inference generator, and the validation losses
    (every module in eval mode) with given scores and augmented signal."""
    port = _port(jax_small)
    batch = _batch()
    want = np.asarray(jax_small.model.enhance(
        {'params': jax_small.params, 'batch_stats': jax_small.stats},
        jnp.asarray(batch[:, 0])))
    got = port.enhance(batch[:, 0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    scores, aug = _scores_and_aug(batch)
    state = _jax_state(jax_small)
    _, loss = jax_small.val_step(state, jnp.asarray(batch),
                                 jnp.full(8, T), _jnp(scores),
                                 jnp.asarray(aug))
    got = port.val_losses(torch.from_numpy(batch), _torch(scores),
                          torch.from_numpy(aug))
    for key in ('loss_g', 'loss_d'):
        assert abs(float(got[key]) - float(loss[key])) \
            <= 1e-5 * abs(float(loss[key]))


def _scores_and_aug(batch, seed=3):
    rng = np.random.RandomState(seed)
    n = batch.shape[0]
    scores = {'noisy': rng.rand(n, 2), 'enh': rng.rand(2, n, 2),
              'aug': rng.rand(n, 2)}
    aug = batch[:, 1].mean(-2) + 0.05 * rng.randn(n, batch.shape[-1])
    return ({k: v.astype(np.float32) for k, v in scores.items()},
            aug.astype(np.float32))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax_state(jax_small):
    return {'params': _jnp(jax_small.params),
            'aux': {'batch_stats': _jnp(jax_small.stats)},
            'opt_state': jax_small.model.init_opt_state(jax_small.tx,
                                                        jax_small.params),
            'step': jnp.zeros((), jnp.int32), 'rng': jax.random.PRNGKey(1)}


def _trainer(tmp_path, model, **kwargs):
    kwargs = dict(dict(train_dataset=DummyDataset(n_items=6, min_length=0.5,
                                                  max_length=1.0),
                       val_dataset=DummyDataset(n_items=2, min_length=0.5,
                                                max_length=1.0, seed=7),
                       model_dirpath=str(tmp_path), epochs=1, device='cpu',
                       batch_size=16.0, val_metrics=set(), val_period=1,
                       seed=0), **kwargs)
    return BreverTrainer(model=model, **kwargs)


def test_train_step_is_the_jax_one(jax_small, tmp_path):
    """One GAN step with the same scores and augmented signal: both
    losses, every updated parameter, the BatchNorm statistics and each
    ``u``/``sigma`` after the discriminator's three calls a generator,
    Adam's count and moments of all three optimizers; the step leaves the
    JAX package's optimizer-state layout, which its trainer restores."""
    trainer = _trainer(tmp_path, ModelRegistry.get('metricganokd')(
        **SMALL, device='cpu'))
    trainer.init_state()
    port = trainer.model
    port.load_state_dict(port.from_flax(jax_small.params,
                                        {'batch_stats': jax_small.stats}))
    batch = _batch(4)
    scores, aug = _scores_and_aug(batch, 5)
    state = _jax_state(jax_small)
    new_state, loss = jax_small.train_step(
        state, jnp.asarray(batch), jnp.full(8, T), _jnp(scores),
        jnp.asarray(aug))
    got = port.update(trainer, torch.from_numpy(batch), _torch(scores),
                      torch.from_numpy(aug))
    for key in ('loss_g', 'loss_d'):
        assert abs(float(got[key]) - float(loss[key])) \
            <= 1e-5 * abs(float(loss[key]))
    sd = port.state_dict()
    _close(port.to_flax(sd), new_state['params'], 2e-6)
    _close(port.flax_aux(sd), new_state['aux'], 1e-5)
    tree = trainer._opt_state_tree()
    assert sorted(tree) == ['discriminator', 'generators']
    assert len(tree['generators']) == 2
    restored = _restore_opt_state(
        jax_small.model.init_opt_state(jax_small.tx, jax_small.params),
        tree)
    want = jax.tree_util.tree_leaves(new_state['opt_state'])
    for got_leaf, want_leaf in zip(jax.tree_util.tree_leaves(restored),
                                   want):
        got_leaf, want_leaf = np.asarray(got_leaf), np.asarray(want_leaf)
        scale = max(np.abs(want_leaf).max(), 1e-30)
        np.testing.assert_allclose(got_leaf, want_leaf, rtol=0,
                                   atol=1e-4 * scale)


def test_loader_transform_and_scorer_calls(jax_small, tmp_path):
    """``loader_transform`` is the JAX one (the mono pair bitwise, the
    noisy score's host metrics); in training the loader scores each item
    once and each step makes two batched host calls (enhanced, augmented),
    as the JAX test of ``precompute_metric`` pins."""
    port = ModelRegistry.get('metricganokd')(
        **dict(SMALL, target_metrics=['stoi'], inference_metric='stoi'),
        device='cpu')
    jm = JaxModels.get('metricganokd')(
        **dict(SMALL, target_metrics=['stoi'], inference_metric='stoi'))
    item = np.random.RandomState(0).randn(2, 2, 9000).astype('float32')
    mono, score = port.loader_transform(item)
    want_mono, want_score = jm.loader_transform(item)
    np.testing.assert_array_equal(mono, want_mono)
    np.testing.assert_array_equal(score, want_score)
    assert mono.shape == (2, 9000) and score.shape == (1,)

    scored = []
    original = port._score

    def counting(deg, ref, lengths):
        scored.append(np.asarray(deg).shape[0])
        return original(deg, ref, lengths)

    port._score = counting
    tf = port.loader_transform
    trainer = _trainer(tmp_path, port, train_dataset=DummyDataset(
        n_items=6, min_length=0.5, max_length=1.0, transform=tf),
        val_dataset=DummyDataset(n_items=2, min_length=0.5, max_length=1.0,
                                 seed=7, transform=tf))
    trainer.run()
    n_steps = len(trainer.train_batch_sampler) \
        + len(trainer.val_batch_sampler)
    assert len([s for s in scored if s > 1]) == 2 * n_steps
    assert len([s for s in scored if s == 1]) >= 6
    losses = trainer.loss_logger.train_loss
    assert set(losses[0]) == {'loss_g', 'loss_d'}
    assert all(np.isfinite(v) for v in losses[0].values())


def test_device_scorer_is_the_jax_one():
    """``_device_metrics`` (STOI, ESTOI and normalised PESQ as regression
    targets) against the JAX package's on the same batch."""
    rng = np.random.RandomState(6)
    clean = 0.3 * rng.randn(3, 16000)
    deg = (clean + 0.1 * rng.randn(3, 16000)).astype(np.float32)
    clean = clean.astype(np.float32)
    lengths = np.array([16000, 12000, 9000])
    names = ['stoi', 'estoi', 'pesq']
    want = np.asarray(jax_metricgan._device_metrics(names, 16000)(
        jnp.asarray(deg), jnp.asarray(clean), jnp.asarray(lengths)))
    got = metricgan._device_metrics(names, 16000)(
        torch.from_numpy(deg), torch.from_numpy(clean),
        torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_device_metric_scoring_never_calls_the_host_scorer(tmp_path):
    """With ``device_metric_scoring`` the step scores with the device
    twins: the host scorer is never called."""
    model = ModelRegistry.get('metricganokd')(
        **dict(SMALL, target_metrics=['stoi'], inference_metric='stoi'),
        device_metric_scoring=True, precompute_metric=False, device='cpu')

    def forbidden(*args, **kwargs):
        raise AssertionError('host scorer called with device scoring on')

    model._score = forbidden
    trainer = _trainer(tmp_path, model, train_dataset=DummyDataset(
        n_items=2, min_length=0.9, max_length=1.0))
    trainer.run()
    losses = trainer.loss_logger.train_loss
    assert all(np.isfinite(v) for v in losses[0].values())


def test_pad_batch_pads_lists_as_the_jax_trainer():
    """A loader-transformed list batch is padded to 8 rows element by
    element with copies of row 0, lengths 0, as the JAX ``_pad_batch``."""
    rng = np.random.RandomState(7)
    batch = [rng.randn(3, 2, 40).astype(np.float32),
             rng.randn(3, 8000).astype(np.float32)]
    lengths = np.array([[40, 1], [30, 1], [20, 1]], np.int32)
    got = BreverTrainer._pad_batch(batch, lengths)
    want = JaxTrainer._pad_batch(types.SimpleNamespace(n_devices=1), batch,
                                 lengths)
    assert got[2] == want[2] == 3
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])


def test_enhance_at_default_width():
    """``metricganp`` at its default width (two BLSTMs of 200 units) from
    the same flax weights: ``enhance`` of (2, 2, 8000)."""
    jm = JaxModels.get('metricganp')()
    variables = jax.tree.map(np.asarray,
                             jm.init_variables(jax.random.PRNGKey(3)))
    port = ModelRegistry.get('metricganp')(device='cpu')
    port.load_state_dict(port.from_flax(
        variables['params'], {'batch_stats': variables['batch_stats']}))
    x = _batch(8, batch=2, length=8000)[:, 0]
    want = np.asarray(jm.enhance(variables, jnp.asarray(x)))
    got = port.enhance(x).numpy()
    assert got.shape == (2, 8000)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _model_dir(tmp_path, name='model'):
    """A ``metricganp`` model directory from the default config with the
    model's widths cut (its trainer settings untouched) and WAV sets."""
    with open(os.path.join(ROOT, 'config', 'models', 'metricganp.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    config['model'].update(generator_lstm_hidden_size=16,
                           generator_fc_channels=[16],
                           discriminator_conv_channels=[4, 4],
                           discriminator_fc_channels=[8])
    config['train_path'] = write_wav_dataset(str(tmp_path / 'train'),
                                             [8000, 9000, 12000, 7000])
    config['val_path'] = write_wav_dataset(str(tmp_path / 'val'),
                                           [8000, 7000], seed=1)
    model_dir = tmp_path / name
    model_dir.mkdir()
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump(config, f)
    return str(model_dir)


def test_train_main_resumes_bitwise_and_serves(tmp_path):
    """``python -m brever_tpu_torch.train`` from the default
    ``metricganp.yaml`` with the model's widths cut and only ``--device
    cpu --epochs --val_period`` given: host PESQ targets from the loader,
    ``estoi``/``pesq``/``snr`` validation by the device twins, dict
    losses; a resumed run's state (parameters, both optimizers, ``aux``)
    equals an uninterrupted run's bit for bit; the JAX package's loader
    and the port's server read the checkpoint."""
    dirs = [_model_dir(tmp_path, name) for name in ('once', 'twice')]
    base = ['--device', 'cpu', '--val_period', '1']
    once = train_cli.main([dirs[0], '--epochs', '2'] + base)
    losses = once.loss_logger.train_loss
    assert set(losses[0]) == {'loss_g', 'loss_d'}
    assert set(once.loss_logger.metrics[0]) == {'estoi', 'pesq', 'snr'}
    train_cli.main([dirs[1], '--epochs', '1'] + base)
    os.remove(os.path.join(dirs[1], 'losses.npz'))
    twice = train_cli.main([dirs[1], '--epochs', '2'] + base)
    assert twice.epochs_ran == 2
    assert torch.equal(once.flat, twice.flat)
    a, b = (load_checkpoint(os.path.join(d, 'checkpoints', 'last.ckpt'))
            for d in dirs)
    for key in ('params', 'aux', 'opt_state'):
        for x, y in zip(jax.tree_util.tree_leaves(a[key]),
                        jax.tree_util.tree_leaves(b[key])):
            np.testing.assert_array_equal(x, y)
    state = jax_load_checkpoint(os.path.join(dirs[0], 'checkpoints',
                                             'last.ckpt'))
    assert len(state['opt_state']['generators']) == 1
    stats = state['aux']['batch_stats']['discriminator']
    assert stats['SpectralNorm_0']['conv_0/kernel/u'].shape == (1, 4)
    service = EnhanceService(dirs[0], 'cpu')
    audio = np.random.RandomState(9).randn(4000).astype(np.float32) * 0.1
    out = service.enhance(audio)
    assert out.shape == (4000,) and np.isfinite(out).all()
