"""The port's FFNN (brever_tpu_torch.models.ffnn, .ops.features and
``MelFilterbank`` in .ops.stft) against the JAX package's, on the CPU.

* ``MelFilterbank``: the filters and the inverse filters bit for bit, its
  ``forward`` and ``backward`` at relative 1e-6 of the largest value.
* Each of the twelve features on one random binaural STFT (and a sorted
  stack of three with its ``indices``) at relative 1e-5 of the largest
  value; the doubling scan of ``ic``'s smoothing against
  ``first_order_smooth`` (``jax.lax.associative_scan``) past the 55 frames
  where ``alpha ** -t`` would overflow float32, at 1e-6.
* ``stack`` and ``decimate`` exactly; ``irm``, ``normalize`` (static, with
  stats off their initial values) and ``transform`` at decimation 1 and 2
  at relative 1e-5; cumulative ``normalize`` at 1e-4 (``E[x ** 2] - mean **
  2`` of float32 prefix sums cancels, and XLA sums them in another order);
  the per-item ``loss`` in eval mode and in train mode at dropout 0 on a
  padded batch (a short row, a row of length 0) at relative 1e-5; its
  gradients, the port's and the JAX package's in float32, each against the
  port's float64 gradient at rtol 1e-4 with a floor of 1e-4 of the largest
  gradient.
* Dropout's mask in train mode: values 0 or ``1 / (1 - p)``, a keep rate
  within 0.005 of ``1 - p`` over 262,144 draws (18 standard deviations),
  the same mask from the same generator seed, none in eval mode.
* The full width: 1,509,440 parameters, the bridge's tree against
  ``jax.eval_shape`` of ``init_variables`` (``params`` and ``stats``), one
  ``enhance`` of a 4,096-sample clip at relative 1e-4.
* ``pre_train`` on batches of a small WAV set against the JAX ``pre_train``
  at relative 1e-5 (both accumulate in float64); it leaves ``cumulative``
  models alone; the ``stats`` ride in a checkpoint's ``aux``, which the
  JAX loader reads.
* ``python -m brever_tpu_torch.train`` on the CPU from the untouched
  default ``ffnn`` config but ``hidden_layers: [64]`` (its validation
  metrics ``estoi``, ``pesq`` and ``snr`` scored by the device twins):
  ``stats`` in ``last.ckpt``, a bitwise resume, and both packages' servers
  on what it wrote at atol 1e-4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from brever_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.ops import features as jax_features
from brever_tpu.ops.stft import MelFilterbank as JaxMelFilterbank
from brever_tpu_torch import train as train_cli
from brever_tpu_torch.batching import BatchSamplerRegistry
from brever_tpu_torch.data import BreverDataLoader, BreverDataset
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models.ffnn import _MLP
from brever_tpu_torch.ops import features
from brever_tpu_torch.ops.stft import MelFilterbank
from brever_tpu_torch.serve import EnhanceService
from test_torch_data import write_wav_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_layers=[32], stacks=3, mel_filters=24,
             stft_frame_length=256, stft_hop_length=128, dropout=0.0)
ALL_FEATURES = ['fbe', 'logfbe', 'cubicfbe', 'pdf', 'logpdf', 'cubicpdf',
                'mfcc', 'cubicmfcc', 'pdfcc', 'ild', 'ipd', 'ic']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _binaural_stft(seed, bins=257, frames=40):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 2, bins, frames)
            + 1j * rng.randn(2, 2, bins, frames)).astype(np.complex64)


def _sources(seed, shape):
    """``(B, 2 sources, 2 channels, n)``: a target and the mixture over
    it."""
    rng = np.random.RandomState(seed)
    target = 0.3 * rng.randn(*shape[:1], 1, *shape[2:])
    return np.concatenate([target + 0.3 * rng.randn(*target.shape), target],
                          axis=1).astype(np.float32)


def _variables(jax_model, seed):
    """FFNN variables from numpy: kernels at 1 / sqrt(fan in), biases
    small, stats off their initial values."""
    shapes = jax.eval_shape(jax_model.init_variables, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*s.shape) / np.sqrt(s.shape[0])) \
                .astype(np.float32)
        if name == 'std':
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _twins(seed=0, **kwargs):
    """The JAX and the port's FFNN with one set of variables."""
    options = dict(SMALL, **kwargs)
    jax_model = JaxModels.get('ffnn')(**options)
    variables = _variables(jax_model, seed)
    model = ModelRegistry.get('ffnn')(**options, device='cpu')
    model.load_state_dict(model.from_flax(variables['params'], variables))
    return jax_model, variables, model


def test_mel_filterbank_is_the_jax_packages():
    for kwargs in (dict(), dict(n_filters=24, n_fft=256)):
        mine, theirs = MelFilterbank(**kwargs), JaxMelFilterbank(**kwargs)
        np.testing.assert_array_equal(mine.filters, np.asarray(
            theirs.filters))
        np.testing.assert_array_equal(mine.inverse_filters, np.asarray(
            theirs.inverse_filters))
        x = np.abs(np.random.RandomState(1).randn(
            2, mine.filters.shape[1], 9)).astype(np.float32)
        _close(mine(torch.from_numpy(x)), theirs(jnp.asarray(x)), 1e-6)
        m = x[:, :mine.n_filters]
        _close(mine.backward(torch.from_numpy(m)),
               theirs.backward(jnp.asarray(m)), 1e-6)


@pytest.mark.parametrize('feature', ALL_FEATURES)
def test_each_feature_matches_jax(feature):
    x = _binaural_stft(2)
    mine = features.FeatureExtractor({feature}, MelFilterbank())
    theirs = jax_features.FeatureExtractor({feature}, JaxMelFilterbank())
    want = jax.jit(theirs)(jnp.asarray(x))
    got = mine(torch.from_numpy(x))
    assert mine.n_features == theirs.n_features == got.shape[1]
    assert np.isfinite(got.numpy()).all()
    _close(got, want)
    # unbatched input
    _close(mine(torch.from_numpy(x[0])), np.asarray(want)[0])


def test_sorted_stack_and_indices_match_jax():
    x = _binaural_stft(3, bins=129, frames=12)
    chosen = {'mfcc', 'ic', 'logfbe'}
    mine = features.FeatureExtractor(chosen, MelFilterbank(24, 256))
    theirs = jax_features.FeatureExtractor(chosen, JaxMelFilterbank(24, 256))
    got = mine(torch.from_numpy(x))
    want = jax.jit(theirs)(jnp.asarray(x))
    assert mine.features == theirs.features == ['ic', 'logfbe', 'mfcc']
    assert mine.indices == theirs.indices
    _close(got, want)


def test_doubling_scan_matches_first_order_smooth():
    rng = np.random.RandomState(4)
    x = np.abs(rng.randn(3, 5, 300)).astype(np.float32)
    alpha = float(np.exp(-256 / 160))
    want = jax.jit(lambda v: jax_features.first_order_smooth(v, alpha))(
        jnp.asarray(x))
    got = features.first_order_smooth(torch.from_numpy(x), alpha)
    _close(got, want, 1e-6)
    # along another axis, and against the recurrence in float64
    y = np.zeros((3, 300, 5))
    xt = x.transpose(0, 2, 1).astype(np.float64)
    for t in range(300):
        y[:, t] = (1 - alpha) * xt[:, t] + alpha * (y[:, t - 1] if t else 0)
    _close(features.first_order_smooth(torch.from_numpy(xt), alpha, dim=1),
           y, 1e-12)


def test_stack_decimate_irm_and_normalize_match_jax():
    for normalization in ('static', 'cumulative'):
        jax_model, variables, model = _twins(
            decimation=2, normalization=normalization)
        feats = np.random.RandomState(5).randn(2, model.input_size // 4, 11) \
            .astype(np.float32)
        stacked = model.stack(torch.from_numpy(feats))
        _close(stacked, jax_model.stack(jnp.asarray(feats)), 0)
        _close(model.decimate(stacked), jax_model.decimate(
            jnp.asarray(stacked.numpy())), 0)
        # cumulative: E[x ** 2] - mean ** 2 of float32 prefix sums, which
        # XLA sums in another order, cancels; 1e-4 there
        _close(model.normalize(stacked),
               jax_model.normalize(variables, jnp.asarray(stacked.numpy())),
               1e-5 if normalization == 'static' else 1e-4)
    mags = np.abs(_binaural_stft(6, bins=129, frames=10))
    _close(model.irm(*torch.from_numpy(mags)),
           jax_model.irm(*jnp.asarray(mags)))


@pytest.mark.parametrize('decimation', [1, 2])
def test_transform_matches_jax(decimation):
    jax_model, _, model = _twins(decimation=decimation,
                                 features={'logfbe', 'ild', 'ic'})
    x = _sources(7, (2, 2, 2, 3000))
    got = model.transform(torch.from_numpy(x))
    want = jax.jit(jax_model.transform)(jnp.asarray(x))
    assert got.shape[1] == model.input_size + model.output_size
    _close(got, want)
    _close(model.transform(torch.from_numpy(x[0])), np.asarray(want)[0])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_loss_and_gradients_match_jax(train):
    """Eval mode, and train mode at dropout 0 (a flax and a torch dropout
    mask are other draws)."""
    jax_model, variables, model = _twins(seed=8)
    batch = _sources(9, (3, 2, 2, 3000))
    lengths = np.array([3000, 1700, 0])

    def jax_loss(params):
        per_item = jax_model.loss({'params': params, 'stats':
                                   variables['stats']}, jnp.asarray(batch),
                                  jnp.asarray(lengths),
                                  jax.random.PRNGKey(0), train=train)
        return per_item.mean(), per_item

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables['params'])

    def port(dtype):
        model.to(dtype).train(train)
        per_item = model.loss(torch.from_numpy(batch).to(dtype),
                              torch.from_numpy(lengths),
                              torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(per_item.mean(),
                                    list(model.parameters()))
        sd = {k: g for (k, _), g in zip(model.named_parameters(), grads)}
        return per_item.detach().double().numpy(), model.to_flax(sd)

    items, grads = port(torch.float32)
    _close(items, want)
    assert items[2] == 0.0
    _, grads64 = port(torch.float64)
    leaves64 = jax.tree.leaves(grads64)
    top = max(np.abs(g).max() for g in leaves64)
    for got in (grads, jax.tree.map(np.asarray, want_grads)):
        assert jax.tree.structure(got) == jax.tree.structure(grads64)
        for g, ref in zip(jax.tree.leaves(got), leaves64):
            np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-4 * top)


def test_dropout_mask_keeps_at_the_rate_and_scales():
    p = 0.25
    mlp = _MLP(8, [4096], 4, dropout=p)
    with torch.no_grad():
        mlp.Dense_0.weight.zero_()
        mlp.Dense_0.bias.fill_(1.0)      # every hidden activation is 1
    seen = []
    mlp.Dense_1.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    x = torch.randn(2, 8, 32)

    def hidden(seed):
        mlp(x, torch.Generator().manual_seed(seed))
        return seen[-1]

    mlp.train()
    h = hidden(0)
    assert h.numel() == 262_144
    kept = h != 0
    torch.testing.assert_close(h[kept], torch.full_like(h[kept], 1 / (1 - p)))
    assert abs(kept.double().mean().item() - (1 - p)) < 0.005
    assert torch.equal(hidden(0), h) and not torch.equal(hidden(1), h)
    mlp.eval()
    assert torch.equal(hidden(0), torch.ones_like(h))


def test_full_width_model():
    """The default geometry: 1,509,440 parameters, the bridge's tree
    against the JAX init's shapes, one enhance against JAX."""
    jax_model = JaxModels.get('ffnn')()
    model = ModelRegistry.get('ffnn')(device='cpu')
    assert count_params(model) == 1_509_440
    shapes = jax.eval_shape(jax_model.init_variables, jax.random.PRNGKey(0))
    sd = model.state_dict()
    params, aux = model.to_flax(sd), model.flax_aux(sd)
    for mine, theirs in ((params, shapes['params']),
                         (aux['stats'], shapes['stats'])):
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        assert [a.shape for a in jax.tree.leaves(mine)] == \
            [a.shape for a in jax.tree.leaves(theirs)]
    np.testing.assert_array_equal(aux['stats']['std'], 1.0)
    variables = _variables(jax_model, 10)
    model.load_state_dict(model.from_flax(variables['params'], variables))
    x = _sources(11, (1, 2, 2, 4096))[:, 0]
    want = jax.jit(jax_model._enhance)(variables, jnp.asarray(x))
    got = model.enhance(x)
    assert got.shape == (1, 4096)
    _close(got, want, 1e-4)


def _wav_batches(tmp_path):
    path = write_wav_dataset(str(tmp_path / 'train'),
                             [4000, 5000, 6000, 3000, 2500], seed=3)
    dataset = BreverDataset(path=path)
    loader = BreverDataLoader(
        dataset=dataset, pad_to_multiple=2000,
        batch_sampler=BatchSamplerRegistry.get('sorted')(
            dataset=dataset, batch_size=2, dynamic=False, shuffle=False))
    batches = list(loader)
    # a padding row of length 0, as the trainer's batches carry
    batch, lengths = batches[0]
    batches[0] = (np.concatenate([batch, batch[:1]]),
                  np.concatenate([lengths, [0]]))
    return batches


def test_pre_train_matches_jax(tmp_path):
    batches = _wav_batches(tmp_path)
    jax_model, variables, model = _twins(features={'logfbe', 'ipd'},
                                         decimation=2)
    want = jax_model.pre_train(dict(variables), None, batches, 1)['stats']
    model.pre_train(None, batches, 1)
    assert model.mean.dtype == model.std.dtype == torch.float32
    _close(model.mean, want['mean'])
    _close(model.std, want['std'])
    # cumulative normalisation keeps its buffers
    _, _, cumulative = _twins(normalization='cumulative')
    before = cumulative.state_dict()
    cumulative.pre_train(None, batches, 1)
    for key, value in cumulative.state_dict().items():
        assert torch.equal(value, before[key])


def _model_dir(tmp_path):
    """The untouched default ``ffnn`` config but a 64-unit hidden layer,
    over WAV datasets."""
    with open(os.path.join(ROOT, 'config', 'models', 'ffnn.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    config['model']['hidden_layers'] = [64]
    config['train_path'] = write_wav_dataset(
        str(tmp_path / 'train'), [8000, 9000, 10000, 7000, 6000, 8000])
    config['val_path'] = write_wav_dataset(str(tmp_path / 'val'),
                                           [8000, 7000], seed=1)
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump(config, f)
    return str(model_dir)


def test_train_cli_default_config_resumes_and_serves(tmp_path):
    model_dir = _model_dir(tmp_path)

    def args(epochs):
        return [model_dir, '--device', 'cpu', '--epochs', str(epochs),
                '--val_period', '1']

    first = train_cli.main(args(2))
    assert first.device_val_metrics
    metrics = first.loss_logger.metrics[-1]
    assert sorted(metrics) == ['estoi', 'pesq', 'snr']
    assert all(np.isfinite(v) for v in metrics.values())
    assert first.model.std.ne(1).any() and first.model.mean.ne(0).any()
    ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    state = jax_load_checkpoint(ckpt)
    np.testing.assert_array_equal(state['aux']['stats']['std'],
                                  first.model.std.numpy())

    probe = train_cli.build_trainer(args(3) + ['--force'])
    probe.init_state()
    probe.load_checkpoint()
    assert torch.equal(probe.flat, first.flat)
    assert torch.equal(probe.optimizer.mu, first.optimizer.mu)
    assert torch.equal(probe.generator.get_state(),
                       first.generator.get_state())
    for a, b in zip(probe.model.buffers(), first.model.buffers()):
        assert torch.equal(a, b)
    second = train_cli.main(args(3) + ['--force'])
    assert second.epochs_ran == 3
    assert torch.equal(second.model.std, first.model.std)

    audio = np.random.RandomState(2).randn(4000).astype(np.float32) * 0.1
    port = EnhanceService(model_dir, 'cpu')
    assert port.health()['arch'] == 'ffnn'
    assert torch.equal(port.model.mean, second.model.mean)
    spec = importlib.util.spec_from_file_location(
        'serve_model', os.path.join(ROOT, 'scripts', 'serve_model.py'))
    serve_model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_model)
    ref = serve_model.EnhanceService(model_dir)
    got = port.enhance(audio)
    assert got.shape == (4000,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.enhance(audio), atol=1e-4, rtol=1e-4)
