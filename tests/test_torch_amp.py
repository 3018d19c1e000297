"""bf16 amp in the port's trainer (brever_tpu_torch.training), mirroring
tests/test_amp.py and the JAX trainer's ``loss_fn``:

* the amp per-item loss is finite and within rel 0.1 of the float32 loss
  (FFNN, whose MLP is cast at the STFT-to-network boundary, and a small
  Conv-TasNet, ``tests/test_tcn_fused.py``'s width, TF-GridNet and DCCRN);
* Conv-TasNet's amp loss and float32 master gradients, on weights carried
  across by ``convert.py``, against the JAX amp loss with its TCN blocks
  through the Pallas kernels in interpret mode (``FORCE_INTERPRET``), and
  both against float64 on the same bf16-rounded weights and batch: the
  port's relative error is at most twice the JAX path's (with a floor of
  1e-3 of relative error for the loss), and the two agree to 2e-2;
* TF-GridNet's and DCCRN's amp loss and float32 master gradients (their
  LSTMs through the bf16 twins of K3/K4 and K5/K6) against the JAX amp
  path on the same weights and batch and against float64 on the same
  bf16-rounded weights and batch: within 2e-2 relative of both;
* the trunk runs in bf16 while masters, gradients, Adam's moments, the
  EMA, DCCRN's running statistics and the checkpoint stay float32;
* ``python -m brever_tpu_torch.train`` with ``use_amp: true`` (the default
  config's) on FLAC tars, and a bitwise resume from ``last.ckpt``
  (Conv-TasNet, TF-GridNet, DCCRN, SGMSE+, IDMSE, MANNER);
* SGMSE+'s, IDMSE's and MANNER's amp loss and float32 master gradients
  (their GroupNorms and BatchNorms through the bf16 twins of K7/K8 and
  K7-BN/K8-BN) against the JAX amp path on the same weights and batch (t
  and the noise fixed on both sides) and against float64 on the same
  bf16-rounded weights and batch: the port no farther from float64 than
  the JAX amp path, with 25 % slack (and a floor of 1e-3 of relative error
  for the loss); their trunk runs bf16 while the state stays float32;
* every family trains under amp: SGMSE+, IDMSE and MANNER, which refused it
  before their norms' bf16 route, build an amp trainer that steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import brever_tpu.ops.pallas.tcn_block as jax_tcn
from brever_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch import train as train_cli
from brever_tpu_torch.checkpoint import load_checkpoint
from brever_tpu_torch.convert import flax_to_state_dict
from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.models.base import param_dtype, sample_weighted_mean
from brever_tpu_torch.ops import tcn_block
from brever_tpu_torch.training import BreverTrainer
import brever_tpu.models.sgmse.sgmse as jax_sgmse
from test_torch_flac import write_flac_dataset
from test_torch_manner import _narrow_families, _random_variables
from test_torch_training import DCC, GRID, IDM, NARROW_MANNER, SGM
from utils import DummyDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVTASNET = dict(filters=64, filter_length=16, bottleneck_channels=32,
                  hidden_channels=64, skip_channels=32, layers=2, repeats=2)
FFNN = dict(hidden_layers=[64])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(tmp_path, model, **kwargs):
    options = dict(
        train_dataset=DummyDataset(n_items=4, min_length=0.2,
                                   max_length=0.3),
        val_dataset=DummyDataset(n_items=2, min_length=0.2, max_length=0.3,
                                 seed=7),
        model_dirpath=str(tmp_path), epochs=1, device='cpu',
        batch_size=0.8, val_metrics={'snr'}, val_period=1, seed=0)
    options.update(kwargs)
    return BreverTrainer(model, **options)


def _step_loss(trainer, batch, lengths, seed=1):
    """The train step's loss and float32 master gradients, as
    ``train_step`` forms them, without the update."""
    trainer.model.train()
    trainer.generator.manual_seed(seed)
    with trainer._amp_params():
        loss = sample_weighted_mean(trainer.model.loss(
            trainer._amp_batch(batch), lengths, trainer.generator), lengths)
        grads = torch.autograd.grad(loss, trainer._param_list)
    return loss, grads


@pytest.mark.parametrize('arch,kwargs', [('ffnn', FFNN),
                                         ('convtasnet', CONVTASNET),
                                         ('tfgridnet', GRID),
                                         ('dccrn', DCC)])
def test_amp_loss_finite_and_close(tmp_path, arch, kwargs):
    model = ModelRegistry.get(arch)(**kwargs, device='cpu')
    trainers = [_trainer(tmp_path / str(amp), model, use_amp=amp)
                for amp in (True, False)]
    trainers[0].init_state()
    batch = torch.from_numpy(np.random.RandomState(0).randn(
        2, 2, 2, 8192).astype('float32'))
    lengths = torch.full((2,), 8192)
    amp, ref = (float(_step_loss(t, batch, lengths)[0].detach())
                for t in trainers)
    assert np.isfinite(amp) and np.isfinite(ref)
    # a bf16 trunk: ~3 significant digits through the model
    assert amp == pytest.approx(ref, rel=0.1), (amp, ref)


@pytest.fixture(scope='module')
def twins():
    jax_model = JaxModels.get('convtasnet')(**CONVTASNET)
    variables = jax_model.init_variables(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables['params'])
    rng = np.random.RandomState(0)
    target = 0.3 * rng.randn(3, 1, 2, 2400)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2400)
    batch = np.concatenate([mix, target], axis=1).astype(np.float32)
    lengths = np.array([2400, 1700, 0], np.int32)
    return jax_model, params, batch, lengths


def _bf16_tree(tree):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree)


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def test_convtasnet_amp_matches_jax_and_float64(twins, monkeypatch,
                                                tmp_path):
    jax_model, params, batch, lengths = twins
    monkeypatch.setattr(jax_tcn, 'FORCE_INTERPRET', True)

    def jax_loss(p):
        per_item = jax_model.loss({'params': _bf16_tree(p)},
                                  jnp.asarray(batch).astype(jnp.bfloat16),
                                  jnp.asarray(lengths), None)
        return jax_mean(per_item.astype(jnp.float32), jnp.asarray(lengths))

    jloss, jgrads = jax.value_and_grad(jax_loss)(params)
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))

    model = ModelRegistry.get('convtasnet')(**CONVTASNET, device='cpu')
    model.load_state_dict(flax_to_state_dict(params))
    trainer = _trainer(tmp_path, model, use_amp=True)
    n = torch.from_numpy(lengths)
    tcn_block.tcn_block.launches = tcn_block.tcn_block_bwd.launches = 0
    loss, grads = _step_loss(trainer, torch.from_numpy(batch), n)
    assert loss.dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads)
    assert tcn_block.tcn_block.launches == 0   # the CPU takes the twins

    # float64 on the same bf16-rounded weights and batch
    exact = ModelRegistry.get('convtasnet')(**CONVTASNET, device='cpu')
    exact.load_state_dict({k: torch.as_tensor(v).bfloat16().double()
                           for k, v in flax_to_state_dict(params).items()})
    exact.double()
    ref = sample_weighted_mean(exact.loss(
        torch.from_numpy(batch).bfloat16().double(), n), n)
    ref_grads = torch.autograd.grad(ref, list(exact.parameters()))
    ref = float(ref)

    names = [name for name, _ in model.named_parameters()]
    got = np.concatenate([g.numpy().ravel() for g in grads])
    want = np.concatenate([jgrads[k].numpy().ravel() for k in names])
    exact_g = np.concatenate([g.numpy().ravel() for g in ref_grads])
    port_err, jax_err = _rel(got, exact_g), _rel(want, exact_g)
    print('gradients: relative error against float64, port', port_err,
          'JAX', jax_err, 'port against JAX', _rel(got, want))
    print('loss', float(loss), 'JAX', float(jloss), 'float64', ref)
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    assert abs(float(loss) - ref) <= 2 * max(abs(float(jloss) - ref),
                                             1e-3 * abs(ref))
    assert _rel(got, want.astype(np.float64)) < 2e-2
    assert float(loss) == pytest.approx(float(jloss), rel=2e-2)


def test_trunk_runs_bf16_and_the_state_stays_float32(tmp_path):
    model = ModelRegistry.get('convtasnet')(**CONVTASNET, device='cpu')
    trainer = _trainer(tmp_path, model, use_amp=True, ema=True)
    trainer.init_state()
    seen = {}

    def record(name):
        def hook(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] = {t.dtype for t in outs if t is not None}
        return hook

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(record(name))
    batch = torch.from_numpy(np.random.RandomState(1).randn(
        2, 2, 2, 4000).astype('float32'))
    lengths = torch.tensor([4000, 3000])
    with trainer._amp_params():
        assert param_dtype(model) == torch.bfloat16
    assert param_dtype(model) == torch.float32
    trainer.train_step(batch, lengths)
    for name in ('encoder', 'tcn.norm', 'tcn.bottleneck', 'tcn.blocks.0',
                 'tcn.blocks.3', 'tcn.prelu_out', 'tcn.mask', 'tcn',
                 'decoder'):
        assert seen[name] == {torch.bfloat16}, name
    assert all(p.dtype == torch.float32 for p in model.parameters())
    opt = trainer.optimizer
    for t in (trainer.flat, trainer.ema, opt.mu, opt.nu):
        assert t.dtype == torch.float32
    trainer.save_checkpoint(str(tmp_path / 'a.ckpt'))
    # the JAX package's loader keeps the stored dtypes
    state = jax_load_checkpoint(str(tmp_path / 'a.ckpt'))
    leaves = jax.tree.leaves((state['params'], state['ema'],
                              state['opt_state']))
    assert {np.asarray(x).dtype for x in leaves} <= {np.dtype(np.float32),
                                                     np.dtype(np.int32)}
    assert any(np.asarray(x).dtype == np.float32 for x in leaves)
    # validation enhances with the float32 parameters
    with torch.no_grad():
        assert model.enhance(batch[0, 0]).dtype == torch.float32


def _amp_model_dir(tmp_path, arch='convtasnet', model=CONVTASNET):
    """The untouched default config of ``arch`` (``use_amp: true``) cut to
    a small model, on FLAC tars written with the port's encoder."""
    with open(os.path.join(ROOT, 'config', 'models', f'{arch}.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    assert config['trainer']['use_amp'] is True
    config['model'].update(model)
    config['train_path'] = write_flac_dataset(str(tmp_path / 'train'),
                                              [4000, 5000, 6000, 3000])
    config['val_path'] = write_flac_dataset(str(tmp_path / 'val'),
                                            [4000, 3500], seed=1)
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump(config, f)
    return str(model_dir)


def test_amp_train_main_on_flac_resumes_bitwise(tmp_path):
    model_dir = _amp_model_dir(tmp_path)
    common = ['--device', 'cpu', '--val_metrics', 'snr', '--batch_size',
              '2', '--dynamic_batch_size', 'false', '--val_period', '1']
    whole = os.path.join(str(tmp_path), 'whole')
    os.makedirs(whole)
    os.symlink(os.path.join(model_dir, 'config.yaml'),
               os.path.join(whole, 'config.yaml'))
    train_cli.main([whole, '--epochs', '2'] + common)
    train_cli.main([model_dir, '--epochs', '1'] + common)
    ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    assert os.path.exists(ckpt)
    assert load_checkpoint(ckpt)['step'] > 0
    train_cli.main([model_dir, '--epochs', '2', '--force'] + common)
    a = load_checkpoint(ckpt)
    b = load_checkpoint(os.path.join(whole, 'checkpoints', 'last.ckpt'))
    for x, y in zip(jax.tree.leaves((a['params'], a['opt_state'])),
                    jax.tree.leaves((b['params'], b['opt_state']))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    losses = np.load(os.path.join(model_dir, 'losses.npz'),
                     allow_pickle=True)
    assert np.isfinite(losses['train'].astype(float)).all()


def _narrow_manner(monkeypatch):
    import functools

    from brever_tpu_torch.models import manner
    monkeypatch.setattr(manner, '_MannerModule', functools.partial(
        manner._MannerModule, **NARROW_MANNER))


@pytest.mark.parametrize('arch,kwargs', [
    ('sgmsep', SGM), ('idmse', IDM), ('manner', {})])
def test_amp_accepted_for_every_family(tmp_path, monkeypatch, arch, kwargs):
    """The families that refused amp before their norms' bf16 route build
    an amp trainer whose step runs the bf16 trunk and leaves float32
    masters; without amp, the float32 trainer as before."""
    if arch == 'manner':
        _narrow_manner(monkeypatch)
    model = ModelRegistry.get(arch)(**kwargs, device='cpu')
    trainer = _trainer(tmp_path, model, use_amp=True)
    assert trainer.use_amp is True
    trainer.init_state()
    with trainer._amp_params():
        assert param_dtype(model) == torch.bfloat16
    batch = torch.from_numpy(np.random.RandomState(2).randn(
        2, 2, 2, 4000).astype('float32'))
    loss = trainer.train_step(batch, torch.tensor([4000, 3000]))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert trainer.flat.dtype == torch.float32
    assert _trainer(tmp_path, model, use_amp=False).use_amp is False


@pytest.mark.parametrize('name,last', [('snr', 0), ('sisnr', 300)])
def test_criterion_and_mean_stay_bf16_as_the_jax_ones(name, last):
    """The amp loss's last steps: a bf16 criterion and ``sample_weighted_mean``
    stay in bf16 (their sums accumulated in float32 and rounded, as
    ``jnp.sum`` upcasts), as the JAX package's; snr's row of length 0
    drops out (sisnr's is NaN in both packages). Within 2 bf16 ulps (rtol
    2^-7) of the JAX values."""
    from brever_tpu.criterion import CriterionRegistry as JaxCriteria
    from brever_tpu_torch.criterion import CriterionRegistry
    rng = np.random.RandomState(3)
    y = rng.randn(3, 1, 800).astype(np.float32)
    x = (y + 0.5 * rng.randn(3, 1, 800)).astype(np.float32)
    lengths = np.array([800, 555, last], np.int32)
    want = JaxCriteria.get(name)(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(y, jnp.bfloat16),
                                 jnp.asarray(lengths))
    want_mean = jax_mean(want, jnp.asarray(lengths))
    n = torch.from_numpy(lengths)
    got = CriterionRegistry.get(name)(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(y).bfloat16(), n)
    got_mean = sample_weighted_mean(got, n)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got_mean.dtype == torch.bfloat16
    rows = 3 if last else 2
    np.testing.assert_allclose(got[:rows].float().numpy(),
                               np.asarray(want[:rows], np.float32),
                               rtol=2 ** -7)
    assert float(got_mean) == pytest.approx(float(want_mean), rel=2 ** -7)


# ---------------------------------------------------------------------------
# TF-GridNet and DCCRN under amp (their LSTMs' bf16 route)

RNN_FAMILIES = {'tfgridnet': GRID, 'dccrn': DCC}


def _rnn_twins(arch):
    """The JAX model's variables, numpy (DCCRN's running statistics moved
    off their initial values), and a batch with a row of length 0."""
    jax_model = JaxModels.get(arch)(**RNN_FAMILIES[arch])
    variables = jax.tree.map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(17)
    if 'batch_stats' in variables:
        variables['batch_stats'] = jax.tree.map(
            lambda a: (a + 0.1 * np.abs(rng.randn(*a.shape)))
            .astype(np.float32), variables['batch_stats'])
    target = 0.3 * rng.randn(3, 1, 2, 2100)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2100)
    batch = np.concatenate([mix, target], axis=1).astype(np.float32)
    return jax_model, dict(variables), batch, np.array([2100, 1500, 0],
                                                        np.int32)


@pytest.mark.parametrize('arch', sorted(RNN_FAMILIES))
def test_rnn_family_amp_matches_jax_and_float64(arch, tmp_path):
    """The amp loss and float32 master gradients against the JAX amp path
    (parameters and batch cast to bfloat16, the running statistics float32,
    as the JAX trainer's ``loss_fn`` gives them) and against float64 on the
    same bf16-rounded weights and batch: the port's gradients within 2e-2
    relative of float64 and no farther from it than twice the JAX path's,
    the loss within 2e-2 of both. (The JAX path's own gradients can sit
    further from float64: XLA reduces some of DCCRN's bias and PReLU
    gradients in bfloat16, 10-12 % off float64 for a last-layer bias; the
    port's reductions accumulate in float32.)"""
    jax_model, variables, batch, lengths = _rnn_twins(arch)

    def jax_loss(p):
        tree = dict(variables, params=_bf16_tree(p))
        out = jax_model.loss(tree, jnp.asarray(batch).astype(jnp.bfloat16),
                             jnp.asarray(lengths), None)
        per_item = out[0] if isinstance(out, tuple) else out
        return jax_mean(per_item.astype(jnp.float32), jnp.asarray(lengths))

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(variables['params'])

    def port(dtype=None):
        model = ModelRegistry.get(arch)(**RNN_FAMILIES[arch], device='cpu')
        state = model.from_flax(variables['params'], variables)
        if dtype is not None:
            names = {n for n, _ in model.named_parameters()}
            state = {k: (v.bfloat16() if k in names else v).to(dtype)
                     for k, v in state.items()}
        model.load_state_dict(state)
        return model.to(dtype) if dtype is not None else model

    model = port()
    trainer = _trainer(tmp_path, model, use_amp=True)
    n = torch.from_numpy(lengths)
    loss, grads = _step_loss(trainer, torch.from_numpy(batch), n)
    # the output leaves the inverse STFT in float32, in both packages
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)

    exact = port(torch.float64).train()
    ref = sample_weighted_mean(exact.loss(
        torch.from_numpy(batch).bfloat16().double(), n), n)
    ref_grads = torch.autograd.grad(ref, list(exact.parameters()))
    ref = float(ref)

    names = [name for name, _ in model.named_parameters()]
    want_tree = model.from_flax(jax.tree.map(np.asarray, jgrads))
    got = np.concatenate([g.numpy().ravel() for g in grads])
    want = np.concatenate([want_tree[k].numpy().ravel() for k in names])
    exact_g = np.concatenate([g.numpy().ravel() for g in ref_grads])
    port_err, jax_err = _rel(got, exact_g), _rel(want, exact_g)
    print(f'{arch} gradients: relative error against float64, port',
          port_err, 'JAX', jax_err, 'port against JAX',
          _rel(got, want.astype(np.float64)))
    print('loss', float(loss), 'JAX', float(jloss), 'float64', ref)
    assert port_err < 2e-2, (port_err, jax_err)
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    assert float(loss) == pytest.approx(ref, rel=2e-2)
    assert float(loss) == pytest.approx(float(jloss), rel=2e-2)


@pytest.mark.parametrize('arch', sorted(RNN_FAMILIES))
def test_rnn_family_trunk_runs_bf16_and_the_state_stays_float32(arch,
                                                                 tmp_path):
    model = ModelRegistry.get(arch)(**RNN_FAMILIES[arch], device='cpu')
    trainer = _trainer(tmp_path, model, use_amp=True, ema=True)
    trainer.init_state()
    seen = {}

    def record(name):
        def hook(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] = {t.dtype for t in outs if t is not None}
        return hook

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(record(name))
    batch = torch.from_numpy(np.random.RandomState(1).randn(
        2, 2, 2, 4000).astype('float32'))
    lengths = torch.tensor([4000, 3000])
    trainer.train_step(batch, lengths)
    trunk = {'tfgridnet': ('embed', 'embed_norm', 'blocks.0.intra_norm',
                           'blocks.0.intra_rnn', 'blocks.0.inter_rnn',
                           'blocks.0.attn_q_norm', 'blocks.0.attn_out_norm',
                           'blocks.0', 'deconv'),
             'dccrn': ('enc_conv_0', 'enc_norm_0', 'enc_prelu_1', 'lstm_0',
                       'lstm_proj_real', 'dec_conv_0', 'dec_norm_0',
                       'dec_conv_1')}[arch]
    for name in trunk:
        assert seen[name] == {torch.bfloat16}, (name, seen[name])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    buffers = dict(model.named_buffers())
    if arch == 'dccrn':
        assert buffers and all(b.dtype == torch.float32
                               for b in buffers.values())
        # the train step moved the running statistics
        assert not torch.equal(buffers['enc_norm_0.mean'],
                               torch.zeros_like(buffers['enc_norm_0.mean']))
    opt = trainer.optimizer
    for t in (trainer.flat, trainer.ema, opt.mu, opt.nu):
        assert t.dtype == torch.float32
    with torch.no_grad():
        assert model.enhance(batch[0, 0]).dtype == torch.float32


@pytest.mark.parametrize('arch', sorted(RNN_FAMILIES))
def test_rnn_family_amp_train_main_on_flac_resumes_bitwise(arch, tmp_path):
    """``train.main`` from the family's untouched default config
    (``use_amp: true``), narrowed, on FLAC tars: two epochs at once and one
    then a resumed second give the same bits."""
    model_dir = _amp_model_dir(tmp_path, arch, RNN_FAMILIES[arch])
    common = ['--device', 'cpu', '--val_metrics', 'snr', '--batch_size',
              '2', '--dynamic_batch_size', 'false', '--val_period', '1']
    whole = os.path.join(str(tmp_path), 'whole')
    os.makedirs(whole)
    os.symlink(os.path.join(model_dir, 'config.yaml'),
               os.path.join(whole, 'config.yaml'))
    train_cli.main([whole, '--epochs', '2'] + common)
    train_cli.main([model_dir, '--epochs', '1'] + common)
    ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    train_cli.main([model_dir, '--epochs', '2', '--force'] + common)
    a = load_checkpoint(ckpt)
    b = load_checkpoint(os.path.join(whole, 'checkpoints', 'last.ckpt'))
    assert a['step'] == b['step'] > 0
    for x, y in zip(jax.tree.leaves((a['params'], a['opt_state'],
                                     a.get('aux'))),
                    jax.tree.leaves((b['params'], b['opt_state'],
                                     b.get('aux')))):
        assert np.asarray(x).dtype != np.dtype('bfloat16')
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    losses = np.load(os.path.join(model_dir, 'losses.npz'),
                     allow_pickle=True)
    assert np.isfinite(losses['train'].astype(float)).all()


# ---------------------------------------------------------------------------
# SGMSE+, IDMSE and MANNER under amp (their norms' bf16 route)

NORM_FAMILIES = {'sgmsep': SGM, 'idmse': IDM, 'manner': {}}


def _norm_twins(arch, monkeypatch):
    """The JAX model and its numpy variables, the port's float32 model on
    them, a batch with a row of length 0 (MANNER's rows all real: its loss
    ignores the lengths), and for SGMSE+/IDMSE fixed draws ``(u, noise)``
    of t and the complex noise."""
    rng = np.random.RandomState(23)
    if arch == 'manner':
        jax_model, model = _narrow_families(monkeypatch)
        variables = _random_variables(jax_model.module, 2000, seed=3)
        model.load_state_dict(model.from_flax(variables['params'],
                                              variables))
        length, lengths = 2000, np.array([2000, 2000], np.int32)
    else:
        jax_model = JaxModels.get(arch)(**NORM_FAMILIES[arch])
        variables = jax.tree.map(np.asarray, jax_model.init_variables(
            jax.random.PRNGKey(0)))
        model = ModelRegistry.get(arch)(**NORM_FAMILIES[arch], device='cpu')
        model.load_state_dict(model.from_flax(
            variables['params'], {'buffers': variables['buffers']}))
        length, lengths = 2100, np.array([2100, 1500, 0], np.int32)
    target = 0.3 * rng.randn(len(lengths), 1, 2, length)
    mix = target + 0.3 * rng.randn(len(lengths), 1, 2, length)
    batch = np.concatenate([mix, target], axis=1).astype(np.float32)
    draws = None
    if arch != 'manner':
        frames = model.transform(torch.from_numpy(batch)).shape[2:]
        u = rng.uniform(size=(len(lengths), 1, 1, 1)).astype(np.float32)
        noise = (rng.randn(len(lengths), 1, *frames)
                 + 1j * rng.randn(len(lengths), 1, *frames)) \
            .astype(np.complex64)
        draws = u, noise
    return jax_model, dict(variables), model, batch, lengths, draws


def _port_loss(model, batch, lengths, draws):
    """The family's mean loss of a batch (t and the noise from ``draws``
    for SGMSE+/IDMSE), in the model's current dtype."""
    n = torch.from_numpy(lengths)
    if draws is None:
        return sample_weighted_mean(model.loss(batch, n), n)
    u, noise = draws
    real = batch.float().dtype if batch.dtype == torch.bfloat16 \
        else batch.dtype
    t = torch.from_numpy(u).to(real) * (1 - model.t_eps) + model.t_eps
    noise = torch.from_numpy(noise).to(
        torch.complex128 if real == torch.float64 else torch.complex64)
    return sample_weighted_mean(model.loss_at(batch, n, t, noise), n)


@pytest.mark.parametrize('arch', sorted(NORM_FAMILIES))
def test_norm_family_amp_matches_jax_and_float64(arch, tmp_path,
                                                 monkeypatch):
    """The amp loss and float32 master gradients against the JAX amp path
    (parameters and batch cast to bfloat16; the buffers and running
    statistics float32, as the JAX trainer's ``loss_fn`` gives them; its
    GroupNorms on the jnp path and its BatchNorms on the XLA branch, which
    the CPU takes) and against float64 on the same bf16-rounded weights and
    batch: the port's gradients no farther from float64 than the JAX
    path's with 25 % slack, the loss likewise with a floor of 1e-3 of
    relative error. The port's step runs PyTorch's native CPU convolutions
    (oneDNN off): oneDNN's bfloat16 convolution rounds its partial sums to
    bfloat16 (a MANNER downsampling convolution's output 107 % off float64
    on these inputs, where float32 accumulation of the same bf16 operands
    is 10 % off), while the card's cuDNN and the JAX package's XLA
    accumulate in float32."""
    jax_model, variables, model, batch, lengths, draws = _norm_twins(
        arch, monkeypatch)
    if draws is not None:
        u, noise = draws
        monkeypatch.setattr(jax_sgmse, '_randn_like', lambda key, x: noise)
        monkeypatch.setattr(jax_sgmse.jax.random, 'uniform',
                            lambda key, shape: jnp.asarray(u))

    def jax_loss(p):
        tree = dict(variables, params=_bf16_tree(p))
        out = jax_model.loss(tree, jnp.asarray(batch).astype(jnp.bfloat16),
                             jnp.asarray(lengths), jax.random.PRNGKey(0),
                             train=True)
        per_item = out[0] if isinstance(out, tuple) else out
        return jax_mean(per_item.astype(jnp.float32), jnp.asarray(lengths))

    jloss, jgrads = jax.value_and_grad(jax_loss)(variables['params'])

    trainer = _trainer(tmp_path, model, use_amp=True)
    model.train()
    with trainer._amp_params(), torch.backends.mkldnn.flags(enabled=False):
        loss = _port_loss(model, trainer._amp_batch(torch.from_numpy(batch)),
                          lengths, draws)
        grads = torch.autograd.grad(loss, trainer._param_list)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)

    names = [name for name, _ in model.named_parameters()]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    exact = type(model)(**model.hparams, device='cpu') \
        if arch != 'manner' else type(model)(device='cpu')
    exact.load_state_dict({k: (v.bfloat16() if k in names else v).double()
                           for k, v in state.items()})
    exact.double().train()
    ref = _port_loss(exact, torch.from_numpy(batch).bfloat16().double(),
                     lengths, draws)
    ref_grads = torch.autograd.grad(ref, list(exact.parameters()))
    ref = float(ref)

    want_tree = model.from_flax(jax.tree.map(np.asarray, jgrads))
    got = np.concatenate([g.numpy().ravel() for g in grads])
    want = np.concatenate([want_tree[k].numpy().ravel() for k in names])
    exact_g = np.concatenate([g.numpy().ravel() for g in ref_grads])
    port_err, jax_err = _rel(got, exact_g), _rel(want, exact_g)
    print(f'{arch} gradients: relative error against float64, port',
          port_err, 'JAX', jax_err, 'port against JAX',
          _rel(got, want.astype(np.float64)))
    print('loss', float(loss), 'JAX', float(jloss), 'float64', ref)
    assert port_err <= 1.25 * jax_err, (port_err, jax_err)
    assert abs(float(loss) - ref) <= 1.25 * max(abs(float(jloss) - ref),
                                                1e-3 * abs(ref))


@pytest.mark.parametrize('arch', sorted(NORM_FAMILIES))
def test_norm_family_trunk_runs_bf16_and_the_state_stays_float32(
        arch, tmp_path, monkeypatch):
    """Under amp the U-Net's blocks and GroupNorms (SGMSE+, IDMSE) or
    MANNER's convolutions and BatchNorms run bfloat16, while the masters,
    Adam's moments, the EMA, the running statistics and the buffers (the
    Fourier frequencies) stay float32; a train step moves MANNER's running
    statistics; the float32 parameters enhance."""
    if arch == 'manner':
        _narrow_manner(monkeypatch)
    model = ModelRegistry.get(arch)(**NORM_FAMILIES[arch], device='cpu')
    # (MANNER's one-cycle schedule over one step has no finite rate, in
    # optax as here: size it for a few)
    trainer = _trainer(tmp_path, model, use_amp=True, ema=True, epochs=8)
    trainer.init_state()
    seen = {}

    def record(name):
        def hook(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] = {t.dtype for t in outs
                          if isinstance(t, torch.Tensor)}
        return hook

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(record(name))
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    batch = torch.from_numpy(np.random.RandomState(1).randn(
        2, 2, 2, 4000).astype('float32'))
    lengths = torch.tensor([4000, 3000])
    trainer.train_step(batch, lengths)
    trunk = {'sgmsep': ('net.emb', 'net.input_conv', 'net.enc_0_0.norm_1',
                        'net.enc_0_0', 'net.enc_0_1', 'net.dec_0_0.norm_2',
                        'net.aux_up_norm_0'),
             'idmse': ('net.emb', 'net.enc_0_0.norm_1', 'net.enc_0_0.norm_2',
                       'net.enc_0_0', 'net.dec_0_0', 'net.output_norm'),
             'manner': ('net.in_conv', 'net.in_bn', 'net.enc_0_rescon',
                        'net.enc_1_attn', 'net.dec_0_up_bn',
                        'net.out_conv')}[arch]
    for name in trunk:
        assert seen[name] == {torch.bfloat16}, (name, seen[name])
    if arch == 'manner':
        assert seen['net'] == {torch.float32}   # rescaled by the f32 std
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for k, b in model.named_buffers():
        assert b.dtype == torch.float32, k
    if arch == 'manner':
        assert not torch.equal(buffers['net.in_bn.mean'],
                               model.net.in_bn.mean)
    opt = trainer.optimizer
    for t in (trainer.flat, trainer.ema, opt.mu, opt.nu):
        assert t.dtype == torch.float32
    with torch.no_grad():
        out = model.enhance(batch[0, 0])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize('arch', sorted(NORM_FAMILIES))
def test_norm_family_amp_train_main_on_flac_resumes_bitwise(
        arch, tmp_path, monkeypatch):
    """``train.main`` from the family's untouched default config
    (``use_amp: true``), narrowed, on FLAC tars. SGMSE+ and IDMSE: two
    epochs at once and one then a resumed second give the same bits
    (parameters, Adam, the loss's generator, the buffers in ``aux``).
    MANNER's one-cycle schedule spans the epochs of the command line, so a
    one-epoch run is another schedule: a trainer built from the same
    command line restores its last.ckpt bitwise (parameters, Adam's moments
    and count, the schedule's count, the running statistics), and the run
    resumes to two epochs."""
    from brever_tpu_torch import train as train_mod
    if arch == 'manner':
        _narrow_manner(monkeypatch)
    model_dir = _amp_model_dir(tmp_path, arch, NORM_FAMILIES[arch])
    common = ['--device', 'cpu', '--val_metrics', 'snr', '--batch_size',
              '2', '--dynamic_batch_size', 'false', '--val_period', '1']
    ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
    if arch == 'manner':
        first = train_cli.main([model_dir, '--epochs', '1'] + common)
        assert first.use_amp and first.step > 0
        probe = train_mod.build_trainer([model_dir, '--epochs', '1',
                                         '--force'] + common)
        probe.init_state()
        probe.load_checkpoint()
        a, b = probe.optimizer, first.optimizer
        assert torch.equal(probe.flat, first.flat)
        assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)
        assert torch.equal(a.count, b.count)
        assert a.schedule_count == b.schedule_count == first.step
        assert all(torch.equal(x, y) for x, y in zip(
            probe.model.buffers(), first.model.buffers()))
        second = train_cli.main([model_dir, '--epochs', '2', '--force']
                                + common)
        assert second.epochs_ran == 2
        assert all(b.dtype == torch.float32 for b in second.model.buffers())
        losses = second.loss_logger.train_loss
        assert np.isfinite(np.asarray(losses, float)).all()
        return
    whole = os.path.join(str(tmp_path), 'whole')
    os.makedirs(whole)
    os.symlink(os.path.join(model_dir, 'config.yaml'),
               os.path.join(whole, 'config.yaml'))
    train_cli.main([whole, '--epochs', '2'] + common)
    train_cli.main([model_dir, '--epochs', '1'] + common)
    train_cli.main([model_dir, '--epochs', '2', '--force'] + common)
    a = load_checkpoint(ckpt)
    b = load_checkpoint(os.path.join(whole, 'checkpoints', 'last.ckpt'))
    assert a['step'] == b['step'] > 0
    for x, y in zip(jax.tree.leaves((a['params'], a['opt_state'],
                                     a.get('aux'))),
                    jax.tree.leaves((b['params'], b['opt_state'],
                                     b.get('aux')))):
        assert np.asarray(x).dtype != np.dtype('bfloat16')
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    losses = np.load(os.path.join(model_dir, 'losses.npz'),
                     allow_pickle=True)
    assert np.isfinite(losses['train'].astype(float)).all()
