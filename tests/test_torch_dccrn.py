"""The port's DCCRN (brever_tpu_torch.models.dccrn) against the JAX
package's, in float32 on the CPU.

At a small width (channels [4, 8], one complex LSTM layer of 16, the
default STFT), one set of flax weights and running statistics (moved off
their initial values), converted by brever_tpu_torch.convert, gives

* the same complex conv and transposed conv at stride (2, 1), the same
  ``batch_norm`` and ``ComplexBatchNorm`` in both modes with the same
  running-statistics updates: 1e-5;
* the same enhancement (eval mode, running statistics) and the same
  per-item ``snr`` loss in train mode on a padded batch (a row of length 0
  and a short row): 1e-4; the same running statistics after that loss
  (the padding rows enter them in both packages): 1e-6;
* the same parameter gradients: rtol 1e-4 with atol 1e-4 of the tensor's
  largest value, and at least 1e-5 of the model's largest gradient: a
  convolution bias that feeds a train-mode batch norm has a zero gradient
  (the norm subtracts the batch mean), which both packages give as rounding
  noise of ~1e-7.

With ``use_complex_batchnorm`` the loss, the gradients and the statistics
are held the same way. At full width the parameter count is pinned and
the weight bridge's tree (``params`` and ``batch_stats``) is the JAX
model's, key for key and shape for shape, without a JAX init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu.models.common import ComplexBatchNorm as JaxComplexBN
from brever_tpu.models.dccrn import DCCRN as JaxDCCRN
from brever_tpu.models.dccrn import _ComplexConv as JaxComplexConv
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models.base import sample_weighted_mean
from brever_tpu_torch.models.common import BatchNorm, ComplexBatchNorm
from brever_tpu_torch.models.dccrn import DCCRN, _ComplexConv

SMALL = dict(channels=[4, 8], lstm_channels=16, lstm_layers=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _twins(**kwargs):
    """The JAX and the port's model with one set of weights and running
    statistics, both moved off their initial values."""
    jax_model = JaxModels.get('dccrn')(**SMALL, **kwargs)
    variables = _np(jax_model.init_variables(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(5)
    variables = {
        'params': jax.tree.map(
            lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
            variables['params']),
        'batch_stats': jax.tree.map(
            lambda a: (a + 0.1 * np.abs(rng.randn(*a.shape)))
            .astype(np.float32), variables['batch_stats'])}
    model = ModelRegistry.get('dccrn')(**SMALL, **kwargs, device='cpu')
    model.load_state_dict(model.from_flax(variables['params'], variables))
    return jax_model, variables, model


@pytest.fixture(scope='module')
def twins():
    return _twins()


@pytest.fixture(scope='module')
def batch():
    rng = np.random.RandomState(0)
    target = 0.3 * rng.randn(3, 1, 2, 2100)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2100)
    data = np.concatenate([mix, target], axis=1).astype(np.float32)
    return data, np.array([2100, 1500, 0], np.int32)


def test_default_width_param_count():
    """Pinned like the JAX model (tests/test_training.py)."""
    assert count_params(ModelRegistry.get('dccrn')(device='cpu')) \
        == 3_671_053


def test_full_width_bridge_is_the_jax_tree():
    """The port's default model through ``to_flax``/``flax_aux`` has the JAX
    model's ``params`` and ``batch_stats`` trees (shapes from
    ``jax.eval_shape``, no init), and ``from_flax`` gives back the
    ``state_dict`` exactly."""
    jax_model = JaxDCCRN()
    shapes = jax.eval_shape(
        lambda key: jax_model.module.init(
            key, jax_model._to_input(jnp.zeros((1, 4096))), train=False),
        jax.random.PRNGKey(0))
    model = ModelRegistry.get('dccrn')(device='cpu')
    state = model.state_dict()
    params, aux = model.to_flax(state), model.flax_aux(state)
    for ours, theirs in ((params, shapes['params']),
                         (aux['batch_stats'], shapes['batch_stats'])):
        ours, theirs = flatten_dict(ours), flatten_dict(theirs)
        assert ours.keys() == theirs.keys()
        for key, value in theirs.items():
            assert ours[key].shape == value.shape, key
    back = model.from_flax(params, aux)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    assert count_params(model) == sum(v.size for v in
                                      flatten_dict(params).values())


@pytest.mark.parametrize('transpose', [False, True],
                         ids=['conv', 'transposed'])
def test_complex_conv_matches_jax(transpose):
    """Stride (2, 1), kernel (5, 2), padding (2, 0), output padding (1,
    0): the block kernel with the double bias, and the transposed conv as
    ``lax.conv_transpose`` computes it (the kernel unflipped over the
    dilated input); ``conv_transpose2d`` of the unflipped kernel differs."""
    kf, kt, (pf, pt), (opf, opt) = 5, 2, (2, 0), (1, 0)
    lo_f, lo_t = kf - 1 - pf, kt - 1 - pt
    pad = (((lo_f, lo_f + opf), (lo_t, lo_t + opt)) if transpose
           else ((pf, pf), (pt, pt)))
    layer = JaxComplexConv(features=6, kernel_size=(kf, kt), strides=(2, 1),
                           padding=pad, transpose=transpose)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 17, 9, 2 * 5).astype(np.float32)    # (B, F, T, 2 cin)
    variables = _np(layer.init(jax.random.PRNGKey(0), x))
    variables = jax.tree.map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32),
        variables)
    want = np.asarray(layer.apply(variables, x))
    conv = _ComplexConv(5, 6, (kf, kt), (2, 1), (pf, pt), (opf, opt),
                        transpose)
    sd = {}
    for part in ('real', 'imag'):
        tree = variables['params'][part]
        sd[f'{part}.weight'] = torch.from_numpy(
            np.ascontiguousarray(tree['kernel'].transpose(3, 2, 0, 1)))
        sd[f'{part}.bias'] = torch.from_numpy(tree['bias'])
    conv.load_state_dict(sd)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    if transpose:   # conv_transpose2d of the unflipped kernel differs
        with torch.no_grad():
            kernel = torch.cat([
                torch.cat([conv.real.weight, -conv.imag.weight], 1),
                torch.cat([conv.imag.weight, conv.real.weight], 1)])
            wrong = torch.nn.functional.conv_transpose2d(
                torch.from_numpy(x).permute(0, 3, 1, 2),
                kernel.transpose(0, 1), None, (2, 1), (pf, pt), (opf, opt))
        bias = np.concatenate([
            variables['params']['real']['bias']
            - variables['params']['imag']['bias'],
            variables['params']['real']['bias']
            + variables['params']['imag']['bias']])
        assert np.abs(wrong.permute(0, 2, 3, 1).numpy() + bias
                      - want).max() > 0.1


def _stats_after(module, variables, x, train):
    out, updates = module.apply(variables, x, train=train,
                                mutable=['batch_stats'])
    return np.asarray(out), _np(updates['batch_stats'])


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_batch_norm_matches_flax(train):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis
    against the port's over channels first: the output and the running
    mean and biased variance."""
    import flax.linen as fnn
    rng = np.random.RandomState(2)
    x = (1.5 * rng.randn(3, 6, 7, 5) + 0.4).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-5)
    variables = {
        'params': {'scale': 1 + 0.1 * rng.randn(5).astype(np.float32),
                   'bias': 0.1 * rng.randn(5).astype(np.float32)},
        'batch_stats': {'mean': 0.2 * rng.randn(5).astype(np.float32),
                        'var': 1 + 0.2 * rng.rand(5).astype(np.float32)}}
    out, updates = flax_bn.apply(variables, x, mutable=['batch_stats'])
    bn = BatchNorm(5, momentum=0.9)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**variables['params'],
                         **variables['batch_stats']}.items()})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out), atol=1e-5, rtol=1e-5)
    for name in ('mean', 'var'):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(updates['batch_stats'][name]),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_complex_batch_norm_matches_jax(train):
    """2 x 2 whitening, the running mean and covariance (momentum 0.1),
    the (3, C) weight and (2, C) bias."""
    rng = np.random.RandomState(3)
    re = (2 * rng.randn(4, 6, 5, 3) + 1).astype(np.float32)
    im = (0.5 * re + rng.randn(4, 6, 5, 3)).astype(np.float32)
    x = np.concatenate([re, im], axis=-1)
    module = JaxComplexBN()
    variables = {
        'params': {'weight': np.array([[1.1], [0.2], [0.9]], np.float32)
                   + 0.05 * rng.randn(3, 3).astype(np.float32),
                   'bias': 0.1 * rng.randn(2, 3).astype(np.float32)},
        'batch_stats': {
            'mean': 0.3 * rng.randn(2, 3).astype(np.float32),
            'cov': np.array([[[1.5], [0.3]], [[0.3], [0.8]]], np.float32)
            + np.zeros((2, 2, 3), np.float32)}}
    want, stats = _stats_after(module, variables, x, train)
    bn = ComplexBatchNorm(3)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**variables['params'],
                         **variables['batch_stats']}.items()})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    for name in ('mean', 'cov'):
        np.testing.assert_allclose(getattr(bn, name).numpy(), stats[name],
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_enhance_matches_jax(twins):
    jax_model, variables, model = twins
    x = (0.5 * np.random.RandomState(1).randn(2, 2, 3001)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_model.enhance)(variables, x))
    out = model.eval().enhance(x)
    assert out.shape == ref.shape == (2, 3001)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def _jax_loss_and_grads(jax_model, variables, data, lengths):
    def loss(params):
        per_item, aux = jax_model.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(data), jnp.asarray(lengths), None, train=True)
        return jax_mean(per_item, jnp.asarray(lengths)), (per_item, aux)

    grads, (per_item, aux) = jax.jit(jax.grad(loss, has_aux=True))(
        variables['params'])
    return np.asarray(per_item), _np(grads), _np(aux)


def _check_train_step(jax_model, variables, model, batch):
    """The train-mode per-item loss, the gradients and the running
    statistics after the loss, against the JAX model's."""
    data, lengths = batch
    per_item, grads, aux = _jax_loss_and_grads(jax_model, variables, data,
                                               lengths)
    model.load_state_dict(model.from_flax(variables['params'], variables))
    model.train()
    model.zero_grad()
    n = torch.from_numpy(lengths)
    got = model.loss(torch.from_numpy(data), n)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), per_item, rtol=1e-4,
                               atol=1e-4)
    sample_weighted_mean(got, n).backward()
    want = model.from_flax(grads)
    top = max(float(v.abs().max()) for v in want.values())
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    for name, ref in want.items():
        assert params[name].grad is not None, name
        np.testing.assert_allclose(
            params[name].grad.numpy(), ref.numpy(), rtol=1e-4,
            atol=max(1e-4 * float(ref.abs().max()), 1e-5 * top),
            err_msg=name)
    stats = model.from_flax({}, aux)
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(stats)
    for name, ref in stats.items():
        assert not torch.equal(ref, model.from_flax(
            {}, variables)[name]), name    # the statistics moved
        np.testing.assert_allclose(buffers[name].numpy(), ref.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_train_step_matches_jax(twins, batch):
    _check_train_step(*twins, batch)


def test_complex_batchnorm_train_step_matches_jax(batch):
    _check_train_step(*_twins(use_complex_batchnorm=True), batch)


def test_apply_mask_matches_jax():
    """The polar mask with its guards (a mask whose real part is 0, a zero
    mask): the output and its gradient with respect to the mask."""
    rng = np.random.RandomState(6)
    spec = rng.randn(2, 5, 4, 2).astype(np.float32)
    mask = rng.randn(2, 5, 4, 2).astype(np.float32)
    mask[0, 0, :2, 0] = 0.0
    mask[1, 1, 1] = 0.0
    cot = rng.randn(2, 5, 4, 2).astype(np.float32)

    def jax_out(m):
        return jnp.sum(JaxDCCRN._apply_mask(jnp.asarray(spec), m) * cot)

    want = np.asarray(JaxDCCRN._apply_mask(jnp.asarray(spec),
                                           jnp.asarray(mask)))
    want_grad = np.asarray(jax.grad(jax_out)(jnp.asarray(mask)))
    m = torch.from_numpy(mask).permute(0, 3, 1, 2).requires_grad_()
    real, imag = DCCRN._apply_mask(
        torch.from_numpy(spec).permute(0, 3, 1, 2), m)
    got = torch.stack([real, imag], dim=-1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    grad = m.grad.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want_grad, atol=1e-4, rtol=1e-4)


def test_latency_and_optimizer():
    model = ModelRegistry.get('dccrn')(**SMALL, device='cpu')
    assert model.latency == JaxDCCRN(**SMALL).latency == 512 + 128 * 2
    assert model.optimizer().learning_rate == 1e-4
    assert model.grad_clip == 5.0
    with pytest.raises(NotImplementedError, match='adam'):
        ModelRegistry.get('dccrn')(**SMALL, optimizer='sgd',
                                   device='cpu').optimizer()
