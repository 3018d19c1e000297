"""The port's MANNER (brever_tpu_torch.models.manner) against the JAX
package's (``brever_tpu/models/manner.py``, unpacked, as its default
``BREVER_MANNER_PACK=0`` runs) on one set of flax weights and ``batch_stats``
made from numpy, moved across by ``convert.manner_*``.

* A narrow network (hidden 12, depth 2, chunks of 8; 48 and 24 channels at
  the attention levels, divisible by 3) in train and eval mode: output and
  updated running statistics; the family's per-item loss (energy-weighted L1
  plus the three-resolution STFT loss, in train mode) and its gradients.
  Outputs and statistics at relative 1e-4 of the largest value; gradients,
  float32 on both sides, each against the port's float64 gradient, at rtol
  2e-3 with a floor of 2e-3 of the largest gradient: through 69-deep
  stacks of train-mode BatchNorms over a handful of samples float32 keeps
  about that much (the JAX package's own float32 gradient misses a floor of
  1e-4 by 3.4 times at the first convolutions), and a conv bias before a
  train-mode BatchNorm has a zero gradient.
* The attention branches and the chunking alone.
* The full width: 21,253,921 parameters and 69 BatchNorms, the bridge's
  tree against ``jax.eval_shape`` of the JAX init, the init's rescale, and
  one eval forward of a 4,096-sample clip at relative 1e-4.
* The one-cycle schedule against ``optax.cosine_onecycle_schedule`` at every
  step of a 40-step cycle, and Adam's state after 3 steps against
  ``optax.adam(schedule)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brever_tpu.models import manner as jax_manner
from brever_tpu_torch import convert
from brever_tpu_torch.models import count_params
from brever_tpu_torch.models import manner
from brever_tpu_torch.optim import Adam, cosine_onecycle_schedule

NARROW = dict(hidden=12, depth=2, segment_len=8)


def manner_flax_to_state_dict(params, aux=None, prefix='net.'):
    """The bridge's ``state_dict``, for a bare network (``prefix=''``)
    too."""
    sd = convert.manner_flax_to_state_dict(params, aux)
    return {prefix + k[len('net.'):]: v for k, v in sd.items()}


def manner_state_dict_to_flax(state_dict, prefix='net.'):
    return convert.manner_state_dict_to_flax(
        {'net.' + k[len(prefix):]: v for k, v in state_dict.items()})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_variables(module, length, seed):
    """A flax variable tree of ``module`` (shapes from ``jax.eval_shape``)
    filled from numpy: kernels at 1 / sqrt(fan in), scales and running
    variances in [0.5, 1.5), biases and running means small."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, length)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == 'kernel':
            fan = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan)).astype(np.float32)
        if name in ('scale', 'var'):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_net(variables, dtype=torch.float32, **kwargs):
    net = manner._MannerModule(**kwargs)
    net.load_state_dict(manner_flax_to_state_dict(
        variables['params'], {'batch_stats': variables['batch_stats']},
        prefix=''))
    return net.to(dtype)


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _signal(seed, shape):
    rng = np.random.RandomState(seed)
    return (0.3 * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_narrow_module_matches_jax(train):
    jax_net = jax_manner._MannerModule(**NARROW, pack=False)
    variables = _random_variables(jax_net, 700, seed=1)
    x = _signal(2, (3, 1, 700))
    net = _port_net(variables, **NARROW).train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    if train:
        want, upd = jax_net.apply(variables, jnp.asarray(x), train=True,
                                  mutable=['batch_stats'])
        _, aux = manner_state_dict_to_flax(net.state_dict(), prefix='')
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(aux['batch_stats'])[0],
                jax.tree_util.tree_flatten_with_path(
                    upd['batch_stats'])[0]):
            _close(a, np.asarray(b), 1e-5)
    else:
        want = jax_net.apply(variables, jnp.asarray(x), train=False)
    assert got.shape == want.shape == x.shape
    _close(got, np.asarray(want))


def _narrow_families(monkeypatch):
    """The JAX and the port's MANNER family over the narrow network."""
    jax_model = jax_manner.MANNER()
    jax_model.module = jax_manner._MannerModule(**NARROW, pack=False)
    monkeypatch.setattr(manner, '_MannerModule',
                        functools.partial(manner._MannerModule, **NARROW))
    return jax_model, manner.MANNER(device='cpu')


def test_loss_and_gradients_match_jax(monkeypatch):
    jax_model, model = _narrow_families(monkeypatch)
    variables = _random_variables(jax_model.module, 2000, seed=3)
    clean = _signal(4, (2, 1, 2, 2000))
    batch = np.concatenate([clean + _signal(5, (2, 1, 2, 2000)), clean],
                           axis=1)
    lengths = np.array([2000, 1500])

    def jax_loss(params):
        per_item, upd = jax_model.loss(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(batch), jnp.asarray(lengths), None, train=True)
        return per_item.mean(), (per_item, upd)

    (_, (want_items, upd)), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables['params'])

    def port(dtype):
        model.load_state_dict(manner_flax_to_state_dict(
            variables['params'], {'batch_stats': variables['batch_stats']}))
        model.to(dtype).train()
        per_item = model.loss(torch.from_numpy(batch).to(dtype),
                              torch.from_numpy(lengths))
        grads = torch.autograd.grad(per_item.mean(),
                                    list(model.parameters()))
        sd = {k: g for (k, _), g in zip(model.named_parameters(), grads)}
        return (per_item.detach().double().numpy(),
                manner_state_dict_to_flax(sd)[0],
                manner_state_dict_to_flax(model.state_dict())[1])

    items, grads, aux = port(torch.float32)
    _close(items, np.asarray(want_items))
    for a, b in zip(jax.tree.leaves(aux['batch_stats']),
                    jax.tree.leaves(upd['batch_stats'])):
        _close(a, np.asarray(b), 1e-5)
    _, grads64, _ = port(torch.float64)
    leaves64 = [np.asarray(g, np.float64) for g in jax.tree.leaves(grads64)]
    top = max(np.abs(g).max() for g in leaves64)
    for got in (grads, jax.tree.map(np.asarray, want_grads)):
        assert jax.tree.structure(got) == jax.tree.structure(grads64)
        for g, ref in zip(jax.tree.leaves(got), leaves64):
            np.testing.assert_allclose(g, ref, rtol=2e-3, atol=2e-3 * top)


def test_attention_branches_and_chunking_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 6).astype(np.float32)            # (B, P, chunk)
    jax_global = jax_manner._GlobalAttention(1, 6)
    v = _filled(jax_global, x, rng)
    port = manner._GlobalAttention(1, 6)
    port.load_state_dict(manner_flax_to_state_dict(v['params'], prefix=''))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jax_global.apply(v, jnp.asarray(x))))

    c = rng.randn(2, 5, 8, 6).astype(np.float32)         # (B, P, chunk, C)
    jax_local = jax_manner._LocalAttention(6)
    v = _filled(jax_local, c, rng, train=True)
    port = manner._LocalAttention(6)
    port.load_state_dict(manner_flax_to_state_dict(
        v['params'], {'batch_stats': v['batch_stats']}, prefix=''))
    for train in (False, True):   # eval first: train mode moves the stats
        port.train(train)
        with torch.no_grad():
            got = port(torch.from_numpy(c.transpose(0, 3, 1, 2).copy()))
        want = jax_local.apply(v, jnp.asarray(c), train=train,
                               mutable=['batch_stats'])[0]
        _close(got.numpy().transpose(0, 2, 3, 1), np.asarray(want))

    seq = rng.randn(2, 21, 3).astype(np.float32)         # (B, T, C)
    frames = jax_manner._chunk(jnp.asarray(seq), 8, 4)
    got = manner._chunk(torch.from_numpy(seq.transpose(0, 2, 1).copy()), 8, 4)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(frames))
    back = manner._unchunk(got, 8, 4, 21).numpy().transpose(0, 2, 1)
    _close(back, np.asarray(jax_manner._unchunk(frames, 8, 4, 21)), 1e-6)
    _close(back, seq, 1e-6)


def _filled(module, x, rng, train=False):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), *([train] if train else [])))

    def fill(path, s):
        if path[-1].key in ('scale', 'var'):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(max(s.shape[0], 1)) / 2) \
            .astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_full_width_model():
    """The default geometry: its parameter and BatchNorm counts, the bridge's
    tree against the JAX init's, and one eval forward against JAX."""
    model = manner.MANNER(device='cpu')
    assert count_params(model) == 21_253_921
    assert manner.count_batch_norms(model) == manner.N_BATCH_NORMS == 69
    jax_model = jax_manner.MANNER()
    variables = _random_variables(jax_model.module, 1024, seed=8)
    model.load_state_dict(model.from_flax(
        variables['params'], {'batch_stats': variables['batch_stats']}))
    sd = model.state_dict()
    params, aux = model.to_flax(sd), model.flax_aux(sd)
    assert jax.tree.structure(params) == \
        jax.tree.structure(variables['params'])
    assert jax.tree.structure(aux['batch_stats']) == \
        jax.tree.structure(variables['batch_stats'])
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(variables['params'])):
        np.testing.assert_array_equal(a, b)
    x = _signal(9, (1, 2, 4096))
    want = jax.jit(jax_model._enhance)(variables, jnp.asarray(x))
    got = model.enhance(x).numpy()
    assert got.shape == (1, 4096)
    _close(got, np.asarray(want))


def test_init_parameters_rescales_every_conv_kernel():
    """Each 3-D kernel (convolutions, transposed and depthwise) of the draw
    and its bias are divided by sqrt(std / 0.1), so the kernel's std becomes
    sqrt(0.1 std0); the Linear weights and the norms keep the draw."""
    model = manner.MANNER(device='cpu')
    model.init_parameters(11)
    raw = manner.MANNER(device='cpu')
    manner.BreverBaseModel.init_parameters(raw, 11)
    rescaled = set()
    convs = (manner._Conv, manner._ConvTranspose)
    for (name, m), r in zip(model.named_modules(), raw.modules()):
        if not isinstance(m, convs):
            continue
        std0 = r.weight.std(correction=0)
        torch.testing.assert_close(m.weight.std(correction=0),
                                   torch.sqrt(0.1 * std0), rtol=1e-5, atol=0)
        scale = torch.sqrt(std0 / 0.1)
        torch.testing.assert_close(m.weight, r.weight / scale)
        rescaled.add(f'{name}.weight')
        if m.bias is not None:
            torch.testing.assert_close(m.bias, r.bias / scale)
            rescaled.add(f'{name}.bias')
    assert len(rescaled) > 100
    for (name, p), q in zip(model.named_parameters(), raw.parameters()):
        assert p.ndim < 3 or name in rescaled
        if name not in rescaled:
            assert torch.equal(p, q), name


def test_onecycle_schedule_matches_optax():
    want = optax.cosine_onecycle_schedule(transition_steps=40,
                                          peak_value=1e-3)
    got = cosine_onecycle_schedule(40, 1e-3)
    for step in range(45):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def test_adam_with_the_schedule_matches_optax():
    """Three updates of ``optax.adam(schedule)``: Adam's count, mu and nu,
    the schedule's own count and the parameters."""
    rng = np.random.RandomState(12)
    params = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) for _ in range(3)]
    schedule = optax.cosine_onecycle_schedule(10, 1e-3)
    opt = optax.adam(schedule)
    state, p = opt.init(jnp.asarray(params)), jnp.asarray(params)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    adam = Adam(cosine_onecycle_schedule(10, 1e-3))
    flat = torch.from_numpy(params.copy())
    adam.init(flat)
    for g in grads:
        adam.step(flat, torch.from_numpy(g))
    adam_state, sched_state = state
    assert int(adam.count) == int(adam_state.count) == 3
    assert adam.schedule_count == int(sched_state.count) == 3
    np.testing.assert_allclose(adam.mu.numpy(), np.asarray(adam_state.mu),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(adam.nu.numpy(), np.asarray(adam_state.nu),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(flat.numpy(), np.asarray(p), rtol=0,
                               atol=1e-6)
