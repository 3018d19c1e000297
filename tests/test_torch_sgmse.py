"""The port's SGMSE+ (brever_tpu_torch.models.sgmse) against the JAX
package's, in float32 on the CPU, at a small width: n_fft 128, hop 64, base
16 channels, channel_mult [1, 2], one block a level, 2 solver steps, and
attention at the second level (one AttentionBlock in the encoder, one in
the decoder). One set of flax weights (its ``buffers`` too), converted by
brever_tpu_torch.convert, gives

* the same denoiser output and the same per-item loss with t and the noise
  fixed, on a padded batch (a row of length 0 and a short row): 1e-4;
* the same parameter gradients of that loss: rtol 1e-4 with atol 1e-4 of
  the tensor's largest value (the U-Net is rematerialised in both), and
  at least 1e-8: the attention keys' bias has a zero gradient (softmax
  ignores a constant added to one query's logits), which both packages
  give as rounding noise of ~1e-9;
* the same enhancement through both solvers with the noise replaced by one
  constant in both packages: 1e-4.

The seven SDEs' s, sigma, g and sigma_inv agree at rtol 1e-5; the full
widths' parameter counts are pinned without a JAX init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import brever_tpu.models.sgmse.sdes as jax_sdes
import brever_tpu.models.sgmse.sgmse as jax_sgmse
import brever_tpu.models.sgmse.solvers as jax_solvers
from brever_tpu.models import ModelRegistry as JaxModels
from brever_tpu.models.base import sample_weighted_mean as jax_mean
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models.base import sample_weighted_mean
from brever_tpu_torch.models.sgmse import sdes

SMALL = dict(net_base_channels=16, net_channel_mult=[1, 2],
             net_num_blocks_per_res=1, solver_num_steps=2,
             net_attn_bottleneck=False, stft_frame_length=128,
             stft_hop_length=64, net_attn_resolutions=[32])
HEUN = dict(SMALL, net_attn_resolutions=[])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twins(arch, kwargs):
    jax_model = JaxModels.get(arch)(**kwargs)
    variables = jax.tree.map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0)))
    model = ModelRegistry.get(arch)(**kwargs, device='cpu')
    model.load_state_dict(model.from_flax(
        variables['params'], {'buffers': variables['buffers']}))
    return jax_model, variables, model


@pytest.fixture(scope='module')
def twins():
    return _twins('sgmsepm', SMALL)


@pytest.fixture(scope='module')
def batch():
    rng = np.random.RandomState(0)
    target = 0.3 * rng.randn(3, 1, 2, 2100)
    mix = target + 0.3 * rng.randn(3, 1, 2, 2100)
    data = np.concatenate([mix, target], axis=1).astype(np.float32)
    return data, np.array([2100, 1500, 0], np.int32)


@pytest.mark.parametrize('arch,n_params', [('sgmsep', 65_590_694),
                                           ('sgmsepm', 27_756_186)])
def test_default_width_param_count(arch, n_params):
    """Pinned like the JAX models (tests/test_training.py)."""
    assert count_params(ModelRegistry.get(arch)(device='cpu')) == n_params


def test_convert_round_trip(twins):
    """flax params and buffers -> state_dict -> flax is exact."""
    _, variables, model = twins
    sd = model.state_dict()
    assert torch.equal(sd['net.emb.fourier_freqs'], torch.from_numpy(
        np.array(variables['buffers']['emb']['fourier_freqs'])))
    back = {'params': model.to_flax(sd), **model.flax_aux(sd)}
    got, want = flatten_dict(back), flatten_dict(variables)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    assert count_params(model) == sum(
        v.size for v in flatten_dict(variables['params']).values())


def test_adm_blocks_raise():
    for arch in ('idmse', 'idmselarge'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            ModelRegistry.get(arch)(device='cpu')


def _complex(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def test_denoiser_matches_jax(twins):
    jax_model, variables, model = twins
    rng = np.random.RandomState(1)
    x, y = _complex(rng, (2, 1, 64, 19)), _complex(rng, (2, 1, 64, 19))
    t = np.array([0.3, 0.9], np.float32).reshape(2, 1, 1, 1)
    sigma = np.asarray(jax_model.sde.sigma(jnp.asarray(t)))
    ref = jax_model.model(variables, x, y, sigma, t)
    with torch.no_grad():
        got = model.model(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(sigma), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def _fixed_draws(rng, model, batch):
    """u for t = u (1 - t_eps) + t_eps, and the complex noise."""
    data, _ = batch
    spec = model.transform(torch.from_numpy(data))
    u = rng.uniform(size=(data.shape[0], 1, 1, 1)).astype(np.float32)
    return u, _complex(rng, (data.shape[0], 1) + tuple(spec.shape[2:]))


def _jax_loss(jax_model, monkeypatch, u, noise):
    monkeypatch.setattr(jax_sgmse, '_randn_like', lambda key, x: noise)
    monkeypatch.setattr(jax_sgmse.jax.random, 'uniform',
                        lambda key, shape: jnp.asarray(u))

    def loss(params, variables, data, lengths):
        per_item = jax_model.loss({**variables, 'params': params}, data,
                                  lengths, jax.random.PRNGKey(0))
        return jax_mean(per_item, lengths), per_item
    return loss


def test_loss_and_gradients_match_jax(twins, batch, monkeypatch):
    """The padded batch's per-item losses and every parameter gradient,
    with t and the noise fixed; the padding row's loss is 0 and the
    gradient finite (the complex mse's square is real^2 + imag^2)."""
    jax_model, variables, model = twins
    data, lengths = batch
    u, noise = _fixed_draws(np.random.RandomState(2), model, batch)
    loss_fn = _jax_loss(jax_model, monkeypatch, u, noise)
    (ref_mean, ref_items), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables['params'], variables, data, lengths)

    model.train()
    t = torch.from_numpy(u) * (1 - model.t_eps) + model.t_eps
    n = torch.from_numpy(lengths)
    items = model.loss_at(torch.from_numpy(data), n, t,
                          torch.from_numpy(noise))
    mean = sample_weighted_mean(items, n)
    grads = torch.autograd.grad(mean, list(model.parameters()))
    model.eval()
    np.testing.assert_allclose(items.detach().numpy(), np.asarray(ref_items),
                               rtol=1e-4, atol=1e-4)
    assert float(items[2].detach()) == 0.0
    want = model.from_flax(jax.tree.map(np.asarray, ref_grads))
    for (name, _), got in zip(model.named_parameters(), grads):
        assert torch.isfinite(got).all(), name
        ref = want[name]
        torch.testing.assert_close(
            got, ref, rtol=1e-4,
            atol=max(1e-4 * ref.abs().max().item(), 1e-8), msg=name)


def test_loss_draws_from_the_generator(twins, batch):
    _, _, model = twins
    data = torch.from_numpy(batch[0])
    n = torch.from_numpy(batch[1])
    with torch.no_grad():
        a = model.loss(data, n, torch.Generator().manual_seed(5))
        b = model.loss(data, n, torch.Generator().manual_seed(5))
        c = model.loss(data, n, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize('arch,kwargs', [('sgmsepm', SMALL),
                                         ('sgmsepmheun', HEUN)],
                         ids=['pc', 'edm'])
def test_solvers_match_jax_with_constant_noise(arch, kwargs, monkeypatch):
    jax_model, variables, model = _twins(arch, kwargs)
    noise = 0.1 + 0.05j

    def jax_noise(key, x):
        return jnp.full(x.shape, noise if jnp.iscomplexobj(x) else 0.1,
                        x.dtype)

    def torch_noise(x, generator=None):
        return torch.full(x.shape, noise if x.is_complex() else 0.1,
                          dtype=x.dtype)

    monkeypatch.setattr(jax_sdes, '_randn_like', jax_noise)
    monkeypatch.setattr(jax_solvers, '_randn_like', jax_noise)
    monkeypatch.setattr(sdes, 'randn_like', torch_noise)
    scores = []
    score = model.model.score
    monkeypatch.setattr(model.model, 'score',
                        lambda *a: scores.append(1) or score(*a))
    x = (0.3 * np.random.RandomState(3).randn(2, 2, 1900)).astype(np.float32)
    ref = np.asarray(jax_model._enhance(variables, x))
    got = model.enhance(x).numpy()
    assert got.shape == ref.shape == (2, 1900)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # 2 steps: PC evaluates twice a step, EDM skips the last step's Heun
    assert len(scores) == model.solver.evaluations == {'sgmsepm': 4,
                                                       'sgmsepmheun': 3}[arch]


SDE_KWARGS = dict(stiffness=1.5, sigma_min=0.05, sigma_max=0.5,
                  beta_min=0.01, beta_max=1.0, lambda_min=-12.0,
                  lambda_max=float('inf'), shift=3.0, beta_clamp=10.0,
                  scaling=0.1, k=10.0)


@pytest.mark.parametrize('name', ['richter-ouve', 'brever-ouve',
                                  'brever-ouvp', 'brever-oucosine', 'bbed',
                                  'bbcd', 'bbls'])
def test_sdes_match_jax(name):
    ref = jax_sdes.SDERegistry.get(name)(**SDE_KWARGS)
    sde = sdes.SDERegistry.get(name)(**SDE_KWARGS)
    t = np.linspace(0.05, 0.95, 7).astype(np.float32)
    tt = torch.from_numpy(t)
    for fn in ('s', 'sigma', 'g'):
        np.testing.assert_allclose(getattr(sde, fn)(tt).numpy(),
                                   np.asarray(getattr(ref, fn)(t)),
                                   rtol=1e-5, atol=1e-7, err_msg=fn)
    if name != 'bbed':   # the JAX package has no sigma_inv for BBED
        sigma = np.asarray(ref.sigma(t))
        np.testing.assert_allclose(
            sde.sigma_inv(torch.from_numpy(sigma)).numpy(),
            np.asarray(ref.sigma_inv(sigma)), rtol=1e-5, atol=1e-7)


def test_dropout_draws_from_the_generator_and_remat_replays_it():
    """dropout is 0 in every config; ported with an explicit generator: the
    rematerialised U-Net (checkpoint recomputes each block in the
    backward) replays the forward's draws, so its output and gradients
    equal the U-Net's without remat, bitwise, for one generator seed."""
    from brever_tpu_torch.models.sgmse.net import DiffusionUNet
    kwargs = dict(num_freqs=16, base_channels=8, channel_mult=(1, 2),
                  num_blocks_per_res=1, attn_resolutions=(8,),
                  dropout=0.3)
    torch.manual_seed(0)
    remat = DiffusionUNet(**kwargs, remat=True).train()
    plain = DiffusionUNet(**kwargs, remat=False).train()
    plain.load_state_dict(remat.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 9, 4)
                         .astype(np.float32))
    sigma = torch.tensor([0.1, 0.5])
    outs, grads = [], []
    for net in (remat, plain, remat):
        y = net(x, sigma, torch.Generator().manual_seed(7))
        outs.append(y)
        grads.append(torch.autograd.grad(y.square().sum(),
                                         list(net.parameters())))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    other = remat(x, sigma, torch.Generator().manual_seed(8))
    assert not torch.equal(other, outs[0])
    with torch.no_grad():
        evals = [remat.eval()(x, sigma, torch.Generator().manual_seed(s))
                 for s in (7, 8)]
    assert torch.equal(*evals)
