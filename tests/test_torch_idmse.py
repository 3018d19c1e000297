"""The port's IDMSE (``idmse``/``idmselarge``: the ADM U-Net, the cosine
SDE, EDM preconditioning and the Heun solver) against the JAX package's, in
float32 on the CPU, at a small width: n_fft 128, hop 64, base 16 channels,
channel_mult [1, 2, 3] (three levels, 16/32/48 channels, 4/8/12 groups),
one block a level, FIR [1, 1], 2 solver steps, attention at the second
level (so in every decoder block there, the ADM rule) and the bottleneck.
One set of flax weights (its ``buffers`` too), converted by
brever_tpu_torch.convert, gives

* the GroupNorm with the external affine (``GroupNormExtFunction``)
  against ``_make_gn_silu(..., has_ext=True)``: forward within rtol 2e-5 /
  atol 2e-6, the five gradients within rtol 3e-4 / atol 2e-5, the bounds of
  tests/test_torch_groupnorm.py;
* an ``adm`` ``UNetBlock`` with attention and the U-Net's denoiser: 1e-4;
* a 2-step ``edm`` solve with the noise replaced by one constant in both
  packages: 1e-4, at batch 1 (the JAX package's solve at a larger batch
  reshapes the noise level's ``(1, C)`` conditioning to ``(B, C)`` and
  raises; the port broadcasts it, and a batch of two gives each item's
  solve alone within 1e-4, other batch sizes summing in other orders);
* the per-item loss with t and the noise fixed, on a padded batch: 1e-4;
  and every parameter gradient, float32 on both sides, each against the
  port's float64 gradient at rtol 1e-3 with a floor of 1e-4 of the largest
  gradient (float32 through the remat U-Net keeps about that much; the
  attention keys' bias has a zero gradient, rounding noise in float32);
* the bridge's round trip, and at full width the bridge's tree against
  ``jax.eval_shape`` of the JAX init; the full widths' parameter counts
  (16,613,378 and 70,995,586) are pinned."""

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
from brever_tpu.models.sgmse.net import UNetBlock as JaxBlock
from brever_tpu.ops.normalization import _make_gn_silu
from brever_tpu_torch.convert import sgmse_flax_to_state_dict
from brever_tpu_torch.models import ModelRegistry, count_params
from brever_tpu_torch.models.base import sample_weighted_mean
from brever_tpu_torch.models.sgmse import net, sdes
from brever_tpu_torch.ops import groupnorm

SMALL = dict(net_base_channels=16, net_channel_mult=[1, 2, 3],
             net_num_blocks_per_res=1, solver_num_steps=2,
             stft_frame_length=128, stft_hop_length=64,
             net_attn_resolutions=[32])
EPS = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def twins():
    jax_model = JaxModels.get('idmse')(**SMALL)
    variables = jax.tree.map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0)))
    model = ModelRegistry.get('idmse')(**SMALL, device='cpu')
    model.load_state_dict(model.from_flax(
        variables['params'], {'buffers': variables['buffers']}))
    return jax_model, variables, model


def _t(a):
    return torch.from_numpy(np.array(a, order='C'))


@pytest.mark.parametrize('apply_silu', [True, False])
def test_group_norm_ext_matches_jax(apply_silu):
    """Channels last in the JAX package, channels first in the port: the
    forward and the gradients of x, scale, bias, ext_scale and ext_shift."""
    rng = np.random.RandomState(0)
    batch, n, channels, groups = 2, 37, 24, 6
    x = (0.3 + 2.0 * rng.randn(batch, n, channels)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(channels)).astype(np.float32)
    bias = (0.1 * rng.randn(channels)).astype(np.float32)
    ext_scale = (1.0 + 0.3 * rng.randn(batch, channels)).astype(np.float32)
    ext_shift = (0.3 * rng.randn(batch, channels)).astype(np.float32)
    dy = rng.randn(batch, n, channels).astype(np.float32)
    f = _make_gn_silu(groups, EPS, apply_silu, True)
    want, vjp = jax.vjp(f, x, scale, bias, ext_scale, ext_shift)
    want_grads = vjp(jnp.asarray(dy))

    leaves = [_t(x.transpose(0, 2, 1)), _t(scale), _t(bias), _t(ext_scale),
              _t(ext_shift)]
    leaves = [t.requires_grad_() for t in leaves]
    y = groupnorm.group_norm_silu(leaves[0], *leaves[1:3], groups, EPS,
                                  apply_silu, ext_scale=leaves[3],
                                  ext_shift=leaves[4])
    assert y.grad_fn.name() == 'GroupNormExtFunctionBackward'
    grads = torch.autograd.grad(y, leaves, _t(dy.transpose(0, 2, 1)))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want), rtol=2e-5, atol=2e-6)
    got = [grads[0].numpy().transpose(0, 2, 1)] + [g.numpy()
                                                   for g in grads[1:]]
    for name, g, w in zip(('x', 'scale', 'bias', 'ext_scale', 'ext_shift'),
                          got, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=3e-4, atol=2e-5,
                                   err_msg=name)
    with torch.no_grad():
        served = groupnorm.group_norm_silu(
            leaves[0], *leaves[1:3], groups, EPS, apply_silu,
            ext_scale=leaves[3], ext_shift=leaves[4])
    assert torch.equal(served, y.detach())


def test_group_norm_ext_launches_no_kernel_and_its_plain_twin_agrees():
    """With the external affine the plain route runs on every device: no K7
    or K8 is counted, and the plain wrapper gives the same bits."""
    rng = np.random.RandomState(1)
    x = _t(rng.randn(2, 8, 3, 5).astype(np.float32)).requires_grad_()
    scale, bias = torch.ones(8), torch.zeros(8)
    ext = [_t(rng.randn(2, 8).astype(np.float32)) for _ in range(2)]
    fwd, bwd = groupnorm.group_norm_act_fwd, groupnorm.group_norm_act_bwd
    before = fwd.launches, bwd.launches
    y = groupnorm.group_norm_silu(x, scale, bias, 2, ext_scale=ext[0],
                                  ext_shift=ext[1])
    y.sum().backward()
    assert (fwd.launches, bwd.launches) == before
    plain = groupnorm.group_norm_silu_plain(x, scale, bias, 2,
                                            ext_scale=ext[0],
                                            ext_shift=ext[1])
    assert torch.equal(plain, y)


def test_adm_block_matches_jax():
    """An adm block that changes width (so a skip projection) with
    attention: the emb projection's scale + 1 and shift enter the second
    GroupNorm after its own affine."""
    rng = np.random.RandomState(2)
    block = JaxBlock(in_channels=16, out_channels=24, block_type='adm',
                     skip_scale=0.5 ** 0.5, dropout=0.0, attention=True)
    x = rng.randn(2, 8, 5, 16).astype(np.float32)
    emb = rng.randn(2, 32).astype(np.float32)
    params = jax.tree.map(np.asarray, block.init(
        jax.random.PRNGKey(3), x, emb))['params']
    # the affines away from (1, 0), so that every term counts
    params = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape)
                          .astype(np.float32), params)
    want = block.apply({'params': params}, x, emb)
    port = net.UNetBlock(16, 24, 0.5 ** 0.5, 0.0, emb_channels=32,
                         block_type='adm', attention=True).eval()
    port.load_state_dict({k[len('net.'):]: v for k, v in
                          sgmse_flax_to_state_dict(params).items()})
    assert port.linear.out_features == 48 and hasattr(port, 'skip_conv')
    with torch.no_grad():
        got = port(_t(x.transpose(0, 3, 1, 2)), _t(emb))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


def test_adm_decoder_puts_attention_in_every_block_of_a_level(twins):
    _, variables, model = twins
    unet = model.net
    with_attn = {name for name, m in unet.named_children()
                 if isinstance(m, net.UNetBlock) and m.attn is not None}
    assert with_attn == {'enc_1_0', 'bottleneck_1', 'dec_1_0', 'dec_1_1'}
    params = variables['params']
    want = {name for name in params
            if isinstance(params[name], dict) and 'attn' in params[name]}
    assert with_attn == want


def test_convert_round_trip(twins):
    """flax params and buffers -> state_dict -> flax is exact."""
    _, variables, model = twins
    sd = model.state_dict()
    back = {'params': model.to_flax(sd), **model.flax_aux(sd)}
    got, want = flatten_dict(back), flatten_dict(variables)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    assert count_params(model) == sum(
        v.size for v in flatten_dict(variables['params']).values())


@pytest.mark.parametrize('arch,n_params', [('idmse', 16_613_378),
                                           ('idmselarge', 70_995_586)])
def test_default_width_param_count(arch, n_params):
    """Pinned: the JAX init's count (``jax.eval_shape`` of
    ``init_variables``) at the configs' full widths."""
    assert count_params(ModelRegistry.get(arch)(device='cpu')) == n_params


def test_full_width_bridge_tree_matches_jax():
    """idmse at full width: the port's flax tree (params and buffers) has
    the JAX init's leaves and shapes."""
    jax_model = JaxModels.get('idmse')()
    shapes = jax.eval_shape(jax_model.init_variables,
                            jax.random.PRNGKey(0))
    model = ModelRegistry.get('idmse')(device='cpu')
    sd = model.state_dict()
    got = flatten_dict({'params': model.to_flax(sd), **model.flax_aux(sd)})
    want = flatten_dict(shapes)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape, key


def _complex(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def test_denoiser_matches_jax(twins):
    jax_model, variables, model = twins
    rng = np.random.RandomState(4)
    x, y = _complex(rng, (2, 1, 64, 19)), _complex(rng, (2, 1, 64, 19))
    t = np.array([0.3, 0.9], np.float32).reshape(2, 1, 1, 1)
    sigma = np.asarray(jax_model.sde.sigma(jnp.asarray(t)))
    ref = jax_model.model(variables, x, y, sigma, t)
    with torch.no_grad():
        got = model.model(_t(x), _t(y), _t(sigma), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_edm_solve_matches_jax_with_constant_noise(twins, monkeypatch):
    jax_model, variables, model = twins
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
    x = (0.3 * np.random.RandomState(5).randn(2, 2, 1900)).astype(np.float32)
    ref = np.asarray(jax_model._enhance(variables, x[:1]))
    got = model.enhance(x).numpy()
    assert got.shape == (2, 1900) and ref.shape == (1, 1900)
    np.testing.assert_allclose(got[:1], ref, atol=1e-4, rtol=1e-4)
    # the solver's noise level is one for the batch: its (1, C) conditioning
    # broadcasts over the items, which run as they run alone
    np.testing.assert_allclose(got[1:], model.enhance(x[1:]).numpy(),
                               atol=1e-4, rtol=1e-4)
    assert model.solver.evaluations == 3


def test_loss_and_gradients_match_jax(twins, monkeypatch):
    """The padded batch's per-item losses, and every parameter gradient of
    both packages' float32 paths against the port's float64 one."""
    jax_model, variables, model = twins
    rng = np.random.RandomState(6)
    target = 0.3 * rng.randn(3, 1, 2, 2100)
    data = np.concatenate([target + 0.3 * rng.randn(3, 1, 2, 2100), target],
                          axis=1).astype(np.float32)
    lengths = np.array([2100, 1500, 0], np.int32)
    frames = model.transform(_t(data)).shape[-1]
    u = rng.uniform(size=(3, 1, 1, 1)).astype(np.float32)
    noise = _complex(rng, (3, 1, 64, frames))
    monkeypatch.setattr(jax_sgmse, '_randn_like', lambda key, x: noise)
    monkeypatch.setattr(jax_sgmse.jax.random, 'uniform',
                        lambda key, shape: jnp.asarray(u))

    def jax_loss(params):
        per_item = jax_model.loss({**variables, 'params': params}, data,
                                  lengths, jax.random.PRNGKey(0))
        return jax_mean(per_item, lengths), per_item

    (_, want_items), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(variables['params'])

    def port(dtype):
        model.to(dtype).train()
        cdtype = torch.complex128 if dtype == torch.float64 \
            else torch.complex64
        t = _t(u).to(dtype) * (1 - model.t_eps) + model.t_eps
        n = _t(lengths)
        items = model.loss_at(_t(data).to(dtype), n, t, _t(noise).to(cdtype))
        grads = torch.autograd.grad(sample_weighted_mean(items, n),
                                    list(model.parameters()))
        model.to(torch.float32).eval()
        return items.detach(), {k: g.double() for (k, _), g in
                                zip(model.named_parameters(), grads)}

    items, grads = port(torch.float32)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items),
                               rtol=1e-4, atol=1e-4)
    assert float(items[2]) == 0.0
    _, grads64 = port(torch.float64)
    top = max(g.abs().max().item() for g in grads64.values())
    jax_grads = {k: v.double() for k, v in model.from_flax(
        jax.tree.map(np.asarray, want_grads)).items()}
    for name, ref in grads64.items():
        for got in (grads[name], jax_grads[name]):
            assert torch.isfinite(got).all(), name
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * top,
                                       msg=name)
