"""The port's LSTM recurrence (brever_tpu_torch.ops.lstm_scan: the plain
versions of K3 and K4, which the CPU path runs; brever_tpu_torch.models.rnn)
against the JAX package on the same numpy inputs: ``lstm_scan_fused_x`` in
Pallas interpret mode (``FORCE_INTERPRET``, as tests/test_lstm_fused.py
runs it; H = 128 only) and the ``_dispatch_scan_x`` fallback (the
projection einsum and the memory-lean scan VJP). Forward at atol 1e-5 /
rtol 1e-5; gradients at rtol 1e-4 with atol 1e-4 of the tensor's largest
value (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.ops.pallas.lstm_scan as fused_mod
from brever_tpu.models import rnn as jax_rnn
from brever_tpu_torch.models import rnn
from brever_tpu_torch.ops import lstm_scan as L

# (T, D, R, E, H): D = 1 and 2, H = 16 and 128, E = 72 and 128
CASES = [(5, 1, 12, 72, 16), (4, 2, 9, 128, 16), (3, 2, 20, 72, 128),
         (4, 1, 16, 128, 128)]
PATHS = [(case, 'fallback') for case in CASES] + \
    [(case, 'interpret') for case in CASES if case[4] % 128 == 0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(t_steps, n_dir, rows, feat, hidden, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    return (arr(t_steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(t_steps, n_dir, rows, hidden))


def _jax_scan(path, monkeypatch):
    if path == 'interpret':
        monkeypatch.setattr(fused_mod, 'FORCE_INTERPRET', True)
        return fused_mod.lstm_scan_fused_x
    assert not fused_mod.lstm_pallas_available()
    return lambda x, wi, b, wh: jax_rnn._dispatch_scan_x(
        x, wi, b, wh, jax_rnn.DEFAULT_UNROLL)


def _ids(params):
    case, path = params
    return f'{path}-T{case[0]}-D{case[1]}-R{case[2]}-E{case[3]}-H{case[4]}'


@pytest.mark.parametrize('case,path', PATHS, ids=[_ids(p) for p in PATHS])
def test_forward_matches_jax(case, path, monkeypatch):
    x, w_ih, bias, w_hh, _ = _inputs(*case)
    want = np.asarray(_jax_scan(path, monkeypatch)(
        jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(bias),
        jnp.asarray(w_hh)))
    got = L.lstm_scan_x(*map(torch.from_numpy, (x, w_ih, bias, w_hh)))
    assert got.shape == want.shape == case[:3] + (case[4],)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('case,path', PATHS, ids=[_ids(p) for p in PATHS])
def test_gradients_match_jax(case, path, monkeypatch):
    x, w_ih, bias, w_hh, cot = _inputs(*case, seed=1)
    scan = _jax_scan(path, monkeypatch)

    def loss(*args):
        return jnp.sum(scan(*args) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w_ih, bias, w_hh)))
    args = [torch.from_numpy(a).requires_grad_() for a in
            (x, w_ih, bias, w_hh)]
    (L.lstm_scan_x(*args) * torch.from_numpy(cot)).sum().backward()
    for name, arg, ref in zip(('dx', 'dw_ih', 'db', 'dw_hh'), args, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(arg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_plain_backward_is_autograd_of_the_loop():
    """The memory-lean plain VJP equals autograd through the time loop
    (float64)."""
    x, w_ih, bias, w_hh, cot = (torch.from_numpy(a).double() for a in
                                _inputs(6, 2, 5, 12, 8, seed=2))
    args = [a.clone().requires_grad_() for a in (x, w_ih, bias, w_hh)]
    h, _ = L.lstm_scan_x_reference(*args)
    want = torch.autograd.grad((h * cot).sum(), args)
    h_seq, c_seq = L.lstm_scan_x_reference(x, w_ih, bias, w_hh)
    got = L.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h_seq, c_seq, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-10)
    assert torch.autograd.gradcheck(
        L.lstm_scan_x_plain, [a.detach()[:, :, :2].clone().requires_grad_()
                              if i == 0 else a.detach().clone()
                              .requires_grad_()
                              for i, a in enumerate((x, w_ih, bias, w_hh))])


def test_serving_path_keeps_no_graph():
    x, w_ih, bias, w_hh, _ = map(torch.from_numpy, _inputs(3, 2, 4, 8, 8))
    w_ih.requires_grad_()
    with torch.no_grad():
        assert not L.lstm_scan_x(x, w_ih, bias, w_hh).requires_grad
    assert L.lstm_scan_x(x, w_ih, bias, w_hh).grad_fn is not None


@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_module_matches_flax(reverse):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 7, 10).astype(np.float32)
    module = rnn.LSTM(10, 16, reverse=reverse)
    params = {k: v.detach().numpy() for k, v in module.named_parameters()}
    want = jax_rnn.LSTM(16, reverse=reverse).apply({'params': params}, x)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_blstm_module_matches_flax():
    """Direction-stacked parameters, the backward direction flipped in
    time, forward and backward states concatenated; gradients too."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 9, 12).astype(np.float32)
    cot = rng.randn(4, 9, 32).astype(np.float32)
    module = rnn.BLSTM(12, 16)
    params = {k: v.detach().numpy() for k, v in module.named_parameters()}
    flax_blstm = jax_rnn.BLSTM(16)

    def loss(p, v):
        return jnp.sum(flax_blstm.apply({'params': p}, v) * cot)

    want = flax_blstm.apply({'params': params}, x)
    want_grads = jax.grad(loss)(params, x)
    xt = torch.from_numpy(x)
    got = module(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    for name, p in module.named_parameters():
        ref = np.asarray(want_grads[name])
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
