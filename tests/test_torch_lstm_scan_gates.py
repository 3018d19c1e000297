"""The port's gates-in LSTM scan (brever_tpu_torch.ops.lstm_scan: the plain
versions of K5 and K6, which the CPU path runs) and the scan routing of
brever_tpu_torch.models.rnn, against the JAX package on the same numpy
inputs: ``rnn.lstm_scan`` (the jnp scan ``_lstm_scan_impl`` with its
memory-lean custom VJP) and ``lstm_scan_fused`` in Pallas interpret mode
(``FORCE_INTERPRET``, as tests/test_lstm_fused.py runs it; H = 128).
Forward at atol 1e-5 / rtol 1e-5; gradients at rtol 1e-4 with atol 1e-4 of
the tensor's largest value (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.ops.pallas.lstm_scan as fused_mod
from brever_tpu.models import rnn as jax_rnn
from brever_tpu_torch.models import rnn
from brever_tpu_torch.ops import lstm_scan as L

# (T, D, R, H): D = 1 and 2, H = 16, 32 and 128, R under and over a tile
CASES = [(5, 1, 12, 16), (4, 2, 9, 32), (6, 2, 8, 128), (3, 1, 20, 128)]
PATHS = [(case, 'jnp') for case in CASES] + \
    [(case, 'interpret') for case in CASES if case[3] == 128]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: parallel test workers
    with a full thread pool each oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(t_steps, n_dir, rows, hidden, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    return (arr(t_steps, n_dir, rows, 4 * hidden),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(t_steps, n_dir, rows, hidden))


def _jax_scan(path, monkeypatch):
    if path == 'interpret':
        monkeypatch.setattr(fused_mod, 'FORCE_INTERPRET', True)
        return fused_mod.lstm_scan_fused
    return jax_rnn.lstm_scan


def _ids(params):
    case, path = params
    return f'{path}-T{case[0]}-D{case[1]}-R{case[2]}-H{case[3]}'


@pytest.mark.parametrize('case,path', PATHS, ids=[_ids(p) for p in PATHS])
def test_forward_matches_jax(case, path, monkeypatch):
    gates_x, w_hh, _ = _inputs(*case)
    want = np.asarray(_jax_scan(path, monkeypatch)(jnp.asarray(gates_x),
                                                   jnp.asarray(w_hh)))
    got = L.lstm_scan(torch.from_numpy(gates_x), torch.from_numpy(w_hh))
    assert got.shape == want.shape == case[:3] + (case[3],)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cell_states_match_jax():
    """The saved c sequence is ``_lstm_scan_impl``'s."""
    gates_x, w_hh, _ = _inputs(7, 2, 5, 16, seed=4)
    h_want, c_want = jax_rnn._lstm_scan_impl(jnp.asarray(gates_x),
                                             jnp.asarray(w_hh), 1)
    h, c = L.lstm_scan_reference(torch.from_numpy(gates_x),
                                 torch.from_numpy(w_hh))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('case,path', PATHS, ids=[_ids(p) for p in PATHS])
def test_gradients_match_jax(case, path, monkeypatch):
    gates_x, w_hh, cot = _inputs(*case, seed=1)
    scan = _jax_scan(path, monkeypatch)
    want = jax.grad(lambda g, w: jnp.sum(scan(g, w) * cot), argnums=(0, 1))(
        jnp.asarray(gates_x), jnp.asarray(w_hh))
    args = [torch.from_numpy(a).requires_grad_() for a in (gates_x, w_hh)]
    (L.lstm_scan(*args) * torch.from_numpy(cot)).sum().backward()
    for name, arg, ref in zip(('dgates', 'dw_hh'), args, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(arg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_plain_backward_is_autograd_of_the_loop():
    """The memory-lean plain VJP equals autograd through the time loop
    (float64); gradcheck of the plain path."""
    gates_x, w_hh, cot = (torch.from_numpy(a).double() for a in
                          _inputs(6, 2, 5, 8, seed=2))
    args = [a.clone().requires_grad_() for a in (gates_x, w_hh)]
    h, _ = L.lstm_scan_reference(*args)
    want = torch.autograd.grad((h * cot).sum(), args)
    h_seq, c_seq = L.lstm_scan_reference(gates_x, w_hh)
    got = L.lstm_scan_bwd_plain(gates_x, w_hh, h_seq, c_seq, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-10)
    assert torch.autograd.gradcheck(
        L.lstm_scan_plain, [gates_x[:3, :, :2].clone().requires_grad_(),
                            w_hh.clone().requires_grad_()])


def test_serving_path_keeps_no_graph():
    gates_x, w_hh, _ = map(torch.from_numpy, _inputs(3, 2, 4, 8))
    w_hh.requires_grad_()
    with torch.no_grad():
        assert not L.lstm_scan(gates_x, w_hh).requires_grad
    assert L.lstm_scan(gates_x, w_hh).grad_fn is not None


def _routes(monkeypatch):
    """Record which scan ``_dispatch_scan_x`` calls."""
    taken = []

    def record(name, fn):
        def run(*args):
            taken.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(rnn, 'lstm_scan_x', record('x', L.lstm_scan_x))
    monkeypatch.setattr(rnn, 'lstm_scan', record('gates', L.lstm_scan))
    return taken


@pytest.mark.parametrize('rows,route', [(1, 'gates'), (127, 'gates'),
                                        (128, 'x'), (130, 'x')])
def test_dispatch_takes_the_jax_route(rows, route, monkeypatch):
    """Under 128 rows the projection is one product and the gates-in scan
    follows (K5/K6 on CUDA); from 128 rows up the projection-fused scan
    (K3/K4); both give the JAX package's ``_dispatch_scan_x``."""
    taken = _routes(monkeypatch)
    rng = np.random.RandomState(rows)
    x = rng.randn(3, 2, rows, 12).astype(np.float32)
    w_ih = (rng.randn(2, 12, 64) / 4).astype(np.float32)
    bias = (0.1 * rng.randn(2, 64)).astype(np.float32)
    w_hh = (rng.randn(2, 16, 64) / 4).astype(np.float32)
    got = rnn._dispatch_scan_x(*map(torch.from_numpy, (x, w_ih, bias, w_hh)))
    assert taken == [route]
    want = jax_rnn._dispatch_scan_x(*map(jnp.asarray, (x, w_ih, bias, w_hh)),
                                    jax_rnn.DEFAULT_UNROLL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_dispatch_scan_unidirectional():
    """The 3-D ``(T, R, 4H)`` case of ``_dispatch_scan``, as the JAX
    package's."""
    gates_x, w_hh, _ = _inputs(4, 1, 6, 16, seed=3)
    got = rnn._dispatch_scan(torch.from_numpy(gates_x[:, 0]),
                             torch.from_numpy(w_hh[0]))
    want = jax_rnn._dispatch_scan(jnp.asarray(gates_x[:, 0]),
                                  jnp.asarray(w_hh[0]), 1)
    assert got.shape == (4, 6, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
