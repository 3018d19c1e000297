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


# ---------------------------------------------------------------------------
# K4's split: its launches' algebra in float64, and its launch plan

# (T, D, R, E, H) on the kernels' grid of H; the last has 2400 (t, r) pairs,
# which the weight GEMM cuts into three chunks
SPLIT_CASES = [(5, 1, 12, 72, 32), (4, 2, 9, 128, 32), (3, 2, 20, 72, 128),
               (4, 1, 16, 128, 128), (6, 2, 400, 12, 32)]


def _split_twin(x, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    """K4 as its launches split it, in float64 numpy: (1) the gates of
    every step at once from the saved h, x w_ih + bias + h[t-1] w_hh; (2)
    the reverse scan over them, dgates[t] and dh_rec = dgates[t] w_hh^T; (3)
    dx = dgates w_ih^T; (4) [x | h[t-1] | 1]^T dgates over the weight GEMM's
    chunks of (t, r) pairs; (5) the chunks' partials summed in chunk order.
    Returns (dx, dw_ih, db, dw_hh)."""
    steps, n_dir, rows, feat = x.shape
    hidden = w_hh.shape[1]
    h_prev = np.concatenate([np.zeros_like(h_seq[:1]), h_seq[:-1]])
    c_prev = np.concatenate([np.zeros_like(c_seq[:1]), c_seq[:-1]])
    pre = (np.einsum('tdre,dek->tdrk', x, w_ih) + bias[None, :, None]
           + np.einsum('tdrh,dhk->tdrk', h_prev, w_hh))

    def sig(z):
        return 1 / (1 + np.exp(-z))

    i, f, g, o = np.split(pre, 4, axis=-1)
    i, f, g, o = sig(i), sig(f), np.tanh(g), sig(o)
    tc = np.tanh(c_seq)
    dgates = np.empty_like(pre)
    rec = np.zeros_like(dh_seq[0])
    dc = np.zeros_like(dh_seq[0])
    for t in range(steps - 1, -1, -1):
        dh = dh_seq[t] + rec
        dcc = dh * o[t] * (1 - tc[t] ** 2) + dc
        dgates[t] = np.concatenate([
            dcc * g[t] * i[t] * (1 - i[t]),
            dcc * c_prev[t] * f[t] * (1 - f[t]),
            dcc * i[t] * (1 - g[t] ** 2),
            dh * tc[t] * o[t] * (1 - o[t])], axis=-1)
        dc = dcc * f[t]
        rec = np.einsum('drk,dhk->drh', dgates[t], w_hh)
    dx = np.einsum('tdrk,dek->tdre', dgates, w_ih)
    pairs = steps * rows
    a = np.concatenate([x, h_prev, np.ones(x.shape[:3] + (1,))], axis=-1)
    a = a.transpose(1, 0, 2, 3).reshape(n_dir, pairs, feat + hidden + 1)
    dg = dgates.transpose(1, 0, 2, 3).reshape(n_dir, pairs, 4 * hidden)
    plan = L.bwd_plan(steps, n_dir, rows, feat + (-feat % 4), hidden)
    chunk = plan['chunk']
    parts = [np.einsum('dpm,dpn->dmn', a[:, lo:lo + chunk],
                       dg[:, lo:lo + chunk])
             for lo in range(0, pairs, chunk)]
    assert len(parts) == plan['chunks']
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return (dx, total[:, :feat], total[:, feat + hidden],
            total[:, feat:feat + hidden])


@pytest.mark.parametrize('case', SPLIT_CASES,
                         ids=['T{}-D{}-R{}-E{}-H{}'.format(*c)
                              for c in SPLIT_CASES])
def test_split_backward_is_the_plain_backward(case):
    """K4's split (the gates as one product, the reverse scan, the dx and
    the chunked weight products) gives ``lstm_scan_x_bwd_plain``'s dx,
    dW_ih, db and dW_hh in float64, to 1e-12."""
    x, w_ih, bias, w_hh, cot = (torch.from_numpy(a).double()
                                for a in _inputs(*case, seed=5))
    h_seq, c_seq = L.lstm_scan_x_reference(x, w_ih, bias, w_hh)
    want = L.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h_seq, c_seq, cot)
    got = _split_twin(*(t.numpy() for t in (x, w_ih, bias, w_hh, h_seq,
                                            c_seq, cot)))
    for name, a, b in zip(('dx', 'dw_ih', 'db', 'dw_hh'), got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-12, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize('case', [c for c in SPLIT_CASES if c[4] == 128],
                         ids=['T{}-D{}-R{}-E{}-H{}'.format(*c)
                              for c in SPLIT_CASES if c[4] == 128])
def test_split_backward_matches_the_pallas_vjp(case, monkeypatch):
    """K4's split against ``jax.grad`` through the JAX package's
    ``lstm_scan_fused_x`` in interpret mode (its VJP is ``_bwd_x_pallas``),
    at ``test_gradients_match_jax``'s float32 tolerance."""
    x, w_ih, bias, w_hh, cot = _inputs(*case, seed=6)
    scan = _jax_scan('interpret', monkeypatch)

    def loss(*args):
        return jnp.sum(scan(*args) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w_ih, bias, w_hh)))
    f64 = [torch.from_numpy(a).double() for a in (x, w_ih, bias, w_hh)]
    h_seq, c_seq = L.lstm_scan_x_reference(*f64)
    got = _split_twin(*(t.numpy() for t in (*f64, h_seq, c_seq)),
                      cot.astype(np.float64))
    for name, a, ref in zip(('dx', 'dw_ih', 'db', 'dw_hh'), got, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


#: TF-GridNet's BLSTMs at 16 x 4 s, (T, D, R, E, H): intra, inter
GRID_SHAPES = [(33, 2, 8064, 128, 128), (126, 2, 2112, 128, 128)]


@pytest.mark.parametrize('hidden', range(32, 257, 32))
def test_backward_plan_fits_every_hidden_size(hidden):
    """The wrapper's mirror of K4's plan at every H K4 takes, on TF-GridNet's
    row counts, a ragged one and one row: the scan's threads own whole
    8-unit groups and tile rows, at most 256 a block; its shared memory
    fits a block's 232,448 bytes; the tiles cover R; the weight GEMM's
    chunks cover the T R pairs in multiples of its k slice, within the
    grid's z range."""
    for steps, n_dir, rows in ((33, 2, 8064), (126, 2, 2112), (9, 1, 70),
                               (1, 1, 1)):
        for feat in (4, 128, 1024):
            plan = L.bwd_plan(steps, n_dir, rows, feat, hidden)
            tile, per_thread = plan['rows'], plan['rows_a_thread']
            assert tile == 32 or (tile == 64 and hidden <= 128)
            assert per_thread == (2 if tile == 32 and hidden <= 128 else 4)
            assert plan['threads'] == tile // per_thread * hidden // 8
            assert plan['threads'] % 32 == 0 and plan['threads'] <= 256
            ring_rows = 4 * (32 if hidden <= 128 else 16)
            assert plan['smem'] == 4 * (4 * hidden * (tile + 4)
                                        + ring_rows * hidden)
            assert plan['smem'] <= L._MAX_SMEM
            assert (plan['tiles'] - 1) * tile < rows <= plan['tiles'] * tile
            pairs, chunk = steps * rows, plan['chunk']
            assert chunk % 16 == 0
            assert (plan['chunks'] - 1) * chunk < pairs \
                <= plan['chunks'] * chunk
            assert n_dir * plan['chunks'] <= 65535


def test_backward_plan_at_tfgridnet_shapes():
    """At 16 x 4 s the intra BLSTM's scan takes 64-row tiles (252 blocks of
    256 threads, 204,800 bytes of shared memory, one block an SM) and the
    inter BLSTM's 32-row tiles (132 blocks, 139,264 bytes); the weight GEMM
    cuts the 266,112 pairs of either into 33 chunks of 8,064: 528 blocks
    over its 16 output tiles."""
    intra, inter = (L.bwd_plan(*shape) for shape in GRID_SHAPES)
    assert (intra['rows'], intra['rows_a_thread'], intra['threads'],
            2 * intra['tiles'], intra['smem']) == (64, 4, 256, 252, 204800)
    assert (inter['rows'], inter['rows_a_thread'], inter['threads'],
            2 * inter['tiles'], inter['smem']) == (32, 2, 256, 132, 139264)
    for plan in (intra, inter):
        assert (plan['chunks'], plan['chunk']) == (33, 8064)
        assert plan['chunks'] * 2 * 2 * 4 == 528
