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


# ---------------------------------------------------------------------------
# the shapes the kernels take since the repairs: H off the grid is padded,
# rows past the int range are chunked, a wide E routes to the gates-in scan


@pytest.mark.parametrize('fused', [True, False], ids=['x', 'gates'])
def test_pad_hidden_keeps_the_scan(fused):
    """H = 200 zero-padded to the kernels' 224 by ``pad_hidden``: the first
    200 units of the padded plain scan are the unpadded scan, and so are the
    gradients of x and every weight (to 1e-6)."""
    rng = np.random.RandomState(200)
    steps, n_dir, rows, feat, hidden = 3, 2, 4, 8, 200
    assert L.kernel_hidden(hidden) == 224
    x = torch.from_numpy(rng.randn(steps, n_dir, rows, feat)
                         .astype(np.float32)).requires_grad_()
    w_ih = torch.from_numpy((rng.randn(n_dir, feat, 4 * hidden) / 3)
                            .astype(np.float32)).requires_grad_()
    bias = torch.from_numpy((0.1 * rng.randn(n_dir, 4 * hidden))
                            .astype(np.float32)).requires_grad_()
    w_hh = torch.from_numpy((rng.randn(n_dir, hidden, 4 * hidden) / 15)
                            .astype(np.float32)).requires_grad_()
    dh = torch.from_numpy(rng.randn(steps, n_dir, rows, hidden)
                          .astype(np.float32))
    inputs = (x, w_ih, bias, w_hh)

    def run(pad):
        if fused:
            w_hh_p, w_ih_p, bias_p = (L.pad_hidden(224, w_hh, w_ih, bias)
                                      if pad else (w_hh, w_ih, bias))
            h = L.lstm_scan_x_plain(x, w_ih_p, bias_p, w_hh_p)
        else:
            gates_x = torch.einsum('tdre,dek->tdrk', x, w_ih) \
                + bias[None, :, None]
            w_hh_p, gates_p = (L.pad_hidden(224, w_hh, gates_x) if pad
                               else (w_hh, gates_x))
            h = L.lstm_scan_plain(gates_p, w_hh_p)
        if pad:
            assert h.shape[-1] == 224
            assert not h[..., hidden:].any()
            h = h[..., :hidden]
        return h, torch.autograd.grad(h, inputs, dh)

    h_want, g_want = run(False)
    h_got, g_got = run(True)
    torch.testing.assert_close(h_got, h_want, atol=1e-6, rtol=0)
    for got, want in zip(g_got, g_want):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('steps,n_dir,rows,width', [
    (33, 2, 8064, 512),          # TF-GridNet's intra scan at 16 x 4 s
    (495, 2, 32, 512),
    (1, 1, 1, 4),
    (4000, 2, 2113, 512),        # a request of about 504 s: 2 chunks
    (126, 2, 2 ** 20, 512),      # many chunks
    (2 ** 20 - 1, 2, 3, 1024),   # one row a chunk, just under the bound
])
def test_row_chunks_cover_every_row_once(steps, n_dir, rows, width):
    chunks = L.row_chunks(steps, n_dir, rows, width)
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    for (lo, hi), (nxt, _) in zip(chunks, chunks[1:] + [(rows, None)]):
        assert lo < hi == nxt
        assert steps * n_dir * (hi - lo) * width < 2 ** 31
    if steps * n_dir * rows * width < 2 ** 31:
        assert chunks == [(0, rows)]
    else:
        assert len(chunks) == -(-steps * n_dir * rows * width // (2 ** 31 - 1))


def test_row_chunks_refuse_a_row_past_the_range():
    with pytest.raises(ValueError, match='int range'):
        L.row_chunks(2 ** 21, 2, 4, 1024)


def test_joined_chunks_are_one_launch():
    """``_join`` concatenates the per-row outputs on the row axis and sums
    the weight gradients in chunk order."""
    a = (torch.ones(2, 1, 3, 4), torch.full((2, 4), 1.0))
    b = (torch.zeros(2, 1, 2, 4), torch.full((2, 4), 2.0))
    rows, total = L._join([a, b], 1)
    assert rows.shape == (2, 1, 5, 4) and rows[:, :, :3].eq(1).all() \
        and rows[:, :, 3:].eq(0).all()
    assert total.eq(3).all()


@pytest.mark.parametrize('feat,hidden,fits', [
    (128, 128, True), (512, 128, True), (1816 - 6 * 256, 256, True),
    (1816 - 6 * 256 + 1, 256, False), (1700, 32, False), (2048, 200, False)])
def test_fused_x_fits_the_shared_memory(feat, hidden, fits):
    """K3/K4 take 32 rows x (E + 6H) floats of shared memory, E padded to a
    multiple of 4, against the H100's 227 KB a block."""
    assert L.fused_x_fits(feat, hidden) is fits


def test_dispatch_routes_a_wide_input_to_the_gates_scan(monkeypatch):
    """128 rows, but an (E, H) whose fused kernels pass the shared memory:
    the projection goes outside and the gates-in scan runs (K5/K6 on
    CUDA), as the JAX package's XLA scan gives."""
    taken = _routes(monkeypatch)
    rng = np.random.RandomState(7)
    feat, hidden = 1700, 32
    x = rng.randn(2, 2, 128, feat).astype(np.float32)
    w_ih = (rng.randn(2, feat, 4 * hidden) / 40).astype(np.float32)
    bias = (0.1 * rng.randn(2, 4 * hidden)).astype(np.float32)
    w_hh = (rng.randn(2, hidden, 4 * hidden) / 6).astype(np.float32)
    got = rnn._dispatch_scan_x(*map(torch.from_numpy, (x, w_ih, bias, w_hh)))
    assert taken == ['gates']
    want = jax_rnn._dispatch_scan_x(*map(jnp.asarray, (x, w_ih, bias, w_hh)),
                                    jax_rnn.DEFAULT_UNROLL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('hidden', [288, 384, 512])
def test_fused_x_fits_refuses_a_hidden_size_past_256(hidden):
    """K3/K4 take H up to 256 whatever E: a larger H takes the projection
    and K5/K6."""
    assert not L.fused_x_fits(4, hidden)
    assert L.fused_x_fits(4, 256)


@pytest.mark.parametrize('hidden', range(288, 8193, 32))
def test_scan_kernels_take_a_hidden_size_up_to_512(hidden):
    """K5/K6 take every multiple of 32 up to 8192 (row tiles above 256), and
    every such H is routed to them whatever E; K3/K4 still stop at 256."""
    L._check_hidden(hidden, 'lstm_scan')
    assert not L.fused_x_fits(4, hidden)
    with pytest.raises(NotImplementedError, match='up to 256'):
        L._check_hidden(hidden, 'lstm_scan_x', L._MAX_HIDDEN_X)


def test_scan_kernels_refuse_a_hidden_size_past_512():
    """Past 8192 (H = 8224) the gates-in scan raises, and says why: the
    one-row tile's state in shared memory is the smallest tile there is."""
    with pytest.raises(NotImplementedError, match='shared memory'):
        L._check_hidden(8224, 'lstm_scan')
    with pytest.raises(NotImplementedError, match='multiple of 32'):
        L._check_hidden(400, 'lstm_scan')


def test_dispatch_routes_a_wide_hidden_size_to_the_gates_scan(monkeypatch):
    """128 rows at H = 384: the projection goes outside and the gates-in
    scan runs (K5/K6 on CUDA), as the JAX package's scan gives."""
    taken = _routes(monkeypatch)
    rng = np.random.RandomState(8)
    feat, hidden = 12, 384
    x = rng.randn(2, 2, 128, feat).astype(np.float32)
    w_ih = (rng.randn(2, feat, 4 * hidden) / 4).astype(np.float32)
    bias = (0.1 * rng.randn(2, 4 * hidden)).astype(np.float32)
    w_hh = (rng.randn(2, hidden, 4 * hidden) / 20).astype(np.float32)
    got = rnn._dispatch_scan_x(*map(torch.from_numpy, (x, w_ih, bias, w_hh)))
    assert taken == ['gates']
    want = jax_rnn._dispatch_scan_x(*map(jnp.asarray, (x, w_ih, bias, w_hh)),
                                    jax_rnn.DEFAULT_UNROLL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# K5/K6's cluster (H <= 256): the shared-memory plan and the split algebra


@pytest.mark.parametrize('hidden', range(32, 257, 32))
def test_cluster_plan_fits_every_hidden_size(hidden):
    """The wrapper's mirror of the cluster plan: the cluster's blocks divide
    H into an even number of units, at most 16 a block, and both kernels'
    shared memory fits a block's 232,448 bytes."""
    blocks = L.CLUSTER_BLOCKS
    assert blocks in (8, 16) and hidden % blocks == 0
    units = hidden // blocks
    assert units % 2 == 0 and units <= 16
    fwd, bwd = L.cluster_smem(hidden)
    assert 0 < fwd <= 232448 and 0 < bwd <= 232448
    assert L._MAX_SMEM == 232448


@pytest.mark.parametrize('hidden', range(288, 8193, 32))
def test_scan_tile_plan_fits_every_wide_hidden_size(hidden):
    """Above H = 256 K5/K6 scan row tiles: 16 rows (H threads) up to 512, 8
    rows (H / 2 threads) up to 1024, then 4, 2 and 1 rows (H / 4, H / 8 and
    H / 16 threads: a thread owns 4, 8 and 16 units) up to 2048, 4096 and
    8192, and both kernels' shared memory (h, and K6's dgates and dh_rec:
    6H floats a row) fits a block's 232,448 bytes: 196,608 for K6 wherever
    H doubles the last tile's."""
    rows = next(r for r, top in ((16, 512), (8, 1024), (4, 2048),
                                 (2, 4096), (1, 8192)) if hidden <= top)
    threads = {16: hidden, 8: hidden // 2, 4: hidden // 4, 2: hidden // 8,
               1: hidden // 16}[rows]
    assert L.scan_tile_rows(hidden) == (rows, threads)
    assert 0 < threads <= 512
    fwd, bwd = L.scan_tile_smem(hidden)
    assert (fwd, bwd) == (4 * rows * hidden, 4 * rows * 6 * hidden)
    assert bwd <= L._MAX_SMEM
    if hidden in (512, 1024, 2048, 4096, 8192):
        assert bwd == 196608
    # the bf16 route holds the same values as bf16: half the bytes
    assert L.scan_tile_smem(hidden, 2) == (fwd // 2, bwd // 2)


def _cluster_twin(gates_x, w_hh, dh_seq, blocks):
    """K5 and K6 as the cluster splits them, in float64 numpy: block b owns
    units [b U, (b+1) U) with their four gates (columns ``cols[b]`` of
    w_hh) and forms their gates from its column slice; K6's dh_rec is the
    rank-ordered sum of the blocks' partials dgates[:, cols_b] w_hh[:,
    cols_b]^T. Returns (h, c, dgates, dw_hh)."""
    steps, n_dir, rows, width = gates_x.shape
    hidden = width // 4
    units = hidden // blocks
    own = [b * units + np.arange(units) for b in range(blocks)]
    cols = [np.concatenate([g * hidden + u for g in range(4)]) for u in own]

    def sig(z):
        return 1 / (1 + np.exp(-z))

    def gates(t, h_prev, b):
        pre = gates_x[t][..., cols[b]] + h_prev @ w_hh[..., cols[b]]
        return np.split(pre, 4, axis=-1)

    h_seq = np.zeros((steps, n_dir, rows, hidden))
    c_seq = np.zeros_like(h_seq)
    h, c = h_seq[0].copy(), h_seq[0].copy()
    for t in range(steps):
        h_new, c_new = np.empty_like(h), np.empty_like(c)
        for b, u in enumerate(own):
            i, f, g, o = gates(t, h, b)
            c_new[..., u] = sig(f) * c[..., u] + sig(i) * np.tanh(g)
            h_new[..., u] = sig(o) * np.tanh(c_new[..., u])
        h, c = h_seq[t], c_seq[t] = h_new, c_new
    dgates = np.zeros(gates_x.shape)
    dh_rec, dc = np.zeros_like(h), np.zeros_like(h)
    for t in range(steps - 1, -1, -1):
        h_prev = h_seq[t - 1] if t else np.zeros_like(h)
        c_prev = c_seq[t - 1] if t else np.zeros_like(h)
        partials = []
        for b, u in enumerate(own):
            i, f, g, o = gates(t, h_prev, b)
            i, f, g, o = sig(i), sig(f), np.tanh(g), sig(o)
            tc = np.tanh(c_seq[t][..., u])
            dh = dh_seq[t][..., u] + dh_rec[..., u]
            dcc = dh * o * (1 - tc * tc) + dc[..., u]
            dg_b = np.concatenate([dcc * g * i * (1 - i),
                                   dcc * c_prev[..., u] * f * (1 - f),
                                   dcc * i * (1 - g * g),
                                   dh * tc * o * (1 - o)], axis=-1)
            dc[..., u] = dcc * f
            dgates[t][..., cols[b]] = dg_b
            partials.append(dg_b @ np.swapaxes(w_hh[..., cols[b]], -1, -2))
        dh_rec = partials[0]
        for part in partials[1:]:        # rank order
            dh_rec = dh_rec + part
    h_prev = np.concatenate([np.zeros_like(h_seq[:1]), h_seq[:-1]])
    return h_seq, c_seq, dgates, np.einsum('tdrh,tdrk->dhk', h_prev, dgates)


@pytest.mark.parametrize('blocks', [8, 16])
def test_cluster_split_is_the_scan(blocks):
    """The cluster's split by columns gives the plain scan's h, c, dgates
    and dW_hh in float64 (to 1e-12), and the JAX package's
    ``_lstm_scan_impl`` and ``_lstm_scan_bwd`` on the same numpy inputs at
    this file's tolerances."""
    gates_x, w_hh, dh = _inputs(6, 2, 5, 32, seed=9)
    twin = _cluster_twin(*(a.astype(np.float64) for a in (gates_x, w_hh,
                                                          dh)), blocks)
    g64, w64, dh64 = (torch.from_numpy(a).double() for a in (gates_x, w_hh,
                                                             dh))
    h64, c64 = L.lstm_scan_reference(g64, w64)
    plain = (h64, c64, *L.lstm_scan_bwd_plain(g64, w64, h64, c64, dh64))
    for name, got, want in zip(('h', 'c', 'dgates', 'dw_hh'), twin, plain):
        np.testing.assert_allclose(got, want.numpy(), atol=1e-12, rtol=0,
                                   err_msg=name)
    h_jax, c_jax = jax_rnn._lstm_scan_impl(jnp.asarray(gates_x),
                                           jnp.asarray(w_hh), 1)
    jax_grads = jax_rnn._lstm_scan_bwd(
        1, (jnp.asarray(gates_x), jnp.asarray(w_hh), h_jax, c_jax),
        jnp.asarray(dh))
    for name, got, want in zip(('h', 'c'), twin, (h_jax, c_jax)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    for name, got, want in zip(('dgates', 'dw_hh'), twin[2:], jax_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_dispatch_routes_a_hidden_size_past_512_to_the_plain_scan(
        monkeypatch):
    """H = 640, past K3/K4's 256, on the CPU: ``_dispatch_scan_x`` projects
    outside the scan and the gates-in scan runs its plain version, with the
    JAX package's forward and gradients. (On CUDA the same route runs K5/K6
    on 8-row tiles; past H = 8192 the scan raises before any launch.)"""
    taken = _routes(monkeypatch)
    rng = np.random.RandomState(640)
    feat, hidden = 12, 640
    x = rng.randn(3, 2, 4, feat).astype(np.float32)
    w_ih = (rng.randn(2, feat, 4 * hidden) / 4).astype(np.float32)
    bias = (0.1 * rng.randn(2, 4 * hidden)).astype(np.float32)
    w_hh = (rng.randn(2, hidden, 4 * hidden) / 25).astype(np.float32)
    cot = rng.randn(3, 2, 4, hidden).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, w_ih, bias, w_hh)]
    got = rnn._dispatch_scan_x(*args)
    assert taken == ['gates']
    (got * torch.from_numpy(cot)).sum().backward()

    def loss(*a):
        return jnp.sum(jax_rnn._dispatch_scan_x(*a, jax_rnn.DEFAULT_UNROLL)
                       * cot)

    jargs = [jnp.asarray(a) for a in (x, w_ih, bias, w_hh)]
    want = jax_rnn._dispatch_scan_x(*jargs, jax_rnn.DEFAULT_UNROLL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
    for name, arg, ref in zip(('x', 'w_ih', 'bias', 'w_hh'), args, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(arg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
