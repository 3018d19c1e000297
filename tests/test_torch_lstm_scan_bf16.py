"""The bf16 mode of the port's LSTM twins (brever_tpu_torch.ops.lstm_scan:
the plain versions of K3/K4, projection-fused, and K5/K6, gates-in) against
the JAX package's Pallas kernels run at bfloat16 in interpret mode
(``FORCE_INTERPRET``, as tests/test_lstm_fused.py runs them), forward and
every gradient, on the same numpy inputs rounded to bfloat16.

The twins mirror the kernels as written: each jnp operation of
``_fwd_x_kernel``/``_bwd_x_kernel``/``_fwd_kernel``/``_bwd_kernel`` rounds
to bfloat16. XLA on the CPU may keep float32 between fused bfloat16
elementwise operations (``xla_allow_excess_precision``), which computes
something a little off the written rounding points, so the kernels are
compiled here with that option off. Tolerance in bfloat16 ulps (the
distance of the two bit patterns in bfloat16's order): at most 1 ulp
anywhere (float32 sums in another order may flip one rounding), and
bitwise for at least 99 % of the elements. Each twin is also no farther
from float64 (the float64 plain path on the same bf16-rounded inputs) than
the kernel; the default-compiled kernel's distance is printed beside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.ops.pallas.lstm_scan as fused_mod
from brever_tpu_torch.ops import lstm_scan as L

# (T, D, R, E, H) for the projection-fused kernels, (T, D, R, H) gates-in
X_CASES = [(6, 2, 16, 40, 32), (5, 1, 9, 24, 64), (4, 2, 20, 64, 48)]
#: (T, D, R, H); H = 288 is a width the card scans on row tiles
GATE_CASES = [(6, 2, 16, 32), (7, 1, 5, 64), (5, 2, 12, 48), (3, 1, 5, 288)]
AS_WRITTEN = {'xla_allow_excess_precision': False}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(fused_mod, 'FORCE_INTERPRET', True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_inputs(shapes, seed):
    """numpy float32 arrays drawn from a seed, rounded to bfloat16."""
    rng = np.random.RandomState(seed)
    out = []
    for shape, scale in shapes:
        a = (scale * rng.randn(*shape)).astype(np.float32)
        out.append(torch.from_numpy(a).bfloat16().float().numpy())
    return out


def _x_inputs(t_steps, n_dir, rows, feat, hidden, seed=0):
    return _bf16_inputs([((t_steps, n_dir, rows, feat), 1.0),
                         ((n_dir, feat, 4 * hidden), feat ** -0.5),
                         ((n_dir, 4 * hidden), 0.1),
                         ((n_dir, hidden, 4 * hidden), hidden ** -0.5),
                         ((t_steps, n_dir, rows, hidden), 1.0)], seed)


def _gate_inputs(t_steps, n_dir, rows, hidden, seed=0):
    return _bf16_inputs([((t_steps, n_dir, rows, 4 * hidden), 0.5),
                         ((n_dir, hidden, 4 * hidden), hidden ** -0.5),
                         ((t_steps, n_dir, rows, hidden), 1.0)], seed)


def _jax(fn, arrays, as_written):
    """``fn`` over bfloat16 copies of ``arrays``, compiled as written or with
    XLA's defaults; float32 numpy outputs."""
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    jitted = jax.jit(fn)
    compiled = (jitted.lower(*args).compile(compiler_options=AS_WRITTEN)
                if as_written else jitted)
    return [np.asarray(o, np.float32) for o in compiled(*args)]


def _ordered(a):
    """bfloat16 bit patterns of float32 values (already bf16) as integers in
    the values' order."""
    bits = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .view(torch.int16).numpy().astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7fff), bits)


def _ulps(got, want):
    return np.abs(_ordered(got) - _ordered(want))


def _rel(got, exact):
    return float(np.linalg.norm(np.asarray(got, np.float64) - exact)
                 / np.linalg.norm(exact))


def _compare(names, got, kernel, default, exact):
    for name, g, k, d, e in zip(names, got, kernel, default, exact):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        ulps = _ulps(g, k)
        err, kernel_err = _rel(g, e), _rel(k, e)
        print(f'{name}: {np.mean(ulps > 0):.2e} of elements differ, at most '
              f'{ulps.max()} ulp; float64 error twin {err:.3e} kernel '
              f'{kernel_err:.3e} default XLA {_rel(d, e):.3e}')
        assert ulps.max() <= 1, name
        assert np.mean(ulps > 0) <= 0.01, name
        assert err <= kernel_err * (1 + 1e-3) + 1e-12, name


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize('case', X_CASES, ids=str)
def test_fused_x_bf16_twin_matches_the_pallas_kernel(case):
    x, w_ih, bias, w_hh, dh = _x_inputs(*case)
    h, c = L.lstm_scan_x_reference(*_torch((x, w_ih, bias, w_hh),
                                           torch.bfloat16))
    assert h.dtype == c.dtype == torch.bfloat16
    grads = L.lstm_scan_x_bwd_plain(*_torch((x, w_ih, bias, w_hh),
                                            torch.bfloat16),
                                    h, c, torch.from_numpy(dh).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)

    def run(x, w_ih, bias, w_hh, dh):
        h, c = fused_mod._fwd_x_pallas(x, w_ih, bias, w_hh)
        return (h, c) + fused_mod._bwd_x_pallas(x, w_ih, bias, w_hh, h, c,
                                                dh)

    arrays = (x, w_ih, bias, w_hh, dh)
    kernel, default = _jax(run, arrays, True), _jax(run, arrays, False)
    exact_in = _torch(arrays, torch.float64)
    h64, c64 = L.lstm_scan_x_reference(*exact_in[:4])
    exact = [t.numpy() for t in (h64, c64) + L.lstm_scan_x_bwd_plain(
        *exact_in[:4], h64, c64, exact_in[4])]
    _compare(('h', 'c', 'dx', 'dw_ih', 'db', 'dw_hh'), (h, c) + grads,
             kernel, default, exact)


@pytest.mark.parametrize('case', GATE_CASES, ids=str)
def test_gates_in_bf16_twin_matches_the_pallas_kernel(case):
    gates_x, w_hh, dh = _gate_inputs(*case, seed=1)
    h, c = L.lstm_scan_reference(*_torch((gates_x, w_hh), torch.bfloat16))
    grads = L.lstm_scan_bwd_plain(*_torch((gates_x, w_hh), torch.bfloat16),
                                  h, c, torch.from_numpy(dh).bfloat16())
    assert all(t.dtype == torch.bfloat16 for t in (h, c) + grads)

    def run(gates_x, w_hh, dh):
        h, c = fused_mod._fwd_pallas(gates_x, w_hh)
        return (h, c) + fused_mod._bwd_pallas(gates_x, w_hh, h, c, dh)

    arrays = (gates_x, w_hh, dh)
    kernel, default = _jax(run, arrays, True), _jax(run, arrays, False)
    exact_in = _torch(arrays, torch.float64)
    h64, c64 = L.lstm_scan_reference(*exact_in[:2])
    exact = [t.numpy() for t in (h64, c64) + L.lstm_scan_bwd_plain(
        *exact_in[:2], h64, c64, exact_in[2])]
    _compare(('h', 'c', 'dgates', 'dw_hh'), (h, c) + grads, kernel, default,
             exact)


@pytest.mark.parametrize('fused', [True, False])
def test_bf16_autograd_gives_bf16_gradients(fused):
    """Under grad mode the bf16 twins go through the autograd Functions:
    gradients in bfloat16, the plain backward's values."""
    if fused:
        x, w_ih, bias, w_hh, dh = _torch(_x_inputs(4, 2, 6, 8, 16, seed=3),
                                         torch.bfloat16)
        args = [t.clone().requires_grad_() for t in (x, w_ih, bias, w_hh)]
        h = L.lstm_scan_x(*args)
        h_ref, c_ref = L.lstm_scan_x_reference(x, w_ih, bias, w_hh)
        want = L.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h_ref, c_ref, dh)
    else:
        gates_x, w_hh, dh = _torch(_gate_inputs(4, 2, 6, 16, seed=3),
                                   torch.bfloat16)
        args = [t.clone().requires_grad_() for t in (gates_x, w_hh)]
        h = L.lstm_scan(*args)
        h_ref, c_ref = L.lstm_scan_reference(gates_x, w_hh)
        want = L.lstm_scan_bwd_plain(gates_x, w_hh, h_ref, c_ref, dh)
    assert h.dtype == torch.bfloat16
    torch.testing.assert_close(h.detach(), h_ref, atol=0, rtol=0)
    h.backward(dh)
    for arg, ref in zip(args, want):
        assert arg.grad.dtype == torch.bfloat16
        torch.testing.assert_close(arg.grad, ref, atol=0, rtol=0)


def test_float32_mode_is_unchanged_by_the_bf16_one():
    """The float32 twins still sum in float32 with no rounding to bf16:
    against float64 on the same inputs, far inside a bf16 ulp."""
    x, w_ih, bias, w_hh, dh = _x_inputs(5, 2, 7, 12, 16, seed=5)
    h32, c32 = L.lstm_scan_x_reference(*_torch((x, w_ih, bias, w_hh),
                                               torch.float32))
    h64, _ = L.lstm_scan_x_reference(*_torch((x, w_ih, bias, w_hh),
                                             torch.float64))
    assert h32.dtype == torch.float32
    assert _rel(h32.numpy(), h64.numpy()) < 1e-6


def test_kernel_operands_share_one_dtype():
    """A launch's operands must all be float32 or all bfloat16."""
    x = torch.zeros(2, 1, 3, 4, dtype=torch.bfloat16)
    L._tensor(x, 'x', x.device, (2, 1, 3, 4), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='as the input is'):
        L._tensor(x.float(), 'w', x.device, (2, 1, 3, 4),
                  dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        L._tensor(x.half(), 'x', x.device, (2, 1, 3, 4), dtype=torch.float16)
