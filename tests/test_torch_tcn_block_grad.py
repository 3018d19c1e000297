"""Gradients of the port's TCN block (brever_tpu_torch.ops.tcn_block):
the autograd Function that carries the kernel path, the backward's plain
version against the JAX package (``jax.grad`` through
``tcn_block_reference`` and through the Pallas backward in interpret
mode, at tests/test_tcn_fused.py's tolerance, atol 1e-4 and rtol 1e-3),
and the forward's per-row statistics against the Pallas forward's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brever_tpu.ops.pallas.tcn_block as tcn
from brever_tpu_torch.ops import tcn_block as port

NAMES = ('w_in', 'b_in', 'a1', 'g1', 'be1', 'w_dw', 'b_dw', 'a2', 'g2', 'be2',
         'w_res', 'b_res', 'w_skip', 'b_skip')
LINEAR = (0, 10, 12)   # 2-D weights: JAX (in, out), torch (out, in)


def _params(rng, c, h, cs):
    def arr(*s):
        return rng.randn(*s).astype('float32') * 0.1
    quarter = np.asarray([0.25], np.float32)
    return (arr(c, h), arr(h), quarter, arr(h), arr(h), arr(3, h), arr(h),
            quarter, arr(h), arr(h), arr(h, c), arr(c), arr(h, cs), arr(cs))


def _port_params(params, last=False, dtype=torch.float32):
    """The same parameters for the port, requiring grad; None for the
    last block's residual projection."""
    out = []
    for i, p in enumerate(params):
        if last and i in (10, 11):
            out.append(None)
            continue
        t = torch.from_numpy(np.ascontiguousarray(p.T) if i in LINEAR else p)
        out.append(t.to(dtype).requires_grad_())
    return out


def _block_loss(res, skip, last):
    loss = (skip ** 2).sum()
    return loss if last else loss + (res ** 2).mean()


def _fake_kernel(monkeypatch):
    """Route CPU tensors down the kernel path, with each launch replaced
    by the plain version run without autograd, as the ctypes launches
    fill fresh tensors that carry no graph."""
    def launch(x, params, dilation, last):
        with torch.no_grad():
            return port.tcn_block_fwd_plain(x, params, dilation, last), None

    def launch_bwd(x, params, stats, g_res, g_skip, dilation, last):
        return port.tcn_block_bwd_plain(x, params, g_res, g_skip, dilation,
                                        last)

    monkeypatch.setattr(port, '_on_kernel_device', lambda x: True)
    monkeypatch.setattr(port, '_launch', launch)
    monkeypatch.setattr(port, '_launch_bwd', launch_bwd)


@pytest.mark.parametrize('last', [False, True])
def test_kernel_path_carries_gradients(monkeypatch, last):
    """The fault: the kernel's forward alone cuts the graph, so a model
    calling it gave its blocks no gradient. Through the Function, x and
    every block parameter get the plain path's gradient, and each kernel
    counts its launch."""
    rng = np.random.RandomState(0)
    x_np = rng.randn(2, 40, 16).astype('float32')
    params_np = _params(rng, 16, 24, 8)
    _fake_kernel(monkeypatch)

    x = torch.from_numpy(x_np).requires_grad_()
    params = _port_params(params_np, last)
    res, skip, _ = port.tcn_block_fwd(x, params, 3, last)
    assert skip.grad_fn is None and (last or res.grad_fn is None)

    fwd, bwd = port.tcn_block.launches, port.tcn_block_bwd.launches
    res, skip = port.tcn_block(x, params, 3, last)
    _block_loss(res, skip, last).backward()
    assert port.tcn_block.launches == fwd + 1
    assert port.tcn_block_bwd.launches == bwd + 1

    x_ref = torch.from_numpy(x_np).requires_grad_()
    ref_params = _port_params(params_np, last)
    _block_loss(*port.tcn_block_plain(x_ref, ref_params, 3, last),
                last).backward()
    for name, p, q in zip(('x',) + NAMES, [x] + params, [x_ref] + ref_params):
        if q is None:
            assert p is None
            continue
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, q.grad, atol=1e-6, rtol=1e-5)


def test_inference_mode_takes_the_forward_alone(monkeypatch):
    """Serving (inference mode) calls the forward kernel and no
    Function."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 20, 16).astype('float32'))
    params = _port_params(_params(rng, 16, 24, 8))
    _fake_kernel(monkeypatch)
    with torch.inference_mode():
        res, skip = port.tcn_block(x, params, 1, False)
    assert res.grad_fn is None and skip.grad_fn is None


@pytest.mark.parametrize('last', [False, True])
@pytest.mark.parametrize('dilation', [1, 2, 4, 8, 96, 250])
def test_backward_matches_jax(dilation, last):
    """The port's backward on the CPU (its plain version, reached through
    the Function) against jax.grad of the reference and of the Pallas
    kernel (tests/test_tcn_fused.py's shapes: d=96 crosses chunks, d=250
    is d >= T's regime of zero padding)."""
    rng = np.random.RandomState(2)
    x_np = rng.randn(1, 192, 64).astype('float32')
    params_np = _params(rng, 64, 96, 64)
    x, params = jnp.asarray(x_np), tuple(jnp.asarray(p) for p in params_np)

    def loss(block):
        return lambda x, params: _block_loss(*block(x, params), last)

    grads = [jax.grad(loss(lambda x, p: tcn.tcn_block_reference(
        x, p, dilation, last)), argnums=(0, 1))(x, params),
             jax.grad(loss(lambda x, p: tcn.tcn_block_fused(
                 x, p, dilation, last, tile=64, interpret=True)),
                 argnums=(0, 1))(x, params)]

    xt = torch.from_numpy(x_np).requires_grad_()
    pt = _port_params(params_np, last)
    port.tcn_block_bwd.launches = 0
    _block_loss(*port.tcn_block(xt, pt, dilation, last), last).backward()
    assert port.tcn_block_bwd.launches == 0   # the CPU takes the plain one
    for gx, gp in grads:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=1e-4, rtol=1e-3)
        for i, (p, g) in enumerate(zip(pt, gp)):
            if p is None:
                continue
            want = np.asarray(g).T if i in LINEAR else np.asarray(g)
            np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4,
                                       rtol=1e-3, err_msg=NAMES[i])


@pytest.mark.parametrize('last', [False, True])
def test_function_gradcheck(last):
    """The Function's backward against finite differences, float64."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 9, 4)).requires_grad_()
    params = _port_params(_params(rng, 4, 6, 3), last, torch.float64)

    def block(x, *params):
        return port.TCNBlockFunction.apply(x, 2, last, *params)

    assert torch.autograd.gradcheck(block, (x, *params))


@pytest.mark.parametrize('dilation,last', [(1, False), (64, True),
                                           (600, False)])
def test_forward_stats_match_pallas(dilation, last):
    """The (B, 4) per-row statistics (mean1, rstd1, mean2, rstd2) the
    backward recomputes from, against the Pallas forward's third
    output."""
    rng = np.random.RandomState(4)
    x_np = rng.randn(2, 520, 128).astype('float32')
    params_np = _params(rng, 128, 256, 128)
    _, _, want = tcn._fwd_pallas(jnp.asarray(x_np),
                                 tuple(jnp.asarray(p) for p in params_np),
                                 dilation, last, 256, interpret=True)
    with torch.no_grad():
        _, _, stats = port.tcn_block_fwd(torch.from_numpy(x_np),
                                         _port_params(params_np, last),
                                         dilation, last)
    assert stats.shape == (2, 4) and stats.dtype == torch.float32
    np.testing.assert_allclose(stats.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
