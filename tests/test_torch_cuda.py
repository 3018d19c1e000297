"""The port's CUDA kernels on the card (marker ``cuda``; they skip
without a device). This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance of the forward kernel vs its plain version, both float32 with
TF32 off: atol 1e-4, rtol 1e-3 — the kernel sums the GEMMs in another
order and merges the global-norm moments per tile; its statistics at atol
1e-6, rtol 1e-5. Two forward runs are bitwise equal, and the backward's
recomputed z1 is bitwise the forward's. A Conv-TasNet whose kernel size is
not 3 (its model drawn from a seed) runs plain blocks on the card and
matches the CPU path at atol 1e-4, rtol 1e-3; its gradients match float64
within eight times the plain float32 path's error (floors: 1e-5 of a PReLU
slope's terms' magnitudes, of another tensor's largest value). The backward kernel
is held against its plain version in float64 (float32 rounding can flip
a PReLU branch at a pre-activation near 0, and the slopes' gradients are
sums that cancel): atol 1e-4 of the tensor's largest value, rtol 1e-3,
at sizes where a flip is unlikely (about 0.5M pre-activations).

The LSTM kernels (K3, K4) against their plain versions: the forward in
float32 at atol 1e-5, rtol 1e-4 (values of order 1; the kernel sums the
gate products in another order), two forward runs bitwise equal and the
gates K4 recomputes bitwise K3's, the backward against the plain float32
backward run in float64 and against the plain float32 backward itself, at
atol 1e-4 of the float64 tensor's largest value, rtol 1e-3; two backward
runs are bitwise equal. One K4 call launches no cuBLAS or cuDNN kernel
(a ``torch.profiler`` trace).

K3-bf16 and K4-bf16 (bf16 tensor cores) against their bf16 twins (the
Pallas kernels' rounding points): every output and gradient at least 35 dB
from the twin (the kernels sum their products in another order, which may
flip a bf16 rounding) and no farther from float64 than the twin by more
than 0.5 dB; two runs, and K4-bf16's recomputed gates and K3-bf16's,
bitwise equal; the SASS holds bf16 HMMA in each of their kernels.

The gates-in LSTM scan kernels (K5, K6) the same way as K3 and K4: the
forward in float32 at atol 1e-5, rtol 1e-4, the backward against the plain
backward run in float64 at atol 1e-4 of the tensor's largest value, rtol
1e-3, two backward runs bitwise equal.

The GroupNorm kernels (K7, K8) against their plain versions: the forward
in float32 at atol 1e-5, rtol 1e-4 (normalised values of order 1; the
kernel sums the statistics in double in another order), the backward
against the plain backward run in float64 at atol 1e-4 of the tensor's
largest value, rtol 1e-3; two backward runs are bitwise equal. The same
bounds hold on every route of their cluster plan (one block, a cluster
that holds the slab, past it, odd N, unaligned), where two runs of each
are bitwise equal, and the library's plan is the wrapper's mirror at the
U-Net's shapes. A K7 call is one launch and a K8 call two, with no library
kernel (a trace in a fresh interpreter).

The flash-BN kernels (K7-BN, K8-BN) the same way as K7 and K8, with the
running statistics' mean and variance at atol 1e-6, rtol 1e-5. The fused
STFT kernel (K9) against its plain version at atol 1e-4 of the spectrum's
largest value (a 512-term float32 product). The elementwise-rate probe
(K10) against its plain chain: float32 within 1e-5 and bfloat16 within
2**-6 of the largest value (the kernel's fused multiply-add rounds once a
step where the plain chain rounds twice), and, also at k and passes off the
benchmark's, within ``fma_chain_limit`` at every element.

FFNN (no kernel of its own) on the card against the CPU path: enhance at
atol 1e-4, rtol 1e-3, ``pre_train``'s statistics, the loss and its
gradients; the validation-metric twins on the card against themselves in
float64 on the CPU: STOI and ESTOI within 2e-3, PESQ within 5e-3 MOS.
MetricGAN+ (no kernel of its own; its BLSTMs on K5/K6) on the card: enhance
against the CPU path at atol 1e-4, rtol 1e-3, and one GAN update against
the same update in float64 on the CPU (its bounds in the test)."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.ops import batchnorm as bn
from brever_tpu_torch.ops import build
from brever_tpu_torch.ops import groupnorm as gn
from brever_tpu_torch.ops import lstm_scan as lstm
from brever_tpu_torch.ops import stft_kernel
from brever_tpu_torch.ops import tcn_block as tcn
from brever_tpu_torch.ops.stft import STFT
from brever_tpu_torch.profile_train import make_trainer

pytestmark = pytest.mark.cuda

SMALL = dict(filters=64, filter_length=16, bottleneck_channels=32,
             hidden_channels=64, skip_channels=32, layers=2, repeats=2)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda', 0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _inputs(device, batch, t_total, c=128, h=256, cs=128, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*s, scale=0.1, center=0.0):
        return torch.from_numpy(
            (center + scale * rng.randn(*s)).astype(np.float32)).to(device)

    x = arr(batch, t_total, c, scale=1.0)
    params = (arr(h, c), arr(h), arr(1, center=0.25), arr(h, center=1.0),
              arr(h), arr(3, h, scale=0.5), arr(h), arr(1, center=0.25),
              arr(h, center=1.0), arr(h), arr(c, h), arr(c), arr(cs, h),
              arr(cs))
    return x, params


@pytest.mark.parametrize('t_total,dilation', [(49, 64), (49, 128),
                                               (520, 600), (3999, 1),
                                               (3999, 128), (1, 1)])
@pytest.mark.parametrize('last', [False, True])
def test_kernel_matches_plain(device, t_total, dilation, last):
    x, params = _inputs(device, 2, t_total)
    before = tcn.tcn_block.launches
    res, skip = tcn.tcn_block(x, params, dilation, last)
    ref_res, ref_skip = tcn.tcn_block_plain(x, params, dilation, last)
    torch.cuda.synchronize()
    assert tcn.tcn_block.launches == before + 1
    torch.testing.assert_close(skip, ref_skip, atol=1e-4, rtol=1e-3)
    if last:
        assert res is None
    else:
        torch.testing.assert_close(res, ref_res, atol=1e-4, rtol=1e-3)


def test_kernel_rejects_what_it_does_not_take(device):
    x, params = _inputs(device, 1, 64)
    before = tcn.tcn_block.launches
    with pytest.raises(TypeError, match='float32'):
        tcn.tcn_block(x.double(), params, 1, False)
    with pytest.raises(ValueError, match='contiguous'):
        tcn.tcn_block(x[:, ::2], params, 1, False)
    with pytest.raises(ValueError, match='on cpu'):
        tcn.tcn_block(x, (params[0].cpu(),) + params[1:], 1, False)
    taps = torch.zeros(5, params[5].shape[1], device=device)
    with pytest.raises(NotImplementedError, match='kernel_size 3'):
        tcn.tcn_block(x, params[:5] + (taps,) + params[6:], 1, False)
    with pytest.raises(ValueError, match='must be'):
        tcn.tcn_block(x, params[:10] + (params[10][:, :8],) + params[11:],
                      1, False)
    w_in = params[0].t().contiguous().t()   # (H, C) but column-major
    with pytest.raises(ValueError, match='contiguous'):
        tcn.tcn_block(x, (w_in,) + params[1:], 1, False)
    assert tcn.tcn_block.launches == before


def test_launch_error_raises(device):
    """A grid the card refuses (batch above the 65535 grid-z limit)
    raises from the wrapper instead of failing silently."""
    x, params = _inputs(device, 65536, 1)
    with pytest.raises(RuntimeError, match='CUDA error'):
        tcn.tcn_block(x, params, 1, False)


def test_build_failure_raises(device, tmp_path, monkeypatch):
    (tmp_path / 'bad.cu').write_text('this is not C++\n')
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / 'out'))
    with pytest.raises(RuntimeError, match='nvcc failed'):
        build.build()


def test_model_runs_every_block_through_the_kernel(device):
    cpu = ModelRegistry.get('convtasnet')(**SMALL, device='cpu')
    gpu = ModelRegistry.get('convtasnet')(**SMALL, device=device)
    gpu.load_state_dict(cpu.state_dict())
    x = np.random.RandomState(3).randn(2, 2, 4000).astype(np.float32)
    before = tcn.tcn_block.launches
    out = gpu.enhance(x).cpu()
    assert tcn.tcn_block.launches - before == len(gpu.tcn.blocks) == 4
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)


# K1 at the TCN widths on the float4 and 128 grids and off them (C/H/Cs
# 36/100/20 leave partial tiles; 36/102/20 and 130/257/21 take the
# single-float kernels), T off the 128-step tile, d = 1 and 128
@pytest.mark.parametrize('c,h,cs,t_total', [
    (128, 512, 128, 3999), (128, 512, 128, 130), (36, 100, 20, 300),
    (36, 102, 20, 300), (130, 257, 21, 77), (32, 64, 32, 129)])
@pytest.mark.parametrize('dilation', [1, 128])
@pytest.mark.parametrize('last', [False, True])
def test_forward_kernel_matches_plain_at_every_width(device, c, h, cs, t_total,
                                                     dilation, last):
    """K1 (both products on the 128 x 128 SIMT tiles) against the plain
    block: res, skip and the gLN statistics; two runs bitwise equal; K2's
    recomputed z1 bitwise K1's."""
    x, params = _inputs(device, 2, t_total, c=c, h=h, cs=cs, seed=c + h + cs)
    with torch.no_grad():
        (res, skip, stats), (h1, _) = tcn._launch(x, params, dilation, last)
        again = tcn._launch(x, params, dilation, last)[0]
        ref_res, ref_skip, ref_stats = tcn.tcn_block_fwd_plain(
            x, params, dilation, last)
        z1 = tcn.recompute_z1(x, params)
    torch.cuda.synchronize()
    torch.testing.assert_close(skip, ref_skip, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(stats, ref_stats, atol=1e-6, rtol=1e-5)
    assert torch.equal(skip, again[1]) and torch.equal(stats, again[2])
    if last:
        assert res is None and again[0] is None
    else:
        torch.testing.assert_close(res, ref_res, atol=1e-4, rtol=1e-3)
        assert torch.equal(res, again[0])
    assert torch.equal(torch.where(z1 >= 0, z1, params[2] * z1), h1)


def test_forward_partials_are_the_wrappers(device):
    """K1's partials a batch row in the library (``tcn_in_partials``,
    ``tcn_dw_partials``) are the wrapper's ``fwd_partials``."""
    lib = build.load_library()
    for t_total in (1, 127, 128, 129, 3999):
        for hidden in (64, 100, 257, 512):
            assert (lib.tcn_in_partials(t_total, hidden),
                    lib.tcn_dw_partials(t_total, hidden)) == \
                tcn.fwd_partials(t_total, hidden)


@pytest.mark.parametrize('kernel_size', [5, 2])
def test_kernel_size_off_three_serves_and_trains_on_the_card(device,
                                                              kernel_size,
                                                              tmp_path):
    """A Conv-TasNet whose depthwise convs have 5 (or 2) taps runs plain
    blocks on the card (no K1 or K2 launch): enhance matches the CPU path,
    the loss's gradients match the float64 CPU path within eight times the
    plain float32 path's own error (a PReLU slope's at least 1e-5 of the
    sum of its terms' magnitudes, a cancelling sum; any other tensor's at
    least 1e-5 of its largest value: ``probe_conv_grads.gradient_bounds``),
    and a trainer step on the card gives a finite loss and moves every
    parameter. The model is drawn from a seed. ``tcn_block`` itself still
    refuses such a block on CUDA."""
    from brever_tpu_torch import probe_conv_grads as probe
    from brever_tpu_torch.profile_train import _Items
    from brever_tpu_torch.training import BreverTrainer
    kwargs = dict(SMALL, kernel_size=kernel_size)
    cpu, f64, gpu = probe.seeded_models(kernel_size, device,
                                        seed=kernel_size)
    x, batch, lengths = probe.batch_of(kernel_size)
    before = tcn.tcn_block.launches, tcn.tcn_block_bwd.launches
    out = gpu.enhance(x).cpu()
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)
    got = probe.grads(gpu, batch, lengths)
    ref, scales, _ = probe.reference(f64, batch, lengths)
    bounds = probe.gradient_bounds(ref, probe.grads(cpu, batch, lengths),
                                   scales)
    for name, r in ref.items():
        err = (got[name] - r).abs().max().item()
        assert err <= bounds[name], (name, err, bounds[name])
    items = _Items(2, 0.15)
    trainer = BreverTrainer(ModelRegistry.get('convtasnet')(
        **kwargs, device='cpu'), items, items, str(tmp_path), device=device,
        val_metrics={'snr'}, seed=0)
    trainer.init_state()
    flat = trainer.flat.clone()
    loss = trainer.train_step(torch.from_numpy(batch).to(device),
                              torch.from_numpy(lengths).to(device))
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and not torch.equal(flat, trainer.flat)
    assert (tcn.tcn_block.launches, tcn.tcn_block_bwd.launches) == before
    x_blk, params = _inputs(device, 1, 64)
    taps = torch.zeros(kernel_size, params[5].shape[1], device=device)
    with pytest.raises(NotImplementedError, match='kernel_size 3'):
        tcn.tcn_block(x_blk, params[:5] + (taps,) + params[6:], 1, False)


def _cotangents(device, x, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                 .to(device) for _ in range(2))


@pytest.mark.parametrize('t_total,dilation', [(49, 64), (49, 128), (520, 1),
                                               (520, 600), (1, 1)])
@pytest.mark.parametrize('last', [False, True])
def test_backward_kernel_matches_plain(device, t_total, dilation, last):
    x, params = _inputs(device, 2, t_total)
    if last:
        params = params[:10] + (None, None) + params[12:]
    g_res, g_skip = _cotangents(device, x)
    g_res = None if last else g_res
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, dilation, last)
    before = tcn.tcn_block_bwd.launches
    dx, dparams = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip,
                                    dilation, last)
    assert tcn.tcn_block_bwd.launches == before + 1

    def f64(t):
        return None if t is None else t.double()

    ref_dx, ref_params = tcn.tcn_block_bwd_plain(
        f64(x), [f64(p) for p in params], f64(g_res), f64(g_skip), dilation,
        last)
    torch.cuda.synchronize()
    for got, ref in zip((dx,) + dparams, (ref_dx,) + ref_params):
        if ref is None:
            assert got is None
            continue
        torch.testing.assert_close(got.double().reshape(ref.shape), ref,
                                   atol=1e-4 * ref.abs().max().item(),
                                   rtol=1e-3)


def test_backward_kernel_is_bitwise_repeatable(device):
    x, params = _inputs(device, 2, 3999)
    g_res, g_skip = _cotangents(device, x)
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, 4, False)
    first = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, 4, False)
    second = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, 4, False)
    for a, b in zip((first[0],) + first[1], (second[0],) + second[1]):
        assert torch.equal(a, b)


def test_backward_kernel_rejects_what_it_does_not_take(device):
    x, params = _inputs(device, 1, 64)
    g_res, g_skip = _cotangents(device, x)
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, 1, False)
    before = tcn.tcn_block_bwd.launches
    with pytest.raises(TypeError, match='float32'):
        tcn.tcn_block_bwd(x, params, stats, g_res, g_skip.double(), 1, False)
    with pytest.raises(ValueError, match='contiguous'):
        tcn.tcn_block_bwd(x, params, stats, g_res, g_skip[:, :32], 1, False)
    with pytest.raises(ValueError, match='on cpu'):
        tcn.tcn_block_bwd(x, params, stats.cpu(), g_res, g_skip, 1, False)
    w_skip = params[12].t().contiguous().t()   # (Cs, H) but column-major
    with pytest.raises(ValueError, match='contiguous'):
        tcn.tcn_block_bwd(x, params[:12] + (w_skip,) + params[13:], stats,
                          g_res, g_skip, 1, False)
    assert tcn.tcn_block_bwd.launches == before


def test_backward_plan_is_the_wrappers(device):
    """K2's plan in the library (``tcn_bwd_plan``, ``tcn_bwd_workspace``) is
    the wrapper's mirror (``bwd_plan``) on the Conv-TasNet shape and ragged
    ones, widths off the float4 grid among them."""
    for shape in ((16, 3999, 128, 512, 128), (2, 49, 128, 256, 128),
                  (1, 1, 32, 64, 32), (3, 4001, 36, 100, 20),
                  (2, 300, 36, 102, 20), (2, 77, 130, 257, 21)):
        for last in (False, True):
            assert tcn.plan_info(*shape, last) == tcn.bwd_plan(*shape, last)


@pytest.mark.parametrize('t_total,dilation,last', [
    (3999, 1, False), (520, 600, True), (777, 128, False), (1, 1, True)])
def test_backward_recomputes_the_forward_z1_bitwise(device, t_total,
                                                     dilation, last):
    """K2's recomputed z1 (its first launch alone) is bitwise the forward's:
    PReLU of it is K1's saved h1, so the backward takes the forward's PReLU
    branches and gLN statistics."""
    x, params = _inputs(device, 4, t_total, h=512)
    with torch.no_grad():
        _, (h1, _) = tcn._launch(x, params, dilation, last)
        z1 = tcn.recompute_z1(x, params)
    torch.cuda.synchronize()
    assert torch.equal(torch.where(z1 >= 0, z1, params[2] * z1), h1)


@pytest.mark.parametrize('dilation', [1, 2, 128])
@pytest.mark.parametrize('last', [False, True])
def test_backward_kernel_matches_float64_at_full_width(device, dilation,
                                                       last):
    """K2 at Conv-TasNet's widths (C = Cs = 128, H = 512) on a T off both
    tiles (777 steps) against the plain backward in float64 (atol 1e-4 of
    the tensor's largest value, rtol 1e-3); two runs bitwise equal."""
    x, params = _inputs(device, 1, 777, h=512, seed=dilation)
    if last:
        params = params[:10] + (None, None) + params[12:]
    g_res, g_skip = _cotangents(device, x, seed=dilation + 1)
    g_res = None if last else g_res
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, dilation, last)
    first = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation, last)
    second = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                               last)

    def f64(t):
        return None if t is None else t.double()

    ref_dx, ref_params = tcn.tcn_block_bwd_plain(
        f64(x), [f64(p) for p in params], f64(g_res), f64(g_skip), dilation,
        last)
    torch.cuda.synchronize()
    for got, again, ref in zip((first[0],) + first[1],
                               (second[0],) + second[1],
                               (ref_dx,) + ref_params):
        if ref is None:
            assert got is None and again is None
            continue
        assert torch.equal(got, again)
        torch.testing.assert_close(got.double().reshape(ref.shape), ref,
                                   atol=1e-4 * ref.abs().max().item(),
                                   rtol=1e-3)


# (C, H, Cs, T, dilation): partial 128-wide GEMM tiles in C, H and Cs on
# the float4 kernels (36/100/20, and SMALL's 32/64/32), and widths off the
# float4 grid on the single-float kernels (H = 102; C = 130, H = 257, Cs =
# 21), at a T off both tiles
@pytest.mark.parametrize('c,h,cs,t_total,dilation', [
    (36, 100, 20, 300, 1), (32, 64, 32, 129, 2), (36, 102, 20, 300, 128),
    (130, 257, 21, 77, 4)])
@pytest.mark.parametrize('last', [False, True])
def test_backward_kernel_matches_float64_at_ragged_widths(
        device, c, h, cs, t_total, dilation, last):
    """K2 at widths that leave partial tiles, or lie off the float4 grid,
    against the plain backward in float64 (atol 1e-4 of the tensor's
    largest value, rtol 1e-3); two runs bitwise equal, one launch each, and
    the recomputed z1 bitwise K1's."""
    x, params = _inputs(device, 2, t_total, c=c, h=h, cs=cs, seed=c + h)
    if last:
        params = params[:10] + (None, None) + params[12:]
    rng = np.random.RandomState(cs)
    g_res, g_skip = (torch.from_numpy(rng.randn(2, t_total, n).astype(
        np.float32)).to(device) for n in (c, cs))
    g_res = None if last else g_res
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, dilation, last)
        _, (h1, _) = tcn._launch(x, params, dilation, last)
        z1 = tcn.recompute_z1(x, params)
    before = tcn.tcn_block_bwd.launches
    first = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation, last)
    second = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                               last)
    assert tcn.tcn_block_bwd.launches == before + 2

    def f64(t):
        return None if t is None else t.double()

    ref_dx, ref_params = tcn.tcn_block_bwd_plain(
        f64(x), [f64(p) for p in params], f64(g_res), f64(g_skip), dilation,
        last)
    torch.cuda.synchronize()
    assert torch.equal(torch.where(z1 >= 0, z1, params[2] * z1), h1)
    for got, again, ref in zip((first[0],) + first[1],
                               (second[0],) + second[1],
                               (ref_dx,) + ref_params):
        if ref is None:
            assert got is None and again is None
            continue
        assert torch.equal(got, again)
        torch.testing.assert_close(got.double().reshape(ref.shape), ref,
                                   atol=1e-4 * ref.abs().max().item(),
                                   rtol=1e-3)


def test_full_width_train_step(device, tmp_path):
    """One step of BreverTrainer on default Conv-TasNet at 2 x 1 s: a
    finite loss, every parameter moved, every block's backward on the
    kernel."""
    trainer, data, lengths = make_trainer(device, str(tmp_path), batch=2,
                                          seconds=1.0)
    before = trainer.flat.clone()
    launches = tcn.tcn_block_bwd.launches
    loss = trainer.train_step(data, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tcn.tcn_block_bwd.launches - launches == 24
    moved = [not torch.equal(p, before[o:o + p.numel()].view_as(p))
             for p, o in zip(trainer._param_list, np.cumsum(
                 [0] + [q.numel() for q in trainer._param_list])[:-1])]
    assert all(moved)


# (T, D, R, E, H): R not a multiple of the 32-row tile, E = 72 (padded to
# a multiple of 4 inside the wrapper), 12 and 22, T = 1, D = 1, H 32..256
# (96 and 224 off the powers of two), K4's 64-row scan tile (D ceil(R / 64)
# >= 132)
LSTM_CASES = [(5, 2, 40, 72, 32), (1, 1, 33, 128, 128), (7, 2, 100, 128, 64),
              (3, 1, 17, 12, 256), (9, 2, 70, 128, 128), (4, 2, 45, 32, 32),
              (3, 2, 70, 22, 96), (3, 1, 130, 64, 224), (4, 2, 300, 128, 256),
              (2, 2, 4300, 16, 64)]


def _lstm_inputs(device, t_steps, n_dir, rows, feat, hidden, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)) \
            .to(device)

    return (arr(t_steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(t_steps, n_dir, rows, hidden))


@pytest.mark.parametrize('case', LSTM_CASES)
def test_lstm_kernels_match_plain(device, case):
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, *case)
    before = lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    ref_h, ref_c = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)
    torch.testing.assert_close(h, ref_h, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(c, ref_c, atol=1e-5, rtol=1e-4)
    grads = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    again = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    assert (lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    f64 = [t.double() for t in (x, w_ih, bias, w_hh)]
    h64, c64 = lstm.lstm_scan_x_reference(*f64)
    ref = lstm.lstm_scan_x_bwd_plain(*f64, h64, c64, dh.double())
    plain = lstm.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h, c, dh)
    torch.cuda.synchronize()
    for got, rerun, want, p32 in zip(grads, again, ref, plain):
        assert got.shape == want.shape
        assert torch.equal(got, rerun)
        for other in (want, p32.double()):
            torch.testing.assert_close(got.double(), other,
                                       atol=1e-4 * want.abs().max().item(),
                                       rtol=1e-3)


#: TF-GridNet's BLSTMs at 16 x 4 s, (T, D, R, E, H): intra, inter
GRID_LSTMS = [(33, 2, 8064, 128, 128), (126, 2, 2112, 128, 128)]


@pytest.mark.parametrize('case', LSTM_CASES + GRID_LSTMS)
def test_forward_lstm_kernel_matches_plain_and_k4_recomputes_its_gates(
        device, case):
    """K3 (the ring scan) against the plain forward, two runs bitwise
    equal, its plan the wrapper's; the gate pre-activations it formed are
    the bits K4's gates GEMM recomputes from the saved h."""
    x, w_ih, bias, w_hh, _ = _lstm_inputs(device, *case, seed=5)
    steps, n_dir, rows, feat, hidden = case
    assert lstm.fwd_plan_info(steps, n_dir, rows, feat + (-feat % 4),
                              hidden) == lstm.fwd_plan(*case)
    before = lstm.lstm_scan_x.launches
    with torch.no_grad():
        h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
        h2, c2 = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
        h3, c3, gates = lstm.forward_gates(x, w_ih, bias, w_hh)
        again = lstm.recompute_gates(x, w_ih, bias, w_hh, h)
        ref_h, ref_c = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)
    torch.cuda.synchronize()
    assert lstm.lstm_scan_x.launches == before + 2
    torch.testing.assert_close(h, ref_h, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(c, ref_c, atol=1e-5, rtol=1e-4)
    for a, b in ((h, h2), (c, c2), (h, h3), (c, c3), (gates, again)):
        assert torch.equal(a, b)


# K4 with weights at an unaligned offset, and with its rows cut into three
# chunks: (T, D, R, E, H, how)
K4_CASES = [(5, 2, 40, 72, 64, 'unaligned'), (6, 2, 90, 24, 128, 'chunked')]


@pytest.mark.parametrize('case', K4_CASES,
                         ids=['T{}-D{}-R{}-E{}-H{}-{}'.format(*c)
                              for c in K4_CASES])
def test_lstm_backward_kernel_matches_float64(device, case, monkeypatch):
    """K4 (the gates GEMM, the reverse scan, the dx and weight GEMMs and
    their sums) on an unaligned weight view and over row chunks against
    the plain backward in float64 and in float32, and two runs bitwise
    equal."""
    *shape, how = case
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, *shape, seed=3)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    weights = (w_ih, bias, w_hh)
    if how == 'unaligned':
        weights = tuple(_shifted(t) for t in weights)
        assert all(t.data_ptr() % 16 for t in weights)
    if how == 'chunked':
        monkeypatch.setattr(lstm, '_INT_RANGE', 6 * 2 * 30 * 512 + 1)
        assert len(lstm.row_chunks(6, 2, 90, 512)) == 3
    before = lstm.lstm_scan_x_bwd.launches
    grads = lstm.lstm_scan_x_bwd(x, *weights, h, c, dh)
    again = lstm.lstm_scan_x_bwd(x, *weights, h, c, dh)
    assert lstm.lstm_scan_x_bwd.launches - before == \
        (6 if how == 'chunked' else 2)
    f64 = [t.double() for t in (x, w_ih, bias, w_hh)]
    h64, c64 = lstm.lstm_scan_x_reference(*f64)
    ref = lstm.lstm_scan_x_bwd_plain(*f64, h64, c64, dh.double())
    plain = lstm.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h, c, dh)
    torch.cuda.synchronize()
    for got, rerun, want, p32 in zip(grads, again, ref, plain):
        assert got.shape == want.shape
        assert torch.equal(got, rerun)
        for other in (want, p32.double()):
            torch.testing.assert_close(got.double(), other,
                                       atol=1e-4 * want.abs().max().item(),
                                       rtol=1e-3)


def _shifted(t):
    """A copy of ``t`` one float into a larger buffer: contiguous, not
    16-byte aligned."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def test_lstm_backward_plan_is_the_wrappers(device):
    """K4's plan in the library (``lstm_bwd_plan``) is the wrapper's mirror
    (``bwd_plan``) at every H K4 takes, on TF-GridNet's row counts and
    ragged ones; ``plan_info`` raises where they differ."""
    for hidden in range(32, 257, 32):
        for shape in ((33, 2, 8064, 128), (126, 2, 2112, 128),
                      (2, 2, 4300, 16), (5, 1, 45, 24)):
            plan = lstm.plan_info(*shape, hidden)
            assert plan == lstm.bwd_plan(*shape, hidden)
            assert plan['smem'] <= lstm._MAX_SMEM


def test_lstm_backward_launches_no_library_kernel(device):
    """One K4 call on the card launches the library's own kernels (the
    gates, dx and weight GEMMs, the reverse scan, the sums) and PyTorch's
    copies of the transposed weights, and no cuBLAS or cuDNN kernel."""
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, 6, 2, 300, 128, 128)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = ('lstm_bwd_gates_gemm', 'lstm_bwd_rscan', 'lstm_bwd_dx_gemm',
            'lstm_bwd_wgrad_gemm', 'sum_partials')
    for part in ours:
        assert any(part in n for n in names), (part, names)
    for n in names:   # a cuBLAS or cuDNN kernel is neither
        assert any(o in n for o in ours) or 'at::native' in n, n


def test_lstm_kernels_reject_what_they_do_not_take(device):
    x, w_ih, bias, w_hh, _ = _lstm_inputs(device, 3, 2, 8, 16, 64)
    before = lstm.lstm_scan_x.launches
    with pytest.raises(TypeError, match='float32'):
        lstm.lstm_scan_x(x.double(), w_ih, bias, w_hh)
    with pytest.raises(ValueError, match='contiguous'):
        lstm.lstm_scan_x(x, w_ih.transpose(1, 2).contiguous()
                         .transpose(1, 2), bias, w_hh)
    with pytest.raises(ValueError, match='must be a contiguous'):
        lstm.lstm_scan_x(x, w_ih[:, :8], bias, w_hh)
    with pytest.raises(ValueError, match='on cpu'):
        lstm.lstm_scan_x(x, w_ih, bias.cpu(), w_hh)
    x48, w48, b48, h48, _ = _lstm_inputs(device, 3, 2, 8, 16, 48)
    with pytest.raises(NotImplementedError, match='multiple of 32'):
        lstm.lstm_scan_x_fwd(x48, w48, b48, h48)
    x288, w288, b288, h288, _ = _lstm_inputs(device, 2, 1, 8, 16, 288)
    with pytest.raises(NotImplementedError, match='up to 256'):
        lstm.lstm_scan_x(x288, w288, b288, h288)
    assert lstm.lstm_scan_x.launches == before


def test_tfgridnet_runs_every_blstm_through_the_kernels(device):
    """A small TF-GridNet (H = 32) on the card: enhance matches the CPU
    plain path with one K3 launch a grid block for the inter BLSTM (264
    rows) and one K5 launch for the intra BLSTM (80 rows, under the
    128-row floor); a loss gradient takes one K4 and one K6 launch a
    block."""
    small = dict(n_layers=2, lstm_hidden_units=32, emb_dim=8, attn_n_head=2,
                 attn_approx_qk_dim=32)
    cpu = ModelRegistry.get('tfgridnet')(**small, device='cpu')
    gpu = ModelRegistry.get('tfgridnet')(**small, device=device)
    gpu.load_state_dict(cpu.state_dict())
    x = (0.3 * np.random.RandomState(4).randn(2, 2, 5000)).astype(np.float32)
    before = lstm.lstm_scan_x.launches, lstm.lstm_scan.launches
    out = gpu.enhance(x).cpu()
    assert (lstm.lstm_scan_x.launches - before[0],
            lstm.lstm_scan.launches - before[1]) == (2, 2)
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)
    batch = torch.from_numpy(np.stack([x, x], axis=1)).to(device)
    before = lstm.lstm_scan_x_bwd.launches, lstm.lstm_scan_bwd.launches
    gpu.loss(batch, torch.tensor([5000, 4000], device=device)).sum() \
        .backward()
    torch.cuda.synchronize()
    assert (lstm.lstm_scan_x_bwd.launches - before[0],
            lstm.lstm_scan_bwd.launches - before[1]) == (2, 2)
    assert all(torch.isfinite(p.grad).all() for p in gpu.parameters())


def test_lstm_kernels_take_unaligned_views(device):
    """Weights and dh at an offset that is not 16-byte aligned, as a
    parameter in the trainer's flat buffer is, give the aligned inputs'
    bits."""
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, 4, 2, 40, 72, 64)

    def shifted(t):
        buf = t.new_empty(t.numel() + 1)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    moved = [shifted(t) for t in (w_ih, bias, w_hh, dh)]
    assert all(t.data_ptr() % 16 for t in moved)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    h2, c2 = lstm.lstm_scan_x_fwd(x, *moved[:3])
    assert torch.equal(h, h2) and torch.equal(c, c2)
    want = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    got = lstm.lstm_scan_x_bwd(x, *moved[:3], h, c, moved[3])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# K3-bf16 and K4-bf16 (the tensor-core route) against their bf16 twins:
# (T, D, R, E, H). K4's hidden-size ends at ragged R (E = 36 and 12 padded
# to the MMA depth of 16), T = 1, D = 1, H off the powers of two (96, 224:
# w_hh streamed past 128), 64-row tiles at H = 64 and 128 (D ceil(R / 64)
# >= 132) and 32-row ones, and a wide input (E = 1616: 101 k16 slices of
# w_ih through K3-bf16's ring a step)
BF16_LSTM_CASES = [(6, 2, 45, 36, 32), (4, 2, 300, 128, 256),
                   (1, 1, 33, 128, 128), (5, 2, 40, 72, 32),
                   (3, 1, 17, 12, 256), (3, 2, 70, 22, 96),
                   (3, 1, 130, 64, 224), (2, 2, 4300, 16, 64),
                   (2, 2, 8300, 128, 128), (9, 2, 70, 128, 128),
                   (3, 2, 50, 1616, 128)]
#: each bf16 output and gradient against its twin, SNR at least (dB), and
#: no farther from float64 than the twin by more than this (dB)
BF16_TWIN_DB, BF16_F64_SLACK_DB = 35.0, 0.5


def _db(got, want):
    """SNR of ``got`` against ``want`` (dB); infinite where they are equal
    (an all-zero gradient, as dW_hh at T = 1)."""
    err = ((got.double() - want.double()) ** 2).sum().item()
    if err == 0:
        return float('inf')
    return 10 * np.log10(max((want.double() ** 2).sum().item(), 1e-300)
                         / err)


def _bf16_lstm_inputs(device, t_steps, n_dir, rows, feat, hidden, seed=0):
    return [t.bfloat16() for t in _lstm_inputs(device, t_steps, n_dir, rows,
                                               feat, hidden, seed)]


@pytest.mark.parametrize('case', BF16_LSTM_CASES,
                         ids=['T{}-D{}-R{}-E{}-H{}'.format(*c)
                              for c in BF16_LSTM_CASES])
def test_bf16_lstm_kernels_match_their_twins(device, case):
    """K3-bf16 and K4-bf16 against the bf16 twins (the Pallas kernels'
    rounding points): every output and gradient >= 35 dB from the twin and
    no farther from float64 (the float64 plain path on the same bf16
    inputs) than the twin, two runs bitwise equal, K4-bf16's recomputed
    gates bitwise K3-bf16's, the plans the wrapper's mirrors."""
    x, w_ih, bias, w_hh, dh = _bf16_lstm_inputs(device, *case, seed=7)
    steps, n_dir, rows, feat, hidden = case
    e_pad = feat + (-feat % 16)
    assert lstm.fwd_plan_info(steps, n_dir, rows, e_pad, hidden, True) == \
        lstm.fwd_plan(steps, n_dir, rows, e_pad, hidden, True)
    assert lstm.plan_info(steps, n_dir, rows, e_pad, hidden, True) == \
        lstm.bwd_plan(steps, n_dir, rows, e_pad, hidden, True)
    before = (lstm.lstm_scan_x.launches_bf16,
              lstm.lstm_scan_x_bwd.launches_bf16)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    grads = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    assert (lstm.lstm_scan_x.launches_bf16 - before[0],
            lstm.lstm_scan_x_bwd.launches_bf16 - before[1]) == (1, 1)
    with torch.no_grad():
        h2, c2, gates = lstm.forward_gates(x, w_ih, bias, w_hh)
        again = lstm.recompute_gates(x, w_ih, bias, w_hh, h)
    rerun = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    twin = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)
    twin_g = lstm.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, *twin, dh)
    wide = [t.double() for t in (x, w_ih, bias, w_hh)]
    exact = lstm.lstm_scan_x_reference(*wide)
    exact_g = lstm.lstm_scan_x_bwd_plain(*wide, *exact, dh.double())
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(c, c2)
    assert torch.equal(gates, again)
    for got, want, ref in zip((h, c, *grads), (*twin, *twin_g),
                              (*exact, *exact_g)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got).all()
        assert _db(got, want) >= BF16_TWIN_DB
        assert _db(got, ref) >= _db(want, ref) - BF16_F64_SLACK_DB
    for a, b in zip(grads, rerun):
        assert torch.equal(a, b)


def test_bf16_lstm_kernels_take_unaligned_views(device):
    """bf16 weights and dh at an offset that is not 16-byte aligned give
    the aligned inputs' bits on K3-bf16 and K4-bf16 (E = 72 padded to 80)."""
    x, w_ih, bias, w_hh, dh = _bf16_lstm_inputs(device, 4, 2, 40, 72, 64)
    moved = [_shifted(t) for t in (w_ih, bias, w_hh, dh)]
    assert all(t.data_ptr() % 16 for t in moved)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    h2, c2 = lstm.lstm_scan_x_fwd(x, *moved[:3])
    assert torch.equal(h, h2) and torch.equal(c, c2)
    want = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    got = lstm.lstm_scan_x_bwd(x, *moved[:3], h, c, moved[3])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_lstm_plans_are_the_wrappers(device):
    """K3-bf16's and K4-bf16's plans in the library are the wrapper's
    mirrors at every H they take, on TF-GridNet's row counts and ragged
    ones, within a block's shared memory."""
    for hidden in range(32, 257, 32):
        for shape in ((33, 2, 8064, 128), (126, 2, 2112, 128),
                      (2, 2, 4300, 16), (5, 1, 45, 48)):
            fwd = lstm.fwd_plan_info(*shape, hidden, True)
            bwd = lstm.plan_info(*shape, hidden, True)
            assert fwd == lstm.fwd_plan(*shape, hidden, True)
            assert bwd == lstm.bwd_plan(*shape, hidden, True)
            assert max(fwd['smem'], bwd['smem']) <= lstm._MAX_SMEM


def test_bf16_lstm_kernels_run_on_the_tensor_cores(device):
    """The built library's SASS of K3-bf16's and K4-bf16's kernels holds
    bf16 tensor-core products (HMMA ... BF16)."""
    from brever_tpu_torch.profile_lstm import mma_sass
    counts = mma_sass(build.build())
    assert all(n > 0 for n in counts.values()), counts


# (T, D, R, H) of the gates-in scan: DCCRN's complex LSTM at B = 16 and at
# B = 1, R not a multiple of the 32-row tile, T = 1, D = 1, H 32..256; two
# clusters a direction at DCCRN's length, MetricGAN's padded width at one
# row, one step of a full tile; H = 384 and 512 on 16-row tiles and 640 and
# 1024 on 8-row tiles, R off the tile
SCAN_CASES = [(495, 2, 32, 128), (40, 2, 2, 128), (7, 2, 100, 64),
              (1, 1, 33, 32), (3, 1, 17, 256), (495, 2, 64, 128),
              (33, 1, 1, 224), (1, 2, 32, 32), (9, 2, 40, 384),
              (5, 1, 17, 512), (6, 2, 9, 640), (4, 1, 17, 1024)]


def _scan_inputs(device, t_steps, n_dir, rows, hidden):
    """gates_x (T, D, R, 4H), w_hh and dh of the gates-in scan."""
    gates_x, _, _, w_hh, dh = _lstm_inputs(device, t_steps, n_dir, rows,
                                           4 * hidden, hidden)
    return gates_x, w_hh, dh


@pytest.mark.parametrize('case', SCAN_CASES)
def test_scan_kernels_match_plain(device, case):
    gates_x, w_hh, dh = _scan_inputs(device, *case)
    before = lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches
    h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
    h2, c2 = lstm.lstm_scan_fwd(gates_x, w_hh)
    ref_h, ref_c = lstm.lstm_scan_reference(gates_x, w_hh)
    torch.testing.assert_close(h, ref_h, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(c, ref_c, atol=1e-5, rtol=1e-4)
    assert torch.equal(h, h2) and torch.equal(c, c2)
    grads = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
    again = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
    assert (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    h64, c64 = lstm.lstm_scan_reference(gates_x.double(), w_hh.double())
    ref = lstm.lstm_scan_bwd_plain(gates_x.double(), w_hh.double(), h64, c64,
                                   dh.double())
    torch.cuda.synchronize()
    for got, rerun, want in zip(grads, again, ref):
        assert got.shape == want.shape
        assert torch.equal(got, rerun)
        torch.testing.assert_close(got.double(), want,
                                   atol=1e-4 * want.abs().max().item(),
                                   rtol=1e-3)


def test_scan_kernels_reject_what_they_do_not_take(device):
    gates_x, w_hh, _ = _scan_inputs(device, 3, 2, 8, 64)
    before = lstm.lstm_scan.launches
    with pytest.raises(TypeError, match='float32'):
        lstm.lstm_scan(gates_x.double(), w_hh)
    with pytest.raises(ValueError, match='contiguous'):
        lstm.lstm_scan(gates_x, w_hh.transpose(1, 2).contiguous()
                       .transpose(1, 2))
    with pytest.raises(ValueError, match='gate columns'):
        lstm.lstm_scan(gates_x[..., :128].contiguous(), w_hh)
    with pytest.raises(ValueError, match='on cpu'):
        lstm.lstm_scan(gates_x, w_hh.cpu())
    g48, w48, _ = _scan_inputs(device, 3, 2, 8, 48)
    with pytest.raises(NotImplementedError, match='multiple of 32'):
        lstm.lstm_scan_fwd(g48, w48)
    g8224, w8224, _ = _wide_scan_inputs(device, 2, 1, 8, 8224)
    with pytest.raises(NotImplementedError, match='shared memory'):
        lstm.lstm_scan(g8224, w8224)
    assert lstm.lstm_scan.launches == before


def _wide_scan_inputs(device, t_steps, n_dir, rows, hidden, seed=0):
    """gates_x, w_hh and dh of the gates-in scan at a wide H: w_hh drawn on
    the card (a (D, H, 4H) numpy draw takes tens of seconds at H = 8192),
    the rest from numpy."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    w_hh = torch.randn(n_dir, hidden, 4 * hidden, generator=gen,
                       device=device) * hidden ** -0.5
    gates_x, dh = (torch.from_numpy(rng.randn(t_steps, n_dir, rows, width)
                                    .astype(np.float32)).to(device)
                   for width in (4 * hidden, hidden))
    return gates_x, w_hh, dh


#: K5/K6 past H = 1024 (T, D, R, H): 4-, 2- and 1-row tiles, the first H
#: of the 4-row tiles, R off the tile
WIDE_SCAN_CASES = [(4, 1, 3, 1056), (3, 2, 5, 2048), (3, 1, 3, 4096),
                   (2, 1, 2, 8192)]


@pytest.mark.parametrize('case', WIDE_SCAN_CASES, ids=lambda c: f'H{c[3]}')
def test_wide_scan_kernels_match_float64(device, case):
    """K5/K6 on the 4-, 2- and 1-row tiles against the plain scan and its
    backward in float64 (atol 1e-5 and 1e-4 of the tensor's largest value,
    rtol 1e-4 and 1e-3: float32 sums of up to 8192 products in another
    order); two runs of each bitwise equal."""
    gates_x, w_hh, dh = _wide_scan_inputs(device, *case)
    before = lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches
    runs = [lstm.lstm_scan_fwd(gates_x, w_hh) for _ in range(2)]
    runs = [(h, c, *lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh))
            for h, c in runs]
    assert (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    f64 = gates_x.double(), w_hh.double()
    h64, c64 = lstm.lstm_scan_reference(*f64)
    want = (h64, c64, *lstm.lstm_scan_bwd_plain(*f64, h64, c64, dh.double()))
    torch.cuda.synchronize()
    for i, (got, rerun, ref) in enumerate(zip(*runs, want)):
        assert torch.equal(got, rerun)
        tol = (1e-5, 1e-4) if i < 2 else (1e-4, 1e-3)
        torch.testing.assert_close(got.double(), ref,
                                   atol=tol[0] * ref.abs().max().item(),
                                   rtol=tol[1])


@pytest.mark.parametrize('fused', [True, False], ids=['K3K4', 'K5K6'])
def test_lstm_kernels_pad_a_hidden_size_off_the_grid(device, fused):
    """H = 200 (MetricGAN's) runs on the kernels as 224: h and every
    gradient against the plain path at H = 200."""
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, 5, 2, 40, 24, 200)
    if fused:
        inputs = [t.clone().requires_grad_() for t in (x, w_ih, bias, w_hh)]
        run, plain = lstm.lstm_scan_x, lstm.lstm_scan_x_plain
        counters = (lstm.lstm_scan_x, lstm.lstm_scan_x_bwd)
    else:
        gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                   + bias[None, :, None]).contiguous()
        inputs = [t.clone().requires_grad_() for t in (gates_x, w_hh)]
        run, plain = lstm.lstm_scan, lstm.lstm_scan_plain
        counters = (lstm.lstm_scan, lstm.lstm_scan_bwd)
    before = [c.launches for c in counters]
    h = run(*inputs)
    grads = torch.autograd.grad(h, inputs, dh)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    h_ref = plain(*inputs)
    ref = torch.autograd.grad(h_ref, inputs, dh)
    torch.cuda.synchronize()
    assert h.shape == h_ref.shape
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-4)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want,
                                   atol=1e-4 * want.abs().max().item(),
                                   rtol=1e-3)


@pytest.mark.parametrize('fused', [True, False], ids=['K3K4', 'K5K6'])
def test_lstm_kernels_chunk_rows_past_the_int_range(device, fused,
                                                    monkeypatch):
    """With the int range lowered to force three row chunks, the chunked
    launches give the one launch's h, c, dx and weight gradients."""
    x, w_ih, bias, w_hh, dh = _lstm_inputs(device, 6, 2, 90, 24, 64)
    if fused:
        args = (x, w_ih, bias, w_hh)
        fwd, bwd, counter = (lstm.lstm_scan_x_fwd, lstm.lstm_scan_x_bwd,
                             lstm.lstm_scan_x)
    else:
        args = ((torch.einsum('tdre,dek->tdrk', x, w_ih)
                 + bias[None, :, None]).contiguous(), w_hh)
        fwd, bwd, counter = (lstm.lstm_scan_fwd, lstm.lstm_scan_bwd,
                             lstm.lstm_scan)
    h, c = fwd(*args)
    want = bwd(*args, h, c, dh)
    monkeypatch.setattr(lstm, '_INT_RANGE', 6 * 2 * 30 * 256 + 1)
    assert len(lstm.row_chunks(6, 2, 90, 256)) == 3
    before = counter.launches
    h3, c3 = fwd(*args)
    got = bwd(*args, h3, c3, dh)
    assert counter.launches - before == 3
    torch.testing.assert_close(h3, h, atol=1e-6, rtol=0)
    torch.testing.assert_close(c3, c, atol=1e-6, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5 * w.abs().max().item(),
                                   rtol=1e-5)


def test_fused_x_fits_is_the_kernels_shared_memory(device):
    """The Python routing rule admits only shapes whose K3 plan
    (``lstm_fwd_plan``) and K4 plan (``lstm_bwd_plan``) fit a block, and
    refuses the shapes it refused before K4's redesign (32 rows x (E + 6H)
    floats past a block's)."""
    for feat, hidden in ((128, 128), (280, 256), (284, 256), (1700, 32)):
        e_pad = feat + (-feat % 4)
        fits = 4 * 32 * (e_pad + 6 * hidden) <= lstm._MAX_SMEM
        assert lstm.fused_x_fits(feat, hidden) is fits
        if fits:
            assert lstm.fwd_plan_info(33, 2, 8064, e_pad, hidden)['smem'] \
                <= lstm._MAX_SMEM
            assert lstm.plan_info(33, 2, 8064, e_pad, hidden)['smem'] \
                <= lstm._MAX_SMEM


def test_scan_tile_smem_is_the_wrappers(device):
    """K6's shared memory on row tiles (256 < H <= 8192) in the library is
    the wrapper's ``scan_tile_smem``, within a block's."""
    lib = build.load_library()
    for hidden in range(288, 8193, 32):
        bwd = lstm.scan_tile_smem(hidden)[1]
        assert lib.lstm_scan_tile_smem(hidden) == bwd <= lstm._MAX_SMEM


def test_scan_cluster_is_the_wrappers(device):
    """K5/K6's cluster at every H up to 256: the library's blocks are
    ``CLUSTER_BLOCKS``, its shared memory ``cluster_smem``'s, and the card
    holds at least one cluster of each kernel at once."""
    for hidden in range(32, 257, 32):
        info = lstm.cluster_info(hidden)
        assert info['blocks'] == lstm.CLUSTER_BLOCKS
        assert (info['smem_fwd'], info['smem_bwd']) == \
            lstm.cluster_smem(hidden)
        assert min(info['active_fwd'], info['active_bwd']) >= 1


def test_wide_hidden_scan_raises_before_any_launch(device):
    """H = 8224, past K5/K6's 8192, through ``models/rnn.py`` on the card:
    the gates-in scan raises with its message, and neither kernel is
    launched."""
    from brever_tpu_torch.models import rnn
    x, w_ih, bias, _, _ = _lstm_inputs(device, 4, 2, 6, 24, 32)
    hidden = 8224
    w_ih, bias = (t.repeat_interleave(hidden // 32, dim=-1)
                  for t in (w_ih, bias))
    w_hh = _wide_scan_inputs(device, 1, 2, 1, hidden)[1]
    leaves = [t.clone().requires_grad_() for t in (x, w_ih, bias, w_hh)]
    before = lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches
    with pytest.raises(NotImplementedError, match='shared memory'):
        rnn._dispatch_scan_x(*leaves)
    assert (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches) == before


def test_scan_kernels_take_unaligned_views(device):
    """gates_x, w_hh and dh at an offset that is not 16-byte aligned give
    the aligned inputs' bits."""
    gates_x, w_hh, dh = _scan_inputs(device, 6, 2, 40, 64)

    def shifted(t):
        buf = t.new_empty(t.numel() + 1)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    moved = [shifted(t) for t in (gates_x, w_hh, dh)]
    assert all(t.data_ptr() % 16 for t in moved)
    h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
    h2, c2 = lstm.lstm_scan_fwd(*moved[:2])
    assert torch.equal(h, h2) and torch.equal(c, c2)
    want = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
    got = lstm.lstm_scan_bwd(*moved[:2], h, c, moved[2])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dccrn_runs_its_complex_lstm_through_the_scan_kernels(device,
                                                          monkeypatch):
    """A small DCCRN (H = 32) on the card: enhance matches the CPU plain
    path with one K5 launch a complex LSTM layer; a loss gradient takes one
    K6 launch a layer and agrees with the plain path in float64; the
    running statistics move in train mode."""
    small = dict(channels=[8, 16], lstm_channels=32, lstm_layers=2)
    cpu = ModelRegistry.get('dccrn')(**small, device='cpu')
    cpu.init_parameters(0)
    gpu = ModelRegistry.get('dccrn')(**small, device=device)
    gpu.load_state_dict(cpu.state_dict())
    x = (0.3 * np.random.RandomState(5).randn(2, 2, 8000)).astype(np.float32)
    before = lstm.lstm_scan.launches, lstm.lstm_scan_x.launches
    out = gpu.enhance(x).cpu()
    assert (lstm.lstm_scan.launches - before[0],
            lstm.lstm_scan_x.launches - before[1]) == (2, 0)
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)
    ref = ModelRegistry.get('dccrn')(**small, device='cpu').double()
    ref.load_state_dict(cpu.state_dict())
    batch = torch.from_numpy(np.stack([x, x], axis=1)).to(device)
    lengths = torch.tensor([8000, 6000], device=device)
    gpu.train()
    before = lstm.lstm_scan_bwd.launches
    got = torch.autograd.grad(gpu.loss(batch, lengths).mean(),
                              list(gpu.parameters()))
    torch.cuda.synchronize()
    assert lstm.lstm_scan_bwd.launches - before == 2
    assert not torch.equal(gpu.enc_norm_0.mean.cpu(), cpu.enc_norm_0.mean)
    ref = ref.to(device).train()
    from brever_tpu_torch.models import rnn
    monkeypatch.setattr(rnn, 'lstm_scan', lstm.lstm_scan_plain)
    want = torch.autograd.grad(ref.loss(batch.double(), lengths).mean(),
                               list(ref.parameters()))
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=1e-3,
                                   atol=1e-4 * top)


GN_CASES = [((2, 128, 33, 41), 32, 'silu'), ((2, 256, 8, 16), 32, 'none'),
            ((1, 384, 7, 13), 32, 'silu'), ((3, 96, 17), 24, 'silu'),
            ((2, 64, 5, 3), 64, 'relu')]


def _gn_inputs(device, shape, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*s, scale=1.0, center=0.0):
        return torch.from_numpy(
            (center + scale * rng.randn(*s)).astype(np.float32)).to(device)

    c = shape[1]
    return (arr(*shape, scale=2.0, center=0.5), arr(c, scale=0.1, center=1.0),
            arr(c, scale=0.1), arr(*shape))


@pytest.mark.parametrize('shape,groups,act', GN_CASES,
                         ids=lambda v: str(v))
def test_groupnorm_kernels_match_plain(device, shape, groups, act):
    x, scale, bias, dy = _gn_inputs(device, shape)
    y, mean, rstd = gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6, act)
    ref, ref_mean, ref_rstd = gn.group_norm_act_reference(
        x, scale, bias, groups, 1e-6, act)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(mean, ref_mean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-6, rtol=1e-5)
    grads = gn.group_norm_act_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  act)
    again = gn.group_norm_act_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  act)
    if act == 'relu':   # the kernel's branches: z near 0 may flip
        dy, act = dy * (y > 0), 'none'
    want = gn.group_norm_act_bwd_plain(
        *(t.double() for t in (x, dy, scale, bias, mean, rstd)), groups, act)
    for got, ref, rerun in zip(grads, want, again):
        assert torch.equal(got, rerun)
        torch.testing.assert_close(got.double(), ref, rtol=1e-3,
                                   atol=1e-4 * ref.abs().max().item())


def test_groupnorm_kernels_reject_what_they_do_not_take(device):
    x, scale, bias, _ = _gn_inputs(device, (2, 64, 5, 7))
    with pytest.raises(ValueError, match='contiguous'):
        gn.group_norm_act_fwd(x.transpose(2, 3), scale, bias, 8, 1e-6,
                              'silu')
    with pytest.raises(TypeError, match='float32'):
        gn.group_norm_act_fwd(x.double(), scale.double(), bias.double(), 8,
                              1e-6, 'silu')
    with pytest.raises(ValueError, match='groups'):
        gn.group_norm_act_fwd(x, scale, bias, 7, 1e-6, 'silu')
    with pytest.raises(ValueError, match='on cpu'):
        gn.group_norm_act_fwd(x, scale.cpu(), bias, 8, 1e-6, 'silu')
    with pytest.raises(ValueError, match='together'):
        gn.group_norm_silu(x, scale, bias, 8, ext_scale=scale[None])


#: K7/K8 cases by the plan's route (one plan for both): one block; a
#: cluster that holds the slab (the (4, 384, 128, 251) class, and (4, 128,
#: 256, 501) at 16 blocks); slabs past a cluster's shared memory (the (4,
#: 256, 256, 501) class); odd N (4-byte copies) in one block, a cluster and
#: past it; the last element of each case: x and dy one float past a
#: 16-byte boundary
GN_ROUTE_CASES = [
    ((2, 256, 16, 32), 32, 'silu', 'block', False),
    ((4, 384, 128, 251), 32, 'silu', 'cluster', False),
    ((4, 128, 256, 501), 32, 'none', 'cluster', False),
    ((4, 256, 256, 501), 32, 'silu', 'partial', False),
    ((3, 96, 1001), 24, 'relu', 'block', False),
    ((2, 32, 101, 103), 4, 'silu', 'cluster', False),
    ((2, 64, 255, 257), 2, 'silu', 'partial', False),
    ((4, 384, 128, 251), 32, 'silu', 'cluster', True),
    ((2, 256, 16, 32), 32, 'none', 'block', True)]
#: the GroupNorm shapes of one sgmsep U-Net evaluation at 4 x 4 s (G = 32)
UNET_GN_SHAPES = [
    (4, 128, 64, 126), (4, 128, 128, 251), (4, 128, 256, 501), (4, 256, 4, 8),
    (4, 256, 8, 16), (4, 256, 16, 32), (4, 256, 32, 63), (4, 256, 64, 126),
    (4, 256, 128, 251), (4, 256, 256, 501), (4, 384, 64, 126),
    (4, 384, 128, 251), (4, 512, 4, 8), (4, 512, 8, 16), (4, 512, 16, 32),
    (4, 512, 32, 63), (4, 512, 64, 126)]


def _offset(t):
    """``t`` one float into a larger buffer: contiguous, not 16-byte
    aligned."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.parametrize('shape,groups,act,route,unaligned', GN_ROUTE_CASES,
                         ids=lambda v: str(v))
def test_groupnorm_kernels_match_on_every_route(device, shape, groups, act,
                                                route, unaligned):
    """K7 against its plain version and K8 against the plain backward in
    float64 (the bounds of ``test_groupnorm_kernels_match_plain``) on each
    route of the cluster plan; two runs of each bitwise equal."""
    x, scale, bias, dy = _gn_inputs(device, shape, seed=len(shape))
    if unaligned:
        x, dy = _offset(x), _offset(dy)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    n = x.numel() // (shape[0] * shape[1])
    assert gn.plan_info(shape[0], shape[1], n, groups)['route'] == route
    out = gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6, act)
    again = gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6, act)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    del again
    y, mean, rstd = out
    ref, ref_mean, ref_rstd = gn.group_norm_act_reference(
        x, scale, bias, groups, 1e-6, act)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(mean, ref_mean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-6, rtol=1e-5)
    del ref
    grads = gn.group_norm_act_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  act)
    again = gn.group_norm_act_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  act)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    if act == 'relu':   # the kernel's branches: z near 0 may flip
        dy, act = dy * (y > 0), 'none'
    del y
    want = gn.group_norm_act_bwd_plain(
        *(t.double() for t in (x, dy, scale, bias, mean, rstd)), groups, act)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.double(), ref, rtol=1e-3,
                                   atol=1e-4 * ref.abs().max().item())


def test_groupnorm_plan_is_the_wrappers(device):
    """The library's K7/K8 plan at the U-Net's shapes is the wrapper's
    mirror, and the card places the plan's cluster of both kernels."""
    for shape in UNET_GN_SHAPES:
        n = shape[2] * shape[3]
        plan = gn.plan_info(shape[0], shape[1], n, 32)
        want = gn.gn_plan(shape[0], shape[1], n, 32)
        assert {k: v for k, v in plan.items() if k != 'clusters'} == want, \
            shape
        assert plan['clusters'] >= 1, (shape, plan)


#: Run in a fresh interpreter: the device kernels of three K7 calls and of
#: three K8 calls at each route, one ``torch.profiler`` trace each.
_TRACE_GN = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import groupnorm as gn

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(0)
cases = []
for shape, groups in (((4, 256, 16, 32), 32), ((4, 384, 128, 251), 32),
                      ((4, 256, 256, 501), 32), ((3, 96, 1001), 24)):
    x, dy = (torch.randn(*shape, generator=gen, device=dev)
             for _ in range(2))
    scale = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    bias = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    with torch.no_grad():
        _, mean, rstd = gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6,
                                              'silu')
    cases.append((x, dy, scale, bias, mean, rstd, groups))


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def k7():
    for x, dy, scale, bias, mean, rstd, groups in cases:
        for _ in range(3):
            gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6, 'silu')


def k8():
    for x, dy, scale, bias, mean, rstd, groups in cases:
        for _ in range(3):
            gn.group_norm_act_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  'silu')


with torch.no_grad():
    out = {'k7': names(k7), 'k8': names(k8)}
print(json.dumps(out))
"""


def test_groupnorm_launches_one_and_two_kernels(device):
    """Twelve K7 calls (three at each route: one block, a cluster that
    holds the slab, past it, odd N) launch twelve ``gn_fwd_cluster``
    kernels and nothing else; twelve K8 calls twelve ``gn_bwd_cluster`` and
    twelve ``gn_bwd_channels``: no library kernel (traced in a fresh
    interpreter)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    run = subprocess.run([sys.executable, '-c', _TRACE_GN], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    names = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(names['k7']) == 12 and all(
        'gn_fwd_cluster' in n for n in names['k7']), names['k7']
    assert len(names['k8']) == 24, names['k8']
    assert sum('gn_bwd_cluster' in n for n in names['k8']) == 12
    assert sum('gn_bwd_channels' in n for n in names['k8']) == 12


def test_sgmse_runs_every_groupnorm_through_the_kernels(device):
    """A small sgmsepm's loss and gradients on the card: every GroupNorm
    launches K7 (again in the recompute of a rematerialised block) and
    K8 once; the gradients agree with the plain path in float64."""
    kwargs = dict(net_base_channels=32, net_channel_mult=[1, 2],
                  net_num_blocks_per_res=1, stft_frame_length=128,
                  stft_hop_length=64, net_attn_resolutions=[32])
    model = ModelRegistry.get('sgmsepm')(**kwargs, device='cpu')
    model.init_parameters(0)
    ref = ModelRegistry.get('sgmsepm')(**kwargs, device='cpu').double()
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(device).train(), ref.to(device).train()
    rng = np.random.RandomState(1)
    batch = torch.from_numpy(0.3 * rng.randn(2, 2, 2, 4000)).to(device)
    lengths = torch.tensor([4000, 2500], device=device)
    t = torch.tensor([0.3, 0.8], device=device).reshape(2, 1, 1, 1)
    spec = model.transform(batch.float())
    noise = torch.complex(*(torch.from_numpy(rng.randn(
        2, 1, *spec.shape[2:]).astype(np.float32)) for _ in range(2))) \
        .to(device)
    fwd, bwd = gn.group_norm_act_fwd, gn.group_norm_act_bwd
    fwd.launches = fwd.recompute_launches = bwd.launches = 0
    loss = model.loss_at(batch.float(), lengths, t, noise).mean()
    got = torch.autograd.grad(loss, list(model.parameters()))
    n_norms = sum(type(m).__name__ == 'GroupNorm' for m in model.modules())
    assert bwd.launches == n_norms
    assert fwd.launches - fwd.recompute_launches == n_norms
    assert 0 < fwd.recompute_launches < n_norms
    from brever_tpu_torch.models.sgmse import net
    try:
        net.group_norm_silu = gn.group_norm_silu_plain
        want = torch.autograd.grad(
            ref.loss_at(batch, lengths, t.double(),
                        noise.to(torch.complex128)).mean(),
            list(ref.parameters()))
    finally:
        net.group_norm_silu = gn.group_norm_silu
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=1e-3,
                                   atol=1e-4 * top)


def test_idmse_runs_its_groupnorms_through_the_kernels(device):
    """A small idmse's loss and gradients on the card: every GroupNorm
    without the external affine launches K7 (again in a recompute) and K8
    once, the adm blocks' norm_2 none; the gradients agree with the plain
    path in float64."""
    kwargs = dict(net_base_channels=32, net_channel_mult=[1, 2, 2],
                  stft_frame_length=128, stft_hop_length=64,
                  net_attn_resolutions=[32])
    model = ModelRegistry.get('idmse')(**kwargs, device='cpu')
    model.init_parameters(0)
    ref = ModelRegistry.get('idmse')(**kwargs, device='cpu').double()
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(device).train(), ref.to(device).train()
    rng = np.random.RandomState(2)
    batch = torch.from_numpy(0.3 * rng.randn(2, 2, 2, 4000)).to(device)
    lengths = torch.tensor([4000, 2500], device=device)
    t = torch.tensor([0.3, 0.8], device=device).reshape(2, 1, 1, 1)
    spec = model.transform(batch.float())
    noise = torch.complex(*(torch.from_numpy(rng.randn(
        2, 1, *spec.shape[2:]).astype(np.float32)) for _ in range(2))) \
        .to(device)
    fwd, bwd = gn.group_norm_act_fwd, gn.group_norm_act_bwd
    fwd.launches = fwd.recompute_launches = bwd.launches = 0
    loss = model.loss_at(batch.float(), lengths, t, noise).mean()
    got = torch.autograd.grad(loss, list(model.parameters()))
    n_norms = sum(type(m).__name__ == 'GroupNorm' for m in model.modules()) \
        - sum(type(m).__name__ == 'UNetBlock' for m in model.modules())
    assert bwd.launches == n_norms
    assert fwd.launches - fwd.recompute_launches == n_norms
    from brever_tpu_torch.models.sgmse import net
    try:
        net.group_norm_silu = gn.group_norm_silu_plain
        want = torch.autograd.grad(
            ref.loss_at(batch, lengths, t.double(),
                        noise.to(torch.complex128)).mean(),
            list(ref.parameters()))
    finally:
        net.group_norm_silu = gn.group_norm_silu
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=1e-3,
                                   atol=1e-4 * top)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['bench', 'wide'])
def test_fma_chain_matches_plain(device, dtype, kind):
    """K10 against the plain chain, on the benchmark's input and a wider
    one: float32 within 1e-5, bfloat16 within 2**-6 of the largest value
    (the kernel rounds once a step, the plain chain twice), and within
    ``fma_chain_limit`` at every element."""
    from brever_tpu_torch.bench_alu_dtype import probe_input
    from brever_tpu_torch.ops import fma_chain as fc
    for shape in ((2, 16, 128), (8, 1024, 512)):
        x = probe_input(dtype, device, shape, kind)
        before = fc.fma_chain.launches
        got = fc.fma_chain(x)
        assert fc.fma_chain.launches == before + 1
        want = fc.fma_chain_reference(x)
        assert got.dtype == dtype and got.shape == x.shape
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
        top = want.double().abs().max().item()
        err = (got.double() - want.double()).abs()
        assert err.max().item() <= rel * top
        assert (err <= fc.fma_chain_limit(x)[0]).all()
    if kind == 'bench' and dtype == torch.bfloat16:
        assert bool((got == 1).all())
    with pytest.raises(ValueError, match='multiple of'):
        fc.fma_chain(x.reshape(-1)[:6])


def _step_cases():
    from brever_tpu_torch.bench_alu_dtype import STEP_CASES
    return [(kind, k, passes, dtype) for kind, k, passes, dtypes
            in STEP_CASES for dtype in dtypes]


@pytest.mark.parametrize('kind,k,passes,dtype', _step_cases())
def test_fma_chain_honours_k_and_passes(device, kind, k, passes, dtype):
    """K10 at k and passes off the benchmark's, on inputs whose chains have
    not converged: within ``fma_chain_limit`` at every element, where a
    chain one step short is not."""
    from brever_tpu_torch.bench_alu_dtype import probe_input
    from brever_tpu_torch.ops import fma_chain as fc
    x = probe_input(dtype, device, (2, 16, 128), kind)
    got = fc.fma_chain(x, k, passes)
    want = fc.fma_chain_reference(x, k, passes)
    short = fc.fma_chain_reference(x, 2, passes * (k // 2) - 1)
    limit, margin = fc.fma_chain_limit(x, k, passes)
    assert margin.max() > 0
    assert ((short.double() - want.double()).abs() > limit).any()
    assert ((got.double() - want.double()).abs() <= limit).all()


# (B, C, T) of MANNER's BatchNorms, cut in length, and the route the plan
# gives K7-BN and K8-BN: one block (its full-resolution level, a wide one
# at an odd length, the local attention's C = 1 gate over 160 chunks, one
# row, N = 249 and 1000 as at 16 x 4 s, and 600 channels of 8 x 64: more
# channels than blocks, with and without the two-buffer ring); a 2-, 4- and
# 8-block cluster (4004 and 16020 at 16 rows, and odd N: 4-byte loads); a
# channel past a 16-block cluster (64084 at 16 rows, and off the float4
# grid); the last element: x and dy one float past a 16-byte boundary
# (4-byte loads, x copied ahead with cp.async). K8-BN takes the passes
# wherever N is off the float4 grid.
BN_CASES = [((4, 60, 4004), 'relu', 'block', False),
            ((3, 1920, 63), 'none', 'block', False),
            ((160, 1, 64), 'none', 'block', False),
            ((1, 120, 1000), 'silu', 'block', False),
            ((5, 7, 9), 'silu', 'block', False),
            ((16, 96, 249), 'relu', 'block', False),
            ((16, 480, 1000), 'silu', 'block', False),
            ((8, 600, 64), 'relu', 'block', False),
            ((16, 8, 4004), 'silu', 'cluster', False),
            ((32, 2, 4001), 'none', 'cluster', False),
            ((16, 12, 16020), 'relu', 'cluster', False),
            ((16, 3, 64084), 'relu', 'past', False),
            ((16, 2, 64085), 'silu', 'past', False),
            ((16, 12, 16020), 'silu', 'cluster', True),
            ((1, 120, 1000), 'relu', 'block', True)]
#: MANNER's 34 (shape, act) BatchNorm classes at 16 x 4 s
MANNER_BN_SHAPES = [
    (16, 60, 64084), (16, 60, 16020), (16, 120, 16020), (16, 240, 16020),
    (16, 120, 4004), (16, 240, 4004), (16, 480, 4004), (16, 160, 1000),
    (16, 240, 1000), (16, 480, 1000), (16, 960, 1000), (16, 320, 249),
    (16, 480, 249), (16, 960, 249), (16, 1920, 249), (160, 1, 64),
    (160, 320, 64), (544, 1, 64), (544, 160, 64)]


@pytest.mark.parametrize('shape,act,route,unaligned', BN_CASES,
                         ids=lambda v: str(v))
def test_batchnorm_kernels_match_plain(device, shape, act, route, unaligned):
    """K7-BN against its plain version and K8-BN against the plain
    backward in float64 on each route of the plan; two runs of each
    bitwise equal."""
    x, scale, bias, dy = _gn_inputs(device, shape, seed=shape[1])
    if unaligned:
        x, dy = _offset(x), _offset(dy)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    plan = bn.plan_info(shape[0], shape[1], shape[2])
    if route == 'past':
        assert (plan['route_fwd'], plan['route_bwd']) == (bn._FWD_PAST,
                                                          bn._BWD_PAST)
    else:   # K8-BN off the float4 grid: the passes
        assert plan['route_fwd'] == route
        assert plan['route_bwd'] == ('passes' if shape[2] % 4 else route)
    before = bn.batch_norm_act_fwd.launches, bn.batch_norm_act_bwd.launches
    out = bn.batch_norm_act_fwd(x, scale, bias, 1e-5, act)
    rerun = bn.batch_norm_act_fwd(x, scale, bias, 1e-5, act)
    assert all(torch.equal(a, b) for a, b in zip(out, rerun))
    del rerun
    y, mean, var, rstd = out
    ref = bn.batch_norm_act_reference(x, scale, bias, 1e-5, act)
    torch.testing.assert_close(y, ref[0], atol=1e-5, rtol=1e-4)
    for got, want in zip((mean, var, rstd), ref[1:]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    del ref, y
    grads = bn.batch_norm_act_bwd(x, dy, scale, bias, mean, rstd, act)
    again = bn.batch_norm_act_bwd(x, dy, scale, bias, mean, rstd, act)
    assert (bn.batch_norm_act_fwd.launches - before[0],
            bn.batch_norm_act_bwd.launches - before[1]) == (2, 2)
    f64 = [t.double() for t in (x, dy, scale, bias)]
    _, m64, _, r64 = bn.batch_norm_act_reference(f64[0], f64[2], f64[3],
                                                 1e-5, act)
    want = bn.batch_norm_act_bwd_plain(*f64, m64, r64, act)
    torch.cuda.synchronize()
    for got, rerun, w in zip(grads, again, want):
        assert torch.equal(got, rerun)
        torch.testing.assert_close(got.double(), w,
                                   atol=1e-4 * w.abs().max().item(),
                                   rtol=1e-3)


def test_batchnorm_plan_is_the_wrappers(device):
    """The library's K7-BN/K8-BN plan at MANNER's classes is the wrapper's
    mirror (``plan_info`` raises where they differ), and the card places
    the plan's cluster of both kernels."""
    for shape in MANNER_BN_SHAPES:
        plan = bn.plan_info(*shape)
        want = bn.bn_plan(*shape)
        assert {k: v for k, v in plan.items() if k != 'clusters'} == want, \
            shape
        assert plan['clusters'] >= 1, (shape, plan)


def test_batchnorm_launches_a_call(device):
    """Three K7-BN and three K8-BN calls at each route (one block, N =
    249, an 8-block cluster, past a 16-block cluster) launch the plan's
    kernels three times each and nothing else: one launch a call on the
    block and cluster routes, at most two on the routes past a cluster, no
    library kernel (``bench_batchnorm.launches_a_call``: traced in a fresh
    interpreter)."""
    from brever_tpu_torch.bench_batchnorm import KERNELS, launches_a_call
    launched = launches_a_call()
    assert launched['fwd'] == {'block': 1, 'cluster': 1,
                               bn._FWD_PAST: len(KERNELS['fwd'][
                                   bn._FWD_PAST])}
    assert launched['bwd'] == {'block': 1, 'cluster': 1,
                               bn._BWD_PAST: len(KERNELS['bwd'][
                                   bn._BWD_PAST])}
    assert max(launched['fwd'].values()) <= 2
    assert max(launched['bwd'].values()) <= 2


def test_batchnorm_kernels_reject_what_they_do_not_take(device):
    x, scale, bias, _ = _gn_inputs(device, (2, 8, 16))
    before = bn.batch_norm_act_fwd.launches
    with pytest.raises(TypeError, match='float32'):
        bn.batch_norm_act_fwd(x.double(), scale, bias, 1e-5, 'relu')
    with pytest.raises(ValueError, match='contiguous'):
        bn.batch_norm_act_fwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                              scale, bias, 1e-5, 'relu')
    with pytest.raises(ValueError, match='on cpu'):
        bn.batch_norm_act_fwd(x, scale.cpu(), bias, 1e-5, 'relu')
    assert bn.batch_norm_act_fwd.launches == before


#: K9's cases (n_fft, hop): the FFT route at every power of two from 16 to
#: 4096, and the dense route at 400/100
STFT_CASES = [(16, 4), (32, 8), (64, 16), (128, 32), (256, 128), (512, 128),
              (1024, 256), (2048, 512), (4096, 1024), (400, 100)]


@pytest.mark.parametrize('n_fft,hop', STFT_CASES)
def test_stft_kernel_matches_plain(device, n_fft, hop):
    """K9 on the route ``fft_route`` picks against its plain version: at
    least 60 dB and within 1e-4 of the spectrum's largest value (float32
    sums of n_fft products on the dense route, an FFT's rounding on the
    other); the module's forward against the cuFFT route."""
    rng = np.random.RandomState(n_fft)
    x = torch.from_numpy(rng.randn(5, 9001).astype(np.float32)).to(device)
    stft = STFT(frame_length=n_fft, hop_length=hop, backend='pallas')
    basis = torch.from_numpy(stft_kernel.stft_basis(
        n_fft, stft._np_window)).to(device)
    fft = stft_kernel.fft_route(n_fft) == 'fft'
    before = (stft_kernel.stft_fused.launches,
              stft_kernel.stft_fused.dense_launches)
    got = stft_kernel.stft_fused(x, basis, hop)
    want = stft_kernel.stft_basis_plain(x, basis, hop)
    assert (stft_kernel.stft_fused.launches - before[0],
            stft_kernel.stft_fused.dense_launches - before[1]) == \
        ((1, 0) if fft else (0, 1))
    err = (got - want).double()
    snr = 10 * torch.log10(want.double().pow(2).sum() / err.pow(2).sum())
    assert snr.item() >= 60
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())
    with torch.no_grad():
        spec = stft(x)
    ref = STFT(frame_length=n_fft, hop_length=hop)(x)
    torch.testing.assert_close(spec, ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    with pytest.raises(NotImplementedError, match='no backward'):
        stft(x.clone().requires_grad_())


#: Run in a fresh interpreter: the device kernels that three calls of K9
#: (both routes) and of K2 launch, from one ``torch.profiler`` trace each.
#: (A trace taken after others in one process lost device events on the
#: card.)
_TRACE_KERNELS = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import lstm_scan as lstm, stft_kernel
from brever_tpu_torch.ops import tcn_block as tcn
from brever_tpu_torch.ops.stft import STFT

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(0)


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


out = {}
x = torch.randn(4, 9001, generator=gen, device=dev)
for n_fft, hop in ((512, 128), (400, 100)):
    stft = STFT(frame_length=n_fft, hop_length=hop)
    basis = torch.from_numpy(stft_kernel.stft_basis(
        n_fft, stft._np_window)).to(dev)
    out[n_fft] = names(lambda: stft_kernel.stft_fused(x, basis, hop))


def arr(*shape, scale=0.1):
    return scale * torch.randn(*shape, generator=gen, device=dev)


c, h, cs = 128, 512, 128
xb = arr(2, 520, c, scale=1.0)
params = (arr(h, c), arr(h), arr(1) + 0.25, arr(h) + 1, arr(h), arr(3, h),
          arr(h), arr(1) + 0.25, arr(h) + 1, arr(h), arr(c, h), arr(c),
          arr(cs, h), arr(cs))
g_res, g_skip = arr(2, 520, c, scale=1.0), arr(2, 520, cs, scale=1.0)
with torch.no_grad():
    _, _, stats = tcn.tcn_block_fwd(xb, params, 2, False)
out['k2'] = names(lambda: tcn.tcn_block_bwd(xb, params, stats, g_res,
                                            g_skip, 2, False))
with torch.no_grad():
    out['k1'] = names(lambda: tcn.tcn_block(xb, params, 2, False))
    x3 = arr(6, 2, 300, 128, scale=1.0)
    w_ih, w_hh = arr(2, 128, 512), arr(2, 128, 512)
    b3 = arr(2, 512)
    out['k3'] = names(lambda: lstm.lstm_scan_x_fwd(x3, w_ih, b3, w_hh))
print(json.dumps(out))
"""


def test_stft_and_tcn_backward_launch_no_library_kernel(device):
    """A K9 call on either route, a K2 call, a K1 call and a K3 call launch
    their own kernels and no cuFFT, cuBLAS or cuDNN kernel, traced in a
    fresh interpreter: three K2 calls are 33 launches of K2's kernels,
    three K1 calls 15 of K1's (neither copies a transposed weight: both
    stage W_in's rows through registers), three K3 calls 3 of the ring
    scan, nothing else (the trace's tensors are 16-byte aligned, so the
    wrappers copy no other)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    run = subprocess.run([sys.executable, '-c', _TRACE_KERNELS], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    names = json.loads(run.stdout.strip().splitlines()[-1])
    for n_fft, kernel in (('512', 'stft_fft_kernel'),
                          ('400', 'stft_basis_kernel')):
        assert names[n_fft] and all(kernel in n for n in names[n_fft]), \
            names[n_fft]
    assert len(names['k2']) == 3 * 11 and all(
        'tcn_bwd_' in n for n in names['k2']), names['k2']
    k1 = ('tcn_in_gemm', 'row_stats', 'dw_prelu_stats', 'tcn_out_gemm')
    assert len(names['k1']) == 3 * 5 and all(
        any(k in n for k in k1) for n in names['k1']), names['k1']
    for kernel, count in zip(k1, (3, 6, 3, 3)):
        assert sum(kernel in n for n in names['k1']) == count, names['k1']
    assert len(names['k3']) == 3 and all(
        'lstm_fwd_ring' in n for n in names['k3']), names['k3']


def test_manner_runs_every_batch_norm_through_the_kernels(device,
                                                          monkeypatch):
    """A narrow MANNER on the card: a train-mode loss launches K7-BN once a
    BatchNorm and K8-BN once a BatchNorm in its backward, and its gradients
    and running statistics agree with the plain path in float64; enhance
    (eval mode) launches neither and matches the CPU."""
    from brever_tpu_torch.models import common, manner
    monkeypatch.setattr(manner, '_MannerModule', functools.partial(
        manner._MannerModule, hidden=12, depth=2, segment_len=8))
    cpu = manner.MANNER(device='cpu')
    cpu.init_parameters(0)
    gpu = manner.MANNER(device=device)
    gpu.load_state_dict(cpu.state_dict())
    n_bn = manner.count_batch_norms(gpu)
    x = (0.3 * np.random.RandomState(6).randn(2, 2, 6000)).astype(np.float32)
    before = bn.batch_norm_act_fwd.launches
    out = gpu.enhance(x).cpu()
    assert bn.batch_norm_act_fwd.launches == before
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)
    batch = torch.from_numpy(np.stack([x, x], axis=1)).to(device)
    lengths = torch.tensor([6000, 5000], device=device)
    gpu.train()
    before = bn.batch_norm_act_fwd.launches, bn.batch_norm_act_bwd.launches
    got = torch.autograd.grad(gpu.loss(batch, lengths).mean(),
                              list(gpu.parameters()))
    torch.cuda.synchronize()
    assert (bn.batch_norm_act_fwd.launches - before[0],
            bn.batch_norm_act_bwd.launches - before[1]) == (n_bn, n_bn)
    ref = manner.MANNER(device='cpu').double()
    ref.load_state_dict(cpu.state_dict())
    ref = ref.to(device).train()
    monkeypatch.setattr(common, 'batch_norm_act', bn.batch_norm_act_plain)
    want = torch.autograd.grad(ref.loss(batch.double(), lengths).mean(),
                               list(ref.parameters()))
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=2e-3,
                                   atol=2e-3 * top)
    for a, b in zip(gpu.buffers(), ref.buffers()):
        torch.testing.assert_close(a.double(), b, atol=1e-5, rtol=1e-4)


def test_ffnn_enhances_pre_trains_and_trains_on_the_card(device, tmp_path):
    """The default-width FFNN (features, stats, MLP) on the card against the
    CPU path: enhance at atol 1e-4, rtol 1e-3; ``pre_train``'s statistics at
    rtol 1e-5; the eval-mode loss at rtol 1e-5 and its gradients at rtol
    1e-3 with a floor of 1e-4 of the tensor's largest value; a trainer step
    on the card (dropout drawn from the trainer's generator on the card)
    gives a finite loss and moves the parameters."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    from brever_tpu_torch.profile_train import _Items
    from brever_tpu_torch.training import BreverTrainer
    cpu = ModelRegistry.get('ffnn')(device='cpu')
    gpu = ModelRegistry.get('ffnn')(device=device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(14)
    target = 0.3 * rng.randn(3, 1, 2, 16000)
    batch = np.concatenate([target + 0.3 * rng.randn(*target.shape), target],
                           axis=1).astype(np.float32)
    lengths = np.array([16000, 11000, 0], np.int64)
    batches = [(batch, lengths)]
    for model in (cpu, gpu):
        model.pre_train(None, batches, 1)
    torch.testing.assert_close(gpu.std.cpu(), cpu.std, rtol=1e-5, atol=0)
    torch.testing.assert_close(gpu.mean.cpu(), cpu.mean, rtol=1e-5,
                               atol=1e-6)
    gpu.load_state_dict(cpu.state_dict())
    torch.testing.assert_close(gpu.enhance(batch[:, 0]).cpu(),
                               cpu.enhance(batch[:, 0]), atol=1e-4, rtol=1e-3)
    losses = []
    for model, dev in ((cpu, 'cpu'), (gpu, device)):
        model.eval()
        n = torch.from_numpy(lengths).to(dev)
        loss = sample_weighted_mean(
            model.loss(torch.from_numpy(batch).to(dev), n), n)
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        scale = p.grad.abs().max().item()
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-3,
                                   atol=1e-4 * scale, msg=name)
    items = _Items(2, 0.15)
    trainer = BreverTrainer(ModelRegistry.get('ffnn')(device='cpu'), items,
                            items, str(tmp_path), device=device,
                            val_metrics={'estoi', 'pesq'}, seed=0)
    trainer.init_state()
    flat = trainer.flat.clone()
    loss = trainer.train_step(torch.from_numpy(batch).to(device),
                              torch.from_numpy(lengths).to(device))
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and not torch.equal(flat, trainer.flat)


def _speech_like(rng, n, fs=16000):
    """A multi-tone under a 2.5 Hz on/off envelope plus a little noise:
    STOI's silent-frame removal keeps and drops frames."""
    t = np.arange(n) / fs
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    sig = env * (np.sin(2 * np.pi * 220 * t)
                 + 0.5 * np.sin(2 * np.pi * 870 * t)
                 + 0.2 * np.sin(2 * np.pi * 1800 * t))
    return sig + 0.01 * rng.randn(n)


@pytest.mark.parametrize('name,bound', [('stoi', 2e-3), ('estoi', 2e-3),
                                        ('pesq', 5e-3), ('pesq_nb', 5e-3)])
def test_metric_twins_on_the_card_match_float64(device, name, bound):
    """The validation-metric twins on the card in float32 against the same
    twins in float64 on the CPU, on a ragged batch of enhancement-style
    signals (20 to -5 dB): STOI and ESTOI within 2e-3, PESQ within 5e-3
    MOS, the JAX twin's bounds against its host metric; the wideband
    identity score at 4.643888749336258 within 2e-3."""
    from brever_tpu_torch import metrics_device as twins
    rng = np.random.RandomState(15)
    lengths = np.array([24000, 22889, 19904, 4000])
    deg = np.zeros((4, 24000))
    ref = np.zeros((4, 24000))
    for i, (n, snr) in enumerate(zip(lengths, [20, 5, 0, -5])):
        clean = _speech_like(rng, n)
        noise = rng.randn(n) * np.sqrt(np.mean(clean ** 2) / 10 ** (snr / 10))
        ref[i, :n], deg[i, :n] = clean, clean + noise
    fn = (lambda x, y, lengths: twins.pesq_device(x, y, lengths, mode='nb')) \
        if name == 'pesq_nb' else twins.DEVICE_METRICS[name]
    want = fn(torch.from_numpy(deg), torch.from_numpy(ref), lengths)
    got = fn(torch.from_numpy(deg).float().to(device),
             torch.from_numpy(ref).float().to(device), lengths)
    assert got.device.type == 'cuda' and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=bound)
    if name == 'pesq':
        x = torch.from_numpy(ref[:1]).float().to(device)
        np.testing.assert_allclose(twins.pesq_device(x, x).item(),
                                   4.643888749336258, atol=2e-3)


def test_metricgan_enhances_on_the_card(device):
    """MetricGAN+ at its default width (two BLSTMs of 200 units, 224 in
    the kernels) on the card against the same weights on the CPU: enhance
    at atol 1e-4, rtol 1e-3; one K5 launch a BLSTM (B rows, under the
    128-row floor), no K3."""
    cpu = ModelRegistry.get('metricganp')(device='cpu')
    gpu = ModelRegistry.get('metricganp')(device=device)
    gpu.load_state_dict(cpu.state_dict())
    x = np.random.RandomState(16).randn(3, 2, 16000).astype(np.float32) * 0.1
    before = lstm.lstm_scan.launches, lstm.lstm_scan_x.launches
    out = gpu.enhance(x).cpu()
    torch.cuda.synchronize()
    assert (lstm.lstm_scan.launches - before[0],
            lstm.lstm_scan_x.launches - before[1]) == (2, 0)
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)


def test_metricgan_step_on_the_card_matches_float64(device, tmp_path):
    """One GAN update of MetricGAN+ at its default width (4 x 1 s, given
    scores and augmented signal) on the card against the same update in
    float64 on the CPU: both losses within 1e-4 relative, Adam's first
    moments (the clipped gradients) of the generator and the discriminator
    within 1e-3 of their largest value, the BatchNorm statistics and every
    ``u``/``sigma`` within 1e-5; K5 and K6 launch, K3 and K4 do not."""
    from brever_tpu_torch.profile_train import _Items
    from brever_tpu_torch.training import BreverTrainer
    rng = np.random.RandomState(17)
    clean = 0.3 * rng.randn(4, 1, 2, 16000)
    batch = np.concatenate([clean + 0.2 * rng.randn(*clean.shape), clean],
                           1).astype(np.float32)
    scores = {'noisy': rng.rand(4, 1), 'enh': rng.rand(1, 4, 1),
              'aug': rng.rand(4, 1)}
    aug = batch[:, 1].mean(-2) + 0.05 * rng.randn(4, 16000)
    items = _Items(4, 1.0)
    runs = {}
    for name, dev, dtype in (('gpu', device, torch.float32),
                             ('f64', 'cpu', torch.float64)):
        model = ModelRegistry.get('metricganp')(device='cpu').to(dtype)
        trainer = BreverTrainer(model, items, items, str(tmp_path / name),
                                device=dev, val_metrics={'snr'}, seed=0)
        trainer.init_state()
        launches = (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches,
                    lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches)
        loss = trainer.model.update(
            trainer, torch.from_numpy(batch).to(dev, dtype),
            {k: torch.from_numpy(v).to(dev, dtype) for k, v in
             scores.items()}, torch.from_numpy(aug).to(dev, dtype))
        if torch.device(dev).type == 'cuda':
            torch.cuda.synchronize()
            launched = [a - b for a, b in zip(
                (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches,
                 lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches),
                launches)]
            assert launched[0] > 0 and launched[1] > 0, launched
            assert launched[2:] == [0, 0], launched
        runs[name] = (trainer, {k: float(v) for k, v in loss.items()},
                      {k: v.double().cpu()
                       for k, v in trainer.model.state_dict().items()})
    (gpu, loss_gpu, sd_gpu), (f64, loss_ref, sd_ref) = runs['gpu'], \
        runs['f64']
    for key in loss_ref:
        assert abs(loss_gpu[key] - loss_ref[key]) <= 1e-4 * abs(loss_ref[key])
    for name in ('generators', 'discriminator'):
        opts = gpu.optimizer[name], f64.optimizer[name]
        if name == 'generators':
            opts = opts[0][0], opts[1][0]
        got, want = (o.mu.double().cpu() for o in opts)
        assert (got - want).abs().max() <= 1e-3 * want.abs().max(), name
    for key, want in sd_ref.items():
        if '.spectral.' in key or key.endswith(('norm.mean', 'norm.var')):
            torch.testing.assert_close(sd_gpu[key], want, rtol=0, atol=1e-5,
                                       msg=key)
