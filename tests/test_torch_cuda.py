"""The port's CUDA kernels on the card (marker ``cuda``; they skip
without a device). This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance of the forward kernel vs its plain version, both float32 with
TF32 off: atol 1e-4, rtol 1e-3 — the kernel sums the GEMMs in another
order and merges the global-norm moments per tile. The backward kernel
is held against its plain version in float64 (float32 rounding can flip
a PReLU branch at a pre-activation near 0, and the slopes' gradients are
sums that cancel): atol 1e-4 of the tensor's largest value, rtol 1e-3,
at sizes where a flip is unlikely (about 0.5M pre-activations).

The LSTM kernels (K3, K4) against their plain versions: the forward in
float32 at atol 1e-5, rtol 1e-4 (values of order 1; the kernel sums the
gate products in another order), the backward against the plain float32
backward run in float64 at atol 1e-4 of the tensor's largest value, rtol
1e-3; two backward runs are bitwise equal.

The GroupNorm kernels (K7, K8) against their plain versions: the forward
in float32 at atol 1e-5, rtol 1e-4 (normalised values of order 1; the
kernel sums the statistics in double in another order), the backward
against the plain backward run in float64 at atol 1e-4 of the tensor's
largest value, rtol 1e-3; two backward runs are bitwise equal."""

import numpy as np
import pytest
import torch

from brever_tpu_torch.models import ModelRegistry
from brever_tpu_torch.ops import build
from brever_tpu_torch.ops import groupnorm as gn
from brever_tpu_torch.ops import lstm_scan as lstm
from brever_tpu_torch.ops import tcn_block as tcn
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
# a multiple of 4 inside the wrapper) and 12, T = 1, D = 1, H 32..256
LSTM_CASES = [(5, 2, 40, 72, 32), (1, 1, 33, 128, 128), (7, 2, 100, 128, 64),
              (3, 1, 17, 12, 256), (9, 2, 70, 128, 128)]


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
    torch.cuda.synchronize()
    for got, rerun, want in zip(grads, again, ref):
        assert got.shape == want.shape
        assert torch.equal(got, rerun)
        torch.testing.assert_close(got.double(), want,
                                   atol=1e-4 * want.abs().max().item(),
                                   rtol=1e-3)


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
        lstm.lstm_scan_x(x48, w48, b48, h48)
    assert lstm.lstm_scan_x.launches == before


def test_tfgridnet_runs_every_blstm_through_the_kernels(device):
    """A small TF-GridNet (H = 32) on the card: enhance matches the CPU
    plain path with two K3 launches a grid block; a loss gradient takes
    two K4 launches a block."""
    small = dict(n_layers=2, lstm_hidden_units=32, emb_dim=8, attn_n_head=2,
                 attn_approx_qk_dim=32)
    cpu = ModelRegistry.get('tfgridnet')(**small, device='cpu')
    gpu = ModelRegistry.get('tfgridnet')(**small, device=device)
    gpu.load_state_dict(cpu.state_dict())
    x = (0.3 * np.random.RandomState(4).randn(2, 2, 5000)).astype(np.float32)
    before = lstm.lstm_scan_x.launches
    out = gpu.enhance(x).cpu()
    assert lstm.lstm_scan_x.launches - before == 4
    torch.testing.assert_close(out, cpu.enhance(x), atol=1e-4, rtol=1e-3)
    batch = torch.from_numpy(np.stack([x, x], axis=1)).to(device)
    before = lstm.lstm_scan_x_bwd.launches
    gpu.loss(batch, torch.tensor([5000, 4000], device=device)).sum() \
        .backward()
    torch.cuda.synchronize()
    assert lstm.lstm_scan_x_bwd.launches - before == 4
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
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        gn.group_norm_silu(x, scale, bias, 8, ext_scale=scale[None],
                           ext_shift=bias[None])


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
