"""The wrappers' mirrors of the kernels' launch figures, on the CPU: K1's
partial moments a batch row (``ops.tcn_block.fwd_partials``) at the tiles
the sources name, on both routes, K1-bf16's and K2-bf16's bf16 rows and
K2's workspace on the bf16 route (``bf16_ld``, ``bwd_plan``) against the
constants of csrc/tcn_block_bf16.cu and csrc/mma_bf16.cuh, K3's plan (``ops.lstm_scan.fwd_plan``) against the
constants of csrc/lstm_scan.cuh, and K3-bf16's and K4-bf16's plans
(``fwd_plan``/``bwd_plan`` with ``bf16=True``) against those of
csrc/lstm_scan_bf16.cu and csrc/mma_bf16.cuh, within what the card allows a
block. The card tests hold the built library's own figures to the same
mirrors. Also: zero-padding E to the bf16 route's MMA depth leaves the bf16
twins' outputs and gradients bitwise unchanged."""

import os
import re

import numpy as np
import pytest
import torch

from brever_tpu_torch.ops import lstm_scan as L
from brever_tpu_torch.ops import tcn_block as tcn

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'brever_tpu_torch', 'csrc')


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(text, name):
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize('t_total', [1, 31, 32, 127, 128, 129, 3999, 20000])
@pytest.mark.parametrize('hidden', [1, 64, 100, 128, 257, 512])
def test_forward_partials_are_the_sources(t_total, hidden):
    """K1 writes one (count, mean, M2) partial a 128 x 128 tile of its
    input GEMM (simt_gemm.cuh's block tile; on the bf16 route
    mma_bf16.cuh's, the same) and one a 32 x 128 tile of its depthwise
    stage (tcn_common.cuh's, on both routes), each batch row."""
    k1 = _source('tcn_common.cuh')
    tile = _constant(_source('simt_gemm.cuh'), 'kGM')
    rows, cols = _constant(k1, 'kDwRows'), _constant(k1, 'kDwCols')
    assert (tile, rows, cols) == (128, 32, 128)
    assert _constant(_source('mma_bf16.cuh'), 'kTcTile') == tile
    assert tcn.fwd_partials(t_total, hidden) == (
        _cdiv(t_total, tile) * _cdiv(hidden, tile),
        _cdiv(t_total, rows) * _cdiv(hidden, cols))


def test_forward_partials_at_the_convtasnet_shape():
    """T = 3999, H = 512: 32 x 4 GEMM tiles and 125 x 4 depthwise tiles."""
    assert tcn.fwd_partials(3999, 512) == (128, 500)


def test_bf16_tcn_constants_are_the_sources():
    """K1-bf16's and K2-bf16's products run on mma_bf16.cuh's 128 x 128
    block tile, 32-deep k slices (two k16 mma steps) and its padded rows,
    the float32 GEMMs' tile, so K2's plan (its tiles and chunks) is one for
    both routes; their bf16 h2, gz1 and folded weights take rows of H
    rounded up to kLdBf16 elements: whole 16-byte cp.async pieces."""
    mma, src = _source('mma_bf16.cuh'), _source('tcn_block_bf16.cu')
    assert (_constant(mma, 'kTcTile'), _constant(mma, 'kTcSlice'),
            _constant(mma, 'kTcThreads')) == (128, 32, 256)
    assert _constant(mma, 'kTcTile') == tcn._GEMM_TILE
    assert _constant(src, 'kLdBf16') == tcn._LD_BF16 == 8


@pytest.mark.parametrize('hidden', [1, 2, 3, 7, 8, 36, 100, 102, 128, 257,
                                    512])
def test_bf16_tcn_plans_are_the_sources(hidden):
    """At every H: the bf16 row is H rounded up to 8 (at least H, less than
    H + 8, whole 16-byte pieces); K2's workspace on the bf16 route, at the
    Conv-TasNet shape, ragged lengths and ragged widths, holds z1, z2, gy2
    and gy1 (float32) and, in gy2's and gy1's rooms, the (B, T, ld) bf16
    gz1 and h2 (two bf16 a float), each room rounded up to 32 floats."""
    ld = tcn.bf16_ld(hidden)
    assert ld % 8 == 0 and hidden <= ld < hidden + 8 and 2 * ld % 16 == 0
    for batch, t_total, c_in, c_skip, last in (
            (16, 3999, 128, 128, False), (16, 3999, 128, 128, True),
            (2, 300, 36, 20, False), (2, 77, 130, 21, True),
            (1, 1, 1, 1, True), (3, 129, 32, 32, False)):
        plan = tcn.bwd_plan(batch, t_total, c_in, hidden, c_skip, last)
        bth = batch * t_total * hidden
        room = max(bth, _cdiv(batch * t_total * ld, 2))
        assert plan['workspace'] >= 2 * bth + 2 * room
        assert plan['workspace'] % 32 == 0
        assert (plan['gemm_tiles'] - 1) * 128 < t_total \
            <= plan['gemm_tiles'] * 128


def test_bf16_tcn_buffers_at_the_convtasnet_shape():
    """B=16, T=3999, C=Cs=128, H=512: bf16 rows of 512 (no pad); K1-bf16's
    bf16 h2 is 65.5 MB and its folded output weights (B, C + Cs, H) 4 MB;
    K2's workspace is the float32 route's (152,018,752 floats), its bf16 h2
    and gz1 each filling half of a float32 room."""
    assert tcn.bf16_ld(512) == 512
    rows = 16 * 3999
    assert 2 * rows * tcn.bf16_ld(512) == 65_519_616
    assert 2 * 16 * (128 + 128) * tcn.bf16_ld(512) == 4_194_304
    assert tcn.bwd_plan(16, 3999, 128, 512, 128, False)['workspace'] == \
        152_018_752


@pytest.mark.parametrize('hidden', range(32, 257, 32))
def test_k3_plan_is_the_sources(hidden):
    """K3's plan at every H it takes, on TF-GridNet's row counts, a ragged
    one and one row: 64-row tiles only where they still give every SM a
    block, ``kFwdUnits`` units x 4 rows a thread, whole warps of 4 row
    groups x 8 unit groups, at most 512 threads and 232,448 bytes a block,
    room for h[t-1] of the tile and ``kFwdRing`` stages of a weight slice,
    tiles covering R, and a slice's weights whole float4s a thread."""
    src = _source('lstm_scan.cuh')
    ring, units = _constant(src, 'kFwdRing'), _constant(src, 'kFwdUnits')
    sms = _constant(src, 'kSMs')
    assert (ring, units, sms) == (4, 4, 132)
    for steps, n_dir, rows in ((33, 2, 8064), (126, 2, 2112), (9, 1, 70),
                               (1, 1, 1), (2, 2, 4300)):
        for feat in (4, 128, 1624):
            plan = L.fwd_plan(steps, n_dir, rows, feat, hidden)
            tile, k = plan['rows'], plan['slice']
            assert tile == 32 or (tile == 64 and hidden <= 128
                                  and n_dir * _cdiv(rows, 64) >= sms)
            assert k in (8, 16) and hidden % k == 0
            assert plan['threads'] == tile // 4 * hidden // units
            assert plan['threads'] % 64 == 0 and plan['threads'] <= 512
            held = 4 * (hidden * tile + ring * k * (tile + 4 * hidden))
            assert held <= plan['smem'] <= L._MAX_SMEM
            assert plan['smem'] % 16 == 0
            assert (plan['tiles'] - 1) * tile < rows <= plan['tiles'] * tile
            # a thread's share of a slice of the weights is whole float4s
            assert k * 4 * hidden % (4 * plan['threads']) == 0


def test_k3_plan_at_tfgridnet_shapes():
    """At 16 x 4 s the intra BLSTM takes 64-row tiles (252 blocks of 512
    threads, 183,296 bytes of shared memory, one block an SM) and the
    inter BLSTM 32-row tiles (132 blocks of 256 threads, 158,720 bytes);
    both stream 16-row slices of the weights."""
    intra, inter = (L.fwd_plan(33, 2, 8064, 128, 128),
                    L.fwd_plan(126, 2, 2112, 128, 128))
    assert (intra['rows'], intra['slice'], intra['threads'],
            2 * intra['tiles'], intra['smem']) == (64, 16, 512, 252, 183296)
    assert (inter['rows'], inter['slice'], inter['threads'],
            2 * inter['tiles'], inter['smem']) == (32, 16, 256, 132, 158720)


@pytest.mark.parametrize('hidden', range(32, 257, 32))
def test_every_fused_shape_has_a_k3_plan(hidden):
    """The route's rule (``fused_x_fits``, unchanged) admits only (E, H)
    whose K3 plan fits a block; K3's plan does not depend on E."""
    fits = [feat for feat in range(4, 2000, 4) if L.fused_x_fits(feat, hidden)]
    assert fits and fits == list(range(4, fits[-1] + 1, 4))
    assert 4 * 32 * (fits[-1] + 6 * hidden) <= L._MAX_SMEM \
        < 4 * 32 * (fits[-1] + 4 + 6 * hidden)
    plans = {str(L.fwd_plan(33, 2, 8064, feat, hidden)) for feat in fits}
    assert len(plans) == 1


def _bf16_constants():
    src = _source('lstm_scan_bf16.cu')
    names = ('kResidentMax', 'kFwdStagesBf16', 'kSliceBf16', 'kRscanRingBf16',
             'kRscanChunkBf16')
    return {**{n: _constant(src, n) for n in names},
            'kPadBf16': _constant(_source('mma_bf16.cuh'), 'kPadBf16'),
            'kSMs': _constant(_source('lstm_scan.cuh'), 'kSMs')}


def test_bf16_plan_constants_are_the_sources():
    """The wrapper's mirrors of K3-bf16's and K4-bf16's constants are the
    sources' (w_hh held whole up to H = 128, a 4-stage ring of k16 slices,
    the scan's 4-stage ring of 32 columns past 128, rows padded by 8
    bf16)."""
    got = _bf16_constants()
    assert got == {'kResidentMax': L._RESIDENT_MAX,
                   'kFwdStagesBf16': L._FWD_STAGES_BF16,
                   'kSliceBf16': L._SLICE_BF16,
                   'kRscanRingBf16': L._RSCAN_RING_BF16,
                   'kRscanChunkBf16': L._RSCAN_CHUNK_BF16,
                   'kPadBf16': L._PAD_BF16, 'kSMs': L._SMS}
    assert (got['kResidentMax'], got['kSliceBf16'], got['kPadBf16']) == \
        (128, 16, 8)


@pytest.mark.parametrize('hidden', range(32, 257, 32))
def test_bf16_plans_are_the_sources(hidden):
    """K3-bf16's and K4-bf16's plans at every H on the 32-grid, on
    TF-GridNet's row counts, a ragged one and one row: the float32 route's
    tile rule; K3-bf16 2H threads (warps of 16 units), at most 512, shared
    memory for w_hh whole (H <= kResidentMax), h of the tile and the
    ring, rows padded by kPadBf16 (odd multiples of 16 bytes, so ldmatrix
    rows fall in distinct bank groups), the same at every E; K4-bf16's
    reverse scan with w_hh
    whole or a ring of kRscanChunkBf16 columns, dgates and dh_rec of the
    tile, its warps' 8 rt x 32 dh_rec tiles covering the tile; each plan
    within 232,448 bytes a block; the weight GEMM's split the float32
    route's."""
    k = _bf16_constants()
    pad, slice_, stages = k['kPadBf16'], k['kSliceBf16'], k['kFwdStagesBf16']
    resident = hidden <= k['kResidentMax']
    for steps, n_dir, rows in ((33, 2, 8064), (126, 2, 2112), (9, 1, 70),
                               (1, 1, 1), (2, 2, 4300)):
        for feat in (16, 128, 1616):
            fwd = L.fwd_plan(steps, n_dir, rows, feat, hidden, bf16=True)
            tile = fwd['rows']
            assert tile == 32 or (tile == 64 and hidden <= 128
                                  and n_dir * _cdiv(rows, 64) >= k['kSMs'])
            assert tile == L.fwd_plan(steps, n_dir, rows, feat, hidden)['rows']
            assert fwd['slice'] == slice_ and fwd['threads'] == 2 * hidden
            assert fwd['threads'] % 64 == 0 and fwd['threads'] <= 512
            ld = 4 * hidden + pad
            assert (2 * ld) % 32 == 16 and (2 * (hidden + pad)) % 32 == 16
            assert (2 * (slice_ + pad)) % 32 == 16
            assert fwd['smem'] == 2 * (
                (hidden * ld if resident else 0) + tile * (hidden + pad)
                + stages * (slice_ * ld + tile * (slice_ + pad)))
            assert fwd['smem'] <= L._MAX_SMEM == 232448
            assert fwd == L.fwd_plan(steps, n_dir, rows, 16, hidden, True)
            assert (fwd['tiles'] - 1) * tile < rows <= fwd['tiles'] * tile
            bwd = L.bwd_plan(steps, n_dir, rows, feat, hidden, bf16=True)
            f32 = L.bwd_plan(steps, n_dir, rows, feat, hidden)
            assert {n: v for n, v in bwd.items() if n != 'smem'} == \
                {n: v for n, v in f32.items() if n != 'smem'}
            held = (hidden * ld if resident else k['kRscanRingBf16'] * hidden
                    * (k['kRscanChunkBf16'] + pad))
            assert bwd['smem'] == 2 * (held + bwd['rows'] * ld
                                       + bwd['rows'] * (hidden + pad))
            assert bwd['smem'] <= L._MAX_SMEM
            warps = bwd['threads'] // 32
            sub = 8 * bwd['rows_a_thread']
            assert bwd['threads'] % 32 == 0
            assert warps == bwd['rows'] // sub * (hidden // 32)


def test_bf16_plans_at_tfgridnet_shapes():
    """At 16 x 4 s K3-bf16 takes 64-row tiles at the intra BLSTM (252 tiles
    of 256 threads) and 32-row ones at the inter (132 tiles), the ring with
    w_hh resident, 229,376 and 214,528 bytes; K4-bf16's scan 217,088 and
    175,104 bytes: all within a block's 232,448."""
    intra = (33, 2, 8064, 128, 128)
    inter = (126, 2, 2112, 128, 128)
    f_in = L.fwd_plan(*intra, bf16=True)
    f_out = L.fwd_plan(*inter, bf16=True)
    assert (f_in['rows'], f_in['threads'], 2 * f_in['tiles'],
            f_in['smem']) == (64, 256, 252, 229376)
    assert (f_out['rows'], f_out['threads'], 2 * f_out['tiles'],
            f_out['smem']) == (32, 256, 132, 214528)
    b_in, b_out = L.bwd_plan(*intra, bf16=True), L.bwd_plan(*inter, bf16=True)
    assert (b_in['rows'], b_in['threads'], b_in['smem']) == (64, 256, 217088)
    assert (b_out['rows'], b_out['threads'], b_out['smem']) == \
        (32, 256, 175104)
    assert max(p['smem'] for p in (b_in, b_out, f_in, f_out)) <= 232448


@pytest.mark.parametrize('case', [(5, 2, 9, 36, 32), (4, 1, 7, 12, 64),
                                  (3, 2, 20, 72, 32), (6, 2, 17, 4, 32),
                                  (3, 1, 5, 100, 96)])
def test_padding_e_to_the_mma_depth_leaves_the_bf16_twin_bitwise(case):
    """The bf16 route pads E with zeros to a multiple of 16
    (``_pad_feature``): the bf16 twins (``lstm_scan_x_reference``,
    ``lstm_scan_x_bwd_plain``) give the unpadded scan's h, c, dx, dW_ih, db
    and dW_hh bit for bit, and zero gradients at the padded columns."""
    steps, n_dir, rows, feat, hidden = case
    rng = np.random.RandomState(sum(case))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.randn(*shape)).astype(np.float32)).bfloat16()

    try:
        x, w_ih = arr(steps, n_dir, rows, feat), \
            arr(n_dir, feat, 4 * hidden, scale=feat ** -0.5)
        bias, w_hh = arr(n_dir, 4 * hidden, scale=0.1), \
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5)
        dh = arr(steps, n_dir, rows, hidden)
        x_pad, w_pad = L._pad_feature(x, w_ih)
        assert x_pad.shape[-1] == feat + (-feat % 16) > feat
        assert L.feature_step(torch.bfloat16) == 16
        h, c = L.lstm_scan_x_reference(x, w_ih, bias, w_hh)
        h_p, c_p = L.lstm_scan_x_reference(x_pad, w_pad, bias, w_hh)
        grads = L.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, h, c, dh)
        dx_p, dw_ih_p, db_p, dw_hh_p = L.lstm_scan_x_bwd_plain(
            x_pad, w_pad, bias, w_hh, h_p, c_p, dh)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(h, h_p) and torch.equal(c, c_p)
    for got, want in zip((dx_p[..., :feat], dw_ih_p[:, :feat], db_p,
                          dw_hh_p), grads):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not dx_p[..., feat:].any() and not dw_ih_p[:, feat:].any()
