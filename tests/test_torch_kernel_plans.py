"""The wrappers' mirrors of the forward kernels' launch figures, on the
CPU: K1's partial moments a batch row (``ops.tcn_block.fwd_partials``) at
the tiles the sources name, and K3's plan (``ops.lstm_scan.fwd_plan``)
against the constants of csrc/lstm_scan.cuh and what the card allows a
block. The card tests hold the built library's own figures to the same
mirrors."""

import os
import re

import pytest

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
    input GEMM (simt_gemm.cuh's block tile) and one a 32 x 128 tile of its
    depthwise stage, each batch row."""
    k1 = _source('tcn_block.cu')
    tile = _constant(_source('simt_gemm.cuh'), 'kGM')
    rows, cols = _constant(k1, 'kDwRows'), _constant(k1, 'kDwCols')
    assert (tile, rows, cols) == (128, 32, 128)
    assert tcn.fwd_partials(t_total, hidden) == (
        _cdiv(t_total, tile) * _cdiv(hidden, tile),
        _cdiv(t_total, rows) * _cdiv(hidden, cols))


def test_forward_partials_at_the_convtasnet_shape():
    """T = 3999, H = 512: 32 x 4 GEMM tiles and 125 x 4 depthwise tiles."""
    assert tcn.fwd_partials(3999, 512) == (128, 500)


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
