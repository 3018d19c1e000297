"""K7/K8's cluster plan on the CPU: the wrapper's mirror
(``ops.groupnorm.gn_plan``) against the constants of csrc/groupnorm.cuh and
what the card allows a block, at the GroupNorm shapes of one SGMSE+ U-Net
evaluation at 4 x 4 s and at ragged ones, on the float32 route and the bf16
one (2 bytes an element); and ``bench_groupnorm``'s
bounds and call recorder. The card tests hold the built library's own plan
to the same mirror."""

import os
import re

import pytest
import torch

from brever_tpu_torch.ops import groupnorm as gn

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'brever_tpu_torch', 'csrc')

#: the 19 ((B, C, F, T), SiLU) GroupNorm calls of one ``sgmsep`` U-Net
#: evaluation at 4 x 4 s (109 calls, G = 32), recorded from the model on
#: the meta device (``test_unet_groupnorm_calls_at_4x4s``)
UNET_CALLS = [
    ((4, 128, 64, 126), True), ((4, 128, 128, 251), True),
    ((4, 128, 256, 501), True), ((4, 256, 4, 8), False),
    ((4, 256, 4, 8), True), ((4, 256, 8, 16), True),
    ((4, 256, 16, 32), False), ((4, 256, 16, 32), True),
    ((4, 256, 32, 63), True), ((4, 256, 64, 126), True),
    ((4, 256, 128, 251), True), ((4, 256, 256, 501), True),
    ((4, 384, 64, 126), True), ((4, 384, 128, 251), True),
    ((4, 512, 4, 8), True), ((4, 512, 8, 16), True),
    ((4, 512, 16, 32), True), ((4, 512, 32, 63), True),
    ((4, 512, 64, 126), True)]
#: ragged (shape, groups): odd N, B = 1, G = C, a rank-3 length (the card
#: tests' and the smoke's)
RAGGED = [((1, 384, 7, 13), 32), ((2, 64, 33, 17), 64), ((3, 96, 1001), 24),
          ((2, 128, 33, 41), 32), ((2, 256, 8, 16), 32), ((2, 64, 5, 3), 64),
          ((3, 96, 17), 24)]
CASES = [(shape, 32) for shape, _ in UNET_CALLS] + RAGGED


def _constant(name, source='groupnorm.cuh'):
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def _bnc(shape):
    n = 1
    for s in shape[2:]:
        n *= s
    return shape[0], shape[1], n


def test_plan_constants_are_the_sources():
    """The mirror's task length, threads, shared memory, scratch and
    largest cluster are the kernel's; a block may use all of the card's
    232,448 bytes, and the held floats start 16-byte aligned."""
    assert (gn._TASK, gn._THREADS, gn._SMEM_MOST, gn._SCRATCH,
            gn._MOST_CLUSTER) == (_constant('kTask'), _constant('kGnThreads'),
                                  _constant('kSmemMost'),
                                  _constant('kScratch'),
                                  _constant('kMostCluster'))
    assert gn._SMEM_MOST == 232448
    assert gn._SCRATCH % 16 == 0 and gn._TASK % 4 == 0
    # the bf16 route's 16-byte vectors (groupnorm_bf16.cu's kV) are the
    # mirror's whole vectors at 2 bytes an element, and a block's held
    # elements a whole number of them
    assert _constant('kV', 'groupnorm_bf16.cu') == 16 // 2
    assert gn.held_most(2) % 8 == 0


@pytest.mark.parametrize('itemsize', [4, 2])
@pytest.mark.parametrize('most', [16, 8])
@pytest.mark.parametrize('shape,groups', CASES, ids=lambda v: str(v))
def test_plan_covers_the_slab(shape, groups, most, itemsize):
    """A cluster of 1-16 blocks (a power of two), the smallest whose blocks
    hold their shares, else the largest allowed (16, or 8 where the card
    places no 16-block cluster) with the rest of each share named as the
    remainder; the shares tile the slab; the shared memory is the scratch
    and the held floats (whole float4s) and at most 232,448 bytes."""
    batch, channels, n = _bnc(shape)
    plan = gn.gn_plan(batch, channels, n, groups, most, itemsize)
    cluster, held = plan['cluster'], plan['resident']
    assert cluster in (1, 2, 4, 8, 16)
    slab = channels // groups * n
    shares = gn.group_shares(channels, n, groups, cluster)
    assert len(shares) == cluster and shares[0][0] == 0
    assert all(w > 0 for _, w in shares)
    assert all(a + w == b for (a, w), (b, _) in zip(shares, shares[1:]))
    assert shares[-1][0] + shares[-1][1] == slab
    assert plan['remainder'] == sum(max(w - held, 0) for _, w in shares)
    assert cluster <= most
    most_held = (gn._SMEM_MOST - gn._SCRATCH) // itemsize // 4 * 4
    if plan['remainder']:
        assert plan['route'] == 'partial' and cluster == most
        assert held == most_held
    else:
        assert held * cluster >= slab and held >= max(w for _, w in shares)
        assert plan['route'] == ('cluster' if cluster > 1 else 'block')
    if cluster > 1:   # the smallest cluster that holds the slab
        half = gn.gn_plan(batch, channels, n, groups, cluster // 2,
                          itemsize)
        assert half['remainder'] > 0
    # whole 16-byte vectors: four float32, eight bf16
    assert held % (16 // itemsize) == 0
    # the bf16 route's K8 holds dy in what x leaves of a block's memory
    held_dy = min(held, most_held - held) if itemsize == 2 else 0
    assert plan['dy_resident'] == held_dy
    assert plan['smem'] == gn._SCRATCH + itemsize * (held + held_dy) \
        <= gn._SMEM_MOST
    assert plan['tasks'] >= cluster
    assert plan['blocks'] == batch * groups * cluster
    assert plan['threads'] == gn._THREADS


def test_plan_routes_at_the_unet_shapes():
    """At 4 x 4 s K7 and K8 hold every slab of x but the three (4, 256,
    256, 501) calls' (3.91 MiB a group); 68 of the 109 calls (groups of up
    to 126 KB) are one block each."""
    fwd = {shape: gn.gn_plan(*_bnc(shape), 32) for shape, _ in UNET_CALLS}
    assert [s for s, p in fwd.items() if p['route'] == 'partial'] == [
        (4, 256, 256, 501)]
    assert fwd[(4, 128, 256, 501)]['cluster'] == 16
    assert fwd[(4, 256, 256, 501)]['remainder'] == 104448
    counts = {(4, 128, 64, 126): 2, (4, 128, 128, 251): 11,
              (4, 128, 256, 501): 10, (4, 256, 4, 8): 15,
              (4, 256, 8, 16): 12, (4, 256, 16, 32): 15,
              (4, 256, 32, 63): 12, (4, 256, 64, 126): 10,
              (4, 256, 128, 251): 3, (4, 256, 256, 501): 3,
              (4, 384, 64, 126): 1, (4, 384, 128, 251): 1,
              (4, 512, 4, 8): 3, (4, 512, 8, 16): 3,
              (4, 512, 16, 32): 3, (4, 512, 32, 63): 3,
              (4, 512, 64, 126): 2}
    assert sum(counts.values()) == 109
    assert sum(c for s, c in counts.items()
               if fwd[s]['route'] == 'block') == 68
    assert {p['route'] for p in fwd.values()} == {'block', 'cluster',
                                                  'partial'}


def test_plan_routes_at_the_unet_shapes_in_bf16():
    """On the bf16 route a block holds twice the elements: every slab of
    a U-Net evaluation at 4 x 4 s is held, (4, 256, 256, 501)'s 1.96 MiB
    groups by 16-block clusters and (4, 128, 256, 501)'s by 8. K8 holds dy
    in what x leaves of a block's 232,448 bytes: the whole share at the 9
    classes of up to 32,256 elements a block, part of it at the 8 wider ones
    ((4, 256, 256, 501): 50,688 of 64,512; (4, 384, 64, 126): 18,432 of
    96,768), whose blocks then fill their shared memory."""
    plans = {shape: gn.gn_plan(*_bnc(shape), 32, itemsize=2)
             for shape, _ in UNET_CALLS}
    assert all(p['remainder'] == 0 for p in plans.values())
    assert plans[(4, 256, 256, 501)]['cluster'] == 16
    assert plans[(4, 128, 256, 501)]['cluster'] == 8
    assert {p['route'] for p in plans.values()} == {'block', 'cluster'}
    assert all(p['smem'] == gn._SCRATCH + 2 * (p['resident']
                                               + p['dy_resident'])
               for p in plans.values())
    largest, widest = plans[(4, 256, 256, 501)], plans[(4, 384, 64, 126)]
    assert (largest['resident'], largest['dy_resident']) == (64512, 50688)
    assert (widest['resident'], widest['dy_resident']) == (96768, 18432)
    whole = {s for s, p in plans.items()
             if p['dy_resident'] == p['resident']}
    assert len(whole) == 9
    assert all(plans[s]['resident'] <= 32256 for s in whole)
    assert all(p['smem'] == gn._SMEM_MOST for s, p in plans.items()
               if s not in whole)
    # every class is on the 16-byte grid: whole vectors of eight a row
    assert all(_bnc(shape)[2] % 8 == 0 for shape, _ in UNET_CALLS)


def test_plan_keeps_the_cluster_of_x_in_bf16():
    """Holding dy never grows the bf16 cluster: at every class the cluster
    is the smallest whose blocks hold the slab of x alone (the float32
    plan at half the bytes an element would hold x and dy together only
    by doubling it at six classes)."""
    grows = 0
    for shape, groups in CASES:
        bf = gn.gn_plan(*_bnc(shape), groups, itemsize=2)
        both = gn.gn_plan(*_bnc(shape), groups, itemsize=4)
        widths = [w for _, w in gn.group_shares(
            shape[1], _bnc(shape)[2], groups, bf['cluster'])]
        assert max(widths) <= bf['resident'] or bf['remainder']
        grows += both['cluster'] > bf['cluster']
    assert grows >= 6


def test_a_smaller_cluster_holds_less():
    """Capped at 8 blocks, (4, 256, 256, 501) holds half as much of each
    slab as at 16, and reads the rest again."""
    at16 = gn.gn_plan(4, 256, 256 * 501, 32)
    at8 = gn.gn_plan(4, 256, 256 * 501, 32, most=8)
    assert (at8['cluster'], at8['resident']) == (8, at16['resident'])
    assert at8['remainder'] == 8 * 256 * 501 - 8 * at8['resident']
    assert at8['remainder'] > at16['remainder']


def test_unet_groupnorm_calls_at_4x4s(monkeypatch):
    """The calls above are those ``bench_groupnorm.unet_calls`` records
    from one ``sgmsep`` evaluation of a (4, 1, 256, 501) spectrogram, on
    the meta device (no arithmetic)."""
    from brever_tpu_torch.bench_groupnorm import unet_calls
    from brever_tpu_torch.models import ModelRegistry
    from brever_tpu_torch.models.sgmse import net

    def identity(x, scale, bias, groups, eps=1e-6, apply_silu=True, **kw):
        return x

    monkeypatch.setattr(net, 'group_norm_silu', identity)
    model = ModelRegistry.get('sgmsep')(device='meta')
    calls = unet_calls(model, 'meta')
    assert net.group_norm_silu is identity
    assert {g for _, g, _ in calls} == {32}
    assert sorted((shape, silu) for shape, _, silu in calls) == sorted(
        UNET_CALLS)
    assert sum(calls.values()) == 109


def test_bench_bounds():
    """``bench_groupnorm`` bounds K7 by 8 bytes an element and K8 by 12 at
    the card's memory rate."""
    from brever_tpu_torch import bench_groupnorm
    k7, k8 = bench_groupnorm.bound_ms((4, 256, 256, 501))
    assert k7 == pytest.approx(1e3 * 8 * 4 * 256 * 256 * 501 / 3.35e12)
    assert k8 == pytest.approx(1.5 * k7)
