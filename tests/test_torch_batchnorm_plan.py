"""K7-BN's and K8-BN's plan on the CPU: the wrapper's mirror
(``ops.batchnorm.bn_plan``) against the constants of csrc/groupnorm.cuh and
what the card allows a block, at the BatchNorm classes of one MANNER train
step at 16 x 4 s and at ragged shapes, on the float32 route and the bf16
one (2 bytes an element); and ``bench_batchnorm``'s call recorder. The card tests hold the built library's own plan to the same
mirror."""

import os
import re

import numpy as np
import pytest

from brever_tpu_torch.ops import batchnorm as bn
from brever_tpu_torch.ops import groupnorm as gn

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'brever_tpu_torch', 'csrc', 'groupnorm.cuh')

#: the 34 ((B, C, N), act) train-mode BatchNorm classes of one ``manner``
#: forward at 16 x 4 s (69 calls), recorded from the model on the meta
#: device (``test_manner_batchnorm_calls_at_16x4s``)
MANNER_CALLS = {
    ((16, 60, 64084), 'relu'): 2, ((16, 60, 16020), 'relu'): 1,
    ((16, 120, 16020), 'none'): 3, ((16, 60, 16020), 'silu'): 2,
    ((16, 120, 16020), 'silu'): 2, ((16, 120, 16020), 'relu'): 1,
    ((16, 240, 16020), 'none'): 1, ((16, 60, 16020), 'none'): 2,
    ((16, 120, 4004), 'relu'): 1, ((16, 240, 4004), 'none'): 3,
    ((16, 120, 4004), 'silu'): 2, ((16, 240, 4004), 'silu'): 2,
    ((16, 240, 4004), 'relu'): 1, ((16, 480, 4004), 'none'): 1,
    ((16, 120, 4004), 'none'): 2, ((16, 240, 1000), 'relu'): 1,
    ((16, 480, 1000), 'none'): 5, ((16, 240, 1000), 'silu'): 2,
    ((16, 480, 1000), 'silu'): 2, ((16, 480, 1000), 'relu'): 1,
    ((16, 160, 1000), 'relu'): 6, ((16, 960, 1000), 'none'): 1,
    ((16, 240, 1000), 'none'): 2, ((16, 480, 249), 'relu'): 1,
    ((16, 960, 249), 'none'): 5, ((16, 480, 249), 'silu'): 2,
    ((16, 960, 249), 'silu'): 2, ((16, 320, 249), 'relu'): 6,
    ((16, 1920, 249), 'none'): 1, ((16, 480, 249), 'none'): 2,
    ((160, 320, 64), 'silu'): 1, ((160, 1, 64), 'none'): 1,
    ((544, 160, 64), 'silu'): 1, ((544, 1, 64), 'none'): 1}
#: ragged (B, C, N): one row, one channel, odd N, N under a float4, a row
#: longer than a task, a row past what one block holds, a channel past a
#: 16-block cluster off the float4 grid
RAGGED = [(1, 1, 1), (1, 4, 3), (3, 1, 2), (2, 5, 1025), (7, 3, 1023),
          (1, 7, 70001), (5, 9, 33333), (16, 2, 64085), (40, 1, 64084)]
SHAPES = sorted({shape for shape, _ in MANNER_CALLS}) + RAGGED


def _source():
    with open(CSRC) as f:
        return f.read()


def _constant(text, name):
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def test_plan_constants_are_the_sources():
    """The mirror's segment length, an SM's shared memory and its
    reserve, route codes and routes past the largest cluster are the
    kernel's; its cluster plan is K7's (whose constants
    ``test_torch_groupnorm_plan`` holds)."""
    text = _source()
    assert (bn._SEG, bn._SMEM_SM, bn._SMEM_RESERVED) == (
        _constant(text, 'kSeg'), _constant(text, 'kSmemSm'),
        _constant(text, 'kSmemReserved'))
    assert bn._SMEM_SM == 228 * 1024
    enum = re.search(r'enum Route \{([^}]*)\}', text).group(1)
    codes = dict(re.findall(r'k(\w+) = (\d+)', enum))
    assert [codes[name.capitalize()] for name in bn.ROUTES] == \
        [str(i) for i in range(len(bn.ROUTES))]
    past = dict(re.findall(r'constexpr int kBn(Fwd|Bwd)Past = k(\w+);',
                           text))
    assert (bn._FWD_PAST, bn._BWD_PAST) == (past['Fwd'].lower(),
                                            past['Bwd'].lower())


@pytest.mark.parametrize('itemsize', [4, 2])
@pytest.mark.parametrize('most', [16, 8])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_plan_covers_the_channel(shape, most, itemsize):
    """A cluster of 1-16 blocks (a power of two) a channel, the smallest
    whose blocks hold their shares, else the largest allowed with the rest
    named as the remainder; the shares cover each of the channel's B N
    elements exactly once; the shared memory is the scratch and the held
    elements (whole vectors of four, ``itemsize`` bytes each); one block a channel of at most 16 tasks runs
    half the threads, and a ring of two buffers where two such blocks fit
    an SM; the routes
    follow the plan's rule and the passes' workspace holds a pair of
    doubles a segment of each row."""
    batch, channels, n = shape
    plan = bn.bn_plan(batch, channels, n, most, itemsize)
    cluster, held = plan['cluster'], plan['resident']
    assert cluster in (1, 2, 4, 8, 16) and cluster <= most
    shares = bn.channel_shares(batch, n, cluster)
    covered = np.zeros(batch * n, np.int64)
    for start, width in shares:
        assert width > 0
        covered[start:start + width] += 1
    assert (covered == 1).all()
    assert plan['remainder'] == sum(max(w - held, 0) for _, w in shares)
    cap = (gn._SMEM_MOST - gn._SCRATCH) // itemsize // 4 * 4
    assert gn.held_most(itemsize) == cap
    if plan['remainder']:
        assert cluster == most
        assert held == cap
        assert (plan['route_fwd'], plan['route_bwd']) == (bn._FWD_PAST,
                                                          bn._BWD_PAST)
    else:
        assert held * cluster >= batch * n
        route = 'cluster' if cluster > 1 else 'block'
        assert plan['route_fwd'] == route
        bf16_wide = itemsize == 2 and cluster == 16
        assert plan['route_bwd'] == ('passes' if n % 4 or bf16_wide
                                     else route)
    if cluster > 1:   # the smallest cluster that holds the channel
        assert bn.bn_plan(batch, channels, n, cluster // 2,
                          itemsize)['remainder'] > 0
    assert held % 4 == 0
    assert plan['smem'] == gn._SCRATCH + itemsize * held <= gn._SMEM_MOST
    assert plan['tasks'] == batch * -(-n // gn._TASK) >= cluster
    assert plan['blocks'] == channels * cluster
    half = cluster == 1 and plan['tasks'] <= 16
    assert plan['threads'] == (256 if half else 512)
    assert plan['block_smem'] == (gn._SCRATCH
                                  + itemsize * held * plan['stages'])
    pair = 2 * (gn._SCRATCH + 2 * itemsize * held + bn._SMEM_RESERVED)
    assert plan['stages'] == (2 if half and pair <= bn._SMEM_SM else 1)
    segs = -(-n // bn._SEG)
    assert plan['workspace'] == (16 * batch * channels * segs
                                 if plan['route_bwd'] == 'passes' else 0)


def test_plan_routes_at_the_manner_shapes():
    """At 16 x 4 s one block holds a channel at N <= 1000 and at the
    attention's (B, C, 64), 2-block clusters at 4004 and 8-block ones at
    16020 (67 of the 69 calls held whole); (16, 60, 64084)'s 4.1 MB
    channels pass a 16-block cluster's 3.69 MB and take the large
    route; K8-BN takes the passes at N = 249 as well. At N <= 1000 (16 tasks a channel) the blocks have 256 threads,
    two an SM, and at N = 249 a ring of two channels; the attention's 160
    and 544 rows keep 512 threads and one buffer."""
    plans = {shape: bn.bn_plan(*shape) for shape, _ in MANNER_CALLS}
    for shape, plan in plans.items():
        n = shape[2]
        want = (16 if n == 64084 else 8 if n == 16020 else 2 if n == 4004
                else 1)
        assert plan['cluster'] == want, shape
        assert (plan['remainder'] > 0) == (n == 64084), shape
        assert plan['threads'] == (256 if n in (249, 1000) else 512), shape
        assert (plan['route_bwd'] == 'passes') == (n in (249, 64084)), shape
        assert (plan['stages'] == 2) == (n == 249), shape
    big = plans[(16, 60, 64084)]
    assert big['remainder'] == 16 * 64084 - 16 * big['resident'] == 103744
    held = sum(c for (shape, _), c in MANNER_CALLS.items()
               if not plans[shape]['remainder'])
    assert held == 67 and sum(MANNER_CALLS.values()) == 69


def test_plan_routes_at_the_manner_shapes_in_bf16():
    """On the bf16 route a block holds twice the elements: every class of
    the step is held, (16, 60, 64084)'s 2.05 MB channels by a 16-block
    cluster (K7-BN's route; K8-BN takes the passes there, faster on an
    H100), 16020's by 4 blocks and 4004's by one; K8-BN still takes the
    passes at N = 249 (off the vector grid). A ring of two channels now
    fits at N = 1000 as well as at 249."""
    plans = {shape: bn.bn_plan(*shape, itemsize=2)
             for shape, _ in MANNER_CALLS}
    for shape, plan in plans.items():
        n = shape[2]
        want = (16 if n == 64084 else 4 if n == 16020 else 1)
        assert plan['cluster'] == want, shape
        assert plan['remainder'] == 0, shape
        assert plan['route_fwd'] == ('block' if want == 1 else 'cluster')
        assert (plan['route_bwd'] == 'passes') == (n in (249, 64084)), shape
        assert (plan['stages'] == 2) == (n in (249, 1000)), shape
    assert plans[(16, 60, 64084)]['resident'] == 64084
    assert gn.held_most(2) == 2 * gn.held_most(4) == 115200


def test_manner_batchnorm_calls_at_16x4s(monkeypatch):
    """The classes above are those ``bench_batchnorm.manner_calls``
    records from one train-mode ``manner`` forward of a (16, 1, 64000)
    mixture on the meta device (no arithmetic)."""
    from brever_tpu_torch.bench_batchnorm import manner_calls
    from brever_tpu_torch.models import ModelRegistry, common

    def identity(x, scale, bias, eps=1e-5, act='none'):
        return x, x.new_empty(x.shape[1]), x.new_empty(x.shape[1])

    monkeypatch.setattr(common, 'batch_norm_act', identity)
    model = ModelRegistry.get('manner')(device='meta')
    calls = manner_calls(model, 'meta')
    assert common.batch_norm_act is identity
    assert calls == MANNER_CALLS
