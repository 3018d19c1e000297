"""LSTM recurrence, forward and backward: the plain versions and the CUDA
kernels, with the input projection fused in (flash-LSTM-x, K3/K4) and over
precomputed input gates (K5/K6).

Counterpart of ``lstm_scan_fused_x`` in
``brever_tpu/ops/pallas/lstm_scan.py``: over ``x_seq (T, D, R, E)`` with
``D`` directions stacked (a backward direction's input already flipped in
time) and ``R`` rows,

    gates[t] = (x[t] w_ih + bias) + h[t-1] w_hh        (i | f | g | o)
    c[t] = sig(f) c[t-1] + sig(i) tanh(g),   h[t] = sig(o) tanh(c[t])

from zero state, with ``w_ih (D, E, 4H)``, ``bias (D, 4H)`` (``b_ih +
b_hh``) and ``w_hh (D, H, 4H)``, the JAX package's layout: this wrapper
takes the weights in that one layout, contiguous, and checks it.

:func:`lstm_scan_x` is what the models call. Under grad mode with an input
that requires grad it goes through :class:`LSTMScanXFunction`, whose
forward saves x, h and c (as ``_fused_x_fwd`` does) and whose backward
returns dx, dW_ih, db and dW_hh; otherwise (serving) it is the forward
alone. A tensor on the CPU takes the plain versions; a CUDA tensor
launches the kernels (``csrc/lstm_scan.cuh``: K3, the forward, replaces
``_fwd_x_kernel``; K4, the backward, ``_bwd_x_kernel``) or raises. K3 is
one launch: a block scans a row tile over all steps, streaming the rows of
``[w_ih; w_hh]`` through a shared-memory ring (its plan: :func:`fwd_plan`,
checked against the library's before a shape's first launch). K4 is
five launches: the gates of every step as one GEMM (the saved h makes them
independent of the scan), the reverse scan that forms dgates and dh_rec =
dgates w_hh^T, the dx GEMM, the weight GEMM over fixed-order chunks of the
(t, r) pairs (db as its row of ones), and the chunks' sums; its tiles and
chunks are :func:`bwd_plan`'s, checked against the library's before a
shape's first launch.

The plain versions: :func:`lstm_scan_x_reference`, a time loop in the JAX
package's order of operations (``rnn._lstm_scan_impl`` after the einsum
projection), and :func:`lstm_scan_x_bwd_plain`, the memory-lean backward
of ``rnn._lstm_scan_bwd``: it keeps h and c only and recomputes the gates
in one product. Autograd through the time loop would keep about six
gate-sized tensors a step, more than the card holds for TF-GridNet at
16 x 4 s. :func:`lstm_scan_x_plain` is the whole plain path, with that
backward, on any device.

The kernels take every shape the JAX package's scans run, up to H = 8192
(``_check_hidden``; K3/K4 up to 256, K5/K6 up to 8192):

* a hidden size off the kernels' grid of multiples of 32 is zero-padded
  up to it by :func:`pad_hidden` in :func:`lstm_scan_x` and
  :func:`lstm_scan`, and h is sliced back: padded units see zero
  pre-activations, so their c and h stay 0 and the real units' outputs
  and gradients are those of the unpadded scan (H = 200 runs as 224);
* a scan whose ``T D R max(4H, E)`` reaches the kernels' int range is cut
  into row chunks below it (:func:`row_chunks`), launched in order; the
  rows are independent, and the weight-gradient partials are summed in
  chunk order, so the result is deterministic;
* an (E, H) whose projection-fused kernels pass the card's shared memory,
  and every H above 256, is routed by ``models/rnn.py`` to the projection
  and K5/K6 before any launch (:func:`fused_x_fits`).

bf16 (amp): every entry point also takes bfloat16 tensors (all of a call's
operands in one dtype). The plain versions then compute what the Pallas
kernels compute with bf16 operands, at their rounding points
(``_fwd_x_kernel`` ``:414-428``, ``_bwd_x_kernel`` ``:527-560``, and the
gates-in ``_fwd_kernel`` / ``_bwd_kernel``): ``gx = bf16(x w_ih + bias)``
summed in float32, ``gates = gx + bf16(h w_hh)`` added in bf16, each
nonlinearity in float32 rounded to bf16, every product and sum of the cell
and of the backward's do/dc/di/df/dg chain rounded (c carried in bf16),
``dh_rec = bf16(dgates w_hh^T)``, ``dx = bf16(dgates w_ih^T)``, and the
weight gradients summed in float32 and cast to the weights' dtype. A CUDA
bf16 tensor launches the bf16 route (K3 1 launch, K4 5, K5 1, K6 2; K5/K6
up to H = 256) or raises. K3-bf16 and K4-bf16 are kernels of their own
(``csrc/lstm_scan_bf16.cu``), their products on the bf16 tensor cores
(``mma.sync`` m16n8k16, ``csrc/mma_bf16.cuh``), E zero-padded to the MMA
depth of 16 (exact: the padded columns add zero products), with plans of
their own (``fwd_plan``/``bwd_plan`` with ``bf16=True``); K6-bf16's weight
gradient is K4-bf16's weight GEMM.

K5/K6 run up to H = 256 on a thread-block cluster of :data:`CLUSTER_BLOCKS`
blocks per 32-row tile and direction, each block holding its slice of
``w_hh`` in shared memory (:func:`cluster_smem`, checked against the
library's own figure and the card's cluster occupancy before a shape's first
launch); above 256 they scan row tiles with ``w_hh`` read through the caches:
16 rows up to H = 512, then half as many each time H doubles, one row past
4096 (:func:`scan_tile_rows`, :func:`scan_tile_smem`).
"""

import ctypes

import torch
import torch.nn.functional as F

from . import build

#: the kernels' int range: no tensor of a launch may hold this many floats
_INT_RANGE = 2 ** 31
#: the largest hidden size the kernels take (K5/K6, ``kMaxHidden`` of
#: csrc/lstm_scan.cuh), the largest K3/K4 take (``kMaxHiddenWide``), and
#: their grid of sizes
_MAX_HIDDEN, _MAX_HIDDEN_X, _HIDDEN_STEP = 8192, 256, 32
#: rows of a 32-row scan tile (the routing rule's, :func:`fused_x_fits`)
_TILE_ROWS = 32
#: K3's ring (``kFwdRing`` of csrc/lstm_scan.cuh): its stages
_FWD_RING = 4
#: shared memory a block may take on the H100 (bytes)
_MAX_SMEM = 227 * 1024
#: K5/K6 up to H = 256 (csrc/lstm_scan.cuh): rows of a cluster's tile, and
#: the floats that pad a shared row of H
_CLUSTER_ROWS, _CLUSTER_PAD = 32, 4
#: blocks of a K5/K6 cluster at every H <= 256 (``kClusterBlocks``)
CLUSTER_BLOCKS = 16
#: K4's plan (``BwdPlan`` of csrc/lstm_scan.cuh): the H100 SXM's SMs, the
#: weight GEMM's least chunk of (t, r) pairs, the GEMMs' block tile and k
#: slice, and the chunks of w_hh^T in the reverse scan's ring
_SMS, _WG_MIN_CHUNK, _GEMM_TILE, _GEMM_SLICE = 132, 1024, 128, 16
_RING = 4
#: K3-bf16 and K4-bf16 (csrc/lstm_scan_bf16.cu): the largest H whose w_hh a
#: block holds whole (``kResidentMax``), K3-bf16's ring stages and k slice
#: (``kFwdStagesBf16``, ``kSliceBf16``: the MMA depth, E's padding), the
#: reverse scan's ring stages and w_hh columns a stage past it
#: (``kRscanRingBf16``, ``kRscanChunkBf16``), and the bf16 a staged row is
#: padded by (``kPadBf16`` of csrc/mma_bf16.cuh)
_RESIDENT_MAX, _FWD_STAGES_BF16, _SLICE_BF16 = 128, 4, 16
_RSCAN_RING_BF16, _RSCAN_CHUNK_BF16, _PAD_BF16 = 4, 32, 8


def kernel_hidden(hidden):
    """The hidden size the kernels run a scan of ``hidden`` units at: the
    next multiple of 32."""
    return -(-hidden // _HIDDEN_STEP) * _HIDDEN_STEP


def pad_hidden(hidden_to, w_hh, *gated):
    """Zero-pad a scan's hidden size H to ``hidden_to``: ``w_hh (D, H, 4H)``
    to ``(D, hidden_to, 4 hidden_to)`` and each tensor of ``gated`` (``w_ih``,
    ``bias``, ``gates_x``: last axis 4H, gates i|f|g|o) to ``4 hidden_to``,
    gate by gate. Returns ``(w_hh, *gated)``, contiguous. The padded units'
    pre-activations are 0, so their c = 0.5 c_prev + 0.5 tanh(0) stays 0 and
    their h 0: the first H units of the padded scan are the scan itself, and
    so are their gradients (differentiable: ``F.pad``)."""
    hidden = w_hh.shape[-2]
    extra = hidden_to - hidden

    def gates(t):
        t = t.reshape(*t.shape[:-1], 4, hidden)
        return F.pad(t, (0, extra)).reshape(*t.shape[:-2], 4 * hidden_to)

    return (F.pad(gates(w_hh), (0, 0, 0, extra)),
            *(gates(t) for t in gated))


def row_chunks(steps, n_dir, rows, width):
    """``[(start, stop), ...]``: the rows of a scan over ``(T, D, R, width)``
    tensors cut, in order, into the fewest equal chunks whose tensors each
    hold fewer than 2**31 floats; each row in exactly one chunk."""
    per_row = steps * n_dir * width
    most = (_INT_RANGE - 1) // per_row
    if most < 1:
        raise ValueError(f'lstm_scan: one row of T={steps} D={n_dir} x '
                         f'{width} passes the kernels\' int range')
    n_chunks = -(-rows // most)
    size = -(-rows // n_chunks)
    return [(lo, min(lo + size, rows)) for lo in range(0, rows, size)]


def fused_x_fits(feat, hidden):
    """Whether K3 and K4 (the projection inside the scan) take input width
    ``feat`` and hidden size ``hidden``: the route's rule. H at most 256,
    and 32 rows x (E + 6H) floats within a block's shared memory (E padded
    to a multiple of 4): the first K4's scan tile, kept as the rule so that
    every shape keeps its route; else the projection goes outside and
    K5/K6 run the scan, which take H up to 8192 and whose shared memory
    does not depend on E. What the kernels need is less and within it: K3
    and K4 have plans whose shared memory does not depend on E
    (:func:`fwd_plan`, :func:`bwd_plan`); every launch checks the
    library's own figures (``_check``)."""
    e_pad = feat + (-feat % 4)
    return hidden <= _MAX_HIDDEN_X \
        and 4 * _TILE_ROWS * (e_pad + 6 * hidden) <= _MAX_SMEM


def cluster_smem(hidden):
    """``(K5's, K6's)`` shared memory a block, in bytes, at ``hidden`` <= 256:
    the formulas ``cluster_fwd_floats`` and ``cluster_bwd_floats`` of
    csrc/lstm_scan.cuh. Block b of a cluster holds its ``(H, 4U)`` slice of
    w_hh (U = H / :data:`CLUSTER_BLOCKS` units, rows of H padded by 4
    floats); K5 h of the 32-row tile twice (by step parity) and its gates_x
    columns twice; K6 h[t-1], its gates_x columns, c[t], c[t-1], dh and
    dgates of its units, and two sets of :data:`CLUSTER_BLOCKS` dh_rec
    slots."""
    blocks = CLUSTER_BLOCKS
    units, ld, rows = hidden // blocks, hidden + _CLUSTER_PAD, _CLUSTER_ROWS
    fwd = 4 * units * ld + 2 * rows * ld + 2 * rows * 4 * units
    bwd = (4 * units * ld + rows * ld + rows * 4 * units + 3 * rows * units
           + rows * 4 * units + 2 * blocks * rows * units)
    return 4 * fwd, 4 * bwd


def scan_tile_rows(hidden):
    """``(rows, threads)`` of a K5/K6 row tile at 256 < ``hidden`` <= 8192
    (``tile_rows`` and ``Split`` of csrc/lstm_scan.cuh): 16 rows up to 512,
    then half as many each time H doubles, down to 1 row past 4096; a
    thread owns 8 rows and 2 units on tiles of 8 rows or more, else all
    the rows and 16 / rows units, so a block has at most 512 threads."""
    rows = next(r for r, top in ((16, 512), (8, 1024), (4, 2048), (2, 4096),
                                 (1, _MAX_HIDDEN)) if hidden <= top)
    if rows >= 8:
        return rows, rows // 8 * hidden // 2
    return rows, hidden * rows // 16


def scan_tile_smem(hidden):
    """``(K5's, K6's)`` shared memory a block, in bytes, at 256 < ``hidden``
    <= 8192, where they scan row tiles (``lstm_scan_tile_smem`` of
    csrc/lstm_scan.cuh for K6): K5 holds h of the tile, K6 h, dgates and
    dh_rec (6H floats a row), 196,608 bytes at H = 512, 1024, 2048, 4096
    and 8192."""
    rows = scan_tile_rows(hidden)[0]
    return 4 * rows * hidden, 4 * rows * 6 * hidden


def wgrad_split(pairs, tiles):
    """``(chunks, pairs a chunk)`` of the weight GEMM over ``pairs`` (t, r)
    pairs at ``tiles`` output tiles (all directions): the fewest chunks
    that give about 4 x 132 blocks, each at least 1024 pairs, a chunk a
    multiple of the k slice; the partials are summed in chunk order."""
    chunks = max(1, min(-(-4 * _SMS // tiles), -(-pairs // _WG_MIN_CHUNK)))
    chunk = -(-pairs // chunks)
    chunk = -(-chunk // _GEMM_SLICE) * _GEMM_SLICE
    return -(-pairs // chunk), chunk


def feature_step(dtype):
    """The multiple of which K3/K4 take E (the wrapper pads with zeros):
    16 on the bf16 route (the MMA depth), else 4 (float4 loads)."""
    return _SLICE_BF16 if dtype == torch.bfloat16 else 4


def fwd_plan(steps, n_dir, rows, feat, hidden, bf16=False):
    """K3's plan at ``(T, D, R, E, H)`` (E padded to :func:`feature_step`),
    as ``lstm_fwd_plan`` of csrc/lstm_scan.cu gives it: the tile rows (64
    where H <= 128 and 64-row tiles give the 132 SMs a block each, else
    32), the ring's k slice (16 rows of ``[w_ih; w_hh]`` at H <= 128, 8
    above), threads a block (4 rows x 4 units a thread), tiles a direction
    and shared memory a block: h of the tile transposed, ``(H, rows + 4)``
    floats, and the ring's 4 stages of ``(slice, rows + 4)`` x columns and
    ``(slice, 4H)`` weights. ``steps`` and ``feat`` do not change it.

    ``bf16``: K3-bf16's (``lstm_fwd_plan_bf16`` of csrc/lstm_scan_bf16.cu):
    the same tile rows, a 16-deep slice, 2H threads, and shared memory in
    bf16 with rows padded by 8: ``w_hh`` whole ``(H, 4H + 8)`` where H <=
    128, h of the tile ``(rows, H + 8)``, and 4 stages of ``(16, 4H + 8)``
    weight rows and ``(rows, 24)`` x columns."""
    tile = 64 if hidden <= 128 and n_dir * -(-rows // 64) >= _SMS else 32
    if bf16:
        pad = _PAD_BF16
        ld = 4 * hidden + pad
        held = hidden * ld if hidden <= _RESIDENT_MAX else 0
        stage = _SLICE_BF16 * ld + tile * (_SLICE_BF16 + pad)
        return {'rows': tile, 'slice': _SLICE_BF16, 'threads': 2 * hidden,
                'tiles': -(-rows // tile),
                'smem': 2 * (held + tile * (hidden + pad)
                             + _FWD_STAGES_BF16 * stage)}
    k = 16 if hidden <= 128 else 8
    ld = tile + 4
    return {'rows': tile, 'slice': k, 'threads': tile * hidden // 16,
            'tiles': -(-rows // tile),
            'smem': 4 * (hidden * ld + _FWD_RING * k * (ld + 4 * hidden))}


def bwd_plan(steps, n_dir, rows, feat, hidden, bf16=False):
    """K4's plan at ``(T, D, R, E, H)`` (E padded to :func:`feature_step`),
    as ``lstm_bwd_plan`` of csrc/lstm_scan.cu gives it: the reverse scan's
    tile rows (64 where H <= 128 and 64-row tiles give the 132 SMs a block
    each, else 32), rows a thread (4, or 2 on 32-row tiles at H <= 128),
    threads a block (8 units a thread), tiles a direction and shared
    memory a block (dgates of a step, transposed, with 4 floats of padding
    a column, and the ring of 4 w_hh^T chunks of 32 rows at H <= 128,
    else 16), and the weight GEMM's chunks and pairs a chunk.

    ``bf16``: K4-bf16's (``lstm_bwd_plan_bf16`` of
    csrc/lstm_scan_bf16.cu): the same but the scan's shared memory, in bf16
    with rows padded by 8: ``w_hh`` whole ``(H, 4H + 8)`` where H <= 128,
    else a ring of 4 chunks ``(H, 32 + 8)`` of its columns; dgates of a
    step ``(rows, 4H + 8)`` and dh_rec ``(rows, H + 8)``."""
    tile = 64 if hidden <= 128 and n_dir * -(-rows // 64) >= _SMS else 32
    per_thread = 4 if tile == 64 or hidden > 128 else 2
    gemm_tiles = (-(-(feat + hidden) // _GEMM_TILE) * (4 * hidden // _GEMM_TILE)
                  * n_dir)
    chunks, chunk = wgrad_split(steps * rows, gemm_tiles)
    if bf16:
        ld = 4 * hidden + _PAD_BF16
        held = (hidden * ld if hidden <= _RESIDENT_MAX else
                _RSCAN_RING_BF16 * hidden * (_RSCAN_CHUNK_BF16 + _PAD_BF16))
        smem = 2 * (held + tile * ld + tile * (hidden + _PAD_BF16))
    else:
        ring_rows = _RING * (32 if hidden <= 128 else 16)
        smem = 4 * (4 * hidden * (tile + 4) + ring_rows * hidden)
    return {'rows': tile, 'rows_a_thread': per_thread,
            'threads': tile // per_thread * (hidden // 8),
            'tiles': -(-rows // tile), 'smem': smem,
            'chunks': chunks, 'chunk': chunk}


def _cell(gates, c_prev):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _is_bf16(t):
    return t.dtype == torch.bfloat16


def _nonlin(fn, z):
    """``fn`` of a bfloat16 ``z`` in float32, rounded back to bfloat16
    (``_sig`` / ``_tanh`` of the Pallas kernels)."""
    return fn(z.float()).to(torch.bfloat16)


def _gates_bf16(pre):
    """``(i, f, g, o)`` of bfloat16 pre-activations, each nonlinearity in
    float32 and rounded."""
    i, f, g, o = pre.chunk(4, dim=-1)
    return (_nonlin(torch.sigmoid, i), _nonlin(torch.sigmoid, f),
            _nonlin(torch.tanh, g), _nonlin(torch.sigmoid, o))


def _cell_bf16(gates, c_prev):
    """The cell at the Pallas kernel's bfloat16 rounding points: every
    product and sum of ``c = f c_prev + i g`` and ``h = o tanh(c)`` rounded
    to bfloat16 (c carried in bfloat16)."""
    i, f, g, o = _gates_bf16(gates)
    c = f * c_prev + i * g
    return o * _nonlin(torch.tanh, c), c


def _product(a, w):
    """``a w``: float32 as is; bfloat16 operands multiplied and summed in
    float32 and rounded once (``jnp.dot(..., preferred_element_type=f32)
    .astype(bf16)``)."""
    if _is_bf16(a):
        return torch.matmul(a.float(), w.float()).to(torch.bfloat16)
    return torch.matmul(a, w)


def _projection(x_seq, w_ih, bias):
    """``x w_ih + bias`` for every step at once: ``(T, D, R, 4H)``. In
    bfloat16 as the projection-fused kernel forms it: the product summed
    in float32, the bias added in float32, one rounding."""
    if _is_bf16(x_seq):
        gx = torch.einsum('tdre,dek->tdrk', x_seq.float(), w_ih.float()) \
            + bias.float()[None, :, None, :]
        return gx.to(torch.bfloat16)
    return torch.einsum('tdre,dek->tdrk', x_seq, w_ih) + bias[None, :, None, :]


def _wsum(spec, a, b, dtype):
    """``einsum(spec, a, b)``: float32 as is; from bfloat16 operands summed
    in float32 and cast to ``dtype`` at the end, as the Pallas kernels'
    float32 accumulators (weight gradients) and products (dx) are."""
    if _is_bf16(a):
        return torch.einsum(spec, a.float(), b.float()).to(dtype)
    return torch.einsum(spec, a, b)


def lstm_scan_reference(gates_x, w_hh):
    """Plain forward of the gates-in scan, in ``rnn._lstm_scan_impl``'s
    order: ``(h_seq, c_seq)``, each ``(T, D, R, H)``. bfloat16 inputs take
    the Pallas kernel's rounding points (``_fwd_kernel``): ``gates =
    gates_x + bf16(h w_hh)`` added in bfloat16, then :func:`_cell_bf16`."""
    h = gates_x.new_zeros(w_hh.shape[0], gates_x.shape[2], w_hh.shape[1])
    c = torch.zeros_like(h)
    cell = _cell_bf16 if _is_bf16(gates_x) else _cell
    hs, cs = [], []
    for gx in gates_x:
        h, c = cell(gx + _product(h, w_hh), c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_bwd_plain(gates_x, w_hh, h_seq, c_seq, dh_seq):
    """Plain backward of the gates-in scan from the saved h and c, as
    ``rnn._lstm_scan_bwd``: ``(dgates, dw_hh)``. The gates of every step are
    recomputed in one product from ``h[t-1]``; a reverse loop carries (dh,
    dc). bfloat16 inputs take the Pallas kernel's rounding points
    (``_bwd_kernel``): the forward's gates, every product and sum of the
    do/dc/di/df/dg chain rounded, ``dh_rec = bf16(dgates w_hh^T)``, dW_hh
    summed in float32 and cast to w_hh's dtype."""
    bf16 = _is_bf16(gates_x)
    zero = torch.zeros_like(h_seq[:1])
    h_prev = torch.cat([zero, h_seq[:-1]])
    c_prev = torch.cat([zero, c_seq[:-1]])
    pre = gates_x + _product(h_prev, w_hh)
    if bf16:
        i, f, g, o = _gates_bf16(pre)
        tc = _nonlin(torch.tanh, c_seq)
    else:
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
            torch.sigmoid(o)
        tc = torch.tanh(c_seq)
    del pre
    w_hh_t = w_hh.transpose(-1, -2)
    dgates = dh_seq.new_empty(dh_seq.shape[:-1] + (w_hh.shape[-1],))
    dh_rec = torch.zeros_like(dh_seq[0])
    dc_rec = torch.zeros_like(dh_seq[0])
    for t in range(dh_seq.shape[0] - 1, -1, -1):
        dh = dh_seq[t] + dh_rec
        do = dh * tc[t] * o[t] * (1 - o[t])
        dc = dh * o[t] * (1 - tc[t] * tc[t]) + dc_rec
        di = dc * g[t] * i[t] * (1 - i[t])
        df = dc * c_prev[t] * f[t] * (1 - f[t])
        dg = dc * i[t] * (1 - g[t] * g[t])
        dgates[t] = torch.cat([di, df, dg, do], dim=-1)
        dh_rec = _product(dgates[t], w_hh_t)
        dc_rec = dc * f[t]
    return dgates, _wsum('tdrh,tdrk->dhk', h_prev, dgates, w_hh.dtype)


def lstm_scan_x_reference(x_seq, w_ih, bias, w_hh):
    """Plain forward: ``(h_seq, c_seq)``, each ``(T, D, R, H)``; bfloat16
    inputs at the rounding points of ``_fwd_x_kernel``."""
    return lstm_scan_reference(_projection(x_seq, w_ih, bias), w_hh)


def lstm_scan_x_bwd_plain(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    """Plain backward from the saved h and c: ``(dx, dw_ih, db, dw_hh)``:
    :func:`lstm_scan_bwd_plain` through the projection; bfloat16 inputs at
    the rounding points of ``_bwd_x_kernel`` (``dx = bf16(dgates
    w_ih^T)``, dW_ih and db summed in float32 and cast to the weights'
    dtype)."""
    dgates, dw_hh = lstm_scan_bwd_plain(_projection(x_seq, w_ih, bias), w_hh,
                                        h_seq, c_seq, dh_seq)
    dx = _wsum('tdrk,dek->tdre', dgates, w_ih, x_seq.dtype)
    dw_ih = _wsum('tdre,tdrk->dek', x_seq, dgates, w_ih.dtype)
    db = dgates.float().sum(dim=(0, 2)).to(bias.dtype) if _is_bf16(dgates) \
        else dgates.sum(dim=(0, 2))
    return dx, dw_ih, db, dw_hh


def _on_kernel_device(x):
    """Whether x's device takes the CUDA kernels (anything but the CPU,
    which takes the plain versions; a device without kernels raises in
    the launch)."""
    return x.device.type != 'cpu'


def _chunks(seq, w_hh):
    """The row chunks of a launch over ``seq (T, D, R, width)``
    (:func:`row_chunks`); ``[None]``, one launch of the whole, for a shape
    the launch will refuse anyway."""
    if seq.ndim != 4 or 0 in seq.shape or w_hh.ndim != 3:
        return [None]
    steps, n_dir, rows, width = seq.shape
    width = max(width + (-width % feature_step(seq.dtype)),
                4 * w_hh.shape[-2])
    return row_chunks(steps, n_dir, rows, width)


def _rows(t, rows):
    """Rows ``[start, stop)`` of a ``(T, D, R, ...)`` tensor, contiguous;
    the tensor itself for all of them."""
    if rows is None or rows == (0, t.shape[2]):
        return t
    return t[:, :, rows[0]:rows[1]].contiguous()


def _join(parts, n_row_outputs):
    """The outputs of the chunks' launches as one launch's: the first
    ``n_row_outputs`` (per-row tensors) concatenated on the row axis, the
    rest (weight gradients) summed in chunk order."""
    if len(parts) == 1:
        return parts[0]
    out = []
    for i, chunk_outs in enumerate(zip(*parts)):
        if i < n_row_outputs:
            out.append(torch.cat(chunk_outs, dim=2))
        else:
            # summed in float32 (the kernels' accumulators), in chunk order
            total = chunk_outs[0].float()
            for t in chunk_outs[1:]:
                total = total + t.float()
            out.append(total.to(chunk_outs[0].dtype))
    return tuple(out)


def lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh):
    """The forward with its cell states, ``(h_seq, c_seq)``: the plain
    version on the CPU, else K3 (counted in ``lstm_scan_x.launches``)."""
    if not _on_kernel_device(x_seq):
        return lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)
    parts = []
    for rows in _chunks(x_seq, w_hh):
        parts.append(_launch_fwd(_rows(x_seq, rows), w_ih, bias, w_hh))
        lstm_scan_x.launches += 1
        lstm_scan_x.launches_bf16 += _is_bf16(x_seq)
    return _join(parts, 2)


def lstm_scan_x_bwd(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    """The VJP ``(dx, dw_ih, db, dw_hh)``: the plain version on the CPU,
    else K4 (counted in ``lstm_scan_x_bwd.launches``)."""
    if not _on_kernel_device(x_seq):
        return lstm_scan_x_bwd_plain(x_seq, w_ih, bias, w_hh, h_seq, c_seq,
                                     dh_seq)
    parts = []
    for rows in _chunks(x_seq, w_hh):
        parts.append(_launch_bwd(_rows(x_seq, rows), w_ih, bias, w_hh,
                                 *(_rows(t, rows)
                                   for t in (h_seq, c_seq, dh_seq))))
        lstm_scan_x_bwd.launches += 1
        lstm_scan_x_bwd.launches_bf16 += _is_bf16(x_seq)
    return _join(parts, 1)


lstm_scan_x_bwd.launches = lstm_scan_x_bwd.launches_bf16 = 0


class LSTMScanXFunction(torch.autograd.Function):
    """The recurrence with its memory-lean VJP: saves x, h and c.
    ``apply(x_seq, w_ih, bias, w_hh, plain)``: with ``plain`` the plain
    versions on every device, else the kernels on CUDA."""

    @staticmethod
    def forward(ctx, x_seq, w_ih, bias, w_hh, plain):
        if plain:
            h_seq, c_seq = lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)
        else:
            h_seq, c_seq = lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh)
        ctx.plain = plain
        ctx.save_for_backward(x_seq, w_ih, bias, w_hh, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        bwd = lstm_scan_x_bwd_plain if ctx.plain else lstm_scan_x_bwd
        return (*bwd(*ctx.saved_tensors, dh_seq.contiguous()), None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_scan_x(x_seq, w_ih, bias, w_hh):
    """``h_seq (T, D, R, H)`` of the recurrence; differentiable through
    :class:`LSTMScanXFunction` when grad mode is on and an input requires
    grad, else the forward alone. A tensor on the CPU takes the plain
    versions; a CUDA tensor launches K3 (and K4 in the backward) or
    raises. ``lstm_scan_x.launches`` counts K3's calls (``launches_bf16``
    those on the bf16 route). On CUDA a hidden
    size off the kernels' grid is zero-padded to it (:func:`pad_hidden`)."""
    hidden = w_hh.shape[-2]
    if _on_kernel_device(x_seq) and hidden % _HIDDEN_STEP:
        w_hh, w_ih, bias = pad_hidden(kernel_hidden(hidden), w_hh, w_ih, bias)
        return lstm_scan_x(x_seq, w_ih, bias, w_hh)[..., :hidden]
    if _needs_grad(x_seq, w_ih, bias, w_hh):
        return LSTMScanXFunction.apply(x_seq, w_ih, bias, w_hh, False)
    return lstm_scan_x_fwd(x_seq, w_ih, bias, w_hh)[0]


lstm_scan_x.launches = lstm_scan_x.launches_bf16 = 0


def lstm_scan_x_plain(x_seq, w_ih, bias, w_hh):
    """The plain path on any device: :func:`lstm_scan_x_reference`, with
    the memory-lean plain backward under grad mode."""
    if _needs_grad(x_seq, w_ih, bias, w_hh):
        return LSTMScanXFunction.apply(x_seq, w_ih, bias, w_hh, True)
    return lstm_scan_x_reference(x_seq, w_ih, bias, w_hh)[0]


def lstm_scan_fwd(gates_x, w_hh):
    """The gates-in forward with its cell states, ``(h_seq, c_seq)``: the
    plain version on the CPU, else K5 (counted in ``lstm_scan.launches``)."""
    if not _on_kernel_device(gates_x):
        return lstm_scan_reference(gates_x, w_hh)
    parts = []
    for rows in _chunks(gates_x, w_hh):
        parts.append(_launch_scan_fwd(_rows(gates_x, rows), w_hh))
        lstm_scan.launches += 1
        lstm_scan.launches_bf16 += _is_bf16(gates_x)
    return _join(parts, 2)


def lstm_scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq):
    """The gates-in VJP ``(dgates, dw_hh)``: the plain version on the CPU,
    else K6 (counted in ``lstm_scan_bwd.launches``)."""
    if not _on_kernel_device(gates_x):
        return lstm_scan_bwd_plain(gates_x, w_hh, h_seq, c_seq, dh_seq)
    parts = []
    for rows in _chunks(gates_x, w_hh):
        parts.append(_launch_scan_bwd(
            _rows(gates_x, rows), w_hh,
            *(_rows(t, rows) for t in (h_seq, c_seq, dh_seq))))
        lstm_scan_bwd.launches += 1
        lstm_scan_bwd.launches_bf16 += _is_bf16(gates_x)
    return _join(parts, 1)


lstm_scan_bwd.launches = lstm_scan_bwd.launches_bf16 = 0


class LSTMScanFunction(torch.autograd.Function):
    """The gates-in recurrence with its memory-lean VJP: saves gates_x,
    w_hh, h and c. ``apply(gates_x, w_hh, plain)``: with ``plain`` the plain
    versions on every device, else the kernels on CUDA."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, plain):
        if plain:
            h_seq, c_seq = lstm_scan_reference(gates_x, w_hh)
        else:
            h_seq, c_seq = lstm_scan_fwd(gates_x, w_hh)
        ctx.plain = plain
        ctx.save_for_backward(gates_x, w_hh, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        bwd = lstm_scan_bwd_plain if ctx.plain else lstm_scan_bwd
        return (*bwd(*ctx.saved_tensors, dh_seq.contiguous()), None)


def lstm_scan(gates_x, w_hh):
    """``h_seq (T, D, R, H)`` of the gates-in recurrence; differentiable
    through :class:`LSTMScanFunction` when grad mode is on and an input
    requires grad, else the forward alone. A tensor on the CPU takes the
    plain versions; a CUDA tensor launches K5 (and K6 in the backward) or
    raises. ``lstm_scan.launches`` counts K5's calls (``launches_bf16``
    those on the bf16 route). On CUDA a hidden size
    off the kernels' grid is zero-padded to it (:func:`pad_hidden`)."""
    hidden = w_hh.shape[-2]
    if _on_kernel_device(gates_x) and hidden % _HIDDEN_STEP:
        w_hh, gates_x = pad_hidden(kernel_hidden(hidden), w_hh, gates_x)
        return lstm_scan(gates_x, w_hh)[..., :hidden]
    if _needs_grad(gates_x, w_hh):
        return LSTMScanFunction.apply(gates_x, w_hh, False)
    return lstm_scan_fwd(gates_x, w_hh)[0]


lstm_scan.launches = lstm_scan.launches_bf16 = 0


def lstm_scan_plain(gates_x, w_hh):
    """The plain gates-in path on any device: :func:`lstm_scan_reference`,
    with the memory-lean plain backward under grad mode."""
    if _needs_grad(gates_x, w_hh):
        return LSTMScanFunction.apply(gates_x, w_hh, True)
    return lstm_scan_reference(gates_x, w_hh)[0]


# ---------------------------------------------------------------------------
# the kernels


#: the kernels' routes: float32, and bfloat16 I/O
_DTYPES = (torch.float32, torch.bfloat16)


def _tensor(t, name, device, shape, what='lstm_scan_x', dtype=torch.float32):
    """Check one operand of a launch: on ``device``, of ``dtype`` (a call's
    operands share the input's dtype, float32 or bfloat16), contiguous, of
    ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{what}: {name} must be a tensor')
    if t.device != device:
        raise ValueError(f'{what}: {name} is on {t.device}, the input on '
                         f'{device}')
    if dtype not in _DTYPES:
        raise TypeError(f'{what}: the kernels take float32 or bfloat16, got '
                        f'{dtype}')
    if t.dtype != dtype:
        raise TypeError(f'{what}: {name} must be {dtype} as the input is, '
                        f'got {t.dtype}')
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f'{what}: {name} must be a contiguous {shape} '
                         f'tensor, got {tuple(t.shape)} with strides '
                         f'{t.stride()}')
    return t


def _check_hidden(hidden, what, most=_MAX_HIDDEN):
    """Raise unless the kernels take ``hidden``: a multiple of 32 up to
    ``most`` (8192 for K5/K6, 256 for K3/K4)."""
    if hidden % _HIDDEN_STEP or not _HIDDEN_STEP <= hidden <= most:
        beyond = (
            f'; at {_MAX_HIDDEN} K6\'s tile is one row, whose 6H floats of '
            f'state take {4 * 6 * _MAX_HIDDEN:,} bytes of shared memory '
            f'(a block has {_MAX_SMEM:,}), and its 512 threads own 16 units '
            'each: there is no smaller tile to go to'
            if hidden > _MAX_HIDDEN else '')
        raise NotImplementedError(
            f'{what}: the CUDA kernels take a hidden size that is a '
            f'multiple of 32 up to {most} ({what} pads a smaller one to the '
            f'grid), got {hidden}{beyond}')


def _check(x_seq, w_ih, bias, w_hh, lib, backward):
    """Check what the kernels take; returns ``(T, D, R, E, H)``."""
    device = x_seq.device
    if device.type != 'cuda':
        raise ValueError(f'lstm_scan_x: no kernel for device {device}')
    if x_seq.ndim != 4 or 0 in x_seq.shape:
        raise ValueError('lstm_scan_x: x must be a non-empty (T, D, R, E) '
                         f'tensor, got {tuple(x_seq.shape)}')
    steps, n_dir, rows, feat = x_seq.shape
    dtype = x_seq.dtype
    _tensor(x_seq, 'x', device, tuple(x_seq.shape), dtype=dtype)
    if w_hh.ndim != 3:
        raise ValueError('lstm_scan_x: w_hh must be (D, H, 4H), got '
                         f'{tuple(w_hh.shape)}')
    hidden = w_hh.shape[1]
    _tensor(w_hh, 'w_hh', device, (n_dir, hidden, 4 * hidden), dtype=dtype)
    _tensor(w_ih, 'w_ih', device, (n_dir, feat, 4 * hidden), dtype=dtype)
    _tensor(bias, 'bias', device, (n_dir, 4 * hidden), dtype=dtype)
    _check_hidden(hidden, 'lstm_scan_x', _MAX_HIDDEN_X)
    e_pad = feat + (-feat % feature_step(dtype))
    info = plan_info if backward else fwd_plan_info
    smem = info(steps, n_dir, rows, e_pad, hidden, _is_bf16(x_seq))['smem']
    if smem > _MAX_SMEM:
        raise NotImplementedError(
            f'lstm_scan_x: E={feat} with H={hidden} needs {smem} bytes of '
            f'shared memory a block, more than {_MAX_SMEM}')
    if steps * n_dir * rows * max(e_pad, 4 * hidden) >= _INT_RANGE:
        raise ValueError(f'lstm_scan_x: {tuple(x_seq.shape)} with H={hidden}'
                         ' passes the kernels\' int range')
    return steps, n_dir, rows, feat, hidden


#: K3's plan at each (D, R, H, bf16) checked so far: ``lstm_fwd_plan``'s
#: (``lstm_fwd_plan_bf16``'s on the bf16 route)
_fwd_plans = {}


def fwd_plan_info(steps, n_dir, rows, feat, hidden, bf16=False):
    """The library's K3 plan at ``(T, D, R, E, H)`` (E padded to
    :func:`feature_step`), keyed as :func:`fwd_plan`'s, on the bf16 route
    with ``bf16``; raises where it is not the wrapper's mirror."""
    key = (n_dir, rows, hidden, bf16)
    if key not in _fwd_plans:
        lib = build.load_library()
        shape = (steps, n_dir, rows, feat, hidden)
        entry = 'lstm_fwd_plan_bf16' if bf16 else 'lstm_fwd_plan'
        info = (ctypes.c_int * 5)()
        build.check(lib, getattr(lib, entry)(*shape, info), f'{entry}{shape}')
        out = dict(zip(('rows', 'slice', 'threads', 'tiles', 'smem'), info))
        want = fwd_plan(*shape, bf16)
        if out != want:
            raise RuntimeError(f'lstm_scan_x: the library\'s K3 plan at '
                               f'D={n_dir} R={rows} H={hidden} bf16={bf16} '
                               f'is {out}, the wrapper\'s {want}')
        _fwd_plans[key] = out
    return _fwd_plans[key]


#: K4's plan at each (T, D, R, E, H, bf16) checked so far:
#: ``lstm_bwd_plan``'s (``lstm_bwd_plan_bf16``'s on the bf16 route)
_plans = {}


def plan_info(steps, n_dir, rows, feat, hidden, bf16=False):
    """The library's K4 plan at ``(T, D, R, E, H)`` (E padded to
    :func:`feature_step`), keyed as :func:`bwd_plan`'s, on the bf16 route
    with ``bf16``; raises where it is not the wrapper's mirror."""
    key = (steps, n_dir, rows, feat, hidden)
    if key + (bf16,) not in _plans:
        lib = build.load_library()
        info = (ctypes.c_int * 7)()
        entry = 'lstm_bwd_plan_bf16' if bf16 else 'lstm_bwd_plan'
        build.check(lib, getattr(lib, entry)(*key, info), f'{entry}{key}')
        out = dict(zip(('rows', 'rows_a_thread', 'threads', 'tiles', 'smem',
                        'chunks', 'chunk'), info))
        want = bwd_plan(*key, bf16)
        if out != want:
            raise RuntimeError(f'lstm_scan_x: the library\'s K4 plan at '
                               f'{key} bf16={bf16} is {out}, the wrapper\'s '
                               f'{want}')
        _plans[key + (bf16,)] = out
    return _plans[key + (bf16,)]


def _aligned(*tensors):
    """The tensors with 16-byte aligned storage (the kernels load float4
    and float2): a view at another offset, such as a parameter in the
    trainer's flat buffer, is copied."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def _pad_feature(x_seq, w_ih):
    """Zero-pad E to :func:`feature_step` (float32: a multiple of 4, the
    kernels load x as float4; bf16: of 16, the MMA depth); padded columns
    add nothing to the projection or its gradients."""
    pad = -x_seq.shape[-1] % feature_step(x_seq.dtype)
    if pad:
        x_seq = torch.nn.functional.pad(x_seq, (0, pad))
        w_ih = torch.nn.functional.pad(w_ih, (0, 0, 0, pad))
    return x_seq, w_ih


def _launch_fwd(x_seq, w_ih, bias, w_hh, keep_gates=False):
    """K3 on one row chunk: ``(h_seq, c_seq)``; with ``keep_gates`` also
    the gate pre-activations K3 formed ``(T, D, R, 4H)``."""
    lib = build.load_library()
    steps, n_dir, rows, _, hidden = _check(x_seq, w_ih, bias, w_hh, lib,
                                           False)
    x_seq, w_ih = _pad_feature(x_seq, w_ih)
    x_seq, w_ih, bias, w_hh = _aligned(x_seq, w_ih, bias, w_hh)
    device = x_seq.device
    entry = 'lstm_fwd_gates' if keep_gates else 'lstm_fwd'
    with torch.cuda.device(device):
        h_seq = torch.empty(steps, n_dir, rows, hidden, dtype=x_seq.dtype,
                            device=device)
        c_seq = torch.empty_like(h_seq)
        args = [x_seq.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
                w_hh.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr()]
        if keep_gates:
            gates = torch.empty(steps, n_dir, rows, 4 * hidden,
                                dtype=x_seq.dtype, device=device)
            args.append(gates.data_ptr())
        build.check(lib, getattr(lib, entry)(
            *args, steps, n_dir, rows, x_seq.shape[-1], hidden,
            int(_is_bf16(x_seq)),
            torch.cuda.current_stream(device).cuda_stream), entry)
    return (h_seq, c_seq, gates) if keep_gates else (h_seq, c_seq)


def forward_gates(x_seq, w_ih, bias, w_hh):
    """K3 on a CUDA tensor, keeping what it formed: ``(h_seq, c_seq,
    gates)``, gates the pre-activations ``(T, D, R, 4H)`` of every step (a
    check's entry; not counted as a K3 launch)."""
    return _launch_fwd(x_seq, w_ih, bias, w_hh, keep_gates=True)


def recompute_gates(x_seq, w_ih, bias, w_hh, h_seq):
    """K4's first launch alone on a CUDA tensor: the gate pre-activations
    ``(T, D, R, 4H)`` it recomputes from the saved h, which are K3's bits
    (:func:`forward_gates`). Not counted as a K4 launch."""
    lib = build.load_library()
    steps, n_dir, rows, _, hidden = _check(x_seq, w_ih, bias, w_hh, lib,
                                           True)
    device = x_seq.device
    _tensor(h_seq, 'h_seq', device, (steps, n_dir, rows, hidden),
            dtype=x_seq.dtype)
    x_seq, w_ih = _pad_feature(x_seq, w_ih)
    x_seq, w_ih, bias, w_hh, h_seq = _aligned(x_seq, w_ih, bias, w_hh, h_seq)
    with torch.cuda.device(device):
        gates = torch.empty(steps, n_dir, rows, 4 * hidden,
                            dtype=x_seq.dtype, device=device)
        build.check(lib, lib.lstm_bwd_gates(
            x_seq.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
            w_hh.data_ptr(), h_seq.data_ptr(), gates.data_ptr(), steps,
            n_dir, rows, x_seq.shape[-1], hidden, int(_is_bf16(x_seq)),
            torch.cuda.current_stream(device).cuda_stream), 'lstm_bwd_gates')
    return gates


def _launch_bwd(x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq):
    lib = build.load_library()
    steps, n_dir, rows, feat, hidden = _check(x_seq, w_ih, bias, w_hh, lib,
                                              True)
    device, dtype = x_seq.device, x_seq.dtype
    for name, t in (('h_seq', h_seq), ('c_seq', c_seq), ('dh', dh_seq)):
        _tensor(t, name, device, (steps, n_dir, rows, hidden), dtype=dtype)
    x_seq, w_ih = _pad_feature(x_seq, w_ih)
    x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq = _aligned(
        x_seq, w_ih, bias, w_hh, h_seq, c_seq, dh_seq)
    e_pad = x_seq.shape[-1]
    with torch.cuda.device(device):
        # the weight gradients are float32 sums on both routes, cast to
        # the weights' dtype at the end (the Pallas kernel's accumulators)
        f32 = dict(dtype=torch.float32, device=device)
        # the float32 route reads the weights transposed too; the bf16
        # route's GEMMs read w_ih and w_hh themselves
        if _is_bf16(x_seq):
            w_ih_t, w_hh_t = w_ih, w_hh
        else:
            w_ih_t = w_ih.transpose(1, 2).contiguous()   # (D, 4H, E)
            w_hh_t = w_hh.transpose(1, 2).contiguous()   # (D, 4H, H)
        dx = torch.empty(steps, n_dir, rows, e_pad, dtype=dtype, device=device)
        dw = torch.empty(n_dir, e_pad + hidden, 4 * hidden, **f32)
        db = torch.empty(n_dir, 4 * hidden, **f32)
        work = torch.empty(lib.lstm_bwd_workspace(steps, n_dir, rows, e_pad,
                                                  hidden), **f32)
        build.check(lib, lib.lstm_bwd(
            x_seq.data_ptr(), w_ih.data_ptr(), w_ih_t.data_ptr(),
            bias.data_ptr(), w_hh.data_ptr(), w_hh_t.data_ptr(),
            h_seq.data_ptr(),
            c_seq.data_ptr(), dh_seq.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), work.data_ptr(), steps, n_dir,
            rows, e_pad, hidden, int(_is_bf16(x_seq)),
            torch.cuda.current_stream(device).cuda_stream), 'lstm_bwd')
    return (dx[..., :feat], dw[:, :feat].to(dtype), db.to(dtype),
            dw[:, e_pad:].to(dtype))


def _check_scan(gates_x, w_hh):
    """Check what K5 and K6 take; returns ``(T, D, R, H)``."""
    device = gates_x.device
    if device.type != 'cuda':
        raise ValueError(f'lstm_scan: no kernel for device {device}')
    if gates_x.ndim != 4 or 0 in gates_x.shape:
        raise ValueError('lstm_scan: gates_x must be a non-empty (T, D, R, '
                         f'4H) tensor, got {tuple(gates_x.shape)}')
    steps, n_dir, rows, gdim = gates_x.shape
    dtype = gates_x.dtype
    _tensor(gates_x, 'gates_x', device, tuple(gates_x.shape), 'lstm_scan',
            dtype)
    if w_hh.ndim != 3:
        raise ValueError('lstm_scan: w_hh must be (D, H, 4H), got '
                         f'{tuple(w_hh.shape)}')
    hidden = w_hh.shape[1]
    _tensor(w_hh, 'w_hh', device, (n_dir, hidden, 4 * hidden), 'lstm_scan',
            dtype)
    if gdim != 4 * hidden:
        raise ValueError(f'lstm_scan: gates_x has {gdim} gate columns, w_hh '
                         f'{4 * hidden}')
    _check_hidden(hidden, 'lstm_scan')
    if _is_bf16(gates_x) and hidden > _MAX_HIDDEN_X:
        raise NotImplementedError(
            f'lstm_scan: the bfloat16 route of K5/K6 runs on the clusters, '
            f'up to H = {_MAX_HIDDEN_X}, got {hidden}')
    if steps * n_dir * rows * 4 * hidden >= _INT_RANGE:
        raise ValueError(f'lstm_scan: {tuple(gates_x.shape)} passes the '
                         'kernels\' int range')
    if hidden > _MAX_HIDDEN_X:
        smem = build.load_library().lstm_scan_tile_smem(hidden)
        if smem != scan_tile_smem(hidden)[1] or smem > _MAX_SMEM:
            raise RuntimeError(
                f'lstm_scan: K6\'s shared memory at H={hidden} is {smem} '
                f'bytes in the library, {scan_tile_smem(hidden)[1]} in the '
                f'wrapper, against {_MAX_SMEM} a block')
    return steps, n_dir, rows, hidden


#: the cluster of K5/K6 at each H checked so far:
#: ``lstm_scan_cluster_info``'s numbers
_clusters = {}


def cluster_info(hidden):
    """The library's K5/K6 cluster at ``hidden`` <= 256: ``{'blocks',
    'smem_fwd', 'smem_bwd', 'threads', 'active_fwd', 'active_bwd'}``, the
    last two the clusters the card can hold at once. Raises where the
    cluster cannot be placed, or where the library's blocks or shared
    memory are not :data:`CLUSTER_BLOCKS` and :func:`cluster_smem`'s."""
    if hidden not in _clusters:
        lib = build.load_library()
        info = (ctypes.c_int * 6)()
        build.check(lib, lib.lstm_scan_cluster_info(hidden, info),
                    f'lstm_scan_cluster_info(H={hidden})')
        out = dict(zip(('blocks', 'smem_fwd', 'smem_bwd', 'threads',
                        'active_fwd', 'active_bwd'), info))
        if (out['blocks'], out['smem_fwd'], out['smem_bwd']) != (
                CLUSTER_BLOCKS, *cluster_smem(hidden)):
            raise RuntimeError(f'lstm_scan: the library\'s K5/K6 cluster at '
                               f'H={hidden} is {out}, the wrapper\'s '
                               f'{CLUSTER_BLOCKS} blocks and '
                               f'{cluster_smem(hidden)} bytes')
        if min(out['active_fwd'], out['active_bwd']) < 1 \
                or max(out['smem_fwd'], out['smem_bwd']) > _MAX_SMEM:
            raise RuntimeError(
                f'lstm_scan: the card cannot place a K5/K6 cluster at '
                f'H={hidden}: {out["blocks"]} blocks of {out["threads"]} '
                f'threads and {out["smem_fwd"]} / {out["smem_bwd"]} bytes '
                f'of shared memory; clusters at once: K5 '
                f'{out["active_fwd"]}, K6 {out["active_bwd"]}')
        _clusters[hidden] = out
    return _clusters[hidden]


def _launch_scan_fwd(gates_x, w_hh):
    lib = build.load_library()
    steps, n_dir, rows, hidden = _check_scan(gates_x, w_hh)
    if hidden <= _MAX_HIDDEN_X:
        cluster_info(hidden)
    gates_x, w_hh = _aligned(gates_x, w_hh)
    device = gates_x.device
    with torch.cuda.device(device):
        h_seq = torch.empty(steps, n_dir, rows, hidden, dtype=gates_x.dtype,
                            device=device)
        c_seq = torch.empty_like(h_seq)
        build.check(lib, lib.lstm_scan_fwd(
            gates_x.data_ptr(), w_hh.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr(), steps, n_dir, rows, hidden,
            int(_is_bf16(gates_x)),
            torch.cuda.current_stream(device).cuda_stream), 'lstm_scan_fwd')
    return h_seq, c_seq


def _launch_scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq):
    lib = build.load_library()
    steps, n_dir, rows, hidden = _check_scan(gates_x, w_hh)
    if hidden <= _MAX_HIDDEN_X:
        cluster_info(hidden)
    device, dtype = gates_x.device, gates_x.dtype
    for name, t in (('h_seq', h_seq), ('c_seq', c_seq), ('dh', dh_seq)):
        _tensor(t, name, device, (steps, n_dir, rows, hidden), 'lstm_scan',
                dtype)
    gates_x, w_hh, h_seq, c_seq, dh_seq = _aligned(gates_x, w_hh, h_seq,
                                                   c_seq, dh_seq)
    with torch.cuda.device(device):
        f32 = dict(dtype=torch.float32, device=device)
        # the row tiles read w_hh transposed (D, 4H, H); the clusters
        # hold their slices of w_hh itself
        w_hh_t = (w_hh.transpose(1, 2).contiguous() if hidden > _MAX_HIDDEN_X
                  else None)
        dgates = torch.empty(steps, n_dir, rows, 4 * hidden, dtype=dtype,
                             device=device)
        # a float32 sum on both routes, cast to w_hh's dtype at the end
        dw_hh = torch.empty(n_dir, hidden, 4 * hidden, **f32)
        work = torch.empty(lib.lstm_scan_bwd_workspace(steps, n_dir, rows,
                                                       hidden), **f32)
        build.check(lib, lib.lstm_scan_bwd(
            gates_x.data_ptr(), w_hh.data_ptr(),
            None if w_hh_t is None else w_hh_t.data_ptr(),
            h_seq.data_ptr(), c_seq.data_ptr(), dh_seq.data_ptr(),
            dgates.data_ptr(), dw_hh.data_ptr(), work.data_ptr(), steps,
            n_dir, rows, hidden, int(_is_bf16(gates_x)),
            torch.cuda.current_stream(device).cuda_stream), 'lstm_scan_bwd')
    return dgates, dw_hh.to(dtype)
