"""The elementwise-rate probe (K10): a chain of multiply-adds on every
element, in float32 or bfloat16; the plain version and the CUDA kernel.

Counterpart of ``_kernel`` in ``benchmarks/bench_vpu_dtype.py``: for each
element of ``x``, ``acc = x``, then ``passes * k / 2`` times ``acc = acc * x
+ x`` in ``x``'s own dtype. It asks whether the card's non-tensor pipes run
bfloat16 multiply-adds at twice the float32 rate
(:mod:`brever_tpu_torch.bench_alu_dtype` times it).

:func:`fma_chain` launches the kernel (``csrc/fma_chain.cu``: FFMA in
float32, HFMA2.BF16 on bfloat16 pairs) on a CUDA tensor and raises on any
other: the probe exists to time the card, so there is no CPU route behind
it. :func:`fma_chain_reference` is the plain version, two roundings a step
as the JAX kernel's ``acc * x + x``; the kernel's fused multiply-add rounds
once. :func:`fma_chain_limit` bounds how far the two may part, element by
element, from how the rounding error of each step grows down the chain.
"""

import torch

from . import build

#: the benchmark's chained steps a pass (two operations each) and passes
K, PASSES = 64, 8
#: elements of one 16-byte vector, the unit a kernel thread takes
_PER_VECTOR = {torch.float32: 4, torch.bfloat16: 8}
#: the relative error of one rounding to each dtype (half an ulp at 1)
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def fma_chain_reference(x, k=K, passes=PASSES):
    """Plain version: ``acc = x``, then ``passes * k // 2`` times ``acc =
    acc * x + x``, each product and sum rounded to ``x``'s dtype."""
    acc = x
    for _ in range(passes * (k // 2)):
        acc = acc * x + x
    return acc


def fma_chain_limit(x, k=K, passes=PASSES):
    """``(limit, margin)``, float64 tensors of ``x``'s shape.

    ``limit`` bounds ``|fma_chain(x) - fma_chain_reference(x)|`` at each
    element. With ``e_j`` the exact chain after ``j`` steps (float64) and
    ``u`` the dtype's unit roundoff, the fused step's value lies within
    ``|x| A_j + u (|e_j+1| + |x| A_j)`` of ``e_j+1`` and the plain step's,
    rounding the product and then the sum, within ``|x| B_j + u |x| (|e_j|
    + B_j) + u (1 + u) (|e_j+1| + |x| B_j)``; their sum ``D_j >= A_j + B_j``
    runs ``D_j+1 = |x| D_j + u |x| (|e_j| + D_j) + u (2 + u) (|e_j+1| + |x|
    D_j)`` from ``D_0 = 0``, and ``limit = D_n`` after ``n = passes * k //
    2`` steps.

    ``margin`` is ``|e_n - e_n-1| - 2 D_n - D_n-1``: where it is positive,
    a chain one step short lies further than ``limit`` from the plain chain,
    so a comparison that holds there tells ``n`` steps from ``n - 1`` (on an
    input whose chain has converged it does not)."""
    u = UNIT_ROUNDOFF[x.dtype]
    x = x.double()
    ax = x.abs()
    e, d = x, torch.zeros_like(x)
    margin = torch.full_like(x, -float('inf'))
    for _ in range(passes * (k // 2)):
        e_next = e * x + x
        d_next = ax * d + u * ax * (e.abs() + d) \
            + u * (2 + u) * (e_next.abs() + ax * d)
        margin = (e_next - e).abs() - 2 * d_next - d
        e, d = e_next, d_next
    return d, margin


def fma_chain(x, k=K, passes=PASSES):
    """The chain of every element of ``x``, float32 or bfloat16, contiguous,
    on a CUDA device, by K10 (counted in ``fma_chain.launches``); raises on
    a CPU tensor, another dtype or a shape the kernel does not take."""
    per_vector = _PER_VECTOR.get(x.dtype)
    if per_vector is None:
        raise TypeError(f'fma_chain: float32 or bfloat16, got {x.dtype}')
    if x.device.type != 'cuda':
        raise ValueError(f'fma_chain: no kernel for device {x.device}: the '
                         'probe times the card (fma_chain_reference is the '
                         'plain version)')
    if not x.is_contiguous() or x.numel() == 0 or x.numel() % per_vector:
        raise ValueError(f'fma_chain: x must be contiguous with a multiple '
                         f'of {per_vector} elements, got {tuple(x.shape)} '
                         f'with strides {x.stride()}')
    if k % 2 or k < 0 or passes < 0:
        raise ValueError(f'fma_chain: k must be even and k, passes at least '
                         f'0, got k={k} passes={passes}')
    lib = build.load_library()
    if x.data_ptr() % 16:
        x = x.clone()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        build.check(lib, lib.fma_chain(
            x.data_ptr(), out.data_ptr(), x.numel(), k, passes,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream), 'fma_chain')
    fma_chain.launches += 1
    return out


fma_chain.launches = 0
