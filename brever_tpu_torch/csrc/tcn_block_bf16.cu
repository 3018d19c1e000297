// The bf16 route of the TCN block forward and backward (K1-bf16, K2-bf16):
// their products on the bf16 tensor cores (mma.sync m16n8k16 with float32
// accumulators, mma_bf16.cuh's tc_gemm: 128 x 128 block tiles, a 4-stage
// cp.async ring of 32-deep k slices, fragments by ldmatrix), in their own
// translation unit so that nvcc compiles it beside the float32 routes. The
// launches between the products (the statistics, the gLN backward's
// elementwise passes and the fixed-order sums) are tcn_block.cu's and
// tcn_block_bwd.cu's kernels, K2's instantiated on bf16 storage; K1-bf16's
// depthwise stage is this file's own. Those files' C entries call this
// file's launchers.
//
// Replaces the Pallas TPU kernels brever_tpu/ops/pallas/tcn_block.py
// _fwd_kernel and _bwd_kernel/_bwd_kernel_rc on bf16 operands (the JAX
// package engages them only in bf16, under amp). Every product takes two
// bf16 operands at the Pallas kernel's own rounding points:
//
//   K1-bf16  z1 = x W_in^T + b_in (tcn_in_mma; h1 and its 128 x 128 tile's
//            moments in float32 from the accumulators); the depthwise
//            stage, its h2 rounded to bf16 where it is stored
//            (dw_prelu_stats_bf16, 4 channels a thread); the output
//            product [res | skip] = bf16(h2) bf16(W hs2)^T + (cv2 W^T + b)
//            (+ x), hs2 = g2 rstd2 and cv2 = be2 - mean2 hs2 of the batch
//            row, the weights folded once a block and row (tcn_fold_w:
//            B (C + Cs) H bf16 and the float32 biases) and multiplied by
//            the depthwise stage's bf16 h2 (tcn_out_mma).
//   K2-bf16  z1 again (tcn_bwd_z1_mma, the same device routine as K1's:
//            K2's z1 is K1's bit for bit); gy2 = [g_res | g_skip] [W_res;
//            W_skip] with the column sums of gy2 h2 and gy2 (tcn_bwd_gy2_mma);
//            [dW_res; dW_skip] = hs2 (g^T bf16(h2)) + cv2 (sum g) over
//            (row, time chunk) partials (tcn_bwd_wout_mma); dx = bf16(gz1)
//            W_in (+ g_res) (tcn_bwd_dx_mma); dW_in = bf16(gz1)^T x
//            (tcn_bwd_win_mma).
//
// Each product's k16 chunks are summed in ascending order from 0, each
// chunk's mma from a zero accumulator added in float32 (tc_gemm's kSplit:
// a running tensor-core accumulator drifts toward zero, which the bias
// gradients' cancelling sums turned into a dB against float64), then the
// bias is added: a change of order against the SIMT route moves float32
// sums, and nothing else. h2 and gz1 are stored
// as bf16 (the values the products round them to, half the bytes) in rows
// of ld(H) = H rounded up to 8 elements, the pads zero, so that every
// cp.async piece of them is a whole aligned 16 bytes. A row of x, the
// cotangents or a weight off that grid (C, H or Cs not a multiple of 8, a
// ragged tile edge) is staged piece by piece through registers
// (tc::piece); nothing is padded in the wrapper, and h1's and h2's
// moments count only the H columns.
//
// Bound on this card: the products are 25.2 GFLOP a K1 call and 58.7 a K2
// call at B=16, T=3999, C=Cs=128, H=512 (0.026 and 0.059 ms at 989
// TFLOP/s); the intermediates that cross device memory between the
// launches (h1, and K2's z1, z2, gy2, gy1 in float32, h2 and gz1 in bf16)
// are what is left once the products are on the tensor cores (PERF.md).

#include "mma_bf16.cuh"
#include "tcn_common.cuh"

namespace {

using tc::bf16;
using tc::kTcLdK;
using tc::kTcLdW;
using tc::kTcSmem;
using tc::kTcThreads;
using tc::kTcTile;
using tcn::cdiv;
using tcn::prelu;

constexpr int kLdBf16 = 8;  // the bf16 h2, gz1 and folded weights' rows: a multiple of this

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }

int set_tc_smem(const void* kernel) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem));
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// The thread's two staged rows of an [m][k] operand: rows (tid / 4) and
// 64 + that of the tile, piece tid % 4 of each 32-deep slice
__device__ __forceinline__ int staged_row(int q) { return (threadIdx.x >> 2) + 64 * q; }

// stage s's [m][k] pieces of the rows row[q] (null: zeros), k < kmax
__device__ __forceinline__ void stage_rows(bf16* S, int s, const bf16* const* row, int kmax) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = threadIdx.x & 3;
    tc::piece(S + staged_row(q) * kTcLdK + p * 8, row[q], s * tc::kTcSlice + p * 8, kmax);
  }
}

// stage s's [k][n] pieces: src(k) is the source row of slice row k (null:
// zeros), its columns n0 .. n0 + 127 of nmax
template <class Src>
__device__ __forceinline__ void stage_cols(bf16* S, int s, Src src, int n0, int nmax) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = threadIdx.x + q * kTcThreads, k = i >> 4, col = (i & 15) * 8;
    tc::piece(S + k * kTcLdW + col, src(s * tc::kTcSlice + k), n0 + col, nmax);
  }
}

// acc as float32 rows of out (the row of tile row r: row_of(r), null for
// none), columns n0 .. of n_max: pairs where the rows are even
template <class RowOf>
__device__ __forceinline__ void store_f32(const tc::Acc& acc, RowOf row_of, int n0, int n_max) {
  if (n_max % 2 == 0)
    tc::tc_store<float>(acc, row_of, n0, n_max);
  else
    tc::tc_store_any<float>(acc, row_of, n0, n_max);
}

// acc as bf16 rows: whole 128-byte lines through shared memory where the
// rows are on the 8-element grid, else one value at a time
template <class RowOf>
__device__ __forceinline__ void store_bf16(const tc::Acc& acc, RowOf row_of, int n0, int n_max,
                                           bf16* sm) {
  if (n_max % 8 == 0)
    tc::tc_store_staged(acc, row_of, n0, n_max, sm);
  else
    tc::tc_store_any<bf16>(acc, row_of, n0, n_max);
}

// acc[mi][ni][e] += add(tile row, tile column) where both exist
template <class Add>
__device__ __forceinline__ void add_each(tc::Acc& acc, Add add) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = add(tc::tc_row(mi, e), tc::tc_col(ni, e), acc[mi][ni][e]);
}

// ---------------------------------------------------------------------------
// z1 = x W_in^T + b_in, K1's and K2's: A [m][k] the rows of x (T, C), B
// [n][k] the rows of W_in (H, C); k16 chunks from 0 ascending, then + the
// bias. The one routine both kernels call, so K2's z1 is K1's bit for bit.

struct Z1Op {
  const bf16 *xrow[2], *wrow[2];
  int C;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    stage_rows(As, s, xrow, C);
    stage_rows(Bs, s, wrow, C);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// the block's 128 x 128 tile of z1 for batch row blockIdx.z, grid
// (cdiv(T, 128), cdiv(H, 128), B)
__device__ __forceinline__ void z1_tile_mma(tc::Acc& acc, const bf16* __restrict__ x,
                                            const bf16* __restrict__ w_in,
                                            const bf16* __restrict__ b_in, int T, int C, int H,
                                            bf16* sm) {
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  Z1Op op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + staged_row(q), n = n0 + staged_row(q);
    op.xrow[q] = m < T ? x + (static_cast<size_t>(blockIdx.z) * T + m) * C : nullptr;
    op.wrow[q] = n < H ? w_in + static_cast<size_t>(n) * C : nullptr;
  }
  op.C = C;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  tc::tc_gemm<false, false, true>(op, acc, cdiv(C, 16), sm);
  add_each(acc, [&](int, int col, float v) {
    return n0 + col < H ? v + f(b_in[n0 + col]) : v;
  });
}

// ---------------------------------------------------------------------------
// K1-bf16

// h1 = PReLU(z1) (float32) and the tile's (count, mean, M2) of h1 into
// part[b][tile], as tcn_block.cu's tcn_in_gemm writes them
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_in_mma(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
           const bf16* __restrict__ b_in, const bf16* __restrict__ alpha, float* __restrict__ h1,
           float* __restrict__ part, int T, int C, int H) {
  extern __shared__ float smem[];
  __shared__ float red[tcn::kThreads / 32];
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * T;
  tc::Acc acc;
  z1_tile_mma(acc, x, w_in, b_in, T, C, H, reinterpret_cast<bf16*>(smem));
  const float a1 = f(alpha[0]);
  add_each(acc, [&](int, int, float v) { return prelu(v, a1); });
  store_f32(acc, [&](int r) -> float* {
    return m0 + r < T ? h1 + (row0 + m0 + r) * H : nullptr;
  }, n0, H);
  const int n_part = gridDim.x * gridDim.y;
  const float count = static_cast<float>(min(kTcTile, T - m0) * min(kTcTile, H - n0));
  tcn::tile_moments<64>(
      [&](int i) { return acc[i / 16][(i / 4) % 4][i % 4]; },
      [&](int i) {
        return m0 + tc::tc_row(i / 16, i % 4) < T && n0 + tc::tc_col((i / 4) % 4, i % 4) < H;
      },
      count, red,
      part + 3 * (static_cast<size_t>(blockIdx.z) * n_part + blockIdx.x * gridDim.y + blockIdx.y));
}

// The depthwise stage: h2 = PReLU(dw_k3(y1, d) + b_dw) of y1 = (h1 - mean1)
// rstd1 g1 + be1 normalised on load (zero outside [0, T): the conv pads
// after the norm), each value formed in float32 as the float32 route's
// dw_prelu_stats forms it, stored rounded to bf16 in rows of ld (the pad
// columns zeros); the (count, mean, M2) of the float32 values of the
// kDwRows x kDwCols tile into part2[b][tile], the partials
// tcn_dw_partials counts. A thread takes 4 neighbouring channels (one
// float4 of h1 a step where H is a multiple of 4, kVec) of 4 rows, 8 rows
// apart. grid (cdiv(T, kDwRows), cdiv(H, kDwCols), B)
template <bool kVec>
__global__ void __launch_bounds__(tcn::kThreads)
dw_prelu_stats_bf16(const float* __restrict__ h1, const float* __restrict__ stats,
                    const bf16* __restrict__ g1, const bf16* __restrict__ be1,
                    const bf16* __restrict__ w_dw, const bf16* __restrict__ b_dw,
                    const bf16* __restrict__ alpha, bf16* __restrict__ h2, int ld,
                    float* __restrict__ part2, int T, int H, int d) {
  constexpr int kGroups = tcn::kThreads / (tcn::kDwCols / 4), kPer = tcn::kDwRows / kGroups;
  __shared__ float red[tcn::kThreads / 32];
  const int b = blockIdx.z, c0 = blockIdx.y * tcn::kDwCols, t0 = blockIdx.x * tcn::kDwRows;
  const int c = c0 + 4 * (threadIdx.x % (tcn::kDwCols / 4)), r = threadIdx.x / (tcn::kDwCols / 4);
  const int ne = max(0, min(4, H - c));  // the channels that exist
  const float mean = stats[4 * b], rstd = stats[4 * b + 1], a2 = f(alpha[0]);
  float g[4] = {}, be[4] = {}, w0[4] = {}, w1[4] = {}, w2[4] = {}, bd[4] = {};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < ne) {
      g[e] = f(g1[c + e]);
      be[e] = f(be1[c + e]);
      w0[e] = f(w_dw[c + e]);
      w1[e] = f(w_dw[H + c + e]);
      w2[e] = f(w_dw[2 * H + c + e]);
      bd[e] = f(b_dw[c + e]);
    }
  const float* hb = h1 + static_cast<size_t>(b) * T * H + c;
  auto y1 = [&](int t, float (&y)[4]) {
    float v[4] = {};
    if (t >= 0 && t < T && ne > 0) {
      const float* p = hb + static_cast<size_t>(t) * H;
      if constexpr (kVec) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < ne) v[e] = p[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = (t >= 0 && t < T && e < ne) ? (v[e] - mean) * rstd * g[e] + be[e] : 0.f;
  };
  float v[4 * kPer];
  bool ok[4 * kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = t0 + r + kGroups * i;
    float ym[4], y0[4], yp[4], z[4];
    y1(t - d, ym);
    y1(t, y0);
    y1(t + d, yp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      z[e] = ym[e] * w0[e] + y0[e] * w1[e] + yp[e] * w2[e] + bd[e];
      z[e] = e < ne ? (z[e] >= 0.f ? z[e] : a2 * z[e]) : 0.f;
      v[4 * i + e] = z[e];
      ok[4 * i + e] = t < T && e < ne;
    }
    if (t < T && c < ld)
      simt::st4(h2 + (static_cast<size_t>(b) * T + t) * ld + c, z[0], z[1], z[2], z[3]);
  }
  const int n_part = gridDim.x * gridDim.y;
  const float count = static_cast<float>(min(tcn::kDwRows, T - t0) * min(tcn::kDwCols, H - c0));
  tcn::tile_moments<4 * kPer>([&](int i) { return v[i]; }, [&](int i) { return ok[i]; }, count,
                              red,
                              part2 + 3 * (static_cast<size_t>(b) * n_part +
                                           blockIdx.x * gridDim.y + blockIdx.y));
}

// The output weights with the gLN2 affine folded in, once a block and
// batch row: wf[b][n][k] = bf16(W[n][k] hs2[k]) (k < H, zeros to ld), and
// fb[b][n] = sum_k cv2[k] W[n][k] + bias[n] (a fixed-order block sum), n
// over the rows of W_res (n_res of them) then W_skip. grid (n_res + Cs, B)
__global__ void __launch_bounds__(tcn::kThreads)
tcn_fold_w(const float* __restrict__ stats, const bf16* __restrict__ g2,
           const bf16* __restrict__ be2, const bf16* __restrict__ w_res,
           const bf16* __restrict__ b_res, const bf16* __restrict__ w_skip,
           const bf16* __restrict__ b_skip, bf16* __restrict__ wf, float* __restrict__ fb, int H,
           int ld, int n_res) {
  __shared__ float red[tcn::kThreads / 32];
  const int b = blockIdx.y, n = blockIdx.x, M = gridDim.x;
  const bool res = n < n_res;
  const bf16* w = res ? w_res + static_cast<size_t>(n) * H
                      : w_skip + static_cast<size_t>(n - n_res) * H;
  const float mean = stats[4 * b + 2], rstd = stats[4 * b + 3];
  bf16* out = wf + (static_cast<size_t>(b) * M + n) * ld;
  float cv = 0.f;
  for (int k = threadIdx.x; k < ld; k += tcn::kThreads) {
    float v = 0.f;
    if (k < H) {
      const float wk = f(w[k]), hs = f(g2[k]) * rstd;
      cv += (f(be2[k]) - mean * hs) * wk;
      v = wk * hs;
    }
    out[k] = __float2bfloat16_rn(v);
  }
  cv = tcn::block_sum(cv, red);
  if (threadIdx.x == 0) fb[static_cast<size_t>(b) * M + n] = cv + f(res ? b_res[n] : b_skip[n - n_res]);
}

struct OutOp {
  const bf16 *hrow[2], *wrow[2];
  int ld;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    stage_rows(As, s, hrow, ld);
    stage_rows(Bs, s, wrow, ld);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// [res | skip] = h2 wf[b]^T + fb[b] (+ x), h2 the depthwise stage's bf16
// (B, T, ld). grid (cdiv(T, 128), cdiv(n_res, 128) + cdiv(Cs, 128), B):
// the column tiles of res, then those of skip
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_out_mma(const bf16* __restrict__ h2, const bf16* __restrict__ wf,
            const float* __restrict__ fb, const bf16* __restrict__ x, bf16* __restrict__ res,
            bf16* __restrict__ skip, int T, int ld, int C, int Cs, int n_res) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, m0 = blockIdx.x * kTcTile, mr = cdiv(n_res, kTcTile);
  const bool is_res = static_cast<int>(blockIdx.y) < mr;
  const int n0 = (is_res ? blockIdx.y : blockIdx.y - mr) * kTcTile, N = is_res ? n_res : Cs;
  const int M = n_res + Cs, row_off = is_res ? 0 : n_res;
  const size_t row0 = static_cast<size_t>(b) * T;
  OutOp op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + staged_row(q), n = n0 + staged_row(q);
    op.hrow[q] = m < T ? h2 + (row0 + m) * ld : nullptr;
    op.wrow[q] = n < N ? wf + (static_cast<size_t>(b) * M + row_off + n) * ld : nullptr;
  }
  op.ld = ld;
  tc::Acc acc = {};
  tc::tc_gemm<false, false, true>(op, acc, cdiv(ld, 16), reinterpret_cast<bf16*>(smem));
  // the sum, then the folded bias, then (res) x + that
  const float* fbr = fb + static_cast<size_t>(b) * M + row_off;
  add_each(acc, [&](int row, int col, float v) {
    const int t = m0 + row, n = n0 + col;
    if (n >= N) return v;
    v = v + fbr[n];
    return is_res && t < T ? f(x[(row0 + t) * C + n]) + v : v;
  });
  bf16* out = is_res ? res : skip;
  store_bf16(acc, [&](int r) -> bf16* {
    return m0 + r < T ? out + (row0 + m0 + r) * N : nullptr;
  }, n0, N, reinterpret_cast<bf16*>(smem));
}

// ---------------------------------------------------------------------------
// K2-bf16

// z1 (float32) alone: K2's first launch
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_bwd_z1_mma(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
               const bf16* __restrict__ b_in, float* __restrict__ z1, int T, int C, int H) {
  extern __shared__ float smem[];
  const int m0 = blockIdx.x * kTcTile;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * T;
  tc::Acc acc;
  z1_tile_mma(acc, x, w_in, b_in, T, C, H, reinterpret_cast<bf16*>(smem));
  store_f32(acc, [&](int r) -> float* {
    return m0 + r < T ? z1 + (row0 + m0 + r) * H : nullptr;
  }, blockIdx.y * kTcTile, H);
}

// gy2 = [g_res | g_skip] [W_res; W_skip]: A [m][k] the k16 chunks of g_res
// (zeros past C), then those of g_skip; B [k][n] the rows of W_res, then
// of W_skip
struct Gy2Op {
  const bf16 *rrow[2], *srow[2];
  const bf16 *w_res, *w_skip;
  int n_res, Cs, H, nr, n0;  // nr: k16 chunks of g_res

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = threadIdx.x & 3, c = 2 * s + (p >> 1), off = (p & 1) * 8;
      bf16* dst = As + staged_row(q) * kTcLdK + p * 8;
      if (c < nr)
        tc::piece(dst, rrow[q], c * 16 + off, n_res);
      else
        tc::piece(dst, srow[q], (c - nr) * 16 + off, Cs);
    }
    stage_cols(Bs, s, [&](int k) -> const bf16* {
      const int c = k >> 4, kr = (c < nr ? c : c - nr) * 16 + (k & 15);
      if (c < nr) return kr < n_res ? w_res + static_cast<size_t>(kr) * H : nullptr;
      return kr < Cs ? w_skip + static_cast<size_t>(kr) * H : nullptr;
    }, n0, H);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// gy2 (float32) and the tile's column sums of gy2 h2 and gy2 into
// part[b][tile][2][H] (h2 = PReLU(z2) in float32). grid (cdiv(T, 128),
// cdiv(H, 128), B)
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_bwd_gy2_mma(const bf16* __restrict__ g_res, const bf16* __restrict__ g_skip,
                const bf16* __restrict__ w_res, const bf16* __restrict__ w_skip,
                const float* __restrict__ z2, const bf16* __restrict__ a2,
                float* __restrict__ gy2, float* __restrict__ part, int T, int H, int C, int Cs,
                int n_res) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  const size_t row0 = static_cast<size_t>(b) * T;
  Gy2Op op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + staged_row(q);
    op.rrow[q] = n_res && m < T ? g_res + (row0 + m) * C : nullptr;
    op.srow[q] = m < T ? g_skip + (row0 + m) * Cs : nullptr;
  }
  op.w_res = w_res;
  op.w_skip = w_skip;
  op.n_res = n_res;
  op.Cs = Cs;
  op.H = H;
  op.nr = cdiv(n_res, 16);
  op.n0 = n0;
  tc::Acc acc = {};
  tc::tc_gemm<false, true, true>(op, acc, op.nr + cdiv(Cs, 16), reinterpret_cast<bf16*>(smem));
  store_f32(acc, [&](int r) -> float* {
    return m0 + r < T ? gy2 + (row0 + m0 + r) * H : nullptr;
  }, n0, H);
  // the column sums: the thread's 8 rows of each of its 8 columns, then the
  // 8 lanes that share them (lanes l % 4), then the two warps of a column
  // (rows 0-63, 64-127), in a fixed order
  const float alpha = f(a2[0]);
  float s_gh[4][2] = {}, s_g[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + tc::tc_row(mi, 2 * h);
      if (t >= T) continue;
      const float* zr = z2 + (row0 + t) * H;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + tc::tc_col(ni, 0);
        float z[2] = {};
        if (H % 2 == 0 && n < H) {
          const float2 q = *reinterpret_cast<const float2*>(zr + n);
          z[0] = q.x, z[1] = q.y;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < H) z[e] = zr[n + e];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= H) continue;
          const float g = acc[mi][ni][2 * h + e];
          s_gh[ni][e] += g * prelu(z[e], alpha);
          s_g[ni][e] += g;
        }
      }
    }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s_gh[ni][e] += __shfl_xor_sync(0xffffffffu, s_gh[ni][e], off);
        s_g[ni][e] += __shfl_xor_sync(0xffffffffu, s_g[ni][e], off);
      }
  float* red = smem;  // [2 sums][2 row halves][128 columns], free after the stores' barrier
  __syncthreads();
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (l < 4) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tc::tc_col(ni, e);
        red[(w / 4) * kTcTile + col] = s_gh[ni][e];
        red[(2 + w / 4) * kTcTile + col] = s_g[ni][e];
      }
  }
  __syncthreads();
  const int q = threadIdx.x / kTcTile, col = threadIdx.x % kTcTile;
  if (n0 + col < H)
    part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 + q) * H + n0 + col] =
        red[(2 * q) * kTcTile + col] + red[(2 * q + 1) * kTcTile + col];
}

// [dW_res; dW_skip] partials over one (row, chunk) of time: A [k][m] g's
// rows t at columns m0 .. (g_res or g_skip), B [k][n] h2's (bf16, ld);
// the threads tid < 128 also sum g's column m0 + tid from the staged A
// (db, t ascending)
struct WoutOp {
  const bf16 *g, *h2;
  int ld_g, m_max, kc, ld, n0;
  float db = 0.f;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    stage_cols(As, s, [&](int t) -> const bf16* {
      return t < kc ? g + static_cast<size_t>(t) * ld_g : nullptr;
    }, 0, m_max);
    stage_cols(Bs, s, [&](int t) -> const bf16* {
      return t < kc ? h2 + static_cast<size_t>(t) * ld : nullptr;
    }, n0, ld);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16* Bs, int kk) {
    if (threadIdx.x >= kTcTile) return;
    const bf16* As = Bs - tc::kTcOperand;
#pragma unroll
    for (int k = 0; k < 16; ++k) db += f(As[(kk + k) * kTcLdW + threadIdx.x]);
  }
};

// part[z][m][n] = hs2[n] (g^T h2)[m][n] + cv2[n] db[m] over chunk z (the
// TPU kernel's dW = hs2 (h2_bf16^T g) + cv2 sum g, a chunk's share); the
// blocks of column tile 0 also write part_db[z][m] = db[m]. grid
// (cdiv(n_res, 128) + cdiv(Cs, 128), cdiv(H, 128), B chunks)
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_bwd_wout_mma(const bf16* __restrict__ g_res, const bf16* __restrict__ g_skip,
                 const bf16* __restrict__ h2, const float* __restrict__ stats,
                 const bf16* __restrict__ g2, const bf16* __restrict__ be2,
                 float* __restrict__ part, float* __restrict__ part_db, int T, int H, int ld,
                 int C, int Cs, int n_res, int chunks, int chunk) {
  extern __shared__ float smem[];
  const int b = blockIdx.z / chunks, tc0 = (blockIdx.z % chunks) * chunk;
  const int mr = cdiv(n_res, kTcTile), M = n_res + Cs;
  const bool res = static_cast<int>(blockIdx.x) < mr;
  const int m0 = (res ? blockIdx.x : blockIdx.x - mr) * kTcTile, n0 = blockIdx.y * kTcTile;
  const int row_off = res ? 0 : n_res;
  const size_t row0 = static_cast<size_t>(b) * T + tc0;
  WoutOp op;
  op.ld_g = res ? C : Cs;
  op.m_max = (res ? n_res : Cs) - m0;
  op.g = (res ? g_res : g_skip) + row0 * op.ld_g + m0;
  op.h2 = h2 + row0 * ld;
  op.kc = min(chunk, T - tc0);
  op.ld = ld;
  op.n0 = n0;
  tc::Acc acc = {};
  tc::tc_gemm<true, true, true>(op, acc, cdiv(op.kc, 16), reinterpret_cast<bf16*>(smem));
  float* db = smem;  // free once every warp is past the k loop
  __syncthreads();
  if (threadIdx.x < kTcTile) db[threadIdx.x] = op.db;
  __syncthreads();
  const float mean = stats[4 * b + 2], rstd = stats[4 * b + 3];
  add_each(acc, [&](int row, int col, float v) {
    const int n = n0 + col;
    if (n >= H) return v;
    const float hs = f(g2[n]) * rstd, cv = f(be2[n]) - mean * hs;
    return hs * v + cv * db[row];
  });
  float* out = part + (static_cast<size_t>(blockIdx.z) * M + row_off + m0) * H;
  store_f32(acc, [&](int r) -> float* {
    return r < op.m_max ? out + static_cast<size_t>(r) * H : nullptr;
  }, n0, H);
  if (blockIdx.y == 0 && static_cast<int>(threadIdx.x) < min(kTcTile, op.m_max))
    part_db[static_cast<size_t>(blockIdx.z) * M + row_off + m0 + threadIdx.x] = op.db;
}

// dx = gz1 W_in: A [m][k] the rows of bf16 gz1 (ld), B [k][n] the rows of
// W_in (H, C)
struct DxOp {
  const bf16* grow[2];
  const bf16* w;
  int ld, H, C, n0;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    stage_rows(As, s, grow, ld);
    stage_cols(Bs, s, [&](int k) -> const bf16* {
      return k < H ? w + static_cast<size_t>(k) * C : nullptr;
    }, n0, C);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// dx (+ g_res) rounded to bf16. grid (cdiv(T, 128), cdiv(C, 128), B)
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_bwd_dx_mma(const bf16* __restrict__ gz1, const bf16* __restrict__ w_in,
               const bf16* __restrict__ g_res, bf16* __restrict__ dx, int T, int H, int ld,
               int C) {
  extern __shared__ float smem[];
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * T;
  DxOp op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + staged_row(q);
    op.grow[q] = m < T ? gz1 + (row0 + m) * ld : nullptr;
  }
  op.w = w_in;
  op.ld = ld;
  op.H = H;
  op.C = C;
  op.n0 = n0;
  tc::Acc acc = {};
  tc::tc_gemm<false, true, true>(op, acc, cdiv(ld, 16), reinterpret_cast<bf16*>(smem));
  if (g_res)
    add_each(acc, [&](int row, int col, float v) {
      const int t = m0 + row, n = n0 + col;
      return t < T && n < C ? v + f(g_res[(row0 + t) * C + n]) : v;
    });
  store_bf16(acc, [&](int r) -> bf16* {
    return m0 + r < T ? dx + (row0 + m0 + r) * C : nullptr;
  }, n0, C, reinterpret_cast<bf16*>(smem));
}

// dW_in partials: A [k][m] gz1's rows t at columns m0 .. (ld), B [k][n]
// x's rows t at columns n0 .. (C)
struct WinOp {
  const bf16 *g, *x;
  int ld, C, kc, m0, n0;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    stage_cols(As, s, [&](int t) -> const bf16* {
      return t < kc ? g + static_cast<size_t>(t) * ld : nullptr;
    }, m0, ld);
    stage_cols(Bs, s, [&](int t) -> const bf16* {
      return t < kc ? x + static_cast<size_t>(t) * C : nullptr;
    }, n0, C);
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// part[z][h][c] = sum_t gz1[t][h] x[t][c] over one (row, chunk) z. grid
// (cdiv(H, 128), cdiv(C, 128), B chunks)
__global__ void __launch_bounds__(kTcThreads, 2)
tcn_bwd_win_mma(const bf16* __restrict__ gz1, const bf16* __restrict__ x,
                float* __restrict__ part, int T, int H, int ld, int C, int chunks, int chunk) {
  extern __shared__ float smem[];
  const int b = blockIdx.z / chunks, tc0 = (blockIdx.z % chunks) * chunk;
  const size_t row0 = static_cast<size_t>(b) * T + tc0;
  WinOp op;
  op.g = gz1 + row0 * ld;
  op.x = x + row0 * C;
  op.ld = ld;
  op.C = C;
  op.kc = min(chunk, T - tc0);
  op.m0 = blockIdx.x * kTcTile;
  op.n0 = blockIdx.y * kTcTile;
  tc::Acc acc = {};
  tc::tc_gemm<true, true, true>(op, acc, cdiv(op.kc, 16), reinterpret_cast<bf16*>(smem));
  float* out = part + static_cast<size_t>(blockIdx.z) * H * C;
  store_f32(acc, [&](int r) -> float* {
    return op.m0 + r < H ? out + static_cast<size_t>(op.m0 + r) * C : nullptr;
  }, op.n0, C);
}

// the launch of kernel on grid with kTcSmem bytes of shared memory
template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t s, Args... args) {
  const int err = set_tc_smem(reinterpret_cast<const void*>(kernel));
  if (err) return err;
  kernel<<<grid, kTcThreads, kTcSmem, s>>>(args...);
  return last_error();
}

}  // namespace

namespace tcn_bf16 {

int ld(int H) { return cdiv(H, kLdBf16) * kLdBf16; }

int in_mma(const bf16* x, const bf16* w_in, const bf16* b_in, const bf16* a1, float* h1,
           float* part, int B, int T, int C, int H, cudaStream_t s) {
  return launch(tcn_in_mma, dim3(cdiv(T, kTcTile), cdiv(H, kTcTile), B), s, x, w_in, b_in, a1,
                h1, part, T, C, H);
}

int z1(const bf16* x, const bf16* w_in, const bf16* b_in, float* z1, int B, int T, int C, int H,
       cudaStream_t s) {
  return launch(tcn_bwd_z1_mma, dim3(cdiv(T, kTcTile), cdiv(H, kTcTile), B), s, x, w_in, b_in,
                z1, T, C, H);
}

int dw(const float* h1, const float* stats, const bf16* g1, const bf16* be1, const bf16* w_dw,
       const bf16* b_dw, const bf16* a2, bf16* h2, float* part2, int B, int T, int H, int d,
       cudaStream_t s) {
  const dim3 grid(cdiv(T, tcn::kDwRows), cdiv(H, tcn::kDwCols), B);
  if (H % 4 == 0)
    dw_prelu_stats_bf16<true><<<grid, tcn::kThreads, 0, s>>>(h1, stats, g1, be1, w_dw, b_dw, a2,
                                                            h2, ld(H), part2, T, H, d);
  else
    dw_prelu_stats_bf16<false><<<grid, tcn::kThreads, 0, s>>>(h1, stats, g1, be1, w_dw, b_dw, a2,
                                                             h2, ld(H), part2, T, H, d);
  return last_error();
}

int fold(const float* stats, const bf16* g2, const bf16* be2, const bf16* w_res,
         const bf16* b_res, const bf16* w_skip, const bf16* b_skip, bf16* wf, float* fb, int B,
         int H, int n_res, int Cs, cudaStream_t s) {
  tcn_fold_w<<<dim3(n_res + Cs, B), tcn::kThreads, 0, s>>>(stats, g2, be2, w_res, b_res, w_skip,
                                                          b_skip, wf, fb, H, ld(H), n_res);
  return last_error();
}

int out_mma(const bf16* h2, const bf16* wf, const float* fb, const bf16* x, bf16* res,
            bf16* skip, int B, int T, int H, int C, int Cs, int n_res, cudaStream_t s) {
  return launch(tcn_out_mma,
                dim3(cdiv(T, kTcTile), cdiv(n_res, kTcTile) + cdiv(Cs, kTcTile), B), s, h2, wf,
                fb, x, res, skip, T, ld(H), C, Cs, n_res);
}

int gy2(const bf16* g_res, const bf16* g_skip, const bf16* w_res, const bf16* w_skip,
        const float* z2, const bf16* a2, float* gy2, float* part, int B, int T, int H, int C,
        int Cs, int n_res, cudaStream_t s) {
  return launch(tcn_bwd_gy2_mma, dim3(cdiv(T, kTcTile), cdiv(H, kTcTile), B), s, g_res, g_skip,
                w_res, w_skip, z2, a2, gy2, part, T, H, C, Cs, n_res);
}

int wout(const bf16* g_res, const bf16* g_skip, const bf16* h2, const float* stats,
         const bf16* g2, const bf16* be2, float* part, float* part_db, int B, int T, int H, int C,
         int Cs, int n_res, int chunks, int chunk, cudaStream_t s) {
  return launch(tcn_bwd_wout_mma,
                dim3(cdiv(n_res, kTcTile) + cdiv(Cs, kTcTile), cdiv(H, kTcTile), B * chunks), s,
                g_res, g_skip, h2, stats, g2, be2, part, part_db, T, H, ld(H), C, Cs, n_res,
                chunks, chunk);
}

int dx(const bf16* gz1, const bf16* w_in, const bf16* g_res, bf16* dx, int B, int T, int H, int C,
       cudaStream_t s) {
  return launch(tcn_bwd_dx_mma, dim3(cdiv(T, kTcTile), cdiv(C, kTcTile), B), s, gz1, w_in, g_res,
                dx, T, H, ld(H), C);
}

int win(const bf16* gz1, const bf16* x, float* part, int B, int T, int H, int C, int chunks,
        int chunk, cudaStream_t s) {
  return launch(tcn_bwd_win_mma, dim3(cdiv(H, kTcTile), cdiv(C, kTcTile), B * chunks), s, gz1, x,
                part, T, H, ld(H), C, chunks, chunk);
}

}  // namespace tcn_bf16

extern "C" {

// The row of K1-bf16's and K2-bf16's bf16 h2, gz1 and folded weights at
// hidden width H (elements): H rounded up to kLdBf16
int tcn_bf16_ld(int H) { return tcn_bf16::ld(H); }

}  // extern "C"
