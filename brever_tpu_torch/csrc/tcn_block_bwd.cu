// Conv-TasNet TCN block backward (flash-TCN VJP) for NVIDIA Hopper, float32.
//
// Replaces the Pallas TPU kernels brever_tpu/ops/pallas/tcn_block.py
// _bwd_kernel and _bwd_kernel_rc (launched by _bwd_pallas; the _rc variant
// exists only for a Mosaic VMEM limit, one design covers both here). From x,
// the cotangents g_res (absent on the last block) and g_skip, and the four
// gLN scalars per batch row that the forward saved (stats (B, 4) = mean1,
// rstd1, mean2, rstd2; tcn_block.cu), it computes dx and the 14 parameter
// gradients of the block
//
//   z1 = x W_in^T + b_in,  h1 = PReLU(z1),  y1 = gLN(h1) g1 + be1
//   z2 = depthwise_k3(y1, d) + b_dw,  h2 = PReLU(z2),  y2 = gLN(h2) g2 + be2
//   res = x + y2 W_res^T + b_res,  skip = y2 W_skip^T + b_skip.
//
// Bound: GEMM work, about 58.7 GFLOP at B=16, T=3999, C=Cs=128, H=512
// (gy2 = g [W_res; W_skip], dx = gz1 W_in, dW_in, dW_res, dW_skip and the
// recompute of z1: 2 B T H (C + 2 (C + Cs) + 2 C) flops), plus a few
// (B, T, H) f32 round trips through device memory of 131 MB each. The
// Pallas kernel keeps four (T, H) f32 rows in VMEM; an SM has 227 KB and
// blocks run in no order, so the backward splits at the two gLN-backward
// reduction barriers, as the forward splits at its two:
//
//   1. z1:        GEMM x W_in^T + b_in -> z1 (h1 = PReLU(z1) is recomputed
//                 where it is read, from the same bits the forward made).
//   2. z2:        depthwise over y1 normalised on load with the saved stats
//                 (zero outside [0, T), which also covers d >= T) -> z2.
//   3. gy2:       GEMM [g_res | g_skip] [W_res; W_skip] (K = C + Cs) -> gy2;
//                 the epilogue writes per-tile column sums of gy2 h2 and gy2.
//   4. merge2:    per row: dg2, dbe2 and the gLN2-backward scalars
//                 A2 = rstd2 s2a / N, B2 = rstd2^2 s2b / N (N = T H).
//   5. gz2:       gz2 = PReLU'(z2) (hs2 gy2 - A2 - B2 (h2 - mean2)), in
//                 place of gy2; partials of da2 and of dw_dw, db_dw (y1
//                 normalised on load).
//   6. wgrad_out: [dW_res; dW_skip] = g^T y2, y2 normalised on load, split
//                 over (row, 1024-step chunk); run before z2 is overwritten.
//   7. gy1:       transposed depthwise gy1[t] = w0 gz2[t+d] + w1 gz2[t]
//                 + w2 gz2[t-d], into z2's buffer; partials of gy1 h1, gy1.
//   8. merge1:    per row: dg1, dbe1, A1, B1.
//   9. gz1:       gz1 = PReLU'(z1) (hs1 gy1 - A1 - B1 (h1 - mean1)), in
//                 place of z1; partials of da1 and db_in.
//  10. dx:        GEMM gz1 W_in (+ g_res).
//  11. wgrad_in:  dW_in = gz1^T x, split like 6.
//  12. colsum:    partials of db_res, db_skip = column sums of g.
//  13. reduce:    every parameter gradient sums its partials in a fixed
//                 order (no float atomics): two runs on the same inputs give
//                 bitwise-equal gradients.
//
// The PReLU slopes' gradients da = sum gh min(z, 0) add ~8M terms at
// B=16 that cancel: by up to 7e5 times in the sum of their magnitudes on
// random inputs at T = 3999, so a float32 sum of them keeps few digits.
// They are summed in double; and the gLN backward keeps the centred form
// gh = hs gy - A - B (h - mean) (hs = g rstd), because the Pallas kernel's
// fold hs gy + b_s h + c_s (_gh_fold) subtracts two large terms whose
// rounding, the same on every element, adds up in that sum.
//
// Scratch is one float32 workspace (tcn_bwd_workspace floats) that the
// caller allocates: z1, z2 and gy2 of (B, T, H) each and the partials.
// SIMT f32 tiles, like the forward; wgmma, TMA and bf16 are later work.
//
// Every pointer is a dense float32 buffer; 2-D weights are in the torch
// Linear storage (out, in): W_in (H, C), W_res (C, H), W_skip (Cs, H).

#include "tcn_common.cuh"

namespace {

using namespace tcn;

constexpr int kEwRows = 64;    // elementwise tile: time rows (= kBM, one
                               // partial per 64 rows in every stage)
constexpr int kEwCols = 128;   // elementwise tile: channels
constexpr int kEwGroups = kThreads / kEwCols;  // row groups per tile
constexpr int kChunk = 1024;   // weight-gradient split: time steps a block
constexpr int kColRows = 256;  // column-sum split: time steps a block

}  // namespace

extern "C" {

// Everything one backward call reads and writes. Outputs and the
// workspace are written whole; nothing needs zeroing.
struct TcnBwdArgs {
  const float *x, *g_res, *g_skip, *stats;
  const float *w_in, *b_in, *a1, *g1, *be1, *w_dw, *b_dw, *a2, *g2, *be2, *w_res, *w_skip;
  float* dx;      // (B, T, C)
  float* dw_in;   // (H, C)
  float* db_in;   // (H)
  float* da;      // (2): da1, da2
  float* dgb1;    // (2, H): dg1, dbe1
  float* dwb_dw;  // (4, H): dw_dw taps 0..2, db_dw
  float* dgb2;    // (2, H): dg2, dbe2
  float* dw_out;  // (n_res + Cs, H): dW_res rows, then dW_skip rows
  float* db_out;  // (n_res + Cs): db_res, then db_skip
  float* work;    // tcn_bwd_workspace(B, T, C, H, Cs, last) floats
  int B, T, C, H, Cs, last, dilation;
};

}  // extern "C"

namespace {

// z1 = x W_in^T + b_in. grid (cdiv(T, kBM), cdiv(H, kBN), B)
__global__ void __launch_bounds__(kThreads)
bwd_z1(const float* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ bias, float* __restrict__ z1, int T, int C, int H) {
  const int b = blockIdx.z, t0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* xb = x + static_cast<size_t>(b) * T * C;
  float acc[4][4] = {};
  gemm_tile<true, true>(
      acc, C,
      [&](int m, int k) {
        const int t = t0 + m;
        return (t < T && k < C) ? xb[static_cast<size_t>(t) * C + k] : 0.f;
      },
      [&](int k, int n) {
        n += n0;
        return (k < C && n < H) ? w[n * C + k] : 0.f;
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      // the same sum, then bias, as the forward's epilogue: z1 is bitwise
      // the forward's
      if (t < T && n < H) z1[(static_cast<size_t>(b) * T + t) * H + n] = acc[i][j] + bias[n];
    }
  }
}

// The normalised input of a gLN, zero outside [0, T) (the depthwise conv
// pads after the norm).
struct NormOnLoad {
  const float* z;  // (T, H) pre-activation of one batch row
  int T, H;
  float alpha, mean, rstd;
  __device__ float operator()(int t, int c, float g, float be) const {
    if (t < 0 || t >= T) return 0.f;
    return (prelu(z[static_cast<size_t>(t) * H + c], alpha) - mean) * rstd * g + be;
  }
};

// z2 = depthwise(y1) + b_dw, with y1 normalised from z1 on load.
// grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
__global__ void __launch_bounds__(kThreads)
bwd_z2(const float* __restrict__ z1, const float* __restrict__ stats,
       const float* __restrict__ a1, const float* __restrict__ g1,
       const float* __restrict__ be1, const float* __restrict__ w_dw,
       const float* __restrict__ b_dw, float* __restrict__ z2, int T, int H, int d) {
  const int b = blockIdx.z, c = blockIdx.y * kEwCols + threadIdx.x % kEwCols;
  if (c >= H) return;  // no barrier in this kernel
  const NormOnLoad y1{z1 + static_cast<size_t>(b) * T * H, T, H, *a1, stats[4 * b],
                      stats[4 * b + 1]};
  const float g = g1[c], be = be1[c], w0 = w_dw[c], w1 = w_dw[H + c], w2 = w_dw[2 * H + c],
              bd = b_dw[c];
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  for (int t = t0 + threadIdx.x / kEwCols; t < t_end; t += kEwGroups) {
    // the forward's expression and order: z2 is bitwise the forward's
    z2[(static_cast<size_t>(b) * T + t) * H + c] =
        y1(t - d, c, g, be) * w0 + y1(t, c, g, be) * w1 + y1(t + d, c, g, be) * w2 + bd;
  }
}

// gy2 = [g_res | g_skip] [W_res; W_skip]; per-tile column sums of gy2 h2
// and gy2 into part[b][tile][2][H]. grid (cdiv(T, kBM), cdiv(H, kBN), B)
__global__ void __launch_bounds__(kThreads)
bwd_gy2(const float* __restrict__ g_res, const float* __restrict__ g_skip,
        const float* __restrict__ w_res, const float* __restrict__ w_skip,
        const float* __restrict__ z2, const float* __restrict__ a2,
        float* __restrict__ gy2, float* __restrict__ part, int T, int H, int C, int Cs,
        int n_res) {
  __shared__ float red[2][16][kBN];
  const int b = blockIdx.z, t0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int K = n_res + Cs;
  const float* grb = n_res ? g_res + static_cast<size_t>(b) * T * C : nullptr;
  const float* gsb = g_skip + static_cast<size_t>(b) * T * Cs;
  float acc[4][4] = {};
  gemm_tile<true, false>(
      acc, K,
      [&](int m, int k) {
        const int t = t0 + m;
        if (t >= T || k >= K) return 0.f;
        const float* p = k < n_res ? grb + static_cast<size_t>(t) * C + k
                                   : gsb + static_cast<size_t>(t) * Cs + (k - n_res);
        return *p;
      },
      [&](int k, int n) {
        n += n0;
        if (k >= K || n >= H) return 0.f;
        const float* w = k < n_res ? w_res + static_cast<size_t>(k) * H
                                   : w_skip + static_cast<size_t>(k - n_res) * H;
        return w[n];
      });

  const float alpha = *a2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s_gh[4] = {}, s_g[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (t < T && n < H) {
        const size_t o = (static_cast<size_t>(b) * T + t) * H + n;
        const float g = acc[i][j];
        gy2[o] = g;
        s_gh[j] += g * prelu(z2[o], alpha);
        s_g[j] += g;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = s_gh[j];
    red[1][ty][tx + 16 * j] = s_g[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kBN) {
    const int q = threadIdx.x / kBN, col = threadIdx.x % kBN, n = n0 + col;
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += red[q][y][col];
    if (n < H) part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 + q) * H + n] = s;
  }
}

// Per batch row: merge the tile partials (sum gy h, sum gy) of a gLN
// backward into dgb[b] = (dg, dbe) (H each) and the scalars fold[b] =
// (A, B) of gh = hs gy - A - B (h - mean). grid (B)
__global__ void __launch_bounds__(kThreads)
bwd_row_merge(const float* __restrict__ part, int n_tiles, const float* __restrict__ stats,
              int slot, const float* __restrict__ gamma, float* __restrict__ dgb,
              float* __restrict__ fold, int H, float inv_n) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  const float mean = stats[4 * b + 2 * slot], rstd = stats[4 * b + 2 * slot + 1];
  const float* pb = part + static_cast<size_t>(b) * n_tiles * 2 * H;
  float sa = 0.f, sb = 0.f;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float gh = 0.f, g = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      gh += pb[(2 * i) * H + h];
      g += pb[(2 * i + 1) * H + h];
    }
    const float dg = rstd * (gh - mean * g);
    dgb[(2 * static_cast<size_t>(b)) * H + h] = dg;
    dgb[(2 * static_cast<size_t>(b) + 1) * H + h] = g;
    sa += gamma[h] * g;
    sb += gamma[h] * dg;
  }
  sa = block_sum(sa, red);
  sb = block_sum(sb, red);
  if (threadIdx.x == 0) {
    fold[2 * b] = rstd * inv_n * sa;
    fold[2 * b + 1] = rstd * rstd * inv_n * sb;
  }
}

// Column partials of one elementwise tile: the kEwGroups row groups of a
// column combine in a fixed order; returns on row group 0 only.
template <int N>
__device__ bool combine_groups(float (&s)[N], float (*red)[kEwCols]) {
  const int col = threadIdx.x % kEwCols, grp = threadIdx.x / kEwCols;
  for (int g = 1; g < kEwGroups; ++g) {
    __syncthreads();
    if (grp == g)
      for (int q = 0; q < N; ++q) red[q][col] = s[q];
    __syncthreads();
    if (grp == 0)
      for (int q = 0; q < N; ++q) s[q] += red[q][col];
  }
  return grp == 0;
}

// gz2 = PReLU'(z2) (hs2 gy2 - A2 - B2 (h2 - mean2)), written over gy2.
// Partials:
// part[b][tile][4][H] = sum gz2 y1[t-d], sum gz2 y1[t], sum gz2 y1[t+d],
// sum gz2; part_a[b][tile][ctile] = sum gh2 min(z2, 0), in double.
// grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
__global__ void __launch_bounds__(kThreads)
bwd_gz2(const float* __restrict__ z1, const float* __restrict__ z2, float* __restrict__ gy,
        const float* __restrict__ stats, const float* __restrict__ fold2,
        const float* __restrict__ a1, const float* __restrict__ g1,
        const float* __restrict__ be1, const float* __restrict__ a2,
        const float* __restrict__ g2, float* __restrict__ part,
        double* __restrict__ part_a, int T, int H, int d) {
  __shared__ double red[kThreads / 32];
  __shared__ float cred[4][kEwCols];
  const int b = blockIdx.z, c = blockIdx.y * kEwCols + threadIdx.x % kEwCols;
  const bool c_ok = c < H;
  const NormOnLoad y1{z1 + static_cast<size_t>(b) * T * H, T, H, *a1, stats[4 * b],
                      stats[4 * b + 1]};
  const float alpha = *a2, fa = fold2[2 * b], fb = fold2[2 * b + 1], mean2 = stats[4 * b + 2];
  float g = 0.f, be = 0.f, hs2 = 0.f;
  if (c_ok) {
    g = g1[c];
    be = be1[c];
    hs2 = g2[c] * stats[4 * b + 3];
  }
  float s[4] = {};
  double sa = 0.0;
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if (c_ok) {
    for (int t = t0 + threadIdx.x / kEwCols; t < t_end; t += kEwGroups) {
      const size_t o = (static_cast<size_t>(b) * T + t) * H + c;
      const float z = z2[o];
      const float gh = hs2 * gy[o] - fa - fb * (prelu(z, alpha) - mean2);
      const float gz = z >= 0.f ? gh : alpha * gh;
      gy[o] = gz;
      sa += gh * fminf(z, 0.f);
      s[0] += gz * y1(t - d, c, g, be);
      s[1] += gz * y1(t, c, g, be);
      s[2] += gz * y1(t + d, c, g, be);
      s[3] += gz;
    }
  }
  if (combine_groups(s, cred) && c_ok) {
    for (int q = 0; q < 4; ++q)
      part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 4 + q) * H + c] = s[q];
  }
  sa = block_sum(sa, red);
  if (threadIdx.x == 0)
    part_a[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y] = sa;
}

// Weight gradient of the output projections, one (row, chunk) of time per
// block in z: part[z][m][n] = sum_t g[t][m] y2[t][n] over the chunk, with
// g = [g_res | g_skip] and y2 normalised from z2 on load.
// grid (cdiv(n_res + Cs, kBM), cdiv(H, kBN), B * chunks)
__global__ void __launch_bounds__(kThreads)
bwd_wgrad_out(const float* __restrict__ g_res, const float* __restrict__ g_skip,
              const float* __restrict__ z2, const float* __restrict__ stats,
              const float* __restrict__ a2, const float* __restrict__ g2,
              const float* __restrict__ be2, float* __restrict__ part, int T, int H, int C,
              int Cs, int n_res, int chunks) {
  const int b = blockIdx.z / chunks, tc = (blockIdx.z % chunks) * kChunk;
  const int kc = min(kChunk, T - tc), M = n_res + Cs;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* grb = n_res ? g_res + (static_cast<size_t>(b) * T + tc) * C : nullptr;
  const float* gsb = g_skip + (static_cast<size_t>(b) * T + tc) * Cs;
  const float* zb = z2 + (static_cast<size_t>(b) * T + tc) * H;
  const float alpha = *a2, mean = stats[4 * b + 2], rstd = stats[4 * b + 3];
  float acc[4][4] = {};
  gemm_tile<false, false>(
      acc, kc,
      [&](int m, int k) {
        m += m0;
        if (m >= M || k >= kc) return 0.f;
        const float* p = m < n_res ? grb + static_cast<size_t>(k) * C + m
                                   : gsb + static_cast<size_t>(k) * Cs + (m - n_res);
        return *p;
      },
      [&](int k, int n) {
        n += n0;
        if (k >= kc || n >= H) return 0.f;
        return (prelu(zb[static_cast<size_t>(k) * H + n], alpha) - mean) * rstd * g2[n] + be2[n];
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = part + static_cast<size_t>(blockIdx.z) * M * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < H) out[static_cast<size_t>(m) * H + n] = acc[i][j];
    }
  }
}

// gy1[t] = w0 gz2[t+d] + w1 gz2[t] + w2 gz2[t-d] (gz2 zero outside [0, T)),
// written into gy1; partials part[b][tile][2][H] = sum gy1 h1, sum gy1.
// grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
__global__ void __launch_bounds__(kThreads)
bwd_gy1(const float* __restrict__ gz2, const float* __restrict__ z1,
        const float* __restrict__ a1, const float* __restrict__ w_dw,
        float* __restrict__ gy1, float* __restrict__ part, int T, int H, int d) {
  __shared__ float cred[2][kEwCols];
  const int b = blockIdx.z, c = blockIdx.y * kEwCols + threadIdx.x % kEwCols;
  const bool c_ok = c < H;
  const float alpha = *a1;
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  if (c_ok) {
    w0 = w_dw[c];
    w1 = w_dw[H + c];
    w2 = w_dw[2 * H + c];
  }
  const float* gb = gz2 + static_cast<size_t>(b) * T * H;
  auto gz = [&](int t) { return (t >= 0 && t < T) ? gb[static_cast<size_t>(t) * H + c] : 0.f; };
  float s[2] = {};
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if (c_ok) {
    for (int t = t0 + threadIdx.x / kEwCols; t < t_end; t += kEwGroups) {
      const size_t o = (static_cast<size_t>(b) * T + t) * H + c;
      const float g = w0 * gz(t + d) + w1 * gz(t) + w2 * gz(t - d);
      gy1[o] = g;
      s[0] += g * prelu(z1[o], alpha);
      s[1] += g;
    }
  }
  if (combine_groups(s, cred) && c_ok) {
    for (int q = 0; q < 2; ++q)
      part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 + q) * H + c] = s[q];
  }
}

// gz1 = PReLU'(z1) (hs1 gy1 - A1 - B1 (h1 - mean1)), written over z1.
// Partials:
// part[b][tile][H] = sum gz1 (db_in); part_a[b][tile][ctile] =
// sum gh1 min(z1, 0) in double. grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
__global__ void __launch_bounds__(kThreads)
bwd_gz1(const float* __restrict__ gy1, float* __restrict__ z1, const float* __restrict__ stats,
        const float* __restrict__ fold1, const float* __restrict__ a1,
        const float* __restrict__ g1, float* __restrict__ part, double* __restrict__ part_a,
        int T, int H) {
  __shared__ double red[kThreads / 32];
  __shared__ float cred[1][kEwCols];
  const int b = blockIdx.z, c = blockIdx.y * kEwCols + threadIdx.x % kEwCols;
  const bool c_ok = c < H;
  const float alpha = *a1, fa = fold1[2 * b], fb = fold1[2 * b + 1], mean1 = stats[4 * b];
  const float hs1 = c_ok ? g1[c] * stats[4 * b + 1] : 0.f;
  float s[1] = {};
  double sa = 0.0;
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if (c_ok) {
    for (int t = t0 + threadIdx.x / kEwCols; t < t_end; t += kEwGroups) {
      const size_t o = (static_cast<size_t>(b) * T + t) * H + c;
      const float z = z1[o];
      const float gh = hs1 * gy1[o] - fa - fb * (prelu(z, alpha) - mean1);
      const float g = z >= 0.f ? gh : alpha * gh;
      z1[o] = g;
      sa += gh * fminf(z, 0.f);
      s[0] += g;
    }
  }
  if (combine_groups(s, cred) && c_ok)
    part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * H + c] = s[0];
  sa = block_sum(sa, red);
  if (threadIdx.x == 0)
    part_a[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y] = sa;
}

// dx = gz1 W_in (+ g_res). grid (cdiv(T, kBM), cdiv(C, kBN), B)
__global__ void __launch_bounds__(kThreads)
bwd_dx(const float* __restrict__ gz1, const float* __restrict__ w_in,
       const float* __restrict__ g_res, float* __restrict__ dx, int T, int H, int C) {
  const int b = blockIdx.z, t0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* gb = gz1 + static_cast<size_t>(b) * T * H;
  float acc[4][4] = {};
  gemm_tile<true, false>(
      acc, H,
      [&](int m, int k) {
        const int t = t0 + m;
        return (t < T && k < H) ? gb[static_cast<size_t>(t) * H + k] : 0.f;
      },
      [&](int k, int n) {
        n += n0;
        return (k < H && n < C) ? w_in[k * C + n] : 0.f;
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (t < T && n < C) {
        const size_t o = (static_cast<size_t>(b) * T + t) * C + n;
        dx[o] = g_res ? acc[i][j] + g_res[o] : acc[i][j];
      }
    }
  }
}

// dW_in partials: part[z][h][c] = sum_t gz1[t][h] x[t][c] over one (row,
// chunk). grid (cdiv(H, kBM), cdiv(C, kBN), B * chunks)
__global__ void __launch_bounds__(kThreads)
bwd_wgrad_in(const float* __restrict__ gz1, const float* __restrict__ x,
             float* __restrict__ part, int T, int H, int C, int chunks) {
  const int b = blockIdx.z / chunks, tc = (blockIdx.z % chunks) * kChunk;
  const int kc = min(kChunk, T - tc);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float* gb = gz1 + (static_cast<size_t>(b) * T + tc) * H;
  const float* xb = x + (static_cast<size_t>(b) * T + tc) * C;
  float acc[4][4] = {};
  gemm_tile<false, false>(
      acc, kc,
      [&](int m, int k) {
        m += m0;
        return (m < H && k < kc) ? gb[static_cast<size_t>(k) * H + m] : 0.f;
      },
      [&](int k, int n) {
        n += n0;
        return (k < kc && n < C) ? xb[static_cast<size_t>(k) * C + n] : 0.f;
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = part + static_cast<size_t>(blockIdx.z) * H * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < H && n < C) out[static_cast<size_t>(m) * C + n] = acc[i][j];
    }
  }
}

// Column sums of [g_res | g_skip] over kColRows time steps:
// part[b][tile][m]. grid (cdiv(T, kColRows), cdiv(n_res + Cs, kThreads), B)
__global__ void __launch_bounds__(kThreads)
bwd_colsum(const float* __restrict__ g_res, const float* __restrict__ g_skip,
           float* __restrict__ part, int T, int C, int Cs, int n_res) {
  const int b = blockIdx.z, m = blockIdx.y * kThreads + threadIdx.x, M = n_res + Cs;
  if (m >= M) return;
  const int stride = m < n_res ? C : Cs;
  const float* p = m < n_res ? g_res + static_cast<size_t>(b) * T * C + m
                             : g_skip + static_cast<size_t>(b) * T * Cs + (m - n_res);
  const int t0 = blockIdx.x * kColRows, t1 = min(T, t0 + kColRows);
  float s = 0.f;
  for (int t = t0; t < t1; ++t) s += p[static_cast<size_t>(t) * stride];
  part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * M + m] = s;
}

// out[i] = sum over p < n_part of part[p][i], i < n: each of `groups`
// threads of a column sums every groups-th partial, then one thread adds
// the groups in order. grid (cdiv(n, cols)); cols is 32, or 1 for n < 32.
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, int n_part, int n, int cols,
             float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int groups = kThreads / cols, col = threadIdx.x % cols, grp = threadIdx.x / cols;
  const int i = blockIdx.x * cols + col;
  float s = 0.f;
  if (i < n)
    for (int p = grp; p < n_part; p += groups) s += part[static_cast<size_t>(p) * n + i];
  red[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && i < n) {
    float tot = 0.f;
    for (int g = 0; g < groups; ++g) tot += red[g * cols + col];
    out[i] = tot;
  }
}

// out[0] = sum of n_part doubles: each thread sums every kThreads-th,
// then the block adds them in a fixed order. grid (1)
__global__ void __launch_bounds__(kThreads)
sum_partials_f64(const double* __restrict__ part, int n_part, float* __restrict__ out) {
  __shared__ double red[kThreads / 32];
  double s = 0.0;
  for (int p = threadIdx.x; p < n_part; p += kThreads) s += part[p];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[0] = static_cast<float>(s);
}

// Workspace layout (float offsets), shared by tcn_bwd_workspace and the
// launches.
struct Layout {
  size_t z1, z2, gy2, p_gy2, fold2, dgb2_rows, p_gz2, pa2, p_wout, p_gy1, fold1, dgb1_rows,
      p_gz1, pa1, p_win, p_col, total;
  int tiles, ctiles, chunks, coltiles, M;

  Layout(int B, int T, int C, int H, int Cs, int last) {
    tiles = cdiv(T, kEwRows);  // = cdiv(T, kBM): one partial per 64 rows
    ctiles = cdiv(H, kEwCols);
    chunks = cdiv(T, kChunk);
    coltiles = cdiv(T, kColRows);
    M = (last ? 0 : C) + Cs;
    const size_t bth = static_cast<size_t>(B) * T * H, bt = static_cast<size_t>(B) * tiles;
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t start = at;
      at += (n + 31) / 32 * 32;  // 128-byte aligned buffers
      return start;
    };
    z1 = take(bth);
    z2 = take(bth);
    gy2 = take(bth);
    p_gy2 = take(bt * 2 * H);
    fold2 = take(2 * static_cast<size_t>(B));
    dgb2_rows = take(static_cast<size_t>(B) * 2 * H);
    p_gz2 = take(bt * 4 * H);
    pa2 = take(2 * bt * ctiles);  // doubles
    p_wout = take(static_cast<size_t>(B) * chunks * M * H);
    p_gy1 = take(bt * 2 * H);
    fold1 = take(2 * static_cast<size_t>(B));
    dgb1_rows = take(static_cast<size_t>(B) * 2 * H);
    p_gz1 = take(bt * H);
    pa1 = take(2 * bt * ctiles);  // doubles
    p_win = take(static_cast<size_t>(B) * chunks * H * C);
    p_col = take(static_cast<size_t>(B) * coltiles * M);
    total = at;
  }
};

int reduce(const float* part, int n_part, int n, float* out, cudaStream_t s) {
  const int cols = n >= 32 ? 32 : 1;
  sum_partials<<<cdiv(n, cols), kThreads, 0, s>>>(part, n_part, n, cols, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t tcn_bwd_workspace(int B, int T, int C, int H, int Cs, int last) {
  return Layout(B, T, C, H, Cs, last).total;
}

// Launches the whole backward on `stream`; returns the first launch's
// CUDA error code (each launch is checked with cudaGetLastError), or 0.
int tcn_block_bwd(const TcnBwdArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = a->B, T = a->T, C = a->C, H = a->H, Cs = a->Cs, d = a->dilation;
  const int n_res = a->last ? 0 : C;
  const Layout L(B, T, C, H, Cs, a->last);
  float* w = a->work;
  const float inv_n = 1.f / (static_cast<float>(T) * static_cast<float>(H));
  const float* g_res = a->last ? nullptr : a->g_res;
  const dim3 ew(L.tiles, L.ctiles, B);
  int err = 0;
#define TCN_LAUNCHED()                                \
  if ((err = static_cast<int>(cudaGetLastError()))) { \
    return err;                                       \
  }

  bwd_z1<<<dim3(cdiv(T, kBM), cdiv(H, kBN), B), kThreads, 0, s>>>(a->x, a->w_in, a->b_in,
                                                                   w + L.z1, T, C, H);
  TCN_LAUNCHED();
  bwd_z2<<<ew, kThreads, 0, s>>>(w + L.z1, a->stats, a->a1, a->g1, a->be1, a->w_dw, a->b_dw,
                                 w + L.z2, T, H, d);
  TCN_LAUNCHED();
  bwd_gy2<<<dim3(cdiv(T, kBM), cdiv(H, kBN), B), kThreads, 0, s>>>(
      g_res, a->g_skip, a->w_res, a->w_skip, w + L.z2, a->a2, w + L.gy2, w + L.p_gy2, T, H, C,
      Cs, n_res);
  TCN_LAUNCHED();
  bwd_row_merge<<<B, kThreads, 0, s>>>(w + L.p_gy2, L.tiles, a->stats, 1, a->g2,
                                       w + L.dgb2_rows, w + L.fold2, H, inv_n);
  TCN_LAUNCHED();
  double* pa1 = reinterpret_cast<double*>(w + L.pa1);  // 128-byte aligned
  double* pa2 = reinterpret_cast<double*>(w + L.pa2);
  bwd_gz2<<<ew, kThreads, 0, s>>>(w + L.z1, w + L.z2, w + L.gy2, a->stats, w + L.fold2, a->a1,
                                  a->g1, a->be1, a->a2, a->g2, w + L.p_gz2, pa2, T, H, d);
  TCN_LAUNCHED();
  bwd_wgrad_out<<<dim3(cdiv(L.M, kBM), cdiv(H, kBN), B * L.chunks), kThreads, 0, s>>>(
      g_res, a->g_skip, w + L.z2, a->stats, a->a2, a->g2, a->be2, w + L.p_wout, T, H, C, Cs,
      n_res, L.chunks);
  TCN_LAUNCHED();
  // z2 is dead from here: gy1 takes its buffer
  bwd_gy1<<<ew, kThreads, 0, s>>>(w + L.gy2, w + L.z1, a->a1, a->w_dw, w + L.z2, w + L.p_gy1,
                                  T, H, d);
  TCN_LAUNCHED();
  bwd_row_merge<<<B, kThreads, 0, s>>>(w + L.p_gy1, L.tiles, a->stats, 0, a->g1,
                                       w + L.dgb1_rows, w + L.fold1, H, inv_n);
  TCN_LAUNCHED();
  // z1 becomes gz1
  bwd_gz1<<<ew, kThreads, 0, s>>>(w + L.z2, w + L.z1, a->stats, w + L.fold1, a->a1, a->g1,
                                  w + L.p_gz1, pa1, T, H);
  TCN_LAUNCHED();
  bwd_dx<<<dim3(cdiv(T, kBM), cdiv(C, kBN), B), kThreads, 0, s>>>(w + L.z1, a->w_in, g_res,
                                                                  a->dx, T, H, C);
  TCN_LAUNCHED();
  bwd_wgrad_in<<<dim3(cdiv(H, kBM), cdiv(C, kBN), B * L.chunks), kThreads, 0, s>>>(
      w + L.z1, a->x, w + L.p_win, T, H, C, L.chunks);
  TCN_LAUNCHED();
  bwd_colsum<<<dim3(L.coltiles, cdiv(L.M, kThreads), B), kThreads, 0, s>>>(
      g_res, a->g_skip, w + L.p_col, T, C, Cs, n_res);
  TCN_LAUNCHED();
#undef TCN_LAUNCHED

  const int bt = B * L.tiles, bta = B * L.tiles * L.ctiles;
  for (int i = 0; i < 2; ++i) {
    sum_partials_f64<<<1, kThreads, 0, s>>>(i ? pa2 : pa1, bta, a->da + i);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  const struct {
    const float* part;
    int n_part, n;
    float* out;
  } sums[] = {
      {w + L.p_win, B * L.chunks, H * C, a->dw_in},
      {w + L.p_gz1, bt, H, a->db_in},
      {w + L.dgb1_rows, B, 2 * H, a->dgb1},
      {w + L.p_gz2, bt, 4 * H, a->dwb_dw},
      {w + L.dgb2_rows, B, 2 * H, a->dgb2},
      {w + L.p_wout, B * L.chunks, L.M * H, a->dw_out},
      {w + L.p_col, B * L.coltiles, L.M, a->db_out},
  };
  for (const auto& r : sums)
    if ((err = reduce(r.part, r.n_part, r.n, r.out, s))) return err;
  return 0;
}

}  // extern "C"
