// Conv-TasNet TCN block backward (flash-TCN VJP) for NVIDIA Hopper, float32
// or bfloat16 I/O.
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
// Bound: GEMM work, 58.7 GFLOP at B=16, T=3999, C=Cs=128, H=512 (the
// recompute of z1, gy2 = g [W_res; W_skip], dx = gz1 W_in, dW_in and
// [dW_res; dW_skip]: 2 B T H (C + 2 (C + Cs) + 2 C) flops), 0.88 ms at the
// card's 67 TFLOP/s in float32, plus (B, T, H) float32 passes through
// device memory of 131 MB each. The Pallas kernel keeps four (T, H) f32 rows
// in VMEM; an SM has 227 KB and blocks run in no order, so the backward
// splits at the two gLN-backward reduction barriers, as the forward splits
// at its two. Eleven launches:
//
//   1. z1 GEMM:    x W_in^T + b_in -> z1 (h1 = PReLU(z1) is recomputed where
//                  it is read). The forward's own product (z1_tile of
//                  tcn_common.cuh: each output an fmaf chain from 0 over k
//                  ascending, then + the bias): z1 is bitwise the
//                  forward's, and so are the PReLU branches and the gLN
//                  statistics.
//   2. z2:         depthwise over y1 normalised on load with the saved stats
//                  (zero outside [0, T), which also covers d >= T) -> z2.
//   3. gy2 GEMM:   [g_res | g_skip] [W_res; W_skip] (K = C + Cs) -> gy2;
//                  the epilogue writes the tile's column sums of gy2 h2 and
//                  gy2.
//   4. merge2:     per row: dg2, dbe2 and the gLN2-backward scalars
//                  A2 = rstd2 s2a / N, B2 = rstd2^2 s2b / N (N = T H).
//   5. wout GEMM:  [dW_res; dW_skip] = g^T y2, y2 normalised from z2 on
//                  load, split over (row, time chunk); the first column
//                  tile's blocks also sum g's columns (db_res, db_skip).
//   6. gz2 + gy1:  gz2 = PReLU'(z2) (hs2 gy2 - A2 - B2 (h2 - mean2)) where
//                  the transposed depthwise reads it, at t - d, t and t + d,
//                  so it is never stored: gy1[t] = w0 gz2[t+d] + w1 gz2[t]
//                  + w2 gz2[t-d] -> gy1; partials of da2, dw_dw, db_dw
//                  (y1 normalised on load) and of gy1 h1, gy1.
//   7. merge1:     per row: dg1, dbe1, A1, B1.
//   8. gz1:        gz1 = PReLU'(z1) (hs1 gy1 - A1 - B1 (h1 - mean1)), in
//                  place of z1; partials of da1 and db_in.
//   9. dx GEMM:    gz1 W_in (+ g_res).
//  10. win GEMM:   dW_in = gz1^T x, split like 5.
//  11. sums:       every parameter gradient sums its partials in a fixed
//                  order (no float atomics): two runs on the same inputs give
//                  bitwise-equal gradients.
//
// The GEMMs run simt_gemm.cuh's body (K4's): 128 x 128 block tiles, 8 x 8
// outputs a thread, 16-deep k slices in a cp.async double buffer; an
// operand stored with k contiguous is staged through registers, y2 is
// normalised on its load. The weight gradients' split fills two waves of
// the 132 SMs (Split). SIMT float32 FFMA: a 3xTF32 mma.sync
// GEMM lost weight-gradient accuracy against float64 in K4 (PERF.md);
// wgmma/TMA in an f32-accurate form is later work.
//
// The PReLU slopes' gradients da = sum gh min(z, 0) add ~8M terms at
// B=16 that cancel: by up to 7e5 times in the sum of their magnitudes on
// random inputs at T = 3999, so a float32 sum of them keeps few digits.
// They are summed in double; and the gLN backward keeps the centred form
// gh = hs gy - A - B (h - mean) (hs = g rstd), because the Pallas kernel's
// fold hs gy + b_s h + c_s (_gh_fold) subtracts two large terms whose
// rounding, the same on every element, adds up in that sum.
//
// The bf16 route (bf16_io = 1 in TcnBwdArgs: x, g_res, g_skip, every parameter,
// dx and the 14 parameter gradients bfloat16; stats, the workspace and every
// sum float32) is the TPU kernel's VJP under amp, at its rounding points.
// Its five products run on the bf16 tensor cores (tcn_block_bf16.cu, the
// same eleven launches and plan): z1 by K1-bf16's own routine; the output
// weight GEMM takes bf16(h2), which launch 2 writes beside z2 (the TPU
// kernel's dW = hs2 (bf16(h2)^T g) + cv2 sum g); gz1 is rounded to bf16
// where it is written, so dx = gz1 W_in and dW_in = gz1^T x multiply bf16
// values (db_in sums it unrounded); dx and, in the last launch, every
// parameter gradient summed in float32 are rounded to bf16 on store. The
// elementwise stages are this file's, on bf16 parameters; bf16 h2 lives in
// gy1's room (written in launch 2, read in 5, before launch 6 writes gy1)
// and bf16 gz1 in gy2's (gy2's last read is launch 6), in rows of
// tcn_bf16::ld(H) with zero pads.
//
// Scratch is one float32 workspace (tcn_bwd_workspace floats) that the
// caller allocates: z1, z2, gy2 and gy1 of (B, T, H) each and the partials.
// Every pointer is a dense buffer, 16-byte aligned; 2-D weights are
// in the torch Linear storage (out, in): W_in (H, C), W_res (C, H), W_skip
// (Cs, H). Where C, H and Cs are multiples of 4
// every stage moves float4s (kVec); at any other width the same kernels
// instantiated with kVec = false move single floats, with the same sums in
// the same order (the last channels of a width off the float4 grid are
// masked, not padded).

#include <algorithm>

#include "simt_gemm.cuh"
#include "tcn_common.cuh"

namespace {

using namespace simt;
using tcn::block_sum;
using tcn::cdiv;
using tcn::kThreads;
using tcn::prelu;

constexpr int kEwRows = 64;    // elementwise tile: time rows
constexpr int kEwCols = 128;   // elementwise tile: channels, 4 a thread
constexpr int kEwGroups = kThreads / (kEwCols / 4);  // row groups per tile
constexpr int kSMs = 132;      // SMs of the H100 SXM
constexpr int kWgBlocks = 4 * kSMs;
constexpr int kWgMinChunk = 256;

}  // namespace

extern "C" {

// Everything one backward call reads and writes. Outputs and the
// workspace are written whole; nothing needs zeroing.
// stats and work are float32; the others float32 or, with bf16, bfloat16.
struct TcnBwdArgs {
  const void *x, *g_res, *g_skip;
  const float* stats;
  const void *w_in, *b_in, *a1, *g1, *be1, *w_dw, *b_dw, *a2, *g2, *be2, *w_res, *w_skip;
  void* dx;      // (B, T, C)
  void* dw_in;   // (H, C)
  void* db_in;   // (H)
  void* da;      // (2): da1, da2
  void* dgb1;    // (2, H): dg1, dbe1
  void* dwb_dw;  // (4, H): dw_dw taps 0..2, db_dw
  void* dgb2;    // (2, H): dg2, dbe2
  void* dw_out;  // (n_res + Cs, H): dW_res rows, then dW_skip rows
  void* db_out;  // (n_res + Cs): db_res, then db_skip
  float* work;   // tcn_bwd_workspace(B, T, C, H, Cs, last) floats
  int B, T, C, H, Cs, last, dilation, bf16_io;
};

}  // extern "C"

namespace {

// A weight GEMM's split of each batch row's T steps: the most chunks whose
// blocks (its `tiles` output tiles over the B rows and the chunks) fill no
// more than two waves of 2 blocks on each of the 132 SMs, a third wave
// mostly idle costing more than longer chunks, and no more chunks than T
// has pieces of 256 steps; a chunk is a multiple of the k slice.
// ops/tcn_block.py ``bwd_plan`` mirrors it.
struct Split {
  int chunks, chunk;

  Split(int B, int T, int tiles) {
    chunks = std::max(1, std::min(kWgBlocks / (tiles * B), cdiv(T, kWgMinChunk)));
    chunk = cdiv(cdiv(T, chunks), kGK) * kGK;
    chunks = cdiv(T, chunk);
  }
};

// ---------------------------------------------------------------------------
// 1. z1 = x W_in^T + b_in (tcn_common.cuh's z1_tile, which K1 runs too).
// grid (cdiv(T, 128), cdiv(H, 128), B)

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_bwd_z1_gemm(const float* __restrict__ x, const float* __restrict__ w_in,
                const float* __restrict__ bias, float* __restrict__ z1, int T, int C, int H) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int m0 = blockIdx.x * kGM;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * T;
  float acc[8][8];
  tcn::z1_tile<kVec>(acc, x, w_in, bias, T, C, H, sm);
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < T ? z1 + (row0 + m0 + i) * H : nullptr;
  }, blockIdx.y * kGM, H);
}

// ---------------------------------------------------------------------------
// 2. z2 = depthwise(y1) + b_dw, y1 normalised from z1 on load.

// Four neighbouring channels of an elementwise tile, of which the first n
// exist (n >= 4 but for the last channels of a width off the float4 grid).
// kVec: one float4 load or store (the width a multiple of 4, the buffers
// 16-byte aligned); else one float each, channels past n read as 0 and not
// written.
struct F4 {
  float v[4];
};

template <bool kVec>
__device__ __forceinline__ F4 ld4(const float* p, int n) {
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    return {{q.x, q.y, q.z, q.w}};
  } else {
    F4 a = {};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) a.v[e] = p[e];
    return a;
  }
}

template <bool kVec>
__device__ __forceinline__ F4 ld4(const bf16* p, int n) {
  if constexpr (kVec) {
    const float4 q = ldg4(p);
    return {{q.x, q.y, q.z, q.w}};
  } else {
    F4 a = {};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) a.v[e] = ldf(p + e);
    return a;
  }
}

template <bool kVec>
__device__ __forceinline__ void st4(float* p, const F4& a, int n) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = a.v[e];
  }
}

// the channels of the four at c that exist (4 on the float4 grid)
template <bool kVec>
__device__ __forceinline__ int ew_width(int c, int H) {
  return kVec ? 4 : min(4, H - c);
}

// An elementwise tile's thread: channels c .. c + 3 of its 128, rows grp,
// grp + kEwGroups, ... of its kEwRows.
__device__ __forceinline__ int ew_channel() { return blockIdx.y * kEwCols + 4 * (threadIdx.x % 32); }
__device__ __forceinline__ int ew_group() { return threadIdx.x / 32; }

// The normalised input of a gLN at step t of four channels (ne of them
// exist), zero outside [0, T) (the depthwise conv pads after the norm): z
// points at the row's channel c, g and be are the affine's.
template <bool kVec>
struct NormOnLoad {
  const float* z;
  int T, H, ne;
  float alpha, mean, rstd;
  F4 g, be;
  __device__ F4 operator()(int t) const {
    F4 y = {};
    if (t < 0 || t >= T) return y;
    const F4 v = ld4<kVec>(z + static_cast<size_t>(t) * H, ne);
#pragma unroll
    for (int e = 0; e < 4; ++e) y.v[e] = (prelu(v.v[e], alpha) - mean) * rstd * g.v[e] + be.v[e];
    return y;
  }
};

// Column sums of an elementwise tile's N quantities: each thread's four
// channels go to red[q][group][channel], then the kEwGroups groups of a
// channel are added in order; out(q, channel) takes the tile's sum.
template <int N, class Out>
__device__ void tile_sums(const float (&s)[N][4], float* red, Out out) {
#pragma unroll
  for (int q = 0; q < N; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(q * kEwGroups + ew_group()) * kEwCols + 4 * (threadIdx.x % 32) + e] = s[q][e];
  __syncthreads();
  for (int i = threadIdx.x; i < N * kEwCols; i += kThreads) {
    const int q = i / kEwCols, col = i % kEwCols;
    float sum = 0.f;
    for (int g = 0; g < kEwGroups; ++g) sum += red[(q * kEwGroups + g) * kEwCols + col];
    out(q, col, sum);
  }
}

// The bf16 route also writes h2 = bf16(PReLU(z2)) into h2b (rows of ld,
// the pad columns zeros), the output weight GEMM's operand.
// grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
template <bool kVec, class S>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_z2(const float* __restrict__ z1, const float* __restrict__ stats, const S* __restrict__ a1,
           const S* __restrict__ g1, const S* __restrict__ be1, const S* __restrict__ w_dw,
           const S* __restrict__ b_dw, float* __restrict__ z2, const S* __restrict__ a2,
           bf16* __restrict__ h2b, int ld, int T, int H, int d) {
  constexpr bool kBf = !std::is_same_v<S, float>;
  const int b = blockIdx.z, c = ew_channel();
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if constexpr (kBf) {
    if (c >= H && c < ld)
      for (int t = t0 + ew_group(); t < t_end; t += kEwGroups)
        simt::st4(h2b + (static_cast<size_t>(b) * T + t) * ld + c, 0.f, 0.f, 0.f, 0.f);
  }
  if (c >= H) return;  // no barrier in this kernel
  const size_t base = static_cast<size_t>(b) * T * H + c;
  const int ne = ew_width<kVec>(c, H);
  const NormOnLoad<kVec> y1{z1 + base, T, H, ne, ldf(a1), stats[4 * b], stats[4 * b + 1],
                            ld4<kVec>(g1 + c, ne), ld4<kVec>(be1 + c, ne)};
  const F4 w0 = ld4<kVec>(w_dw + c, ne), w1 = ld4<kVec>(w_dw + H + c, ne),
           w2 = ld4<kVec>(w_dw + 2 * H + c, ne), bd = ld4<kVec>(b_dw + c, ne);
  float alpha2 = 0.f;
  if constexpr (kBf) alpha2 = ldf(a2);
  for (int t = t0 + ew_group(); t < t_end; t += kEwGroups) {
    const F4 ym = y1(t - d), y0 = y1(t), yp = y1(t + d);
    F4 z;
    // the forward's expression and order: z2 is bitwise the forward's
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z.v[e] = ym.v[e] * w0.v[e] + y0.v[e] * w1.v[e] + yp.v[e] * w2.v[e] + bd.v[e];
    st4<kVec>(z2 + base + static_cast<size_t>(t) * H, z, ne);
    if constexpr (kBf) {
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = e < ne ? prelu(z.v[e], alpha2) : 0.f;
      simt::st4(h2b + (static_cast<size_t>(b) * T + t) * ld + c, h[0], h[1], h[2], h[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. gy2 = [g_res | g_skip] [W_res; W_skip]: the k slices of g_res (zero
// past C) then those of g_skip. Column sums of gy2 h2 and gy2 over the
// tile's rows into part[b][tile][2][H]. grid (cdiv(T, 128), cdiv(H, 128), B)

template <bool kVec>
struct Gy2Op {
  const float *rrow, *srow, *w_res, *w_skip;  // staged rows of g_res, g_skip
  int n_res, Cs, H, nr;                       // nr: slices of g_res
  RowStage<kVec> a;

  __device__ __forceinline__ void fetch(int s, float*, float* Bs) {
    const int n0 = blockIdx.y * kGM;
    const bool res = s < nr;
    const int k0 = (res ? s : s - nr) * kGK, K = res ? n_res : Cs;
    const float* wm = res ? w_res : w_skip;
    a.load(res ? rrow : srow, k0, K);
    stage_direct<kVec>(Bs, [&](int k, int c) -> const float* {
      return k0 + k < K && n0 + c < H ? wm + static_cast<size_t>(k0 + k) * H + n0 + c : nullptr;
    }, w_skip);
  }
  __device__ __forceinline__ void store(float* As) { a.store(As); }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_bwd_gy2_gemm(const float* __restrict__ g_res, const float* __restrict__ g_skip,
                 const float* __restrict__ w_res, const float* __restrict__ w_skip,
                 const float* __restrict__ z2, const float* __restrict__ a2,
                 float* __restrict__ gy2, float* __restrict__ part, int T, int H, int C, int Cs,
                 int n_res) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int b = blockIdx.z, m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
  const size_t row0 = static_cast<size_t>(b) * T;
  Gy2Op<kVec> op;
  const int m = m0 + threadIdx.x % kGM;
  op.rrow = n_res && m < T ? g_res + (row0 + m) * C : nullptr;
  op.srow = m < T ? g_skip + (row0 + m) * Cs : nullptr;
  op.w_res = w_res;
  op.w_skip = w_skip;
  op.n_res = n_res;
  op.Cs = Cs;
  op.H = H;
  op.nr = cdiv(n_res, kGK);
  float acc[8][8] = {};
  gemm_loop(op, acc, op.nr + cdiv(Cs, kGK), sm);
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < T ? gy2 + (row0 + m0 + i) * H : nullptr;
  }, n0, H);
  // the column sums: the thread's 8 rows, then the 16 threads that share
  // its columns in a fixed order (sm is free after the loop's last barrier)
  const float alpha = *a2;
  float s_gh[8] = {}, s_g[8] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = m0 + frag_row(i);
    if (t >= T) continue;
    const float* zr = z2 + (row0 + t) * H + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = frag_col(4 * h);
      if (n0 + c >= H) continue;
      const int ne = ew_width<kVec>(n0 + c, H);
      const F4 z = ld4<kVec>(zr + c, ne);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= ne) break;
        const float g = acc[i][4 * h + e];
        s_gh[4 * h + e] += g * prelu(z.v[e], alpha);
        s_g[4 * h + e] += g;
      }
    }
  }
  float* red = sm;  // [2][16 sharers][128 columns]
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, sharer = (w / 4) * 8 + l / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[sharer * kGM + frag_col(j)] = s_gh[j];
    red[(16 + sharer) * kGM + frag_col(j)] = s_g[j];
  }
  __syncthreads();
  const int q = threadIdx.x / kGM, col = threadIdx.x % kGM;
  float sum = 0.f;
  for (int y = 0; y < 16; ++y) sum += red[(16 * q + y) * kGM + col];
  if (n0 + col < H)
    part[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 + q) * H + n0 + col] = sum;
}

// ---------------------------------------------------------------------------
// 4 and 7. Per batch row: merge the tile partials (sum gy h, sum gy) of a
// gLN backward into dgb[b] = (dg, dbe) (H each) and the scalars fold[b] =
// (A, B) of gh = hs gy - A - B (h - mean). grid (B)
template <class S>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_row_merge(const float* __restrict__ part, int n_tiles, const float* __restrict__ stats,
                  int slot, const S* __restrict__ gamma, float* __restrict__ dgb,
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
    sa += ldf(gamma + h) * g;
    sb += ldf(gamma + h) * dg;
  }
  sa = block_sum(sa, red);
  sb = block_sum(sb, red);
  if (threadIdx.x == 0) {
    fold[2 * b] = rstd * inv_n * sa;
    fold[2 * b + 1] = rstd * rstd * inv_n * sb;
  }
}

// ---------------------------------------------------------------------------
// 5. [dW_res; dW_skip] partials: part[z][m][n] = sum_t g[t][m] y2[t][n] over
// one (row, chunk) of time z, y2 normalised from z2 on load; the row tiles
// of g_res come first, then those of g_skip. Blocks of column tile 0 also
// write db[z][m] = sum_t g[t][m]. grid (cdiv(n_res, 128) + cdiv(Cs, 128),
// cdiv(H, 128), B chunks)

// The thread's two float4 pieces of y2's (kGK, 128) slice (stage_direct's
// pieces), normalised from z2 through registers; rows past the chunk and
// columns past H are 0.
template <bool kVec>
struct Y2Stage {
  float4 v[2];
  F4 g, be;  // g2 and be2 of the thread's four columns

  __device__ __forceinline__ void load(const float* zrow0, int k0, int kc, int H, int n0,
                                       float alpha, float mean, float rstd) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * kGemmThreads, k = k0 + i / 32, c = n0 + i % 32 * 4;
      F4 y = {};
      if (k < kc && c < H) {
        const float* p = zrow0 + static_cast<size_t>(k) * H + c;
        const int ne = ew_width<kVec>(c, H);
        F4 z = {};
        if constexpr (kVec) {
          const float4 q4 = __ldg(reinterpret_cast<const float4*>(p));
          z = {{q4.x, q4.y, q4.z, q4.w}};
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < ne) z.v[e] = __ldg(p + e);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < ne) y.v[e] = (prelu(z.v[e], alpha) - mean) * rstd * g.v[e] + be.v[e];
      }
      v[q] = make_float4(y.v[0], y.v[1], y.v[2], y.v[3]);
    }
  }

  __device__ __forceinline__ void store(float* S) const {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * kGemmThreads;
      *reinterpret_cast<float4*>(S + (i / 32) * kGLd + i % 32 * 4) = v[q];
    }
  }
};

template <bool kVec>
struct WoutOp {
  const float* g;          // g_res or g_skip at the chunk's first step
  const float* zrow0;      // z2 there
  int ld, m_max, kc, H;    // g's row stride and columns; the chunk's steps
  float alpha, mean, rstd, db = 0.f;
  Y2Stage<kVec> y;

  __device__ __forceinline__ void fetch(int s, float* As, float*) {
    const int k0 = s * kGK, n0 = blockIdx.y * kGM;
    stage_direct<kVec>(As, [&](int k, int c) -> const float* {
      return k0 + k < kc && c < m_max ? g + static_cast<size_t>(k0 + k) * ld + c : nullptr;
    }, g);
    y.load(zrow0, k0, kc, H, n0, alpha, mean, rstd);
  }
  __device__ __forceinline__ void store(float* As) { y.store(As + kGSlice); }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float* Bs) {
    if (blockIdx.y != 0 || threadIdx.x >= kGM) return;
    const float* As = Bs - kGSlice;
#pragma unroll
    for (int k = 0; k < kGK; ++k) db += As[k * kGLd + threadIdx.x];
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_bwd_wout_gemm(const float* __restrict__ g_res, const float* __restrict__ g_skip,
                  const float* __restrict__ z2, const float* __restrict__ stats,
                  const float* __restrict__ a2, const float* __restrict__ g2,
                  const float* __restrict__ be2, float* __restrict__ part,
                  float* __restrict__ part_db, int T, int H, int C, int Cs, int n_res, int chunks,
                  int chunk) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int b = blockIdx.z / chunks, tc = (blockIdx.z % chunks) * chunk;
  const int mr = cdiv(n_res, kGM), M = n_res + Cs;
  const bool res = static_cast<int>(blockIdx.x) < mr;
  const int m0 = (res ? blockIdx.x : blockIdx.x - mr) * kGM, n0 = blockIdx.y * kGM;
  const int row_off = res ? 0 : n_res;  // the output rows of this source
  const size_t row0 = static_cast<size_t>(b) * T + tc;
  WoutOp<kVec> op;
  op.ld = res ? C : Cs;
  op.m_max = (res ? n_res : Cs) - m0;
  op.g = (res ? g_res : g_skip) + row0 * op.ld + m0;
  op.zrow0 = z2 + row0 * H;
  op.kc = min(chunk, T - tc);
  op.H = H;
  op.alpha = *a2;
  op.mean = stats[4 * b + 2];
  op.rstd = stats[4 * b + 3];
  const int c = n0 + threadIdx.x % 32 * 4;
  op.y.g = c < H ? ld4<kVec>(g2 + c, H - c) : F4{};
  op.y.be = c < H ? ld4<kVec>(be2 + c, H - c) : F4{};
  float acc[8][8] = {};
  gemm_loop(op, acc, cdiv(op.kc, kGK), sm);
  float* out = part + (static_cast<size_t>(blockIdx.z) * M + row_off + m0) * H;
  store_tile<kVec>(acc, [&](int i) -> float* {
    return i < op.m_max ? out + static_cast<size_t>(i) * H : nullptr;
  }, n0, H);
  if (blockIdx.y == 0 && threadIdx.x < kGM && static_cast<int>(threadIdx.x) < op.m_max)
    part_db[static_cast<size_t>(blockIdx.z) * M + row_off + m0 + threadIdx.x] = op.db;
}

// ---------------------------------------------------------------------------
// 6. gz2 at t - d, t and t + d from gy2 and z2 (zero outside [0, T)), gy1[t]
// = w0 gz2[t+d] + w1 gz2[t] + w2 gz2[t-d] into gy1. Partials:
// part2[b][tile][4][H] = sum gz2 y1[t-d], sum gz2 y1[t], sum gz2 y1[t+d],
// sum gz2; part_a[b][tile][ctile] = sum gh2 min(z2, 0), in double;
// part1[b][tile][2][H] = sum gy1 h1, sum gy1.
// grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
template <bool kVec, class S>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_gz2_gy1(const float* __restrict__ z1, const float* __restrict__ z2,
                const float* __restrict__ gy2, float* __restrict__ gy1,
                const float* __restrict__ stats, const float* __restrict__ fold2,
                const S* __restrict__ a1, const S* __restrict__ g1, const S* __restrict__ be1,
                const S* __restrict__ w_dw, const S* __restrict__ a2, const S* __restrict__ g2,
                float* __restrict__ part2, double* __restrict__ part_a,
                float* __restrict__ part1, int T, int H, int d) {
  __shared__ double red[kThreads / 32];
  __shared__ float cred[6 * kEwGroups * kEwCols];
  const int b = blockIdx.z, c = ew_channel();
  const bool c_ok = c < H;
  const int ne = c_ok ? ew_width<kVec>(c, H) : 0;
  const size_t base = static_cast<size_t>(b) * T * H + c;
  const float alpha1 = ldf(a1), alpha = ldf(a2), fa = fold2[2 * b], fb = fold2[2 * b + 1],
              mean2 = stats[4 * b + 2], rstd2 = stats[4 * b + 3];
  F4 g = {}, be = {}, hs2 = {}, w0 = {}, w1 = {}, w2 = {};
  if (c_ok) {
    g = ld4<kVec>(g1 + c, ne);
    be = ld4<kVec>(be1 + c, ne);
    hs2 = ld4<kVec>(g2 + c, ne);
    w0 = ld4<kVec>(w_dw + c, ne);
    w1 = ld4<kVec>(w_dw + H + c, ne);
    w2 = ld4<kVec>(w_dw + 2 * H + c, ne);
#pragma unroll
    for (int e = 0; e < 4; ++e) hs2.v[e] *= rstd2;
  }
  const NormOnLoad<kVec> y1{z1 + base, T, H, ne, alpha1, stats[4 * b], stats[4 * b + 1], g, be};
  // gh2 at step t of the four channels (t in [0, T)), and z2 there
  auto gh_at = [&](int t, F4& z) {
    const size_t o = base + static_cast<size_t>(t) * H;
    z = ld4<kVec>(z2 + o, ne);
    const F4 gy = ld4<kVec>(gy2 + o, ne);
    F4 gh;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gh.v[e] = hs2.v[e] * gy.v[e] - fa - fb * (prelu(z.v[e], alpha) - mean2);
    return gh;
  };
  // gz2 at step t, zero outside [0, T)
  auto gz_at = [&](int t) {
    F4 gz = {};
    if (t < 0 || t >= T) return gz;
    F4 z;
    const F4 gh = gh_at(t, z);
#pragma unroll
    for (int e = 0; e < 4; ++e) gz.v[e] = z.v[e] >= 0.f ? gh.v[e] : alpha * gh.v[e];
    return gz;
  };
  float s[6][4] = {};
  double sa = 0.0;
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if (c_ok) {
    for (int t = t0 + ew_group(); t < t_end; t += kEwGroups) {
      const size_t o = base + static_cast<size_t>(t) * H;
      F4 z;
      const F4 gh = gh_at(t, z);
      const F4 ym = y1(t - d), y0 = y1(t), yp = y1(t + d), gzp = gz_at(t + d),
               gzm = gz_at(t - d), zt = ld4<kVec>(z1 + o, ne);
      F4 gy = {};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= ne) break;
        const float gz = z.v[e] >= 0.f ? gh.v[e] : alpha * gh.v[e];
        sa += gh.v[e] * fminf(z.v[e], 0.f);
        s[0][e] += gz * ym.v[e];
        s[1][e] += gz * y0.v[e];
        s[2][e] += gz * yp.v[e];
        s[3][e] += gz;
        gy.v[e] = w0.v[e] * gzp.v[e] + w1.v[e] * gz + w2.v[e] * gzm.v[e];
        s[4][e] += gy.v[e] * prelu(zt.v[e], alpha1);
        s[5][e] += gy.v[e];
      }
      st4<kVec>(gy1 + o, gy, ne);
    }
  }
  const size_t tile = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  tile_sums(s, cred, [&](int q, int col, float sum) {
    const int ch = blockIdx.y * kEwCols + col;
    if (ch >= H) return;
    if (q < 4)
      part2[(tile * 4 + q) * H + ch] = sum;
    else
      part1[(tile * 2 + q - 4) * H + ch] = sum;
  });
  sa = block_sum(sa, red);
  if (threadIdx.x == 0) part_a[tile * gridDim.y + blockIdx.y] = sa;
}

// ---------------------------------------------------------------------------
// 8. gz1 = PReLU'(z1) (hs1 gy1 - A1 - B1 (h1 - mean1)), written over z1;
// on the bf16 route rounded to bf16 after its sums, into gz1b (rows of ld,
// the pad columns zeros) instead.
// Partials: part[b][tile][H] = sum gz1 (db_in); part_a[b][tile][ctile] =
// sum gh1 min(z1, 0) in double. grid (cdiv(T, kEwRows), cdiv(H, kEwCols), B)
template <bool kVec, class S>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_gz1(const float* __restrict__ gy1, float* __restrict__ z1,
            const float* __restrict__ stats, const float* __restrict__ fold1,
            const S* __restrict__ a1, const S* __restrict__ g1, float* __restrict__ part,
            double* __restrict__ part_a, bf16* __restrict__ gz1b, int ld, int T, int H) {
  constexpr bool kBf = !std::is_same_v<S, float>;
  __shared__ double red[kThreads / 32];
  __shared__ float cred[kEwGroups * kEwCols];
  const int b = blockIdx.z, c = ew_channel();
  const bool c_ok = c < H;
  const int ne = c_ok ? ew_width<kVec>(c, H) : 0;
  const size_t base = static_cast<size_t>(b) * T * H + c;
  const float alpha = ldf(a1), fa = fold1[2 * b], fb = fold1[2 * b + 1], mean1 = stats[4 * b];
  F4 hs1 = {};
  if (c_ok) {
    hs1 = ld4<kVec>(g1 + c, ne);
#pragma unroll
    for (int e = 0; e < 4; ++e) hs1.v[e] *= stats[4 * b + 1];
  }
  float s[1][4] = {};
  double sa = 0.0;
  const int t0 = blockIdx.x * kEwRows, t_end = min(T, t0 + kEwRows);
  if (c_ok) {
    for (int t = t0 + ew_group(); t < t_end; t += kEwGroups) {
      const size_t o = base + static_cast<size_t>(t) * H;
      const F4 z = ld4<kVec>(z1 + o, ne), gy = ld4<kVec>(gy1 + o, ne);
      F4 gz = {};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= ne) break;
        const float gh = hs1.v[e] * gy.v[e] - fa - fb * (prelu(z.v[e], alpha) - mean1);
        gz.v[e] = z.v[e] >= 0.f ? gh : alpha * gh;
        sa += gh * fminf(z.v[e], 0.f);
        s[0][e] += gz.v[e];
      }
      if constexpr (kBf)
        simt::st4(gz1b + (static_cast<size_t>(b) * T + t) * ld + c, gz.v[0], gz.v[1], gz.v[2],
                  gz.v[3]);
      else
        st4<kVec>(z1 + o, gz, ne);
    }
  } else if (kBf && c < ld) {
    for (int t = t0 + ew_group(); t < t_end; t += kEwGroups)
      simt::st4(gz1b + (static_cast<size_t>(b) * T + t) * ld + c, 0.f, 0.f, 0.f, 0.f);
  }
  const size_t tile = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  tile_sums(s, cred, [&](int, int col, float sum) {
    const int ch = blockIdx.y * kEwCols + col;
    if (ch < H) part[tile * H + ch] = sum;
  });
  sa = block_sum(sa, red);
  if (threadIdx.x == 0) part_a[tile * gridDim.y + blockIdx.y] = sa;
}

// ---------------------------------------------------------------------------
// 9. dx = gz1 W_in (+ g_res). grid (cdiv(T, 128), cdiv(C, 128), B)

template <bool kVec>
struct DxOp {
  const float* grow;  // the staged row of gz1
  const float* w;     // W_in (H, C), rows k
  int H, C;
  RowStage<kVec> a;

  __device__ __forceinline__ void fetch(int s, float*, float* Bs) {
    const int k0 = s * kGK, n0 = blockIdx.y * kGM;
    a.load(grow, k0, H);
    stage_direct<kVec>(Bs, [&](int k, int c) -> const float* {
      return k0 + k < H && n0 + c < C ? w + static_cast<size_t>(k0 + k) * C + n0 + c : nullptr;
    }, w);
  }
  __device__ __forceinline__ void store(float* As) { a.store(As); }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_bwd_dx_gemm(const float* __restrict__ gz1, const float* __restrict__ w_in,
                const float* __restrict__ g_res, float* __restrict__ dx, int T, int H, int C) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int b = blockIdx.z, m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
  const size_t row0 = static_cast<size_t>(b) * T;
  DxOp<kVec> op;
  const int m = m0 + threadIdx.x % kGM;
  op.grow = m < T ? gz1 + (row0 + m) * H : nullptr;
  op.w = w_in;
  op.H = H;
  op.C = C;
  float acc[8][8] = {};
  gemm_loop(op, acc, cdiv(H, kGK), sm);
  if (g_res) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = m0 + frag_row(i);
      if (t >= T) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + frag_col(4 * h);
        if (n >= C) continue;
        const F4 r = ld4<kVec>(g_res + (row0 + t) * C + n, C - n);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * h + e] += r.v[e];
      }
    }
  }
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < T ? dx + (row0 + m0 + i) * C : nullptr;
  }, n0, C);
}

// ---------------------------------------------------------------------------
// 10. dW_in partials: part[z][h][c] = sum_t gz1[t][h] x[t][c] over one (row,
// chunk) z. grid (cdiv(H, 128), cdiv(C, 128), B chunks)

template <bool kVec>
struct WinOp {
  const float* g;  // gz1 at the chunk's first step
  const float* x;  // x there
  int H, C, kc;

  __device__ __forceinline__ void fetch(int s, float* As, float* Bs) {
    const int k0 = s * kGK, m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
    stage_direct<kVec>(As, [&](int k, int c) -> const float* {
      return k0 + k < kc && m0 + c < H ? g + static_cast<size_t>(k0 + k) * H + m0 + c : nullptr;
    }, g);
    stage_direct<kVec>(Bs, [&](int k, int c) -> const float* {
      return k0 + k < kc && n0 + c < C ? x + static_cast<size_t>(k0 + k) * C + n0 + c : nullptr;
    }, x);
  }
  __device__ __forceinline__ void store(float*) {}
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_bwd_win_gemm(const float* __restrict__ gz1, const float* __restrict__ x,
                 float* __restrict__ part, int T, int H, int C, int chunks, int chunk) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int b = blockIdx.z / chunks, tc = (blockIdx.z % chunks) * chunk;
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
  const size_t row0 = static_cast<size_t>(b) * T + tc;
  WinOp<kVec> op;
  op.g = gz1 + row0 * H;
  op.x = x + row0 * C;
  op.H = H;
  op.C = C;
  op.kc = min(chunk, T - tc);
  float acc[8][8] = {};
  gemm_loop(op, acc, cdiv(op.kc, kGK), sm);
  float* out = part + static_cast<size_t>(blockIdx.z) * H * C;
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < H ? out + static_cast<size_t>(m0 + i) * C : nullptr;
  }, n0, C);
}

// ---------------------------------------------------------------------------
// 11. Every parameter gradient from its partials, one task a grid row:
// out[i] = sum over p < n_part of part[p][i], i < n, in float (each of the
// groups of threads of a column sums every groups-th partial, then one
// thread adds the groups in order), or a sum of n_part doubles into out[0];
// out is float32, or bfloat16 (the sum rounded on store).

struct SumTask {
  const void* part;
  void* out;
  int n_part, n, f64;
};

constexpr int kMaxSums = 9;

struct SumTasks {
  SumTask task[kMaxSums];
};

// grid (the most blocks a task needs, tasks)
template <class S>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_sums(const SumTasks tasks) {
  __shared__ float red[kThreads];
  __shared__ double dred[kThreads / 32];
  const SumTask& task = tasks.task[blockIdx.y];
  if (task.f64) {
    if (blockIdx.x != 0) return;
    const double* part = static_cast<const double*>(task.part);
    double s = 0.0;
    for (int p = threadIdx.x; p < task.n_part; p += kThreads) s += part[p];
    s = block_sum(s, dred);
    if (threadIdx.x == 0) stf(static_cast<S*>(task.out), static_cast<float>(s));
    return;
  }
  const int cols = task.n >= 32 ? 32 : 1;
  if (static_cast<int>(blockIdx.x) * cols >= task.n) return;
  const float* part = static_cast<const float*>(task.part);
  const int groups = kThreads / cols, col = threadIdx.x % cols, grp = threadIdx.x / cols;
  const int i = blockIdx.x * cols + col;
  float s = 0.f;
  if (i < task.n)
    for (int p = grp; p < task.n_part; p += groups) s += part[static_cast<size_t>(p) * task.n + i];
  red[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && i < task.n) {
    float tot = 0.f;
    for (int g = 0; g < groups; ++g) tot += red[g * cols + col];
    stf(static_cast<S*>(task.out) + i, tot);
  }
}

// The launch plan and workspace layout (float offsets), shared by
// tcn_bwd_plan, tcn_bwd_workspace and the launches of both routes: gy2's
// and gy1's rooms also hold the bf16 route's gz1 and h2, (B, T, ld) bf16.
struct Layout {
  size_t z1, z2, gy2, gy1, p_gy2, fold2, dgb2_rows, p_gz2, pa2, p_wout, p_dbout, p_gy1, fold1,
      dgb1_rows, p_gz1, pa1, p_win, total;
  int gtiles, tiles, ctiles, M;
  Split wout, win;

  Layout(int B, int T, int C, int H, int Cs, int last)
      : wout(B, T, (cdiv(last ? 0 : C, kGM) + cdiv(Cs, kGM)) * cdiv(H, kGM)),
        win(B, T, cdiv(H, kGM) * cdiv(C, kGM)) {
    gtiles = cdiv(T, kGM);
    tiles = cdiv(T, kEwRows);
    ctiles = cdiv(H, kEwCols);
    M = (last ? 0 : C) + Cs;
    const size_t bth = static_cast<size_t>(B) * T * H, bt = static_cast<size_t>(B) * tiles;
    const size_t room = std::max(bth, (static_cast<size_t>(B) * T * tcn_bf16::ld(H) + 1) / 2);
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t start = at;
      at += (n + 31) / 32 * 32;  // 128-byte aligned buffers
      return start;
    };
    z1 = take(bth);
    z2 = take(bth);
    gy2 = take(room);
    gy1 = take(room);
    p_gy2 = take(static_cast<size_t>(B) * gtiles * 2 * H);
    fold2 = take(2 * static_cast<size_t>(B));
    dgb2_rows = take(static_cast<size_t>(B) * 2 * H);
    p_gz2 = take(bt * 4 * H);
    pa2 = take(2 * bt * ctiles);  // doubles
    p_wout = take(static_cast<size_t>(B) * wout.chunks * M * H);
    p_dbout = take(static_cast<size_t>(B) * wout.chunks * M);
    p_gy1 = take(bt * 2 * H);
    fold1 = take(2 * static_cast<size_t>(B));
    dgb1_rows = take(static_cast<size_t>(B) * 2 * H);
    p_gz1 = take(bt * H);
    pa1 = take(2 * bt * ctiles);  // doubles
    p_win = take(static_cast<size_t>(B) * win.chunks * H * C);
    total = at;
  }
};

bool shape_ok(int B, int T, int C, int H, int Cs) {
  return B > 0 && T > 0 && C > 0 && H > 0 && Cs > 0;
}

// every width on the float4 grid: the kVec kernels
bool vec_widths(int C, int H, int Cs) { return C % 4 == 0 && H % 4 == 0 && Cs % 4 == 0; }

#define TCN_LAUNCHED()                                \
  if ((err = static_cast<int>(cudaGetLastError()))) { \
    return err;                                       \
  }

// The whole backward on s; the first launch's CUDA error code, or 0. S:
// the storage of x, the cotangents, the parameters, dx and the gradients.
template <bool kVec, class S>
int launch_bwd(const TcnBwdArgs* a, cudaStream_t s) {
  const int B = a->B, T = a->T, C = a->C, H = a->H, Cs = a->Cs, d = a->dilation;
  const int n_res = a->last ? 0 : C;
  const Layout L(B, T, C, H, Cs, a->last);
  float* w = a->work;
  const float inv_n = 1.f / (static_cast<float>(T) * static_cast<float>(H));
  auto in = [](const void* p) { return static_cast<const S*>(p); };
  const S* x = in(a->x);
  const S* g_res = a->last ? nullptr : in(a->g_res);
  const S* g_skip = in(a->g_skip);
  const S *w_in = in(a->w_in), *b_in = in(a->b_in), *a1 = in(a->a1), *g1 = in(a->g1),
          *be1 = in(a->be1), *w_dw = in(a->w_dw), *b_dw = in(a->b_dw), *a2 = in(a->a2),
          *g2 = in(a->g2), *be2 = in(a->be2), *w_res = in(a->w_res), *w_skip = in(a->w_skip);
  const dim3 ew(L.tiles, L.ctiles, B);
  double* pa1 = reinterpret_cast<double*>(w + L.pa1);  // 128-byte aligned
  double* pa2 = reinterpret_cast<double*>(w + L.pa2);
  int err = 0;
  // the bf16 route's products (tcn_block_bf16.cu) and its bf16 h2 and gz1
  constexpr bool kBf = !std::is_same_v<S, float>;
  const int ld = tcn_bf16::ld(H);
  bf16* h2b = kBf ? reinterpret_cast<bf16*>(w + L.gy1) : nullptr;
  bf16* gz1b = kBf ? reinterpret_cast<bf16*>(w + L.gy2) : nullptr;

  if constexpr (kBf) {
    err = tcn_bf16::z1(x, w_in, b_in, w + L.z1, B, T, C, H, s);
  } else {
    tcn_bwd_z1_gemm<kVec><<<dim3(L.gtiles, cdiv(H, kGM), B), kGemmThreads, 0, s>>>(
        x, w_in, b_in, w + L.z1, T, C, H);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  tcn_bwd_z2<kVec, S><<<ew, kThreads, 0, s>>>(w + L.z1, a->stats, a1, g1, be1, w_dw, b_dw,
                                              w + L.z2, a2, h2b, ld, T, H, d);
  TCN_LAUNCHED();
  if constexpr (kBf) {
    err = tcn_bf16::gy2(g_res, g_skip, w_res, w_skip, w + L.z2, a2, w + L.gy2, w + L.p_gy2, B,
                        T, H, C, Cs, n_res, s);
  } else {
    tcn_bwd_gy2_gemm<kVec><<<dim3(L.gtiles, cdiv(H, kGM), B), kGemmThreads, 0, s>>>(
        g_res, g_skip, w_res, w_skip, w + L.z2, a2, w + L.gy2, w + L.p_gy2, T, H, C, Cs, n_res);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  tcn_bwd_row_merge<S><<<B, kThreads, 0, s>>>(w + L.p_gy2, L.gtiles, a->stats, 1, g2,
                                              w + L.dgb2_rows, w + L.fold2, H, inv_n);
  TCN_LAUNCHED();
  if constexpr (kBf) {
    err = tcn_bf16::wout(g_res, g_skip, h2b, a->stats, g2, be2, w + L.p_wout, w + L.p_dbout, B,
                         T, H, C, Cs, n_res, L.wout.chunks, L.wout.chunk, s);
  } else {
    tcn_bwd_wout_gemm<kVec>
        <<<dim3(cdiv(n_res, kGM) + cdiv(Cs, kGM), cdiv(H, kGM), B * L.wout.chunks),
           kGemmThreads, 0, s>>>(g_res, g_skip, w + L.z2, a->stats, a2, g2, be2, w + L.p_wout,
                                 w + L.p_dbout, T, H, C, Cs, n_res, L.wout.chunks,
                                 L.wout.chunk);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  tcn_bwd_gz2_gy1<kVec, S><<<ew, kThreads, 0, s>>>(w + L.z1, w + L.z2, w + L.gy2, w + L.gy1,
                                                   a->stats, w + L.fold2, a1, g1, be1, w_dw, a2,
                                                   g2, w + L.p_gz2, pa2, w + L.p_gy1, T, H, d);
  TCN_LAUNCHED();
  tcn_bwd_row_merge<S><<<B, kThreads, 0, s>>>(w + L.p_gy1, L.tiles, a->stats, 0, g1,
                                              w + L.dgb1_rows, w + L.fold1, H, inv_n);
  TCN_LAUNCHED();
  // z1 becomes gz1 (the bf16 route: bf16 gz1 in gy2's room)
  tcn_bwd_gz1<kVec, S><<<ew, kThreads, 0, s>>>(w + L.gy1, w + L.z1, a->stats, w + L.fold1, a1,
                                               g1, w + L.p_gz1, pa1, gz1b, ld, T, H);
  TCN_LAUNCHED();
  if constexpr (kBf) {
    err = tcn_bf16::dx(gz1b, w_in, g_res, static_cast<S*>(a->dx), B, T, H, C, s);
    if (err || (err = tcn_bf16::win(gz1b, x, w + L.p_win, B, T, H, C, L.win.chunks,
                                    L.win.chunk, s)))
      return err;
  } else {
    tcn_bwd_dx_gemm<kVec><<<dim3(L.gtiles, cdiv(C, kGM), B), kGemmThreads, 0, s>>>(
        w + L.z1, w_in, g_res, static_cast<S*>(a->dx), T, H, C);
    TCN_LAUNCHED();
    tcn_bwd_win_gemm<kVec>
        <<<dim3(cdiv(H, kGM), cdiv(C, kGM), B * L.win.chunks), kGemmThreads, 0, s>>>(
            w + L.z1, x, w + L.p_win, T, H, C, L.win.chunks, L.win.chunk);
    TCN_LAUNCHED();
  }

  const int bt = B * L.tiles, bta = B * L.tiles * L.ctiles;
  S* da = static_cast<S*>(a->da);
  const SumTasks tasks = {{
      {w + L.p_win, a->dw_in, B * L.win.chunks, H * C, 0},
      {w + L.p_gz1, a->db_in, bt, H, 0},
      {w + L.dgb1_rows, a->dgb1, B, 2 * H, 0},
      {w + L.p_gz2, a->dwb_dw, bt, 4 * H, 0},
      {w + L.dgb2_rows, a->dgb2, B, 2 * H, 0},
      {w + L.p_wout, a->dw_out, B * L.wout.chunks, L.M * H, 0},
      {w + L.p_dbout, a->db_out, B * L.wout.chunks, L.M, 0},
      {pa1, da, bta, 1, 1},
      {pa2, da + 1, bta, 1, 1},
  }};
  int blocks = 1;
  for (const SumTask& t : tasks.task)
    if (!t.f64) blocks = std::max(blocks, cdiv(t.n, t.n >= 32 ? 32 : 1));
  tcn_bwd_sums<S><<<dim3(blocks, kMaxSums), kThreads, 0, s>>>(tasks);
  TCN_LAUNCHED();
  return 0;
}

#undef TCN_LAUNCHED

}  // namespace

extern "C" {

size_t tcn_bwd_workspace(int B, int T, int C, int H, int Cs, int last) {
  return Layout(B, T, C, H, Cs, last).total;
}

// K2's plan at a shape: info[0..6] = the GEMMs' row tiles a batch row, the
// elementwise tiles a batch row, the elementwise column tiles, the output
// weight GEMM's chunks and steps a chunk, and the input weight GEMM's.
// Returns cudaErrorInvalidValue for a shape K2 does not take, else 0.
int tcn_bwd_plan(int B, int T, int C, int H, int Cs, int last, int* info) {
  if (!shape_ok(B, T, C, H, Cs)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(B, T, C, H, Cs, last);
  const int out[7] = {L.gtiles, L.tiles, L.ctiles, L.wout.chunks, L.wout.chunk, L.win.chunks,
                      L.win.chunk};
  for (int i = 0; i < 7; ++i) info[i] = out[i];
  return 0;
}

// Launches the whole backward on `stream`; returns the first launch's
// CUDA error code (each launch is checked with cudaGetLastError), or 0.
int tcn_block_bwd(const TcnBwdArgs* a, void* stream) {
  if (!shape_ok(a->B, a->T, a->C, a->H, a->Cs)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_widths(a->C, a->H, a->Cs);
  if (a->bf16_io) return vec ? launch_bwd<true, bf16>(a, s) : launch_bwd<false, bf16>(a, s);
  return vec ? launch_bwd<true, float>(a, s) : launch_bwd<false, float>(a, s);
}

// K2's first launch alone: z1 (B, T, H) = x W_in^T + b_in, the bits K2
// recomputes (for the check that they are the forward's). Returns a CUDA
// error code, or 0.
int tcn_bwd_z1(const void* x, const void* w_in, const void* b_in, float* z1, int B, int T,
               int C, int H, int bf16_io, void* stream) {
  if (!shape_ok(B, T, C, H, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_io)
    return tcn_bf16::z1(static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
                        static_cast<const bf16*>(b_in), z1, B, T, C, H, s);
  const dim3 grid(cdiv(T, kGM), cdiv(H, kGM), B);
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  if (vec_widths(C, H, 4))
    tcn_bwd_z1_gemm<true><<<grid, kGemmThreads, 0, s>>>(in(x), in(w_in), in(b_in), z1, T, C, H);
  else
    tcn_bwd_z1_gemm<false><<<grid, kGemmThreads, 0, s>>>(in(x), in(w_in), in(b_in), z1, T, C, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
