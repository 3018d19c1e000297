// LSTM recurrence for NVIDIA Hopper, float32: with the input projection
// fused in (flash-LSTM-x), forward (K3) and backward (K4), and over
// precomputed input gates, forward (K5) and backward (K6).
//
// K3 and K4 replace the Pallas TPU kernels brever_tpu/ops/pallas/
// lstm_scan.py _fwd_x_kernel (launched by _fwd_x_pallas) and _bwd_x_kernel
// (launched by _bwd_x_pallas). Over x (T, D, R, E), with D directions stacked (the
// backward direction's input already flipped in time), R rows, and the
// weights w_ih (D, E, 4H), bias (D, 4H) = b_ih + b_hh, w_hh (D, H, 4H):
//
//   gates[t] = (x[t] w_ih + bias) + h[t-1] w_hh          (i | f | g | o)
//   c[t] = sig(f) c[t-1] + sig(i) tanh(g),   h[t] = sig(o) tanh(c[t])
//
// with h[-1] = c[-1] = 0. The forward writes h and c (T, D, R, H); the
// backward takes them and dh (T, D, R, H) and returns dx, dW_ih, db, dW_hh.
//
// Bound. At TF-GridNet's width (E = H = 128) the forward does 2 (E + H) 4H =
// 262,144 flops a row and step (139.5 GFLOP per BLSTM at 16 x 4 s) and moves
// only x, h and c; the weights (512 KB) do not fit one block's shared memory
// as they fit the TPU's VMEM. The design:
//
// * One block scans a tile of 32 rows of one direction over all T steps in
//   one launch: no launch and no host work per step. h[t-1] and x[t] of the
//   tile sit in shared memory; c stays in registers, each thread owning
//   8 rows x 2 hidden units x all 4 gates, so the cell update needs no
//   exchange. The weights are read through L1/L2 every step (the 8 or more
//   warps of a block read the same rows in step): 512 KB a step and block,
//   16 flops a weight byte at 32 rows.
// * The gates are never written (a gates_x buffer would be 1.09 GB per
//   intra BLSTM at 16 x 4 s, what the Pallas kernel exists to avoid).
//
// The backward runs the same tile in reverse time and recomputes each
// step's gates from x and the saved h with the forward's code and order
// (the same bits), keeps dc in registers and dh_rec = dgates w_hh^T in
// registers, and writes dgates (T, D, R, 4H) to device memory once (the
// same 1.09 GB at 16 x 4 s for the intra BLSTM; read back twice). Then two
// parallel GEMM launches: dx = dgates w_ih^T, and [dW_ih; dW_hh] =
// [x | h_prev]^T dgates split into chunks of 4096 (t, r) pairs whose
// partials, like db's per-tile partials, are summed in a fixed order. No
// float atomics: two runs give bitwise-equal gradients.
//
// K5 and K6 replace _fwd_kernel (launched by _fwd_pallas) and _bwd_kernel
// (launched by _bwd_pallas): the same recurrence over gates_x (T, D, R, 4H),
// the input projection x w_ih + bias done before the call (one cuBLAS GEMM,
// as the JAX package's _dispatch_scan_x does it outside the scan):
//
//   gates[t] = gates_x[t] + h[t-1] w_hh
//
// They are K3 and K4 with the projection off (the scan kernels take a
// template flag): each step of a tile reads its gates_x rows from device
// memory where K3 multiplies x by w_ih. K6 recomputes each step's gates from
// gates_x and the saved h, writes dgates (= d gates_x, T, D, R, 4H) as its
// output, and forms dW_hh = sum over t of h[t-1]^T dgates[t] with K4's weight
// GEMM over fixed-order partials: bitwise repeatable. dx, dW_ih and db are
// then the projection's own backward.
//
// SIMT float32 throughout; wgmma, TMA, clusters and bf16 are later work.
// Every pointer is a dense float32 buffer in the layouts above; w_hh_t is
// w_hh transposed to (D, 4H, H). E is a multiple of 4 (the wrapper pads),
// H a multiple of 32 and at most 256 (2H threads a block).

#include "tcn_common.cuh"

namespace {

using tcn::cdiv;
using tcn::gemm_tile;
using tcn::kBM;
using tcn::kBN;
using tcn::kThreads;

constexpr int kRows = 32;                    // rows of a scan tile
constexpr int kRowsPer = 8;                  // rows a thread owns
constexpr int kGroups = kRows / kRowsPer;    // row groups of a tile
constexpr int kMaxThreads = 512;             // 2 H threads, H <= 256
constexpr int kWgChunk = 4096;               // (t, r) pairs per wgrad partial

__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ size_t at(int t, int d, int r, int D, int R) {
  return (static_cast<size_t>(t) * D + d) * R + r;
}

// rows r0 .. r0 + kRows - 1 of a (R, n) slab into dst (kRows, n), zero past
// R; n is a multiple of 4.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int R, int n) {
  const int q = n / 4;
  for (int i = threadIdx.x; i < kRows * q; i += blockDim.x) {
    const int row = i / q, c4 = i % q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < R)
      v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + row) * n) + c4);
    reinterpret_cast<float4*>(dst + row * n)[c4] = v;
  }
}

// acc += a (kRows, K) in shared memory times w (K, 4H) in device memory,
// for the thread's rows rg * 8 + i and columns g H + 2 ug + u, k ascending.
__device__ __forceinline__ void gemm_rows(float (&acc)[kRowsPer][4][2], const float* a,
                                          const float* __restrict__ w, int K, int H, int rg,
                                          int ug) {
  const int G = 4 * H;
  const float* arow = a + rg * kRowsPer * K;
  const float* wcol = w + 2 * ug;
  for (int k = 0; k < K; k += 2) {
    float2 w0[4], w1[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      w0[g] = __ldg(reinterpret_cast<const float2*>(wcol + static_cast<size_t>(k) * G + g * H));
      w1[g] = __ldg(
          reinterpret_cast<const float2*>(wcol + static_cast<size_t>(k + 1) * G + g * H));
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const float2 av = *reinterpret_cast<const float2*>(arow + i * K + k);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[i][g][0] = fmaf(av.x, w0[g].x, acc[i][g][0]);
        acc[i][g][1] = fmaf(av.x, w0[g].y, acc[i][g][1]);
        acc[i][g][0] = fmaf(av.y, w1[g].x, acc[i][g][0]);
        acc[i][g][1] = fmaf(av.y, w1[g].y, acc[i][g][1]);
      }
    }
  }
}

// The gate pre-activations of the thread's rows and units, the h_prev w_hh
// term skipped at t = 0. kProj: (x w_ih + bias) + h_prev w_hh, x in shared
// memory. Otherwise gates_x[t] + h_prev w_hh, gx pointing at the tile's
// first row of gates_x[t] and rows_left = R - r0 (rows past R read as 0).
// The forward and the backward's recompute both call this, so they get the
// same bits.
template <bool kProj>
__device__ __forceinline__ void gates_tile(float (&acc)[kRowsPer][4][2], const float* xs,
                                           const float* hs, const float* __restrict__ gx,
                                           const float* __restrict__ wi,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ wh, int E, int H, int rg,
                                           int ug, int rows_left, bool has_h) {
  if constexpr (kProj) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g][0] = acc[i][g][1] = 0.f;
    gemm_rows(acc, xs, wi, E, H, rg, ug);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 b = *reinterpret_cast<const float2*>(bias + g * H + 2 * ug);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc[i][g][0] += b.x;
        acc[i][g][1] += b.y;
      }
    }
  } else {
    const int G = 4 * H;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = rg * kRowsPer + i;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float2 v = make_float2(0.f, 0.f);
        if (row < rows_left)
          v = __ldg(reinterpret_cast<const float2*>(gx + static_cast<size_t>(row) * G + g * H +
                                                    2 * ug));
        acc[i][g][0] = v.x;
        acc[i][g][1] = v.y;
      }
    }
  }
  if (has_h) gemm_rows(acc, hs, wh, H, H, rg, ug);
}

// K3 (kProj, x (T, D, R, E) in) and K5 (gates_x (T, D, R, 4H) in, E = 0).
// grid (cdiv(R, kRows), D), 2 H threads, kRows (E + H) floats of dynamic
// shared memory.
template <bool kProj>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_scan(const float* __restrict__ x, const float* __restrict__ w_ih,
              const float* __restrict__ bias, const float* __restrict__ w_hh,
              float* __restrict__ h_seq, float* __restrict__ c_seq, int T, int D, int R, int E,
              int H) {
  extern __shared__ float smem[];
  float* xs = smem;               // (kRows, E)
  float* hs = smem + kRows * E;   // (kRows, H)
  const int d = blockIdx.y, r0 = blockIdx.x * kRows, G = 4 * H;
  const int rg = threadIdx.x / (H / 2), ug = threadIdx.x % (H / 2);
  const float* wi = kProj ? w_ih + static_cast<size_t>(d) * E * G : nullptr;
  const float* wh = w_hh + static_cast<size_t>(d) * H * G;
  const float* bd = kProj ? bias + d * G : nullptr;
  float c[kRowsPer][2] = {};
  for (int t = 0; t < T; ++t) {
    if constexpr (kProj) load_rows(xs, x + at(t, d, 0, D, R) * E, r0, R, E);
    __syncthreads();  // x[t] and h[t-1] of the tile in shared memory
    float acc[kRowsPer][4][2];
    gates_tile<kProj>(acc, xs, hs, kProj ? nullptr : x + at(t, d, r0, D, R) * G, wi, bd, wh, E,
                      H, rg, ug, R - r0, t > 0);
    __syncthreads();  // every thread is done reading xs and hs
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = rg * kRowsPer + i;
      float2 hv, cv;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float cn = sigm(acc[i][1][u]) * c[i][u] + sigm(acc[i][0][u]) * tanhf(acc[i][2][u]);
        const float hn = sigm(acc[i][3][u]) * tanhf(cn);
        c[i][u] = cn;
        (u ? hv.y : hv.x) = hn;
        (u ? cv.y : cv.x) = cn;
      }
      *reinterpret_cast<float2*>(hs + row * H + 2 * ug) = hv;
      if (r0 + row < R) {
        const size_t o = at(t, d, r0 + row, D, R) * H + 2 * ug;
        *reinterpret_cast<float2*>(h_seq + o) = hv;
        *reinterpret_cast<float2*>(c_seq + o) = cv;
      }
    }
  }
}

// K4's and K6's recurrence. Reverse time over the tile: recompute the gates,
// form dgates (written to device memory), carry dc in registers and dh_rec =
// dgates w_hh^T in shared memory slots that only their own thread reads
// (registers would pass the 128 a thread has at 512 threads); with kProj,
// per-tile partials of db into db_part[d][tile][4H]. Without it x is gates_x
// (T, D, R, 4H), E = 0 and w_ih, bias and db_part are not read.
// grid (cdiv(R, kRows), D), 2 H threads, kRows (E + 6 H) floats of
// dynamic shared memory.
template <bool kProj>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_scan(const float* __restrict__ x, const float* __restrict__ w_ih,
              const float* __restrict__ bias, const float* __restrict__ w_hh,
              const float* __restrict__ w_hh_t, const float* __restrict__ h_seq,
              const float* __restrict__ c_seq, const float* __restrict__ dh_seq,
              float* __restrict__ dgates, float* __restrict__ db_part, int T, int D, int R,
              int E, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* xs = smem;                   // (kRows, E)
  float* hs = xs + kRows * E;         // (kRows, H)
  float* gs = hs + kRows * H;         // (kRows, 4H): dgates of the step
  float* dhs = gs + kRows * G;        // (kRows, H): dh_rec
  const int d = blockIdx.y, r0 = blockIdx.x * kRows;
  const int rg = threadIdx.x / (H / 2), ug = threadIdx.x % (H / 2);
  const float* wi = kProj ? w_ih + static_cast<size_t>(d) * E * G : nullptr;
  const float* wh = w_hh + static_cast<size_t>(d) * H * G;
  const float* wht = w_hh_t + static_cast<size_t>(d) * G * H;
  const float* bd = kProj ? bias + d * G : nullptr;
  float dc[kRowsPer][2] = {}, dbs[4][2] = {};
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
    *reinterpret_cast<float2*>(dhs + (rg * kRowsPer + i) * H + 2 * ug) = make_float2(0.f, 0.f);
  for (int t = T - 1; t >= 0; --t) {
    if constexpr (kProj) load_rows(xs, x + at(t, d, 0, D, R) * E, r0, R, E);
    if (t > 0) load_rows(hs, h_seq + at(t - 1, d, 0, D, R) * H, r0, R, H);
    __syncthreads();  // x[t], h[t-1] in; the previous step's gs reads done
    float acc[kRowsPer][4][2];
    gates_tile<kProj>(acc, xs, hs, kProj ? nullptr : x + at(t, d, r0, D, R) * G, wi, bd, wh, E,
                      H, rg, ug, R - r0, t > 0);
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = rg * kRowsPer + i;
      const bool live = r0 + row < R;
      const size_t o = at(t, d, r0 + row, D, R) * H + 2 * ug;
      float2 ct = make_float2(0.f, 0.f), cp = ct, dhv = ct;
      if (live) {
        ct = *reinterpret_cast<const float2*>(c_seq + o);
        dhv = *reinterpret_cast<const float2*>(dh_seq + o);
        if (t > 0) cp = *reinterpret_cast<const float2*>(c_seq + o - static_cast<size_t>(D) * R * H);
      }
      const float2 rec = *reinterpret_cast<const float2*>(dhs + row * H + 2 * ug);
      float dgt[4][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ig = sigm(acc[i][0][u]), fg = sigm(acc[i][1][u]);
        const float gg = tanhf(acc[i][2][u]), og = sigm(acc[i][3][u]);
        const float tc = tanhf(u ? ct.y : ct.x);
        const float dh = (u ? dhv.y : dhv.x) + (u ? rec.y : rec.x);
        const float dcc = dh * og * (1.f - tc * tc) + dc[i][u];
        dgt[0][u] = dcc * gg * ig * (1.f - ig);
        dgt[1][u] = dcc * (u ? cp.y : cp.x) * fg * (1.f - fg);
        dgt[2][u] = dcc * ig * (1.f - gg * gg);
        dgt[3][u] = dh * tc * og * (1.f - og);
        dc[i][u] = dcc * fg;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = make_float2(dgt[g][0], dgt[g][1]);
        *reinterpret_cast<float2*>(gs + row * G + g * H + 2 * ug) = v;
        dbs[g][0] += v.x;
        dbs[g][1] += v.y;
        if (live)
          *reinterpret_cast<float2*>(dgates + at(t, d, r0 + row, D, R) * G + g * H + 2 * ug) = v;
      }
    }
    __syncthreads();  // gs whole; xs and hs reads done
    // dh_rec = dgates w_hh^T for the thread's rows and units, j ascending
    float dh_rec[kRowsPer][2] = {};
    const float* grow = gs + rg * kRowsPer * G;
    for (int j = 0; j < G; j += 2) {
      const float2 w0 = __ldg(reinterpret_cast<const float2*>(wht + static_cast<size_t>(j) * H) + ug);
      const float2 w1 =
          __ldg(reinterpret_cast<const float2*>(wht + static_cast<size_t>(j + 1) * H) + ug);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const float2 gv = *reinterpret_cast<const float2*>(grow + i * G + j);
        dh_rec[i][0] = fmaf(gv.x, w0.x, dh_rec[i][0]);
        dh_rec[i][1] = fmaf(gv.x, w0.y, dh_rec[i][1]);
        dh_rec[i][0] = fmaf(gv.y, w1.x, dh_rec[i][0]);
        dh_rec[i][1] = fmaf(gv.y, w1.y, dh_rec[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
      *reinterpret_cast<float2*>(dhs + (rg * kRowsPer + i) * H + 2 * ug) =
          make_float2(dh_rec[i][0], dh_rec[i][1]);
  }
  if constexpr (!kProj) return;
  // db partial of the tile: the row groups add in a fixed order
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g)
    *reinterpret_cast<float2*>(gs + rg * G + g * H + 2 * ug) = make_float2(dbs[g][0], dbs[g][1]);
  __syncthreads();
  for (int n = threadIdx.x; n < G; n += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q) s += gs[q * G + n];
    db_part[(static_cast<size_t>(d) * gridDim.x + blockIdx.x) * G + n] = s;
  }
}

// K4, dx = dgates w_ih^T: rows m = t R + r of direction d.
// grid (cdiv(T R, kBM), cdiv(E, kBN), D)
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dx(const float* __restrict__ dgates, const float* __restrict__ w_ih,
            float* __restrict__ dx, int T, int D, int R, int E, int H) {
  const int d = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int M = T * R, G = 4 * H;
  const float* wi = w_ih + static_cast<size_t>(d) * E * G;
  float acc[4][4] = {};
  gemm_tile<true, true>(
      acc, G,
      [&](int m, int k) {
        m += m0;
        if (m >= M || k >= G) return 0.f;
        return dgates[at(m / R, d, m % R, D, R) * G + k];
      },
      [&](int k, int n) {
        n += n0;
        return (k < G && n < E) ? wi[static_cast<size_t>(n) * G + k] : 0.f;
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* out = dx + at(m / R, d, m % R, D, R) * E;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < E) out[n] = acc[i][j];
    }
  }
}

// K4, weight-gradient partials: part[d][chunk][m][n] = sum over the chunk's
// pairs p = t R + r of a[p][m] dgates[p][n], a = [x[t] | h[t-1]] (h[-1] =
// 0), m < E + H, n < 4H. grid (cdiv(E + H, kBM), cdiv(4H, kBN), D chunks)
__global__ void __launch_bounds__(kThreads)
lstm_bwd_wgrad(const float* __restrict__ x, const float* __restrict__ h_seq,
               const float* __restrict__ dgates, float* __restrict__ part, int T, int D, int R,
               int E, int H, int chunks) {
  const int d = blockIdx.z / chunks, p0 = (blockIdx.z % chunks) * kWgChunk;
  const int kc = min(kWgChunk, T * R - p0), M = E + H, G = 4 * H;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4] = {};
  gemm_tile<false, false>(
      acc, kc,
      [&](int m, int k) {
        m += m0;
        if (m >= M || k >= kc) return 0.f;
        const int p = p0 + k, t = p / R, r = p % R;
        if (m < E) return x[at(t, d, r, D, R) * E + m];
        return t > 0 ? h_seq[at(t - 1, d, r, D, R) * H + (m - E)] : 0.f;
      },
      [&](int k, int n) {
        n += n0;
        if (n >= G || k >= kc) return 0.f;
        const int p = p0 + k;
        return dgates[at(p / R, d, p % R, D, R) * G + n];
      });
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = part + static_cast<size_t>(blockIdx.z) * M * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < G) out[static_cast<size_t>(m) * G + n] = acc[i][j];
    }
  }
}

// out[i] = sum over p < n_part of part[p][i], i < n, in ascending p: each
// thread owns one i. grid (cdiv(n, kThreads))
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, int n_part, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

bool hidden_ok(int H) { return H >= 32 && H % 32 == 0 && H <= 256; }
bool shape_ok(int E, int H) { return E > 0 && E % 4 == 0 && hidden_ok(H); }

// Workspace layout (float offsets), shared by lstm_bwd_workspace and
// lstm_bwd, and with E = 0 by lstm_scan_bwd_workspace and lstm_scan_bwd
// (whose dgates is its output and which has no db: only wg_part is used).
struct Layout {
  size_t dgates, db_part, wg_part, total;
  int tiles, chunks;

  Layout(int T, int D, int R, int E, int H) {
    tiles = cdiv(R, kRows);
    chunks = cdiv(T * R, kWgChunk);
    const size_t G = 4 * static_cast<size_t>(H);
    size_t off = 0;
    auto take = [&](size_t n) {
      const size_t start = off;
      off += (n + 31) / 32 * 32;  // 128-byte aligned buffers
      return start;
    };
    const bool proj = E > 0;
    dgates = take(proj ? static_cast<size_t>(T) * D * R * G : 0);
    db_part = take(proj ? static_cast<size_t>(D) * tiles * G : 0);
    wg_part = take(static_cast<size_t>(D) * chunks * (E + H) * G);
    total = off;
  }
};

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// Shared memory of the two scan kernels, in bytes (the wrapper checks it
// against the card's limit).
size_t lstm_fwd_smem(int E, int H) { return sizeof(float) * kRows * (E + H); }
size_t lstm_bwd_smem(int E, int H) { return sizeof(float) * kRows * (E + 6 * H); }

size_t lstm_bwd_workspace(int T, int D, int R, int E, int H) {
  return Layout(T, D, R, E, H).total;
}

// K3: h_seq and c_seq (T, D, R, H) from x (T, D, R, E). Returns a CUDA
// error code, or 0.
int lstm_fwd(const float* x, const float* w_ih, const float* bias, const float* w_hh,
             float* h_seq, float* c_seq, int T, int D, int R, int E, int H, void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lstm_fwd_smem(E, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_fwd_scan<true>), smem);
  if (err) return err;
  lstm_fwd_scan<true><<<dim3(cdiv(R, kRows), D), 2 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_ih, bias, w_hh, h_seq, c_seq, T, D, R, E, H);
  return static_cast<int>(cudaGetLastError());
}

// K4: dx (T, D, R, E), dw = [dW_ih; dW_hh] (D, E + H, 4H) and db (D, 4H)
// from the forward's inputs, its h and c, and dh; work holds
// lstm_bwd_workspace floats. Every output is written whole. Returns the
// first launch's CUDA error code, or 0.
int lstm_bwd(const float* x, const float* w_ih, const float* bias, const float* w_hh,
             const float* w_hh_t, const float* h_seq, const float* c_seq, const float* dh_seq,
             float* dx, float* dw, float* db, float* work, int T, int D, int R, int E, int H,
             void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(T, D, R, E, H);
  const int G = 4 * H;
  const size_t smem = lstm_bwd_smem(E, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_bwd_scan<true>), smem);
  if (err) return err;
  lstm_bwd_scan<true><<<dim3(L.tiles, D), 2 * H, smem, s>>>(
      x, w_ih, bias, w_hh, w_hh_t, h_seq, c_seq, dh_seq, work + L.dgates, work + L.db_part, T, D,
      R, E, H);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  lstm_bwd_dx<<<dim3(cdiv(T * R, kBM), cdiv(E, kBN), D), kThreads, 0, s>>>(
      work + L.dgates, w_ih, dx, T, D, R, E, H);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  lstm_bwd_wgrad<<<dim3(cdiv(E + H, kBM), cdiv(G, kBN), D * L.chunks), kThreads, 0, s>>>(
      x, h_seq, work + L.dgates, work + L.wg_part, T, D, R, E, H, L.chunks);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  for (int d = 0; d < D; ++d) {
    const size_t n_w = static_cast<size_t>(E + H) * G;
    sum_partials<<<cdiv(static_cast<int>(n_w), kThreads), kThreads, 0, s>>>(
        work + L.wg_part + d * L.chunks * n_w, L.chunks, static_cast<int>(n_w), dw + d * n_w);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    sum_partials<<<cdiv(G, kThreads), kThreads, 0, s>>>(
        work + L.db_part + static_cast<size_t>(d) * L.tiles * G, L.tiles, G, db + d * G);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

// Shared memory of K5 and K6, in bytes.
size_t lstm_scan_fwd_smem(int H) { return lstm_fwd_smem(0, H); }
size_t lstm_scan_bwd_smem(int H) { return lstm_bwd_smem(0, H); }

size_t lstm_scan_bwd_workspace(int T, int D, int R, int H) { return Layout(T, D, R, 0, H).total; }

// K5: h_seq and c_seq (T, D, R, H) from gates_x (T, D, R, 4H) and w_hh
// (D, H, 4H). Returns a CUDA error code, or 0.
int lstm_scan_fwd(const float* gates_x, const float* w_hh, float* h_seq, float* c_seq, int T,
                  int D, int R, int H, void* stream) {
  if (!hidden_ok(H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lstm_scan_fwd_smem(H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_fwd_scan<false>), smem);
  if (err) return err;
  lstm_fwd_scan<false><<<dim3(cdiv(R, kRows), D), 2 * H, smem,
                         static_cast<cudaStream_t>(stream)>>>(gates_x, nullptr, nullptr, w_hh,
                                                              h_seq, c_seq, T, D, R, 0, H);
  return static_cast<int>(cudaGetLastError());
}

// K6: dgates (T, D, R, 4H) and dw_hh (D, H, 4H) from the forward's inputs,
// its h and c, and dh; work holds lstm_scan_bwd_workspace floats. Every
// output is written whole. Returns the first launch's CUDA error code, or 0.
int lstm_scan_bwd(const float* gates_x, const float* w_hh, const float* w_hh_t,
                  const float* h_seq, const float* c_seq, const float* dh_seq, float* dgates,
                  float* dw_hh, float* work, int T, int D, int R, int H, void* stream) {
  if (!hidden_ok(H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(T, D, R, 0, H);
  const int G = 4 * H;
  const size_t smem = lstm_scan_bwd_smem(H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_bwd_scan<false>), smem);
  if (err) return err;
  lstm_bwd_scan<false><<<dim3(L.tiles, D), 2 * H, smem, s>>>(
      gates_x, nullptr, nullptr, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dgates, nullptr, T, D, R, 0,
      H);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  lstm_bwd_wgrad<<<dim3(cdiv(H, kBM), cdiv(G, kBN), D * L.chunks), kThreads, 0, s>>>(
      nullptr, h_seq, dgates, work + L.wg_part, T, D, R, 0, H, L.chunks);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const size_t n_w = static_cast<size_t>(H) * G;
  for (int d = 0; d < D; ++d) {
    sum_partials<<<cdiv(static_cast<int>(n_w), kThreads), kThreads, 0, s>>>(
        work + L.wg_part + d * L.chunks * n_w, L.chunks, static_cast<int>(n_w), dw_hh + d * n_w);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}

}  // extern "C"
