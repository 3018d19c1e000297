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
// K5 and K6 replace _fwd_kernel (launched by _fwd_pallas, brever_tpu/ops/
// pallas/lstm_scan.py:155) and _bwd_kernel (launched by _bwd_pallas, :235):
// the same recurrence over gates_x (T, D, R, 4H), the input projection
// x w_ih + bias done before the call (one cuBLAS GEMM, as the JAX package's
// _dispatch_scan_x does it outside the scan):
//
//   gates[t] = gates_x[t] + h[t-1] w_hh
//
// K6 recomputes each step's gates from gates_x and the saved h, writes
// dgates (= d gates_x, T, D, R, 4H) as its output, and forms dW_hh = sum
// over t of h[t-1]^T dgates[t] with K4's weight GEMM over fixed-order
// partials: bitwise repeatable. dx, dW_ih and db are then the projection's
// own backward.
//
// Bound. A gates-in scan is a chain of T dependent steps, each a small
// product: at DCCRN's shape (T = 495, D = 2, R = 32, H = 128) one step of
// one direction is 32 x 128 x 512 multiply-adds over a 256 KB w_hh. The
// flops (67 TFLOP/s) and bytes give a few microseconds for the whole scan;
// what bounds it is the latency of one step once the weights stay on chip:
// the step's FMAs on the columns one SM owns, plus one exchange of h.
//
// Design for H <= 256 (the persistent-RNN layout of Diamos et al., ICML
// 2016, on Hopper's thread-block clusters): one cluster of N blocks
// (kClusterBlocks: 16 SMs) scans one 32-row tile of one direction
// over all T steps in one launch. Block b owns hidden units [b U, (b+1) U),
// U = H / N, with all four gates: 4U columns of w_hh, which it copies into
// its shared memory once, transposed, before the time loop. A K5 step:
// each block forms its columns' gates for the 32 rows from h[t-1], whole in
// its shared memory (k ascending), adds gates_x[t] (prefetched by cp.async
// one step ahead), updates c in registers and h, and stores its (32, U)
// slice of h[t] into every block's h buffer through distributed shared
// memory (DSMEM); one cluster barrier (arrive.release / wait.acquire) a
// step, the h buffer double-buffered so that a peer's stores of h[t] never
// meet a read of h[t-1]; h and c go to device memory between the arrive
// and the wait, off the release's path. A K6 step in reverse time:
// recompute the own columns' gates with K5's function from h[t-1] and
// gates_x[t] (both prefetched a step ahead: the forward's bits), form
// dgates (written to device memory for the weight GEMM) with dc in
// registers, then this block's partial dh_rec = dgates_own w_hh[:, own]^T
// for all H units from the slice it holds; the partial for block b's units
// goes to slot [own rank] of block b (DSMEM, double-buffered), and each
// block sums its N slots in rank order: no atomics, bitwise repeatable.
// The last step's barrier keeps every block alive until no peer can still
// store into its shared memory. What bounds a step at DCCRN's shape (N =
// 16, U = 8; PERF.md): the product, ~2 us, is bound by shared-memory
// loads: the 32 x 4U x H tile of a block is too small for register tiling
// at 128 threads, so neighbouring threads load the same h and w_hh values
// (4 wavefronts a float4 load); the DSMEM stores, whose release the
// barrier waits for, and the barrier take most of the rest. wgmma (3 x
// TF32 or bf16) on that tile is the next step.
//
// For 256 < H <= 512 a float32 w_hh (up to 4 MB a direction) does not fit
// 16 SMs' shared memory: K5/K6 keep K3/K4's scan kernels with the
// projection off (a template flag) on 16-row tiles (H threads), reading
// w_hh through L1/L2 every step; K6's shared memory there is 16 x 6H
// floats, 196,608 B at H = 512.
//
// SIMT float32 FFMA throughout (no TF32, no bf16: the parity bounds are
// float32's); wgmma, TMA and bf16 are later work. Every pointer is a dense
// float32 buffer in the layouts above; w_hh_t is w_hh transposed to
// (D, 4H, H) (the 16-row K6 and K4 only). E is a multiple of 4 (the
// wrapper pads), H a multiple of 32, at most 256 for K3/K4 and 512 for
// K5/K6.

#include <cooperative_groups.h>

#include "tcn_common.cuh"

namespace {

using tcn::cdiv;
using tcn::gemm_tile;
using tcn::kBM;
using tcn::kBN;
using tcn::kThreads;

constexpr int kRowsPer = 8;                  // rows a thread owns
constexpr int kMaxThreads = 512;             // 2H threads at 32 rows, H at 16
constexpr int kMaxHiddenWide = 256;          // largest H of a 32-row tile
constexpr int kMaxHidden = 512;              // largest H of a 16-row tile
constexpr int kWgChunk = 4096;               // (t, r) pairs per wgrad partial
constexpr int kClusterThreads = 256;         // threads of a K5/K6 cluster block
constexpr int kClusterRows = 32;             // rows of a K5/K6 cluster tile
constexpr int kPad = 4;                      // floats padding a shared row of H
// blocks of a K5/K6 cluster at every H <= 256: at DCCRN's shape 16 ran K5
// and K6 faster than 8 (PERF.md), and at H = 256 K6's shared memory needs 16
constexpr int kClusterBlocks = 16;

namespace cg = cooperative_groups;

__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ size_t at(int t, int d, int r, int D, int R) {
  return (static_cast<size_t>(t) * D + d) * R + r;
}

// rows r0 .. r0 + kRows - 1 of a (R, n) slab into dst (kRows, n), zero past
// R; n is a multiple of 4.
template <int kRows>
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
// grid (cdiv(R, kRows), D), kRows / 8 x H / 2 threads, kRows (E + H) floats
// of dynamic shared memory.
template <bool kProj, int kRows>
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
    if constexpr (kProj) load_rows<kRows>(xs, x + at(t, d, 0, D, R) * E, r0, R, E);
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
// grid (cdiv(R, kRows), D), kRows / 8 x H / 2 threads, kRows (E + 6 H)
// floats of dynamic shared memory.
template <bool kProj, int kRows>
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
    if constexpr (kProj) load_rows<kRows>(xs, x + at(t, d, 0, D, R) * E, r0, R, E);
    if (t > 0) load_rows<kRows>(hs, h_seq + at(t - 1, d, 0, D, R) * H, r0, R, H);
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
  constexpr int kGroups = kRows / kRowsPer;
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

// ---------------------------------------------------------------------------
// K5 and K6 for H <= 256: a cluster of n blocks per (row tile, direction)

// rows a thread owns in the gate phase: the fewest of 1, 2 and 4 that keep
// the 32 U / rows gate items within half the block's threads (U <= 16).
// Shared-memory loads bound the step's product, and a thread with more
// rows loads each w_hh value for more of them (at U = 8, two rows a thread
// ran faster than one).
__host__ __device__ inline int gate_rows(int U) { return U <= 4 ? 1 : U <= 8 ? 2 : 4; }

// shared memory (floats) of K5 and K6; U = H / kClusterBlocks, rows of H
// padded by kPad floats
size_t cluster_fwd_floats(int H) {
  const size_t U = H / kClusterBlocks, ld = H + kPad, rows = kClusterRows;
  return 4 * U * ld + 2 * rows * ld + 2 * rows * 4 * U;  // w_hh slice, h x 2, gates_x x 2
}
size_t cluster_bwd_floats(int H) {
  const size_t U = H / kClusterBlocks, ld = H + kPad, rows = kClusterRows;
  // w_hh slice, h[t-1], gates_x, c[t], c[t-1], dh, dgates, 2 x N dh_rec slots
  return 4 * U * ld + rows * ld + rows * 4 * U + 3 * rows * U + rows * 4 * U +
         2 * static_cast<size_t>(kClusterBlocks) * rows * U;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;  // 0: fill the destination with zeros
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(kBytes), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The cluster barrier, every thread of every block of the cluster: what
// each stored before its arrive (to its own or a peer's shared memory) is
// seen by all after their wait. Work between the two (a step's stores to
// device memory, which no peer reads) leaves the release's path.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// ws (4U, H + kPad) <- the block's columns of w (H, 4H), transposed: row
// j = g U + u of ws is column g H + b U + u of w
__device__ __forceinline__ void load_w_slice(float* ws, const float* __restrict__ w, int H,
                                             int U, int b) {
  const int cols = 4 * U, ld = H + kPad;
  for (int i = threadIdx.x; i < H * cols; i += blockDim.x) {
    const int k = i / cols, j = i % cols;
    ws[j * ld + k] = w[static_cast<size_t>(k) * 4 * H + (j / U) * H + b * U + j % U];
  }
}

// The cp.async copies one thread issues at each step from one (R, width)
// slab of a step to shared memory: up to kMax pieces of kBytes, their
// offsets fixed over the steps and worked out once (a negative source
// offset is a row past R, filled with zeros).
template <int kMax, int kBytes>
struct StepCopies {
  int src[kMax], dst[kMax];

  // piece i of n: f(i, src, dst) gives its offsets
  template <class F>
  __device__ __forceinline__ StepCopies(int n, F f) {
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      const int i = threadIdx.x + m * blockDim.x;
      src[m] = dst[m] = -1;
      if (i < n) f(i, src[m], dst[m]);
    }
  }

  __device__ __forceinline__ void issue(float* to, const float* __restrict__ slab) const {
#pragma unroll
    for (int m = 0; m < kMax; ++m)
      if (dst[m] >= 0) cp_async<kBytes>(to + dst[m], slab + max(src[m], 0), src[m] >= 0);
  }
};

// the block's gate columns of the tile's rows of gates_x[t] (R, 4H) into
// (32, 4U), as float2 pieces (U is even); at most 4 a thread for U <= 16
__device__ __forceinline__ StepCopies<4, 8> gates_own_copies(int r0, int R, int H, int U,
                                                             int b) {
  const int pairs = 2 * U;
  return StepCopies<4, 8>(kClusterRows * pairs, [=](int i, int& src, int& dst) {
    const int row = i / pairs, j = 2 * (i % pairs);
    if (r0 + row < R) src = (r0 + row) * 4 * H + j / U * H + b * U + j % U;
    dst = row * 4 * U + j;
  });
}

// the block's units of the tile's rows of an (R, H) slab into (32, U)
__device__ __forceinline__ StepCopies<1, 8> units_own_copies(int r0, int R, int H, int U,
                                                             int b) {
  const int pairs = U / 2;
  return StepCopies<1, 8>(kClusterRows * pairs, [=](int i, int& src, int& dst) {
    const int row = i / pairs, u = 2 * (i % pairs);
    if (r0 + row < R) src = (r0 + row) * H + b * U + u;
    dst = row * U + u;
  });
}

// the tile's rows of an (R, H) slab, whole, into (32, H + kPad), as float4
__device__ __forceinline__ StepCopies<8, 16> rows_whole_copies(int r0, int R, int H) {
  const int quads = H / 4;
  return StepCopies<8, 16>(kClusterRows * quads, [=](int i, int& src, int& dst) {
    const int row = i / quads, q = 4 * (i % quads);
    if (r0 + row < R) src = (r0 + row) * H + q;
    dst = row * (H + kPad) + q;
  });
}

// The gate pre-activations of rows rs .. rs + kRpt - 1 and unit u of the
// block, gates i|f|g|o: gxs (32, 4U) plus, when has_h, h (32, H + kPad)
// times the block's w_hh slice ws, k ascending. K5 and K6's recompute both
// call this, so they get the same bits.
template <int kRpt>
__device__ __forceinline__ void cluster_gates(float (&acc)[kRpt][4], const float* gxs,
                                              const float* hs, const float* ws, int H, int U,
                                              int rs, int u, bool has_h) {
  const int ld = H + kPad;
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = gxs[(rs + i) * 4 * U + g * U + u];
  if (!has_h) return;
#pragma unroll 2
  for (int k = 0; k < H; k += 4) {
    float4 w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] = *reinterpret_cast<const float4*>(ws + (g * U + u) * ld + k);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float4 h = *reinterpret_cast<const float4*>(hs + (rs + i) * ld + k);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[i][g] = fmaf(h.x, w[g].x, acc[i][g]);
        acc[i][g] = fmaf(h.y, w[g].y, acc[i][g]);
        acc[i][g] = fmaf(h.z, w[g].z, acc[i][g]);
        acc[i][g] = fmaf(h.w, w[g].w, acc[i][g]);
      }
    }
  }
}

// K5 for H <= 256. grid (n cdiv(R, 32), D) in clusters of (n, 1, 1), n =
// kClusterBlocks, kClusterThreads threads, cluster_fwd_floats(H) floats of dynamic
// shared memory; thread x < 32 U / kRpt owns unit x % U of rows
// (x / U) kRpt .. + kRpt - 1 in the gate phase (kRpt = gate_rows(U)); all
// threads copy.
template <int kRpt>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_scan_fwd_cluster(const float* __restrict__ gates_x, const float* __restrict__ w_hh,
                      float* __restrict__ h_seq, float* __restrict__ c_seq, int T, int D, int R,
                      int H) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks()), b = static_cast<int>(cluster.block_rank());
  const int U = H / n, G = 4 * H, ld = H + kPad, tile = kClusterRows * ld;
  const int d = blockIdx.y, r0 = blockIdx.x / n * kClusterRows;
  float* ws = smem;                     // (4U, ld): the block's columns of w_hh, transposed
  float* hs = ws + 4 * U * ld;          // 2 x (32, ld): h of the tile, whole, by step parity
  float* gxs = hs + 2 * tile;           // 2 x (32, 4U): the block's columns of gates_x
  const int gtile = kClusterRows * 4 * U;
  const auto gx_copies = gates_own_copies(r0, R, H, U, b);
  load_w_slice(ws, w_hh + static_cast<size_t>(d) * H * G, H, U, b);
  gx_copies.issue(gxs, gates_x + at(0, d, 0, D, R) * G);
  cp_async_commit();
  const bool owner = static_cast<int>(threadIdx.x) < kClusterRows / kRpt * U;
  const int u = threadIdx.x % U, rs = threadIdx.x / U * kRpt;
  float c[kRpt] = {}, h[kRpt];
  cluster_barrier();  // every block of the cluster runs before any DSMEM store
  for (int t = 0; t < T; ++t) {
    float* hcur = hs + (t & 1) * tile;
    const float* hprev = hs + ((t + 1) & 1) * tile;
    if (t + 1 < T) gx_copies.issue(gxs + ((t + 1) & 1) * gtile, gates_x + at(t + 1, d, 0, D, R) * G);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // gates_x[t] in, from every thread's copies
    if (owner) {
      float acc[kRpt][4];
      cluster_gates<kRpt>(acc, gxs + (t & 1) * gtile, hprev, ws, H, U, rs, u, t > 0);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int row = rs + i;
        const float cn = sigm(acc[i][1]) * c[i] + sigm(acc[i][0]) * tanhf(acc[i][2]);
        h[i] = sigm(acc[i][3]) * tanhf(cn);
        c[i] = cn;
        // h[t] of the row and unit into every block's buffer, its own too
        for (int q = 0; q < n; ++q) cluster.map_shared_rank(hcur, q)[row * ld + b * U + u] = h[i];
      }
    }
    // h[t] whole in every block, and every block done reading h[t-1]; after
    // the last step, no peer stores into this block's shared memory
    cluster_arrive();
    if (owner)
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (r0 + rs + i < R) {
          const size_t o = at(t, d, r0 + rs + i, D, R) * H + b * U + u;
          h_seq[o] = h[i];
          c_seq[o] = c[i];
        }
    cluster_wait();
  }
}

// K6's recurrence for H <= 256: dgates (T, D, R, 4H). Launched as K5.
template <int kRpt>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_scan_bwd_cluster(const float* __restrict__ gates_x, const float* __restrict__ w_hh,
                      const float* __restrict__ h_seq, const float* __restrict__ c_seq,
                      const float* __restrict__ dh_seq, float* __restrict__ dgates, int T, int D,
                      int R, int H) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks()), b = static_cast<int>(cluster.block_rank());
  const int U = H / n, G = 4 * H, ld = H + kPad, rows = kClusterRows;
  const int d = blockIdx.y, r0 = blockIdx.x / n * kClusterRows;
  float* ws = smem;                   // (4U, ld): the block's columns of w_hh, transposed
  float* hs = ws + 4 * U * ld;        // (32, ld): h[t-1] of the tile, whole
  float* gxs = hs + rows * ld;        // (32, 4U): the block's columns of gates_x[t]
  float* cts = gxs + rows * 4 * U;    // (32, U): c[t] of the block's units
  float* cps = cts + rows * U;        // (32, U): c[t-1]
  float* dhs = cps + rows * U;        // (32, U): dh[t]
  float* dgs = dhs + rows * U;        // (32, 4U): dgates of the step, the block's columns
  float* recv = dgs + rows * 4 * U;   // 2 x (n, 32, U): dh_rec partials by source rank
  const int slots = n * rows * U;
  const auto gx_copies = gates_own_copies(r0, R, H, U, b);
  const auto unit_copies = units_own_copies(r0, R, H, U, b);
  const auto h_copies = rows_whole_copies(r0, R, H);
  auto prefetch = [&](int t) {
    gx_copies.issue(gxs, gates_x + at(t, d, 0, D, R) * G);
    unit_copies.issue(cts, c_seq + at(t, d, 0, D, R) * H);
    unit_copies.issue(dhs, dh_seq + at(t, d, 0, D, R) * H);
    if (t > 0) {
      unit_copies.issue(cps, c_seq + at(t - 1, d, 0, D, R) * H);
      h_copies.issue(hs, h_seq + at(t - 1, d, 0, D, R) * H);
    }
    cp_async_commit();
  };
  load_w_slice(ws, w_hh + static_cast<size_t>(d) * H * G, H, U, b);
  prefetch(T - 1);
  const bool owner = static_cast<int>(threadIdx.x) < kClusterRows / kRpt * U;
  const int u = threadIdx.x % U, rs = threadIdx.x / U * kRpt;
  float dc[kRpt] = {}, dg[kRpt][4];
  cluster_barrier();  // every block of the cluster runs before any DSMEM store
  for (int t = T - 1; t >= 0; --t) {
    cp_async_wait<0>();
    __syncthreads();  // the step's h[t-1], gates_x, c and dh in
    if (owner) {
      float acc[kRpt][4];
      cluster_gates<kRpt>(acc, gxs, hs, ws, H, U, rs, u, t > 0);
      const float* rb = recv + ((t + 1) & 1) * slots;  // stored in step t + 1
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int row = rs + i;
        float rec = 0.f;
        if (t < T - 1)
          for (int s = 0; s < n; ++s) rec += rb[(s * rows + row) * U + u];  // rank order
        const float ct = cts[row * U + u], cp = t > 0 ? cps[row * U + u] : 0.f;
        const float ig = sigm(acc[i][0]), fg = sigm(acc[i][1]);
        const float gg = tanhf(acc[i][2]), og = sigm(acc[i][3]);
        const float tc = tanhf(ct);
        const float dh = dhs[row * U + u] + rec;
        const float dcc = dh * og * (1.f - tc * tc) + dc[i];
        dg[i][0] = dcc * gg * ig * (1.f - ig);
        dg[i][1] = dcc * cp * fg * (1.f - fg);
        dg[i][2] = dcc * ig * (1.f - gg * gg);
        dg[i][3] = dh * tc * og * (1.f - og);
        dc[i] = dcc * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) dgs[row * 4 * U + g * U + u] = dg[i][g];
      }
    }
    __syncthreads();  // dgs whole; the step's prefetched buffers read
    if (t > 0) {
      prefetch(t - 1);
      // the partial dh_rec = dgs (32, 4U) times ws (4U, H), j ascending, for
      // 8 rows and 2 units an item; units [b' U, (b'+1) U) go to block b',
      // slot b, of the buffer of step t
      float* slot = recv + (t & 1) * slots + b * rows * U;
      const int half = H / 2;
      for (int item = threadIdx.x; item < 4 * half; item += blockDim.x) {
        const int k = 2 * (item % half), rg = item / half * 8;
        float a[8][2] = {};
        for (int j = 0; j < 4 * U; j += 4) {
          float2 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const float2*>(ws + (j + q) * ld + k);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 gv = *reinterpret_cast<const float4*>(dgs + (rg + i) * 4 * U + j);
            a[i][0] = fmaf(gv.x, w[0].x, a[i][0]);
            a[i][1] = fmaf(gv.x, w[0].y, a[i][1]);
            a[i][0] = fmaf(gv.y, w[1].x, a[i][0]);
            a[i][1] = fmaf(gv.y, w[1].y, a[i][1]);
            a[i][0] = fmaf(gv.z, w[2].x, a[i][0]);
            a[i][1] = fmaf(gv.z, w[2].y, a[i][1]);
            a[i][0] = fmaf(gv.w, w[3].x, a[i][0]);
            a[i][1] = fmaf(gv.w, w[3].y, a[i][1]);
          }
        }
        float* dst = cluster.map_shared_rank(slot, k / U) + k % U;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float2*>(dst + (rg + i) * U) = make_float2(a[i][0], a[i][1]);
      }
    }
    // the partials of step t in every block, and every block done reading
    // those of step t + 1; after the last step, no peer stores into this
    // block's shared memory
    cluster_arrive();
    if (owner)
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (r0 + rs + i < R)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dgates[at(t, d, r0 + rs + i, D, R) * G + g * H + b * U + u] = dg[i][g];
    cluster_wait();
  }
}

using ClusterFwd = void (*)(const float*, const float*, float*, float*, int, int, int, int);
using ClusterBwd = void (*)(const float*, const float*, const float*, const float*, const float*,
                            float*, int, int, int, int);

ClusterFwd cluster_fwd_kernel(int rpt) {
  return rpt == 1 ? lstm_scan_fwd_cluster<1>
                  : rpt == 2 ? lstm_scan_fwd_cluster<2> : lstm_scan_fwd_cluster<4>;
}
ClusterBwd cluster_bwd_kernel(int rpt) {
  return rpt == 1 ? lstm_scan_bwd_cluster<1>
                  : rpt == 2 ? lstm_scan_bwd_cluster<2> : lstm_scan_bwd_cluster<4>;
}

// The launch configuration of a cluster kernel (kClusterBlocks blocks a
// cluster); sets the kernel's shared memory and cluster-size attributes.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int err = 0;

  ClusterLaunch(const void* kernel, int tiles, int D, size_t smem, cudaStream_t s) {
    constexpr int n = kClusterBlocks;
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (!err)
      err = static_cast<int>(
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    cfg.gridDim = dim3(n * tiles, D);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// whether the cluster takes H: U = H / kClusterBlocks even and at most 16
// (a thread's copies and items are sized for that), both kernels' shared
// memory within the block's 232,448 bytes
bool cluster_fits(int H) {
  constexpr int n = kClusterBlocks;
  if (H % n || (H / n) % 2 || H / n > 16) return false;
  const size_t most = 232448;
  return sizeof(float) * cluster_bwd_floats(H) <= most &&
         sizeof(float) * cluster_fwd_floats(H) <= most;
}

bool hidden_ok(int H, int most) { return H >= 32 && H % 32 == 0 && H <= most; }
bool shape_ok(int E, int H) { return E > 0 && E % 4 == 0 && hidden_ok(H, kMaxHiddenWide); }

// Workspace layout (float offsets), shared by lstm_bwd_workspace and
// lstm_bwd, and with E = 0 by lstm_scan_bwd_workspace and lstm_scan_bwd
// (whose dgates is its output and which has no db: only wg_part is used).
struct Layout {
  size_t dgates, db_part, wg_part, total;
  int tiles, chunks;

  Layout(int T, int D, int R, int E, int H, int rows) {
    tiles = cdiv(R, rows);
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

size_t fwd_smem(int rows, int E, int H) { return sizeof(float) * rows * (E + H); }
size_t bwd_smem(int rows, int E, int H) { return sizeof(float) * rows * (E + 6 * H); }

// K5 for 256 < H <= 512 on 16-row tiles (H threads a block)
int scan_fwd_tiles(const float* gates_x, const float* w_hh, float* h_seq, float* c_seq, int T,
                   int D, int R, int H, cudaStream_t s) {
  const size_t smem = fwd_smem(16, 0, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_fwd_scan<false, 16>), smem);
  if (err) return err;
  lstm_fwd_scan<false, 16><<<dim3(cdiv(R, 16), D), H, smem, s>>>(
      gates_x, nullptr, nullptr, w_hh, h_seq, c_seq, T, D, R, 0, H);
  return static_cast<int>(cudaGetLastError());
}

// K6's recurrence for 256 < H <= 512 on 16-row tiles
int scan_bwd_tiles(const float* gates_x, const float* w_hh, const float* w_hh_t,
                   const float* h_seq, const float* c_seq, const float* dh_seq, float* dgates,
                   int T, int D, int R, int H, cudaStream_t s) {
  const size_t smem = bwd_smem(16, 0, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_bwd_scan<false, 16>), smem);
  if (err) return err;
  lstm_bwd_scan<false, 16><<<dim3(cdiv(R, 16), D), H, smem, s>>>(
      gates_x, nullptr, nullptr, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dgates, nullptr, T, D, R, 0,
      H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of the two scan kernels, in bytes (the wrapper checks it
// against the card's limit).
size_t lstm_fwd_smem(int E, int H) { return fwd_smem(32, E, H); }
size_t lstm_bwd_smem(int E, int H) { return bwd_smem(32, E, H); }

size_t lstm_bwd_workspace(int T, int D, int R, int E, int H) {
  return Layout(T, D, R, E, H, 32).total;
}

// K3: h_seq and c_seq (T, D, R, H) from x (T, D, R, E). Returns a CUDA
// error code, or 0.
int lstm_fwd(const float* x, const float* w_ih, const float* bias, const float* w_hh,
             float* h_seq, float* c_seq, int T, int D, int R, int E, int H, void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lstm_fwd_smem(E, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_fwd_scan<true, 32>), smem);
  if (err) return err;
  lstm_fwd_scan<true, 32><<<dim3(cdiv(R, 32), D), 2 * H, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const Layout L(T, D, R, E, H, 32);
  const int G = 4 * H;
  const size_t smem = lstm_bwd_smem(E, H);
  int err = set_smem(reinterpret_cast<const void*>(lstm_bwd_scan<true, 32>), smem);
  if (err) return err;
  lstm_bwd_scan<true, 32><<<dim3(L.tiles, D), 2 * H, smem, s>>>(
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

// The cluster of K5/K6 at hidden size H <= 256: info[0..5] = blocks a
// cluster (kClusterBlocks), K5's and K6's shared memory a block in bytes,
// threads a block, and the clusters of K5 and of K6 the card can hold at
// once (cudaOccupancyMaxActiveClusters). Returns a CUDA error code, or 0;
// cudaErrorInvalidValue where the cluster cannot take H.
int lstm_scan_cluster_info(int H, int* info) {
  if (!hidden_ok(H, kMaxHiddenWide) || !cluster_fits(H))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpt = gate_rows(H / kClusterBlocks);
  const size_t fwd = sizeof(float) * cluster_fwd_floats(H);
  const size_t bwd = sizeof(float) * cluster_bwd_floats(H);
  info[0] = kClusterBlocks;
  info[1] = static_cast<int>(fwd);
  info[2] = static_cast<int>(bwd);
  info[3] = kClusterThreads;
  const ClusterLaunch lf(reinterpret_cast<const void*>(cluster_fwd_kernel(rpt)), 1, 1, fwd, 0);
  if (lf.err) return lf.err;
  int err = static_cast<int>(cudaOccupancyMaxActiveClusters(
      &info[4], reinterpret_cast<const void*>(cluster_fwd_kernel(rpt)), &lf.cfg));
  if (err) return err;
  const ClusterLaunch lb(reinterpret_cast<const void*>(cluster_bwd_kernel(rpt)), 1, 1, bwd, 0);
  if (lb.err) return lb.err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      &info[5], reinterpret_cast<const void*>(cluster_bwd_kernel(rpt)), &lb.cfg));
}

// the workspace's db tiles are unused without the projection: any row count
size_t lstm_scan_bwd_workspace(int T, int D, int R, int H) {
  return Layout(T, D, R, 0, H, kClusterRows).total;
}

// K5: h_seq and c_seq (T, D, R, H) from gates_x (T, D, R, 4H) and w_hh
// (D, H, 4H); H <= 256 on clusters, above on 16-row tiles. Returns a CUDA
// error code, or 0.
int lstm_scan_fwd(const float* gates_x, const float* w_hh, float* h_seq, float* c_seq, int T,
                  int D, int R, int H, void* stream) {
  if (!hidden_ok(H, kMaxHidden)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > kMaxHiddenWide) return scan_fwd_tiles(gates_x, w_hh, h_seq, c_seq, T, D, R, H, s);
  if (!cluster_fits(H)) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterFwd kernel = cluster_fwd_kernel(gate_rows(H / kClusterBlocks));
  const ClusterLaunch l(reinterpret_cast<const void*>(kernel), cdiv(R, kClusterRows), D,
                        sizeof(float) * cluster_fwd_floats(H), s);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, kernel, gates_x, w_hh, h_seq, c_seq, T, D,
                                             R, H));
}

// K6: dgates (T, D, R, 4H) and dw_hh (D, H, 4H) from the forward's inputs,
// its h and c, and dh; work holds lstm_scan_bwd_workspace floats; w_hh_t is
// read above H = 256 only (may be null below). Every output is written
// whole. Returns the first launch's CUDA error code, or 0.
int lstm_scan_bwd(const float* gates_x, const float* w_hh, const float* w_hh_t,
                  const float* h_seq, const float* c_seq, const float* dh_seq, float* dgates,
                  float* dw_hh, float* work, int T, int D, int R, int H, void* stream) {
  if (!hidden_ok(H, kMaxHidden)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(T, D, R, 0, H, kClusterRows);
  const int G = 4 * H;
  int err = 0;
  if (H > kMaxHiddenWide) {
    if (!w_hh_t) return static_cast<int>(cudaErrorInvalidValue);
    err = scan_bwd_tiles(gates_x, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dgates, T, D, R, H, s);
  } else {
    if (!cluster_fits(H)) return static_cast<int>(cudaErrorInvalidValue);
    const ClusterBwd kernel = cluster_bwd_kernel(gate_rows(H / kClusterBlocks));
    const ClusterLaunch l(reinterpret_cast<const void*>(kernel), cdiv(R, kClusterRows), D,
                          sizeof(float) * cluster_bwd_floats(H), s);
    err = l.err ? l.err
                : static_cast<int>(cudaLaunchKernelEx(&l.cfg, kernel, gates_x, w_hh, h_seq,
                                                      c_seq, dh_seq, dgates, T, D, R, H));
  }
  if (err) return err;
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
