// LSTM recurrence for NVIDIA Hopper, float32 and bf16 I/O: with the input projection
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
// 262,144 flops a row and step (139.5 GFLOP per BLSTM at 16 x 4 s, 2.08 ms
// at the H100's 67 TFLOP/s in float32) and moves only x, h and c: it is
// bound by operations. The weights (512 KB a direction) do not fit one
// block's shared memory as they fit the TPU's VMEM. The design (K3, the
// ring scan, lstm_fwd_ring):
//
// * One block scans a tile of 64 rows (where 64-row tiles still give each
//   of the 132 SMs a block: TF-GridNet's intra BLSTM) or 32 rows of one
//   direction over all T steps in one launch: no launch and no host work
//   per step. h[t-1] of the tile sits in shared memory, transposed; c
//   stays in registers, each thread owning 4 rows x 4 units x all 4 gates,
//   so the cell update needs no exchange.
// * The rows of [w_ih; w_hh] are streamed through shared memory every step
//   in 16-row k slices (8 above H = 128), by cp.async through a ring of 4
//   stages that runs 3 slices ahead, across steps: no slice depends on h,
//   so the copies never wait on the recurrence. Each stage is read by
//   every warp (one L2 read of 512 KB a step and block, 32 flops a weight
//   byte at 64 rows), and multiplied on a 4 x 16 register tile a thread
//   with one shared-memory wavefront per float4 load. The first K3 read
//   the weights per thread through L1/L2 as float2s at each k (8 warps,
//   8 rows x 2 units a thread) and reached 41 % of the bound; this one
//   reaches about 55 % at the intra shape, the rate of the SIMT GEMMs
//   (more stages, 32-row slices or 2 units a thread did not move it).
// * The gates are never written (a gates_x buffer would be 1.09 GB per
//   intra BLSTM at 16 x 4 s, what the Pallas kernel exists to avoid). A
//   split design, which wrote them with one GEMM (K4's gates GEMM without
//   h) and scanned h w_hh alone over them, was timed against it: slower
//   at the intra shape, a little faster at the inter one, slower over a
//   TF-GridNet forward and 1 GB larger (PERF.md), and was deleted.
//
// K4, the backward, takes h and c and dh and needs, per BLSTM at 16 x 4 s,
// the gates again (x w_ih + bias + h[t-1] w_hh: 139.5 GFLOP), dh_rec =
// dgates w_hh^T (69.8), dx = dgates w_ih^T (69.8) and [dW_ih; dW_hh; db] =
// [x | h[t-1] | 1]^T dgates (139.5): 418.5 GFLOP, 6.2 ms at the f32 rate.
// Only dh_rec is serial in t: the gates are recomputed from the saved h,
// so they leave the scan. Five launches:
//
// 1. the gates, all T steps at once, as one GEMM (lstm_bwd_gates_gemm),
//    each sum in K3's order (k ascending over x, + bias, k ascending over
//    h[t-1]): K3's bits. They go to the dgates workspace;
// 2. the reverse scan (lstm_bwd_rscan): a block owns a 64- or 32-row tile
//    of one direction over all T steps and its threads own (row, unit)
//    pairs in both of a step's phases, so dc and dh_rec stay in registers:
//    dgates[t] from the gates, c, dh and dh_rec, written over the gates in
//    place; then dh_rec = dgates[t] w_hh^T with dgates[t] in shared
//    memory and w_hh^T streamed through a cp.async ring of 32-row chunks
//    (256 KB a direction at H = 128 is more than a block's shared memory);
// 3. dx = dgates w_ih^T (lstm_bwd_dx_gemm);
// 4. [dW_ih; dW_hh] = [x | h[t-1]]^T dgates over chunks of (t, r) pairs,
//    the first row tile's blocks also summing dgates' columns (db, the
//    row of ones) (lstm_bwd_wgrad_gemm);
// 5. the chunks' partials summed in chunk order (sum_partials, one launch
//    for dW and one for db).
//
// The GEMMs are one register-tiled SIMT float32 kernel body (gemm_loop):
// 128 x 128 block tiles, 8 x 8 outputs a thread, 16-deep k slices in a
// two-stage shared-memory ring, rows addressed per time step. No float
// atomics anywhere: two runs give bitwise-equal gradients. The dgates
// workspace (1.09 GB for the intra BLSTM at 16 x 4 s) holds the gates and
// then dgates: K4 needs no more device memory than one gates tensor and
// the weight partials.
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
// over t of h[t-1]^T dgates[t] with K4's weight GEMM (launches 4 and 5
// with E = 0 and no db): bitwise repeatable. dx, dW_ih and db are then the projection's
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
// For 256 < H <= 8192 a float32 w_hh (up to 1 GB a direction) does not
// fit 16 SMs' shared memory: K5 keeps the first K3's scan kernel without
// the projection (lstm_fwd_scan) and K6 a scan of the same layout, on row
// tiles
// whose rows halve as H doubles: 16 rows up to H = 512, 8 up to 1024, 4 up
// to 2048, 2 up to 4096 and 1 up to 8192, reading w_hh through L1/L2 every
// step. A thread owns 8 rows (fewer on a smaller tile) and 2 units, 4, 8
// or 16 units where the tile has 4, 2 or 1 rows, so a block has at most
// 512 threads and a thread 64 gate sums. K6's shared memory is rows x 6H
// floats, 196,608 B at H = 512, 1024, 2048, 4096 and 8192: past 8192 a
// one-row tile is the smallest there is, and its threads would own more
// than 16 units each. On the bf16 route the row tiles hold h, dgates and
// dh_rec as bf16 (the values the rounding points give them), half the
// shared memory: rows x 6H bf16.
//
// SIMT float32 FFMA throughout on the float32 route (no TF32: the parity
// bounds are float32's). Every pointer is a dense float32 buffer in the
// layouts above; w_hh_t is w_hh transposed to
// (D, 4H, H) (the tiled K6 and K4 only), w_ih_t w_ih transposed to (D, 4H,
// E) (K4 only). E is a multiple of 4 (the wrapper pads), H a multiple of
// 32, at most 256 for K3/K4 and 8192 for K5/K6.

// This header holds the kernels and their launch helpers; lstm_scan.cu
// has the C entries and the float32 route, lstm_scan_bf16.cu the bf16
// route (lstm_bf16::): K5/K6's clusters instantiated on bf16 storage, and
// K3-bf16 and K4-bf16, kernels of its own on the bf16 tensor cores.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "simt_gemm.cuh"
#include "tcn_common.cuh"

namespace {

using namespace simt;
using tcn::cdiv;
using tcn::kThreads;

constexpr int kMaxThreads = 512;             // threads of a scan tile's block, at most
constexpr int kMaxHiddenWide = 256;          // largest H of a 32-row tile (K3, clusters)
constexpr int kMaxHidden = 8192;             // largest H of a row tile (K5/K6)
constexpr int kClusterThreads = 256;         // threads of a K5/K6 cluster block
constexpr int kClusterRows = 32;             // rows of a K5/K6 cluster tile
constexpr int kPad = 4;                      // floats padding a shared row of H
// blocks of a K5/K6 cluster at every H <= 256: at DCCRN's shape 16 ran K5
// and K6 faster than 8 (PERF.md), and at H = 256 K6's shared memory needs 16
constexpr int kClusterBlocks = 16;

namespace cg = cooperative_groups;

__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }

// ---------------------------------------------------------------------------
// The bf16 route (bfloat16 storage: x, the weights, the bias, gates_x, h, c,
// dh, dgates and dx). K5/K6's clusters and row tiles are templates on the
// storage S: loads are converted to float32, products are summed in float32
// (the product of two bf16 values is exact in float32); K3-bf16 and K4-bf16
// (lstm_scan_bf16.cu) sum theirs on the bf16 tensor cores in float32. Each
// result is rounded to bf16 (round_bf16, nearest even) where the Pallas
// kernels round under bf16, each of their jnp operations landing at the
// carry dtype (_fwd_x_kernel, _bwd_x_kernel, _fwd_kernel, _bwd_kernel):
//
//   gx = bf16(x w_ih + bias)                   (float32 sum, one rounding)
//   gates = bf16(gx + bf16(h[t-1] w_hh))
//   i, f, g, o = bf16(sig / tanh in float32)
//   c = bf16(bf16(f c[t-1]) + bf16(i g)),  h = bf16(o bf16(tanh c))
//
// with c carried in bf16; the backward repeats the gates, rounds after every
// product and sum of its do / dc / di / df / dg chain (bwd_cell_bf16),
// dh_rec = bf16(dgates w_hh^T), dx = bf16(dgates w_ih^T), and sums the
// weight gradients in float32 (the wrapper casts them to the weights'
// dtype). ops/lstm_scan.py's plain versions mirror these points. The float32
// instantiations are the float32 route's code.

using simt::round_bf16;

template <class S>
constexpr bool kIsBf16 = std::is_same_v<S, bf16>;

// four neighbouring values in shared memory as float32 (16 bytes of float32,
// 8 of bf16)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two bf16 of a packed pair as float32, and two float32 rounded into one
__device__ __forceinline__ float2 unpack2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}

// One unit's cell on the bf16 route: c (bf16, carried) and h from the gate
// pre-activations z (i, f, g, o), rounded as _fwd_x_kernel rounds them.
__device__ __forceinline__ void cell_bf16(float zi, float zf, float zg, float zo, float& c,
                                          float& h) {
  const float ig = round_bf16(sigm(zi)), fg = round_bf16(sigm(zf));
  const float gg = round_bf16(tanhf(zg)), og = round_bf16(sigm(zo));
  c = round_bf16(round_bf16(fg * c) + round_bf16(ig * gg));
  h = round_bf16(og * round_bf16(tanhf(c)));
}

// One unit's reverse step on the bf16 route, as _bwd_x_kernel rounds it:
// from the pre-activations z (i, f, g, o), c[t], c[t-1], dh[t] and dh_rec
// (bf16), dg = d(i, f, g, o) and the carried dc <- bf16(dc f).
__device__ __forceinline__ void bwd_cell_bf16(const float (&z)[4], float ct, float cp, float dh_t,
                                              float rec, float& dc, float (&dg)[4]) {
  const float ig = round_bf16(sigm(z[0])), fg = round_bf16(sigm(z[1]));
  const float gg = round_bf16(tanhf(z[2])), og = round_bf16(sigm(z[3]));
  const float tc = round_bf16(tanhf(ct));
  const float dh = round_bf16(dh_t + rec);
  dg[3] = round_bf16(round_bf16(round_bf16(dh * tc) * og) * round_bf16(1.f - og));
  const float dcc = round_bf16(
      round_bf16(round_bf16(dh * og) * round_bf16(1.f - round_bf16(tc * tc))) + dc);
  dg[0] = round_bf16(round_bf16(round_bf16(dcc * gg) * ig) * round_bf16(1.f - ig));
  dg[1] = round_bf16(round_bf16(round_bf16(dcc * cp) * fg) * round_bf16(1.f - fg));
  dg[2] = round_bf16(round_bf16(dcc * ig) * round_bf16(1.f - round_bf16(gg * gg)));
  dc = round_bf16(dcc * fg);
}

__device__ __forceinline__ size_t at(int t, int d, int r, int D, int R) {
  return (static_cast<size_t>(t) * D + d) * R + r;
}

// Two neighbouring values of float32 or bf16 storage as float32 (8 bytes of
// float32, 4 of bf16), from shared or device memory (ldg_pair: through the
// read-only path), and two float32 stored (bf16: each rounded once).
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return unpack2(*reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const bf16* p) {
  return unpack2(__ldg(reinterpret_cast<const unsigned*>(p)));
}
__device__ __forceinline__ void st_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st_pair(bf16* p, float2 v) {
  *reinterpret_cast<unsigned*>(p) = pack2(v.x, v.y);
}

// rows r0 .. r0 + kRows - 1 of a (R, n) slab into dst (kRows, n), zero past
// R, in 16-byte pieces; n is a multiple of 16 / sizeof(S).
template <int kRows, class S>
__device__ __forceinline__ void load_rows(S* dst, const S* __restrict__ src, int r0, int R,
                                          int n) {
  constexpr int kPer = 16 / sizeof(S);
  const int q = n / kPer;
  for (int i = threadIdx.x; i < kRows * q; i += blockDim.x) {
    const int row = i / q, c4 = i % q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < R)
      v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * n) + c4);
    reinterpret_cast<uint4*>(dst + row * n)[c4] = v;
  }
}

// How a scan's row tile of kRows rows splits over its threads: a thread
// owns kRt rows and kP pairs of neighbouring units, with all four gates;
// pair p of thread unit group ug is units 2 (ug + p H / (2 kP)) and the
// next, so a warp's loads of a pair are neighbouring float2s. 8 rows and 1
// pair a thread on tiles of 8 rows or more ((kRows / 8) x H / 2 threads);
// on smaller tiles all the rows and 16 units (H / 16 threads at 1 row):
// 64 gate sums a thread in every case.
template <int kRows>
struct Split {
  static constexpr int kRt = kRows < 8 ? kRows : 8;     // rows a thread
  static constexpr int kP = kRows < 8 ? 8 / kRows : 1;  // unit pairs a thread
  static int threads(int H) { return kRows / kRt * (H / (2 * kP)); }
};

// acc += a (kRows, K) in shared memory times w (K, 4H) in device memory,
// for the thread's rows rg * kRt + i and columns g H + 2 (ug + p H / 2kP) +
// u, k ascending.
template <int kRt, int kU, class S>
__device__ __forceinline__ void gemm_rows(float (&acc)[kRt][4][kU], const S* a,
                                          const S* __restrict__ w, int K, int H, int rg,
                                          int ug) {
  constexpr int kP = kU / 2;
  const int G = 4 * H, np = H / kU;
  const S* arow = a + rg * kRt * K;
  for (int k = 0; k < K; k += 2) {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const S* wcol = w + 2 * (ug + p * np);
      float2 w0[4], w1[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        w0[g] = ldg_pair(wcol + static_cast<size_t>(k) * G + g * H);
        w1[g] = ldg_pair(wcol + static_cast<size_t>(k + 1) * G + g * H);
      }
#pragma unroll
      for (int i = 0; i < kRt; ++i) {
        const float2 av = ld_pair(arow + i * K + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float* o = acc[i][g] + 2 * p;
          o[0] = fmaf(av.x, w0[g].x, o[0]);
          o[1] = fmaf(av.x, w0[g].y, o[1]);
          o[0] = fmaf(av.y, w1[g].x, o[0]);
          o[1] = fmaf(av.y, w1[g].y, o[1]);
        }
      }
    }
  }
}

// The gate pre-activations of the thread's rows and units, gates_x[t] +
// h_prev w_hh, the h_prev w_hh term skipped at t = 0: gx points at the
// tile's first row of gates_x[t] and rows_left = R - r0 (rows past R read
// as 0). On the bf16 route the product is summed from 0 and each gate is
// bf16(gx + bf16(h w_hh)), as cluster_gates forms it. K5's and K6's row
// tiles both call this, so they get the same bits.
template <int kRt, int kU, class S>
__device__ __forceinline__ void gates_tile(float (&acc)[kRt][4][kU], const S* hs,
                                           const S* __restrict__ gx,
                                           const S* __restrict__ wh, int H, int rg, int ug,
                                           int rows_left, bool has_h) {
  constexpr int kP = kU / 2;
  const int np = H / kU, G = 4 * H;
  // gates_x of the thread's rows and units (0 past R): into acc first on
  // the float32 route, added after the product on the bf16 one
  auto add_gx = [&](bool round) {
#pragma unroll
    for (int i = 0; i < kRt; ++i) {
      const int row = rg * kRt + i;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          float2 v = make_float2(0.f, 0.f);
          if (row < rows_left)
            v = ldg_pair(gx + static_cast<size_t>(row) * G + g * H + 2 * (ug + p * np));
          float* o = acc[i][g] + 2 * p;
          if (round) {
            o[0] = round_bf16(v.x + round_bf16(o[0]));
            o[1] = round_bf16(v.y + round_bf16(o[1]));
          } else {
            o[0] = v.x;
            o[1] = v.y;
          }
        }
    }
  };
  if constexpr (kIsBf16<S>) {
#pragma unroll
    for (int i = 0; i < kRt; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[i][g][u] = 0.f;
  } else {
    add_gx(false);
  }
  if (has_h) gemm_rows<kRt, kU>(acc, hs, wh, H, H, rg, ug);
  if constexpr (kIsBf16<S>) add_gx(true);
}

// K5 for 256 < H <= 8192 over gates_x (T, D, R, 4H), storage S (float, or
// bf16: the cell of cell_bf16, c carried in bf16). grid (cdiv(R, kRows),
// D), Split<kRows>::threads(H) threads, kRows H values of S of dynamic
// shared memory (h of the tile).
template <int kRows, class S>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_scan(const S* __restrict__ gates_x, const S* __restrict__ w_hh, S* __restrict__ h_seq,
              S* __restrict__ c_seq, int T, int D, int R, int H) {
  constexpr int kRt = Split<kRows>::kRt, kP = Split<kRows>::kP;
  extern __shared__ float smem[];
  S* hs = reinterpret_cast<S*>(smem);  // (kRows, H)
  const int d = blockIdx.y, r0 = blockIdx.x * kRows, G = 4 * H, np = H / (2 * kP);
  const int rg = threadIdx.x / np, ug = threadIdx.x % np;
  const S* wh = w_hh + static_cast<size_t>(d) * H * G;
  float c[kRt][2 * kP] = {};
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // h[t-1] of the tile in shared memory
    float acc[kRt][4][2 * kP];
    gates_tile<kRt, 2 * kP>(acc, hs, gates_x + at(t, d, r0, D, R) * G, wh, H, rg, ug, R - r0,
                            t > 0);
    __syncthreads();  // every thread is done reading hs
#pragma unroll
    for (int i = 0; i < kRt; ++i) {
      const int row = rg * kRt + i;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        float2 hv, cv;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = 2 * p + u;
          float hn;
          if constexpr (kIsBf16<S>) {
            cell_bf16(acc[i][0][q], acc[i][1][q], acc[i][2][q], acc[i][3][q], c[i][q], hn);
          } else {
            const float cn =
                sigm(acc[i][1][q]) * c[i][q] + sigm(acc[i][0][q]) * tanhf(acc[i][2][q]);
            hn = sigm(acc[i][3][q]) * tanhf(cn);
            c[i][q] = cn;
          }
          (u ? hv.y : hv.x) = hn;
          (u ? cv.y : cv.x) = c[i][q];
        }
        const int unit = 2 * (ug + p * np);
        st_pair(hs + row * H + unit, hv);
        if (r0 + row < R) {
          const size_t o = at(t, d, r0 + row, D, R) * H + unit;
          st_pair(h_seq + o, hv);
          st_pair(c_seq + o, cv);
        }
      }
    }
  }
}

// K6's recurrence for 256 < H <= 8192. Reverse time over the tile:
// recompute the gates from gates_x and the saved h with K5's code (the same
// bits), form dgates (written to device memory), carry dc in registers and
// dh_rec = dgates w_hh^T in shared memory slots that only their own thread
// reads (registers would pass the 128 a thread has at 512 threads). On the
// bf16 route (S = bf16) the step is bwd_cell_bf16's and dh_rec is rounded
// once, where it is stored. grid (cdiv(R, kRows), D),
// Split<kRows>::threads(H) threads, kRows 6H values of S of dynamic shared
// memory.
template <int kRows, class S>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_scan(const S* __restrict__ gates_x, const S* __restrict__ w_hh,
              const S* __restrict__ w_hh_t, const S* __restrict__ h_seq,
              const S* __restrict__ c_seq, const S* __restrict__ dh_seq,
              S* __restrict__ dgates, int T, int D, int R, int H) {
  constexpr int kRt = Split<kRows>::kRt, kP = Split<kRows>::kP;
  extern __shared__ float smem[];
  const int G = 4 * H, np = H / (2 * kP);
  S* hs = reinterpret_cast<S*>(smem);  // (kRows, H)
  S* gs = hs + kRows * H;              // (kRows, 4H): dgates of the step
  S* dhs = gs + kRows * G;             // (kRows, H): dh_rec
  const int d = blockIdx.y, r0 = blockIdx.x * kRows;
  const int rg = threadIdx.x / np, ug = threadIdx.x % np;
  const S* wh = w_hh + static_cast<size_t>(d) * H * G;
  const S* wht = w_hh_t + static_cast<size_t>(d) * G * H;
  float dc[kRt][2 * kP] = {};
#pragma unroll
  for (int i = 0; i < kRt; ++i)
#pragma unroll
    for (int p = 0; p < kP; ++p)
      st_pair(dhs + (rg * kRt + i) * H + 2 * (ug + p * np), make_float2(0.f, 0.f));
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load_rows<kRows>(hs, h_seq + at(t - 1, d, 0, D, R) * H, r0, R, H);
    __syncthreads();  // h[t-1] in; the previous step's gs reads done
    float acc[kRt][4][2 * kP];
    gates_tile<kRt, 2 * kP>(acc, hs, gates_x + at(t, d, r0, D, R) * G, wh, H, rg, ug, R - r0,
                            t > 0);
#pragma unroll
    for (int i = 0; i < kRt; ++i) {
      const int row = rg * kRt + i;
      const bool live = r0 + row < R;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int unit = 2 * (ug + p * np);
        const size_t o = at(t, d, r0 + row, D, R) * H + unit;
        float2 ct = make_float2(0.f, 0.f), cp = ct, dhv = ct;
        if (live) {
          ct = ld_pair(c_seq + o);
          dhv = ld_pair(dh_seq + o);
          if (t > 0) cp = ld_pair(c_seq + o - static_cast<size_t>(D) * R * H);
        }
        const float2 rec = ld_pair(dhs + row * H + unit);
        float dgt[4][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = 2 * p + u;
          if constexpr (kIsBf16<S>) {
            const float z[4] = {acc[i][0][q], acc[i][1][q], acc[i][2][q], acc[i][3][q]};
            float dg[4];
            bwd_cell_bf16(z, u ? ct.y : ct.x, u ? cp.y : cp.x, u ? dhv.y : dhv.x,
                          u ? rec.y : rec.x, dc[i][q], dg);
#pragma unroll
            for (int g = 0; g < 4; ++g) dgt[g][u] = dg[g];
          } else {
            const float ig = sigm(acc[i][0][q]), fg = sigm(acc[i][1][q]);
            const float gg = tanhf(acc[i][2][q]), og = sigm(acc[i][3][q]);
            const float tc = tanhf(u ? ct.y : ct.x);
            const float dh = (u ? dhv.y : dhv.x) + (u ? rec.y : rec.x);
            const float dcc = dh * og * (1.f - tc * tc) + dc[i][q];
            dgt[0][u] = dcc * gg * ig * (1.f - ig);
            dgt[1][u] = dcc * (u ? cp.y : cp.x) * fg * (1.f - fg);
            dgt[2][u] = dcc * ig * (1.f - gg * gg);
            dgt[3][u] = dh * tc * og * (1.f - og);
            dc[i][q] = dcc * fg;
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = make_float2(dgt[g][0], dgt[g][1]);
          st_pair(gs + row * G + g * H + unit, v);
          if (live) st_pair(dgates + at(t, d, r0 + row, D, R) * G + g * H + unit, v);
        }
      }
    }
    __syncthreads();  // gs whole; hs reads done
    // dh_rec = dgates w_hh^T for the thread's rows and units, j ascending
    float dh_rec[kRt][2 * kP] = {};
    const S* grow = gs + rg * kRt * G;
    for (int j = 0; j < G; j += 2) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int unit = 2 * (ug + p * np);
        const float2 w0 = ldg_pair(wht + static_cast<size_t>(j) * H + unit);
        const float2 w1 = ldg_pair(wht + static_cast<size_t>(j + 1) * H + unit);
#pragma unroll
        for (int i = 0; i < kRt; ++i) {
          const float2 gv = ld_pair(grow + i * G + j);
          float* r = dh_rec[i] + 2 * p;
          r[0] = fmaf(gv.x, w0.x, r[0]);
          r[1] = fmaf(gv.x, w0.y, r[1]);
          r[0] = fmaf(gv.y, w1.x, r[0]);
          r[1] = fmaf(gv.y, w1.y, r[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRt; ++i)
#pragma unroll
      for (int p = 0; p < kP; ++p)
        st_pair(dhs + (rg * kRt + i) * H + 2 * (ug + p * np),
                make_float2(dh_rec[i][2 * p], dh_rec[i][2 * p + 1]));
  }
}

// ---------------------------------------------------------------------------
// K4's products and K6's weight gradient on the float32 route run on the
// SIMT GEMM body of simt_gemm.cuh (gemm_loop: 128 x 128 tiles, 8 x 8 outputs
// a thread); the bf16 route's on mma_bf16.cuh's (lstm_scan_bf16.cu).

// K4's gate pre-activations out of the serial chain: pre[t, d, r] =
// (x[t, d, r] w_ih[d] + bias[d]) + h[t-1, d, r] w_hh[d] (h[-1] = 0) into
// pre (T, D, R, 4H), over k ascending: x's slices, the bias, then h's, as
// K3 (lstm_fwd_ring) sums them, so that these are K3's bits.
struct GatesOp {
  const float *xrow, *hrow, *wi, *wh, *bias;
  int E, H, nx;
  RowStage<true> a;

  __device__ __forceinline__ void fetch(int s, float*, float* Bs) {
    const int G = 4 * H, n0 = blockIdx.y * kGM;
    if (s < nx) {
      const int k0 = s * kGK;
      a.load(xrow, k0, E);
      stage_direct(Bs, [&](int k, int c) -> const float* {
        return k0 + k < E ? wi + static_cast<size_t>(k0 + k) * G + n0 + c : nullptr;
      }, wi);
    } else {
      const int k0 = (s - nx) * kGK;
      a.load(hrow, k0, H);
      stage_direct(Bs, [&](int k, int c) -> const float* {
        return wh + static_cast<size_t>(k0 + k) * G + n0 + c;
      }, wh);
    }
  }
  __device__ __forceinline__ void store(float* As) { a.store(As); }
  __device__ __forceinline__ void after(int s, float (&acc)[8][8], const float*) {
    if (s != nx - 1) return;
    const int n0 = blockIdx.y * kGM;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = ldf(bias + n0 + frag_col(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] += b;
    }
  }
};

// grid (cdiv(T R, 128), 4H / 128, D): rows m = t R + r of direction d
__global__ void __launch_bounds__(kGemmThreads, 2)
lstm_bwd_gates_gemm(const float* __restrict__ x, const float* __restrict__ w_ih,
                    const float* __restrict__ bias, const float* __restrict__ w_hh,
                    const float* __restrict__ h_seq, float* __restrict__ pre, int T, int D, int R,
                    int E, int H) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int d = blockIdx.z, G = 4 * H, M = T * R, m0 = blockIdx.x * kGM;
  GatesOp op;
  op.xrow = op.hrow = nullptr;
  const int m = m0 + threadIdx.x % kGM;  // the row this thread stages
  if (m < M) {
    const int t = m / R, r = m % R;
    op.xrow = x + at(t, d, r, D, R) * E;
    if (t > 0) op.hrow = h_seq + at(t - 1, d, r, D, R) * H;
  }
  op.wi = w_ih + static_cast<size_t>(d) * E * G;
  op.wh = w_hh + static_cast<size_t>(d) * H * G;
  op.bias = bias + d * G;
  op.E = E;
  op.H = H;
  op.nx = cdiv(E, kGK);
  float acc[8][8] = {};
  gemm_loop(op, acc, op.nx + H / kGK, sm);
  store_tile(acc, [&](int i) -> float* {
    const int mm = m0 + i;
    return mm < M ? pre + at(mm / R, d, mm % R, D, R) * G : nullptr;
  }, blockIdx.y * kGM, G);
}

// dx = dgates w_ih^T with w_ih^T (4H, E) stored: its rows are the k slices
struct DxOp {
  const float *grow, *wt;
  int G, E;
  RowStage<true> a;

  __device__ __forceinline__ void fetch(int s, float*, float* Bs) {
    const int k0 = s * kGK, n0 = blockIdx.y * kGM;
    a.load(grow, k0, G);
    stage_direct(Bs, [&](int k, int c) -> const float* {
      return n0 + c < E ? wt + static_cast<size_t>(k0 + k) * E + n0 + c : nullptr;
    }, wt);
  }
  __device__ __forceinline__ void store(float* As) { a.store(As); }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

// grid (cdiv(T R, 128), cdiv(E, 128), D)
__global__ void __launch_bounds__(kGemmThreads, 2)
lstm_bwd_dx_gemm(const float* __restrict__ dgates, const float* __restrict__ w_ih_t,
                 float* __restrict__ dx, int T, int D, int R, int E, int H) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int d = blockIdx.z, G = 4 * H, M = T * R, m0 = blockIdx.x * kGM;
  DxOp op;
  const int m = m0 + threadIdx.x % kGM;
  op.grow = m < M ? dgates + at(m / R, d, m % R, D, R) * G : nullptr;
  op.wt = w_ih_t + static_cast<size_t>(d) * G * E;
  op.G = G;
  op.E = E;
  float acc[8][8] = {};
  gemm_loop(op, acc, G / kGK, sm);
  store_tile(acc, [&](int i) -> float* {
    const int mm = m0 + i;
    return mm < M ? dx + at(mm / R, d, mm % R, D, R) * E : nullptr;
  }, blockIdx.y * kGM, E);
}

// Weight-gradient partials over the pairs p in [p0, p1) of a chunk, p =
// t R + r: rows m < E + H of a = [x[t] | h[t-1]] (h[-1] = 0) and columns
// n of dgates[p], k ascending; with kDb the first row tile's threads
// tid < 128 also sum dgates' column n0 + tid (the row of ones) in the
// same order. The operands go to shared memory by cp.async.
template <bool kDb>
struct WgradOp {
  const float *x, *h_seq, *dg;
  int D, R, E, H, d, p0, p1;
  float db = 0.f;

  __device__ __forceinline__ void fetch(int s, float* As, float* Bs) {
    const int k0 = p0 + s * kGK, m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM, G = 4 * H;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * kGemmThreads, k = i / 32, c = i % 32 * 4;
      const int p = k0 + k, m = m0 + c;
      const float *pa = nullptr, *pb = nullptr;
      if (p < p1) {
        const int t = p / R;
        const size_t row = at(t, d, p % R, D, R);
        if (m < E)
          pa = x + row * E + m;
        else if (m < E + H && t > 0)
          pa = h_seq + (row - static_cast<size_t>(D) * R) * H + (m - E);
        pb = dg + row * G + n0 + c;
      }
      cp_async<16>(As + k * kGLd + c, pa ? pa : dg, pa != nullptr);
      cp_async<16>(Bs + k * kGLd + c, pb ? pb : dg, pb != nullptr);
    }
  }
  __device__ __forceinline__ void store(float*) {}
  __device__ __forceinline__ void after(int, float (&)[8][8], const float* Bs) {
    if constexpr (kDb) {
      if (blockIdx.x != 0 || threadIdx.x >= kGM) return;
#pragma unroll
      for (int k = 0; k < kGK; ++k) db += Bs[k * kGLd + threadIdx.x];
    }
  }
};

// part[d][c] (E + H + kDb, 4H) of chunk c of `chunk` pairs; grid
// (cdiv(E + H, 128), 4H / 128, D chunks). x is not read when E = 0 (K6).
template <bool kDb>
__global__ void __launch_bounds__(kGemmThreads, 2)
lstm_bwd_wgrad_gemm(const float* __restrict__ x, const float* __restrict__ h_seq,
                    const float* __restrict__ dgates, float* __restrict__ part, int T, int D,
                    int R, int E, int H, int chunks, int chunk) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int G = 4 * H, rows = E + H + (kDb ? 1 : 0);
  WgradOp<kDb> op;
  op.x = x;
  op.h_seq = h_seq;
  op.dg = dgates;
  op.D = D;
  op.R = R;
  op.E = E;
  op.H = H;
  op.d = blockIdx.z / chunks;
  op.p0 = (blockIdx.z % chunks) * chunk;
  op.p1 = min(op.p0 + chunk, T * R);
  float acc[8][8] = {};
  gemm_loop(op, acc, cdiv(op.p1 - op.p0, kGK), sm);
  float* out = part + static_cast<size_t>(blockIdx.z) * rows * G;
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
  store_tile(acc, [&](int i) -> float* {
    return m0 + i < E + H ? out + static_cast<size_t>(m0 + i) * G : nullptr;
  }, n0, G);
  if (kDb && blockIdx.x == 0 && threadIdx.x < kGM)
    out[static_cast<size_t>(E + H) * G + n0 + threadIdx.x] = op.db;
}

// out[d][i] = sum over c < n_part of part[d][c][i] in ascending c, i < n,
// stride floats from one partial to the next (part[d] starts n_part
// strides after part[d - 1]); each thread owns one i. grid (cdiv(n,
// kThreads), D)
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ part, int n_part, size_t stride, int n,
             float* __restrict__ out, size_t out_stride) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* p = part + static_cast<size_t>(blockIdx.y) * n_part * stride + i;
  float s = 0.f;
  for (int c = 0; c < n_part; ++c) s += p[static_cast<size_t>(c) * stride];
  out[blockIdx.y * out_stride + i] = s;
}

// ---------------------------------------------------------------------------
// K4's reverse scan over the gate pre-activations

// The scan's ring: kRing chunks of w_hh^T rows, 64 KB in all: chunks of
// 32 rows at H <= 128 (half the block barriers a step of 16-row chunks),
// of 16 above
constexpr int kRing = 4;
__host__ __device__ constexpr int chunk_rows(int H) { return H <= 128 ? 32 : 16; }

// shared memory (floats) of the scan at a tile of `rows` rows: dgates of a
// step, transposed (4H, rows + 4), and the ring (kRing, chunk_rows(H), H)
size_t rscan_floats(int rows, int H) {
  return static_cast<size_t>(4) * H * (rows + 4) +
         static_cast<size_t>(kRing) * chunk_rows(H) * H;
}

template <int n>
__device__ __forceinline__ void load_vec(float (&v)[n], const float* p) {
  if constexpr (n == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

template <int n>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[n]) {
  if constexpr (n == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The thread's row group ry and unit group ux, tx = H / 8 unit groups: a
// warp's lanes are 4 row groups x 8 unit groups where tx is a multiple of
// 8 (so that its w_hh^T loads are one 128-byte wavefront and its dgates^T
// loads 4 addresses), else unit groups fastest.
__device__ __forceinline__ void scan_owner(int tx, int& ry, int& ux) {
  if (tx % 8 == 0) {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32, wx = tx / 8;
    ux = (w % wx) * 8 + l % 8;
    ry = (w / wx) * 4 + l / 8;
  } else {
    ux = threadIdx.x % tx;
    ry = threadIdx.x / tx;
  }
}

// four neighbouring gates or dgates of K4's workspace as float32 (written
// in place by the reverse scan: a plain load, not __ldg)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// g: the gates (T, D, R, 4H) in, dgates out, in place. grid (cdiv(R,
// kRows), D), (kRows / kRt) (H / 8) threads, rscan_floats(kRows, H) floats
// of dynamic shared memory. Thread (ry, ux) owns rows ry kRt .. + kRt - 1
// of the tile and units ux 4 .. + 3 and H / 2 + that, in the step's
// elementwise phase and as its outputs of dh_rec = dgates w_hh^T (k
// ascending over the 4H columns), so dc and dh_rec stay in its registers.
// The product streams w_hh^T from L2 every step (256 KB a direction at
// H = 128), three chunks ahead.
template <int kRows, int kRt>
__global__ void __launch_bounds__(kGemmThreads, 1)
lstm_bwd_rscan(float* __restrict__ g, const float* __restrict__ w_hh_t,
               const float* __restrict__ c_seq, const float* __restrict__ dh_seq, int T, int D,
               int R, int H) {
  constexpr int ld = kRows + 4;
  // the instantiations: (64, 4) and (32, 2) at H <= 128, (32, 4) above
  constexpr int kChunk = kRows == 64 || kRt == 2 ? chunk_rows(128) : chunk_rows(256);
  extern __shared__ float smem[];
  const int G = 4 * H, half = H / 2, tx = H / 8;
  float* dgs = smem;                                 // (4H, ld): dgates[t]^T
  float* ring = smem + static_cast<size_t>(G) * ld;  // (kRing, kChunk, H)
  const int d = blockIdx.y, r0 = blockIdx.x * kRows;
  int ry, ux;
  scan_owner(tx, ry, ux);
  const float* wt = w_hh_t + static_cast<size_t>(d) * G * H;
  const int per_step = G / kChunk, total = (T - 1) * per_step;
  // chunk s of the product's sequence (step T - 1 - s / per_step, rows
  // s % per_step of w_hh^T) into its ring slot, in 16-byte pieces; one
  // commit group each
  auto issue = [&](int s) {
    if (s < total) {
      const float* src = wt + static_cast<size_t>(s % per_step) * kChunk * H;
      float* dst = ring + (s % kRing) * kChunk * H;
      for (int i = threadIdx.x; i < kChunk * H / 4; i += blockDim.x)
        cp_async<16>(dst + 4 * i, src + 4 * i, true);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  float dc[kRt][8], rec[kRt][8];
#pragma unroll
  for (int i = 0; i < kRt; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dc[i][j] = rec[i][j] = 0.f;
  int s = 0;  // chunks consumed
  for (int t = T - 1; t >= 0; --t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = q * half + ux * 4;
      float dg[4][4][kRt];  // [gate][unit][row]
#pragma unroll
      for (int i = 0; i < kRt; ++i) {
        const int row = r0 + ry * kRt + i;
        const bool live = row < R;
        const size_t o = live ? at(t, d, row, D, R) : 0;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 pre[4], ct = zero, cp = zero, dhv = zero;
#pragma unroll
        for (int k = 0; k < 4; ++k) pre[k] = zero;
        if (live) {
#pragma unroll
          for (int k = 0; k < 4; ++k) pre[k] = ld4(g + o * G + k * H + u);
          ct = ldg4(c_seq + o * H + u);
          dhv = ldg4(dh_seq + o * H + u);
          if (t > 0) cp = ldg4(c_seq + (o - static_cast<size_t>(D) * R) * H + u);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ig = sigm(lane(pre[0], j)), fg = sigm(lane(pre[1], j));
          const float gg = tanhf(lane(pre[2], j)), og = sigm(lane(pre[3], j));
          const float tc = tanhf(lane(ct, j));
          const float dh = lane(dhv, j) + rec[i][4 * q + j];
          const float dcc = dh * og * (1.f - tc * tc) + dc[i][4 * q + j];
          dg[0][j][i] = live ? dcc * gg * ig * (1.f - ig) : 0.f;
          dg[1][j][i] = live ? dcc * lane(cp, j) * fg * (1.f - fg) : 0.f;
          dg[2][j][i] = live ? dcc * ig * (1.f - gg * gg) : 0.f;
          dg[3][j][i] = live ? dh * tc * og * (1.f - og) : 0.f;
          dc[i][4 * q + j] = dcc * fg;
        }
        if (live)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            st4(g + o * G + k * H + u, dg[k][0][i], dg[k][1][i], dg[k][2][i], dg[k][3][i]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_vec<kRt>(dgs + static_cast<size_t>(k * H + u + j) * ld + ry * kRt, dg[k][j]);
    }
    if (t == 0) break;
    // dh_rec of step t - 1: dgates[t] w_hh^T, chunk by chunk of w_hh^T rows
    float acc[kRt][8];
#pragma unroll
    for (int i = 0; i < kRt; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < per_step; ++c, ++s) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // chunk s in; dgs whole; every thread done with chunk s - 1
      issue(s + kRing - 1);
      const float* w = ring + (s % kRing) * kChunk * H + ux * 4;
      const float* a = dgs + static_cast<size_t>(c) * kChunk * ld + ry * kRt;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        float av[kRt];
        load_vec<kRt>(av, a + k * ld);
        const float4 b0 = lds4(w + k * H);
        const float4 b1 = lds4(w + k * H + half);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kRt; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread done reading dgs before the next step writes it
#pragma unroll
    for (int i = 0; i < kRt; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) rec[i][j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// K3: the forward scan with the projection inside, [w_ih; w_hh] streamed
// through a shared-memory ring

// stages of K3's ring; its k slice (rows of [w_ih; w_hh] a stage): 16 at
// H <= 128, 8 above, so that a slice of the 4H columns is at most 32 KB
constexpr int kFwdRing = 4;
__host__ __device__ constexpr int fwd_slice(int H) { return H <= 128 ? 16 : 8; }
constexpr int kFwdUnits = 4;  // units a K3 thread owns, with 4 rows and all 4 gates

// shared memory (floats) of K3 at a tile of `rows` rows: h[t-1] of the tile,
// transposed (H, rows + 4), and kFwdRing stages of a slice: the x[t] columns
// of its k, transposed (slice, rows + 4), and its rows of [w_ih; w_hh]
// (slice, 4H)
size_t fwd_floats(int rows, int H) {
  const size_t ld = rows + 4, k = fwd_slice(H);
  return H * ld + kFwdRing * k * (ld + 4 * static_cast<size_t>(H));
}

// K3: h_seq and c_seq (T, D, R, H) from x (T, D, R, E), the projection
// inside. grid (cdiv(R, kRows), D), kRows H / 16
// threads, fwd_floats(kRows, H) floats of dynamic shared memory. Thread
// (rg, ug) (a warp is 4 row groups x 8 unit groups, so each of its shared
// loads is one wavefront) owns rows 4 rg .. + 3 of the tile and units 4 ug
// .. + 3 with all four gates: 64 sums, and the cell update in its
// registers. A step is the product [x[t] | h[t-1]] [w_ih; w_hh] over k
// slices in the ring's order, x's slices (k ascending, zero past E), the
// bias, then h's: each sum an fmaf chain in K4's gates GEMM's order
// (lstm_bwd_gates_gemm), so K4 recomputes these bits. Every
// stage is filled by cp.async kFwdRing - 1 slices ahead, across steps (no
// slice depends on h), and read by every warp; h[t-1] is the block's own.
// kKeep: the gate pre-activations go to gates_out (T, D, R, 4H) too (the
// check that they are K4's).
template <int kRows, int kK, bool kKeep>
__global__ void __launch_bounds__(kRows * (kK == 16 ? 128 : 256) / (4 * kFwdUnits), 1)
lstm_fwd_ring(const float* __restrict__ x, const float* __restrict__ w_ih,
              const float* __restrict__ bias, const float* __restrict__ w_hh,
              float* __restrict__ h_seq, float* __restrict__ c_seq,
              float* __restrict__ gates_out, int T, int D, int R, int E, int H) {
  extern __shared__ float smem[];
  constexpr int ld = kRows + 4;
  const int G = 4 * H, d = blockIdx.y, r0 = blockIdx.x * kRows, nthr = blockDim.x;
  const int stage = kK * (ld + G);
  float* hs = smem;              // (H, ld): h[t-1]^T
  float* ring = smem + H * ld;   // kFwdRing x [(kK, ld) x slice^T | (kK, 4H) weights]
  const int ugs = H / kFwdUnits, wx = ugs / 8, w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int ug = (w % wx) * 8 + l % 8, rg = (w / wx) * 4 + l / 8;
  const int nx = cdiv(E, kK), n_step = nx + H / kK;
  const float* wi = w_ih + static_cast<size_t>(d) * E * G;
  const float* wh = w_hh + static_cast<size_t>(d) * H * G;
  // the next slice to issue: step it, slice isl, stage iq % kFwdRing; one
  // commit group each (empty past the last step). A slice's rows of the
  // (K, 4H) weights are one contiguous run, 4 kK kFwdUnits / kRows float4 pieces
  // a thread; x[t]'s columns k0 .. k0 + kK - 1 of the tile are copied as
  // single floats into their transposed places.
  int it = 0, isl = 0, iq = 0;
  auto issue = [&]() {
    if (it < T) {
      float* st = ring + (iq % kFwdRing) * stage;
      const bool xs = isl < nx;
      const int k0 = (xs ? isl : isl - nx) * kK, K = xs ? E : H;
      const float* src = (xs ? wi : wh) + static_cast<size_t>(k0) * G;
      const int n_ok = (K - k0) * H;  // pieces of the rows k < K
#pragma unroll
      for (int m = 0; m < 4 * kK * kFwdUnits / kRows; ++m) {
        const int i = threadIdx.x + m * nthr;
        cp_async<16>(st + kK * ld + 4 * i, i < n_ok ? src + 4 * i : wh, i < n_ok);
      }
      if (xs) {
        const float* xt = x + at(it, d, 0, D, R) * E;
        for (int i = threadIdx.x; i < kRows * kK; i += nthr) {
          const int row = i / kK, k = i % kK;
          const bool ok = r0 + row < R && k0 + k < E;
          cp_async<4>(st + k * ld + row,
                      ok ? xt + static_cast<size_t>(r0 + row) * E + k0 + k : x, ok);
        }
      }
      if (++isl == n_step) isl = 0, ++it;
    }
    ++iq;
    cp_async_commit();
  };
  for (int i = threadIdx.x; i < H * ld; i += nthr) hs[i] = 0.f;  // h[-1]
  for (int q = 0; q < kFwdRing - 1; ++q) issue();
  float c[4][kFwdUnits] = {};
  int q = 0;  // slices consumed
  for (int t = 0; t < T; ++t) {
    float acc[4][4][kFwdUnits];  // [row][gate][unit]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < kFwdUnits; ++u) acc[i][g][u] = 0.f;
    for (int sl = 0; sl < n_step; ++sl, ++q) {
      cp_async_wait<kFwdRing - 2>();
      __syncthreads();  // slice q in; every thread done with slice q - 1 (and, at
                        // the step's first slice, h[t-1] whole in hs)
      issue();  // slice q + kFwdRing - 1, into the stage of slice q - 1
      const float* st = ring + (q % kFwdRing) * stage;
      const bool xs = sl < nx;
      const float* a = (xs ? st : hs + (sl - nx) * kK * ld) + rg * 4;
      const float* b = st + kK * ld + ug * kFwdUnits;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * ld);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float bv[kFwdUnits];
          load_vec<kFwdUnits>(bv, b + k * G + g * H);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < kFwdUnits; ++u) acc[i][g][u] = fmaf(ar[i], bv[u], acc[i][g][u]);
        }
      }
      if (sl == nx - 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float bv[kFwdUnits];
          load_vec<kFwdUnits>(bv, bias + d * G + g * H + ug * kFwdUnits);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < kFwdUnits; ++u) acc[i][g][u] += bv[u];
        }
      }
    }
    __syncthreads();  // every thread done reading h[t-1]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
      const bool live = r0 + row < R;
      const size_t o = live ? at(t, d, r0 + row, D, R) : 0;
      float hv[kFwdUnits], cv[kFwdUnits];
#pragma unroll
      for (int u = 0; u < kFwdUnits; ++u) {
        cv[u] = sigm(acc[i][1][u]) * c[i][u] + sigm(acc[i][0][u]) * tanhf(acc[i][2][u]);
        hv[u] = sigm(acc[i][3][u]) * tanhf(cv[u]);
        c[i][u] = cv[u];
        hs[(ug * kFwdUnits + u) * ld + row] = hv[u];
      }
      if (live) {
        store_vec<kFwdUnits>(h_seq + o * H + ug * kFwdUnits, hv);
        store_vec<kFwdUnits>(c_seq + o * H + ug * kFwdUnits, cv);
        if constexpr (kKeep)
#pragma unroll
          for (int g = 0; g < 4; ++g) store_vec<kFwdUnits>(gates_out + o * G + g * H + ug * kFwdUnits, acc[i][g]);
      }
    }
  }
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

// ws (4U, H + kPad) <- the block's columns of w (H, 4H), transposed, as
// float32: row j = g U + u of ws is column g H + b U + u of w
template <class S>
__device__ __forceinline__ void load_w_slice(float* ws, const S* __restrict__ w, int H, int U,
                                             int b) {
  const int cols = 4 * U, ld = H + kPad;
  for (int i = threadIdx.x; i < H * cols; i += blockDim.x) {
    const int k = i / cols, j = i % cols;
    ws[j * ld + k] = ldf(w + static_cast<size_t>(k) * 4 * H + (j / U) * H + b * U + j % U);
  }
}

// The cp.async copies one thread issues at each step from one (R, width)
// slab of a step to shared memory: up to kMax pieces of kBytes, their
// offsets (elements of the slab's type) fixed over the steps and worked
// out once (a negative source offset is a row past R, filled with zeros).
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

  template <class T>
  __device__ __forceinline__ void issue(T* to, const T* __restrict__ slab) const {
#pragma unroll
    for (int m = 0; m < kMax; ++m)
      if (dst[m] >= 0)
        cp_async<kBytes>(reinterpret_cast<float*>(to + dst[m]),
                         reinterpret_cast<const float*>(slab + max(src[m], 0)), src[m] >= 0);
  }
};

// the block's gate columns of the tile's rows of gates_x[t] (R, 4H) into
// (32, 4U), in pieces of two columns (U is even); at most 4 a thread for
// U <= 16
template <class S>
__device__ __forceinline__ StepCopies<4, 2 * sizeof(S)> gates_own_copies(int r0, int R, int H,
                                                                         int U, int b) {
  const int pairs = 2 * U;
  return StepCopies<4, 2 * sizeof(S)>(kClusterRows * pairs, [=](int i, int& src, int& dst) {
    const int row = i / pairs, j = 2 * (i % pairs);
    if (r0 + row < R) src = (r0 + row) * 4 * H + j / U * H + b * U + j % U;
    dst = row * 4 * U + j;
  });
}

// the block's units of the tile's rows of an (R, H) slab into (32, U), in
// pieces of two units
template <class S>
__device__ __forceinline__ StepCopies<1, 2 * sizeof(S)> units_own_copies(int r0, int R, int H,
                                                                         int U, int b) {
  const int pairs = U / 2;
  return StepCopies<1, 2 * sizeof(S)>(kClusterRows * pairs, [=](int i, int& src, int& dst) {
    const int row = i / pairs, u = 2 * (i % pairs);
    if (r0 + row < R) src = (r0 + row) * H + b * U + u;
    dst = row * U + u;
  });
}

// rows of H in shared memory: padded by kPad floats (float32) or 2 kPad
// bf16 (rows stay 16-byte aligned)
template <class S>
__host__ __device__ constexpr int row_ld(int H) {
  return H + (kIsBf16<S> ? 2 * kPad : kPad);
}

// the tile's rows of an (R, H) slab, whole, into (32, row_ld<S>(H)), in
// 16-byte pieces (at most 8 a thread for H <= 256)
template <class S>
__device__ __forceinline__ StepCopies<8, 16> rows_whole_copies(int r0, int R, int H) {
  constexpr int kPer = 16 / sizeof(S);
  const int pieces = H / kPer;
  return StepCopies<8, 16>(kClusterRows * pieces, [=](int i, int& src, int& dst) {
    const int row = i / pieces, q = kPer * (i % pieces);
    if (r0 + row < R) src = (r0 + row) * H + q;
    dst = row * row_ld<S>(H) + q;
  });
}

// The gate pre-activations of rows rs .. rs + kRpt - 1 and unit u of the
// block, gates i|f|g|o: gxs (32, 4U) plus, when has_h, h (32, ldh) times
// the block's w_hh slice ws, k ascending; on the bf16 route (S = bf16) the
// product is summed from 0 and each gate is bf16(gx + bf16(h w_hh)). K5
// (h as float32) and K6's recompute (h as S) both call this, so they get
// the same bits.
template <int kRpt, class S, class HS>
__device__ __forceinline__ void cluster_gates(float (&acc)[kRpt][4], const S* gxs, const HS* hs,
                                              const float* ws, int H, int U, int rs, int u,
                                              bool has_h, int ldh) {
  const int ld = H + kPad;
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = kIsBf16<S> ? 0.f : ldf(gxs + (rs + i) * 4 * U + g * U + u);
  if (has_h) {
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      float4 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = *reinterpret_cast<const float4*>(ws + (g * U + u) * ld + k);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float4 h = lds4(hs + (rs + i) * ldh + k);
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
  if constexpr (kIsBf16<S>) {
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[i][g] = round_bf16(ldf(gxs + (rs + i) * 4 * U + g * U + u) + round_bf16(acc[i][g]));
  }
}

// K5 for H <= 256. grid (n cdiv(R, 32), D) in clusters of (n, 1, 1), n =
// kClusterBlocks, kClusterThreads threads, cluster_fwd_floats(H) floats of dynamic
// shared memory; thread x < 32 U / kRpt owns unit x % U of rows
// (x / U) kRpt .. + kRpt - 1 in the gate phase (kRpt = gate_rows(U)); all
// threads copy. On the bf16 route gates_x's columns sit in shared memory as
// bf16 (half their float32 space), h as float32.
template <int kRpt, class S>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_scan_fwd_cluster(const S* __restrict__ gates_x, const S* __restrict__ w_hh,
                      S* __restrict__ h_seq, S* __restrict__ c_seq, int T, int D, int R, int H) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks()), b = static_cast<int>(cluster.block_rank());
  const int U = H / n, G = 4 * H, ld = H + kPad, tile = kClusterRows * ld;
  const int d = blockIdx.y, r0 = blockIdx.x / n * kClusterRows;
  float* ws = smem;                     // (4U, ld): the block's columns of w_hh, transposed
  float* hs = ws + 4 * U * ld;          // 2 x (32, ld): h of the tile, whole, by step parity
  S* gxs = reinterpret_cast<S*>(hs + 2 * tile);  // 2 x (32, 4U): the block's columns of gates_x
  const int gtile = kClusterRows * 4 * U;
  const auto gx_copies = gates_own_copies<S>(r0, R, H, U, b);
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
      cluster_gates<kRpt>(acc, gxs + (t & 1) * gtile, hprev, ws, H, U, rs, u, t > 0, ld);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int row = rs + i;
        if constexpr (kIsBf16<S>) {
          cell_bf16(acc[i][0], acc[i][1], acc[i][2], acc[i][3], c[i], h[i]);
        } else {
          const float cn = sigm(acc[i][1]) * c[i] + sigm(acc[i][0]) * tanhf(acc[i][2]);
          h[i] = sigm(acc[i][3]) * tanhf(cn);
          c[i] = cn;
        }
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
          stf(h_seq + o, h[i]);
          stf(c_seq + o, c[i]);
        }
    cluster_wait();
  }
}

// K6's recurrence for H <= 256: dgates (T, D, R, 4H). Launched as K5. On
// the bf16 route h[t-1], gates_x, c and dh sit in shared memory as bf16.
template <int kRpt, class S>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_scan_bwd_cluster(const S* __restrict__ gates_x, const S* __restrict__ w_hh,
                      const S* __restrict__ h_seq, const S* __restrict__ c_seq,
                      const S* __restrict__ dh_seq, S* __restrict__ dgates, int T, int D,
                      int R, int H) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks()), b = static_cast<int>(cluster.block_rank());
  const int U = H / n, G = 4 * H, ld = H + kPad, rows = kClusterRows;
  const int d = blockIdx.y, r0 = blockIdx.x / n * kClusterRows;
  float* ws = smem;                   // (4U, ld): the block's columns of w_hh, transposed
  S* hs = reinterpret_cast<S*>(ws + 4 * U * ld);  // (32, row_ld<S>): h[t-1] of the tile, whole
  S* gxs = reinterpret_cast<S*>(ws + 4 * U * ld + rows * ld);  // (32, 4U): gates_x[t], own columns
  S* cts = gxs + rows * 4 * U;        // (32, U): c[t] of the block's units
  S* cps = cts + rows * U;            // (32, U): c[t-1]
  S* dhs = cps + rows * U;            // (32, U): dh[t]
  // (32, 4U) float32: dgates of the step, the block's columns, where the
  // float32 layout has it
  float* dgs = ws + 4 * U * ld + rows * ld + rows * 4 * U + 3 * rows * U;
  float* recv = dgs + rows * 4 * U;   // 2 x (n, 32, U): dh_rec partials by source rank
  const int slots = n * rows * U;
  const auto gx_copies = gates_own_copies<S>(r0, R, H, U, b);
  const auto unit_copies = units_own_copies<S>(r0, R, H, U, b);
  const auto h_copies = rows_whole_copies<S>(r0, R, H);
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
      cluster_gates<kRpt>(acc, gxs, hs, ws, H, U, rs, u, t > 0, row_ld<S>(H));
      const float* rb = recv + ((t + 1) & 1) * slots;  // stored in step t + 1
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int row = rs + i;
        float rec = 0.f;
        if (t < T - 1)
          for (int s = 0; s < n; ++s) rec += rb[(s * rows + row) * U + u];  // rank order
        const float ct = ldf(cts + row * U + u), cp = t > 0 ? ldf(cps + row * U + u) : 0.f;
        if constexpr (kIsBf16<S>) {
          bwd_cell_bf16(acc[i], ct, cp, ldf(dhs + row * U + u), round_bf16(rec), dc[i], dg[i]);
        } else {
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
        }
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
            stf(dgates + at(t, d, r0 + rs + i, D, R) * G + g * H + b * U + u, dg[i][g]);
    cluster_wait();
  }
}

template <class S>
using ClusterFwd = void (*)(const S*, const S*, S*, S*, int, int, int, int);
template <class S>
using ClusterBwd = void (*)(const S*, const S*, const S*, const S*, const S*, S*, int, int, int,
                            int);

template <class S>
ClusterFwd<S> cluster_fwd_kernel(int rpt) {
  return rpt == 1 ? lstm_scan_fwd_cluster<1, S>
                  : rpt == 2 ? lstm_scan_fwd_cluster<2, S> : lstm_scan_fwd_cluster<4, S>;
}
template <class S>
ClusterBwd<S> cluster_bwd_kernel(int rpt) {
  return rpt == 1 ? lstm_scan_bwd_cluster<1, S>
                  : rpt == 2 ? lstm_scan_bwd_cluster<2, S> : lstm_scan_bwd_cluster<4, S>;
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

// K4's launch plan. The reverse scan takes 64-row tiles (4 rows x 8 units
// a thread) where H <= 128 and they give each of the H100's 132 SMs a
// block, else 32-row tiles (2 rows a thread at H <= 128, 4 above); one
// block an SM. The weight GEMM cuts the T R pairs into the fewest chunks
// that give its tiles about 4 x 132 blocks, each chunk at least 1024 pairs
// and a multiple of the k slice. ops/lstm_scan.py ``bwd_plan`` mirrors
// this.
constexpr int kSMs = 132;          // SMs of the H100 SXM
constexpr int kWgBlocks = 4 * kSMs;
constexpr int kWgMinChunk = 1024;

struct WgSplit {
  int chunks, chunk;

  WgSplit(int pairs, int tiles) {
    chunks = std::max(1, std::min(cdiv(kWgBlocks, tiles), cdiv(pairs, kWgMinChunk)));
    chunk = cdiv(cdiv(pairs, chunks), kGK) * kGK;
    chunks = cdiv(pairs, chunk);
  }
};

// the weight GEMM's row and column tiles over the rows of [x | h] and 4H
int wgrad_tiles(int E, int H, int D) { return cdiv(E + H, kGM) * (4 * H / kGM) * D; }

struct BwdPlan {
  int rows, rt, threads, tiles, smem;
  WgSplit wg;

  BwdPlan(int T, int D, int R, int E, int H) : wg(T * R, wgrad_tiles(E, H, D)) {
    rows = H <= 128 && D * cdiv(R, 64) >= kSMs ? 64 : 32;
    rt = rows == 64 || H > 128 ? 4 : 2;
    threads = rows / rt * (H / 8);
    tiles = cdiv(R, rows);
    smem = static_cast<int>(sizeof(float) * rscan_floats(rows, H));
  }
};

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)));
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// K3's launch plan: 64-row tiles where H <= 128 and they give each of the
// H100's 132 SMs a block, else 32-row tiles; a thread owns 4 rows x 4
// units, so a block has rows H / 16 threads (at most 512); one block an
// SM. ops/lstm_scan.py ``fwd_plan`` mirrors this.
struct FwdPlan {
  int rows, slice, threads, tiles, smem;

  FwdPlan(int D, int R, int H) {
    rows = H <= 128 && D * cdiv(R, 64) >= kSMs ? 64 : 32;
    slice = fwd_slice(H);
    threads = rows / 4 * (H / kFwdUnits);
    tiles = cdiv(R, rows);
    smem = static_cast<int>(sizeof(float) * fwd_floats(rows, H));
  }
};

// K3's ring scan on the plan's tile; kKeep: the gates also to gates_out
template <int kRows, int kK, bool kKeep>
int ring(const FwdPlan& P, const float* x, const float* w_ih, const float* bias,
         const float* w_hh, float* h_seq, float* c_seq, float* gates_out, int T, int D, int R,
         int E, int H, cudaStream_t s) {
  const auto kernel = lstm_fwd_ring<kRows, kK, kKeep>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), P.smem);
  if (err) return err;
  kernel<<<dim3(P.tiles, D), P.threads, P.smem, s>>>(x, w_ih, bias, w_hh, h_seq, c_seq,
                                                     gates_out, T, D, R, E, H);
  return last_error();
}

template <bool kKeep>
int launch_ring(const FwdPlan& P, const float* x, const float* w_ih, const float* bias,
                const float* w_hh, float* h_seq, float* c_seq, float* gates_out, int T, int D,
                int R, int E, int H, cudaStream_t s) {
  if (P.rows == 64)
    return ring<64, 16, kKeep>(P, x, w_ih, bias, w_hh, h_seq, c_seq, gates_out, T, D, R, E, H,
                               s);
  if (P.slice == 16)
    return ring<32, 16, kKeep>(P, x, w_ih, bias, w_hh, h_seq, c_seq, gates_out, T, D, R, E, H,
                               s);
  return ring<32, 8, kKeep>(P, x, w_ih, bias, w_hh, h_seq, c_seq, gates_out, T, D, R, E, H, s);
}

// Workspace layout (float offsets): K4's (lstm_bwd_workspace, lstm_bwd) holds
// the gates, then dgates, and the weight partials with db's row; K6's
// (lstm_scan_bwd_workspace, lstm_scan_bwd, E = 0, whose dgates is its
// output) the dW_hh partials only.
struct Layout {
  size_t dgates, wg_part, total;

  Layout(int T, int D, int R, int E, int H, const WgSplit& wg) {
    const size_t G = 4 * static_cast<size_t>(H);
    size_t off = 0;
    auto take = [&](size_t n) {
      const size_t start = off;
      off += (n + 31) / 32 * 32;  // 128-byte aligned buffers
      return start;
    };
    const bool proj = E > 0;
    dgates = take(proj ? static_cast<size_t>(T) * D * R * G : 0);
    wg_part = take(static_cast<size_t>(D) * wg.chunks * (E + H + (proj ? 1 : 0)) * G);
    total = off;
  }
};

// K5's and K6's shared memory a row tile, in bytes, at esize bytes a value
size_t fwd_smem(int rows, int H, size_t esize) { return esize * rows * H; }
size_t bwd_smem(int rows, int H, size_t esize) { return esize * rows * 6 * H; }

// the rows of a K5/K6 tile for 256 < H <= 8192: 16 up to 512, then half
// as many each time H doubles, down to 1 row past 4096
int tile_rows(int H) { return H <= 512 ? 16 : H <= 1024 ? 8 : H <= 2048 ? 4 : H <= 4096 ? 2 : 1; }

// K5 for 256 < H <= 8192 on kRows-row tiles (Split<kRows>::threads(H))
template <int kRows, class S>
int scan_fwd_tiles(const S* gates_x, const S* w_hh, S* h_seq, S* c_seq, int T, int D, int R,
                   int H, cudaStream_t s) {
  const size_t smem = fwd_smem(kRows, H, sizeof(S));
  int err = set_smem(reinterpret_cast<const void*>(lstm_fwd_scan<kRows, S>), smem);
  if (err) return err;
  lstm_fwd_scan<kRows, S><<<dim3(cdiv(R, kRows), D), Split<kRows>::threads(H), smem, s>>>(
      gates_x, w_hh, h_seq, c_seq, T, D, R, H);
  return last_error();
}

// K6's recurrence for 256 < H <= 8192 on kRows-row tiles
template <int kRows, class S>
int scan_bwd_tiles(const S* gates_x, const S* w_hh, const S* w_hh_t, const S* h_seq,
                   const S* c_seq, const S* dh_seq, S* dgates, int T, int D, int R, int H,
                   cudaStream_t s) {
  const size_t smem = bwd_smem(kRows, H, sizeof(S));
  int err = set_smem(reinterpret_cast<const void*>(lstm_bwd_scan<kRows, S>), smem);
  if (err) return err;
  lstm_bwd_scan<kRows, S><<<dim3(cdiv(R, kRows), D), Split<kRows>::threads(H), smem, s>>>(
      gates_x, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dgates, T, D, R, H);
  return last_error();
}

// K5 on the row tiles of H (256 < H <= 8192)
template <class S>
int scan_fwd_rows(const S* gates_x, const S* w_hh, S* h_seq, S* c_seq, int T, int D, int R,
                  int H, cudaStream_t s) {
  const auto tiles = tile_rows(H) == 16  ? scan_fwd_tiles<16, S>
                     : tile_rows(H) == 8 ? scan_fwd_tiles<8, S>
                     : tile_rows(H) == 4 ? scan_fwd_tiles<4, S>
                     : tile_rows(H) == 2 ? scan_fwd_tiles<2, S>
                                         : scan_fwd_tiles<1, S>;
  return tiles(gates_x, w_hh, h_seq, c_seq, T, D, R, H, s);
}

// K6's recurrence on the row tiles of H (256 < H <= 8192)
template <class S>
int scan_bwd_rows(const S* gates_x, const S* w_hh, const S* w_hh_t, const S* h_seq,
                  const S* c_seq, const S* dh_seq, S* dgates, int T, int D, int R, int H,
                  cudaStream_t s) {
  if (!w_hh_t) return static_cast<int>(cudaErrorInvalidValue);
  const auto tiles = tile_rows(H) == 16  ? scan_bwd_tiles<16, S>
                     : tile_rows(H) == 8 ? scan_bwd_tiles<8, S>
                     : tile_rows(H) == 4 ? scan_bwd_tiles<4, S>
                     : tile_rows(H) == 2 ? scan_bwd_tiles<2, S>
                                         : scan_bwd_tiles<1, S>;
  return tiles(gates_x, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dgates, T, D, R, H, s);
}

// K4's reverse scan on the plan's tile
template <int kRows, int kRt>
int rscan(const BwdPlan& P, float* g, const float* w_hh_t, const float* c_seq,
          const float* dh_seq, int T, int D, int R, int H, cudaStream_t s) {
  const auto kernel = lstm_bwd_rscan<kRows, kRt>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), P.smem);
  if (err) return err;
  kernel<<<dim3(P.tiles, D), P.threads, P.smem, s>>>(g, w_hh_t, c_seq, dh_seq, T, D, R, H);
  return last_error();
}

int launch_rscan(const BwdPlan& P, float* g, const float* w_hh_t, const float* c_seq,
                 const float* dh_seq, int T, int D, int R, int H, cudaStream_t s) {
  if (P.rows == 64) return rscan<64, 4>(P, g, w_hh_t, c_seq, dh_seq, T, D, R, H, s);
  if (P.rt == 2) return rscan<32, 2>(P, g, w_hh_t, c_seq, dh_seq, T, D, R, H, s);
  return rscan<32, 4>(P, g, w_hh_t, c_seq, dh_seq, T, D, R, H, s);
}

// The weight GEMM's chunk partials (D x chunks of (E + H + kDb, 4H)) summed
// in chunk order: dw (D, E + H, 4H) and, with kDb, db (D, 4H), float32 on
// both routes
template <bool kDb>
int sum_weight_partials(const float* part, float* dw, float* db, const WgSplit& wg, int D, int E,
                        int H, cudaStream_t s) {
  const int G = 4 * H, n_w = (E + H) * G;
  const size_t stride = static_cast<size_t>(E + H + (kDb ? 1 : 0)) * G;
  sum_partials<<<dim3(cdiv(n_w, kThreads), D), kThreads, 0, s>>>(part, wg.chunks, stride, n_w,
                                                                  dw, n_w);
  int err = last_error();
  if (err || !kDb) return err;
  sum_partials<<<dim3(cdiv(G, kThreads), D), kThreads, 0, s>>>(part + n_w, wg.chunks, stride, G,
                                                                db, G);
  return last_error();
}

// dW (and, with kDb, db) from dgates by the weight GEMM and its sums: dw
// (D, E + H, 4H), db (D, 4H)
template <bool kDb>
int weight_grads(const float* x, const float* h_seq, const float* dgates, float* part, float* dw,
                 float* db, const WgSplit& wg, int T, int D, int R, int E, int H,
                 cudaStream_t s) {
  const int G = 4 * H;
  lstm_bwd_wgrad_gemm<kDb><<<dim3(cdiv(E + H, kGM), G / kGM, D * wg.chunks), kGemmThreads, 0,
                                s>>>(x, h_seq, dgates, part, T, D, R, E, H, wg.chunks, wg.chunk);
  const int err = last_error();
  if (err) return err;
  return sum_weight_partials<kDb>(part, dw, db, wg, D, E, H, s);
}

// K4 on the float32 route: the five launches over the workspace's gates /
// dgates
int lstm_bwd_route(const float* x, const float* w_ih, const float* w_ih_t, const float* bias,
                   const float* w_hh, const float* w_hh_t, const float* h_seq,
                   const float* c_seq, const float* dh_seq, float* dx, float* dw, float* db,
                   float* work, int T, int D, int R, int E, int H, cudaStream_t s) {
  const BwdPlan P(T, D, R, E, H);
  const Layout L(T, D, R, E, H, P.wg);
  const int G = 4 * H, m_tiles = cdiv(T * R, kGM);
  float* g = work + L.dgates;
  lstm_bwd_gates_gemm<<<dim3(m_tiles, G / kGM, D), kGemmThreads, 0, s>>>(
      x, w_ih, bias, w_hh, h_seq, g, T, D, R, E, H);
  int err = last_error();
  if (err || (err = launch_rscan(P, g, w_hh_t, c_seq, dh_seq, T, D, R, H, s))) return err;
  lstm_bwd_dx_gemm<<<dim3(m_tiles, cdiv(E, kGM), D), kGemmThreads, 0, s>>>(g, w_ih_t, dx, T,
                                                                              D, R, E, H);
  if ((err = last_error())) return err;
  return weight_grads<true>(x, h_seq, g, work + L.wg_part, dw, db, P.wg, T, D, R, E, H, s);
}

// K5 on the clusters (H <= 256)
template <class S>
int scan_fwd_cluster(const S* gates_x, const S* w_hh, S* h_seq, S* c_seq, int T, int D, int R,
                     int H, cudaStream_t s) {
  if (!cluster_fits(H)) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterFwd<S> kernel = cluster_fwd_kernel<S>(gate_rows(H / kClusterBlocks));
  const ClusterLaunch l(reinterpret_cast<const void*>(kernel), cdiv(R, kClusterRows), D,
                        sizeof(float) * cluster_fwd_floats(H), s);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, kernel, gates_x, w_hh, h_seq, c_seq, T, D,
                                             R, H));
}

// K6's recurrence on the clusters (H <= 256)
template <class S>
int scan_bwd_cluster(const S* gates_x, const S* w_hh, const S* h_seq, const S* c_seq,
                     const S* dh_seq, S* dgates, int T, int D, int R, int H, cudaStream_t s) {
  if (!cluster_fits(H)) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterBwd<S> kernel = cluster_bwd_kernel<S>(gate_rows(H / kClusterBlocks));
  const ClusterLaunch l(reinterpret_cast<const void*>(kernel), cdiv(R, kClusterRows), D,
                        sizeof(float) * cluster_bwd_floats(H), s);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, kernel, gates_x, w_hh, h_seq, c_seq, dh_seq,
                                             dgates, T, D, R, H));
}

template <class S>
const S* in(const void* p) {
  return static_cast<const S*>(p);
}
template <class S>
S* out(void* p) {
  return static_cast<S*>(p);
}

}  // namespace

// The bf16 route's entry points, compiled in lstm_scan_bf16.cu (their own
// translation unit, so that nvcc builds the two routes in parallel) and
// called by lstm_scan.cu's C entries with bf16 = 1. Arguments as those
// entries', the tensors bfloat16.
namespace lstm_bf16 {
int fwd(bool keep_gates, const void* x, const void* w_ih, const void* bias, const void* w_hh,
        void* h_seq, void* c_seq, void* gates, int T, int D, int R, int E, int H, cudaStream_t s);
int bwd_gates(const void* x, const void* w_ih, const void* bias, const void* w_hh,
              const void* h_seq, void* gates, int T, int D, int R, int E, int H, cudaStream_t s);
int bwd(const void* x, const void* w_ih, const void* w_ih_t, const void* bias, const void* w_hh,
        const void* w_hh_t, const void* h_seq, const void* c_seq, const void* dh_seq, void* dx,
        float* dw, float* db, float* work, int T, int D, int R, int E, int H, cudaStream_t s);
int scan_fwd(const void* gates_x, const void* w_hh, void* h_seq, void* c_seq, int T, int D, int R,
             int H, cudaStream_t s);
int scan_bwd(const void* gates_x, const void* w_hh, const void* w_hh_t, const void* h_seq,
             const void* c_seq, const void* dh_seq, void* dgates, float* dw_hh, float* work, int T,
             int D, int R, int H, cudaStream_t s);
}  // namespace lstm_bf16
