// Conv-TasNet TCN block forward (flash-TCN) for NVIDIA Hopper, float32.
//
// Replaces the Pallas TPU kernel brever_tpu/ops/pallas/tcn_block.py
// (_fwd_kernel, launched by _fwd_pallas, public tcn_block_fused). One
// block is
//
//   h1   = PReLU(x @ W_in + b_in)                       (B, T, H)
//   y1   = gLN(h1) * g1 + be1                            statistics over (T, H)
//   h2   = PReLU(depthwise_k3(y1, dilation) + b_dw)
//   y2   = gLN(h2) * g2 + be2
//   res  = x + y2 @ W_res + b_res                        (skipped on the last block)
//   skip =     y2 @ W_skip + b_skip
//
// The TPU kernel keeps a whole (T, H) time row of every intermediate in
// 128 MB of VMEM. An H100 block has at most 227 KB of shared memory and
// blocks run in no order, so the block is split at its two global-norm
// reduction barriers into three launches and two small merges:
//
//   1. in_gemm_prelu_stats: tiled GEMM x @ W_in, bias + PReLU epilogue,
//      writes raw h1 and per-tile (count, mean, M2) partial moments.
//   2. row_stats: one block per batch row merges the row's partials
//      (Chan's formula in double, fixed order, so deterministic) and writes
//      (mean1, rstd1) into stats (B, 4).
//   3. dw_prelu_stats: normalizes h1 on load (zero outside [0, T): the
//      padding comes after the norm), dilated 3-tap depthwise conv + PReLU,
//      writes h2 and its partial moments; row_stats then writes
//      (mean2, rstd2).
//   4. out_gemm: normalizes h2 on the A-tile load and runs one GEMM against
//      [W_res | W_skip]; the epilogue adds the biases and the residual.
//
// stats (B, 4) = (mean1, rstd1, mean2, rstd2) is what the backward
// (tcn_block_bwd.cu) recomputes the block from.
//
// Bound: bytes. h1 and h2 each make one round trip through device memory
// (B*T*H*4 bytes written and read about once more; 2 x 8 MB per batch row
// of 4 s at H=512), against 2*T*H*(C + C + Cs) flops per row. The design
// keeps every other intermediate (z1, z2, y1, y2) out of device memory by
// fusing it into a load or an epilogue, and carries only 3 floats per tile
// across the barriers, merged once per row. Folding the gLN affines into
// the weights, bf16 and wgmma/TMA tiles are left for later work: this is
// the simple, right one.
//
// Every pointer is a dense float32 buffer. 2-D weights are in the storage
// of a torch Linear weight, (N, K) = (out, in) row-major, which the model
// passes as it is; a B-tile load then reads K-contiguous runs.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

constexpr int kDwRows = 32;   // depthwise tile: time rows
constexpr int kDwCols = 128;  // depthwise tile: channels
constexpr int kDwPer = kDwRows / (kThreads / kDwCols);  // rows per thread

// Write the tile's (count, mean, M2) from the values this thread holds:
// two passes over registers, so M2 carries no cancellation.
template <int N>
__device__ void tile_moments(const float (&v)[N], const bool (&ok)[N], float count,
                             float* red, float* out) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += ok[i] ? v[i] : 0.f;
  const float mean = block_sum(s, red) / count;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = v[i] - mean;
    q += ok[i] ? e * e : 0.f;
  }
  const float m2 = block_sum(q, red);
  if (threadIdx.x == 0) {
    out[0] = count;
    out[1] = mean;
    out[2] = m2;
  }
}

// One block (one warp) per batch row: merge the row's partial moments in a
// fixed order and write (mean, 1/sqrt(var + eps)) to stats[b][2 slot ..].
// grid (B), 32 threads
__global__ void row_stats(const float* __restrict__ part, int n_part, float eps,
                          float* __restrict__ stats, int slot) {
  const float* p = part + 3 * static_cast<size_t>(blockIdx.x) * n_part;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int i = threadIdx.x; i < n_part; i += 32)
    merge(n, mean, m2, p[3 * i], p[3 * i + 1], p[3 * i + 2]);
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, off);
    const double mb = __shfl_down_sync(0xffffffffu, mean, off);
    const double m2b = __shfl_down_sync(0xffffffffu, m2, off);
    merge(n, mean, m2, nb, mb, m2b);
  }
  if (threadIdx.x == 0) {
    float* out = stats + 4 * blockIdx.x + 2 * slot;
    out[0] = static_cast<float>(mean);
    out[1] = static_cast<float>(1.0 / sqrt(m2 / n + static_cast<double>(eps)));
  }
}

// grid (cdiv(T, kBM), cdiv(H, kBN), B)
__global__ void __launch_bounds__(kThreads)
in_gemm_prelu_stats(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha, float* __restrict__ h1,
                    float* __restrict__ part, int T, int C, int H) {
  __shared__ float red[kThreads / 32];
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
        return (k < C && n < H) ? w[n * C + k] : 0.f;  // H * C < 2^31
      });

  const float a1 = *alpha;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float v[16];
  bool ok[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const bool in = t < T && n < H;
      float z = acc[i][j] + (in ? bias[n] : 0.f);
      z = z >= 0.f ? z : a1 * z;
      if (in) h1[(static_cast<size_t>(b) * T + t) * H + n] = z;
      v[4 * i + j] = z;
      ok[4 * i + j] = in;
    }
  }
  const int n_part = gridDim.x * gridDim.y;
  const float count = static_cast<float>(min(kBM, T - t0) * min(kBN, H - n0));
  tile_moments(v, ok, count, red,
               part + 3 * (static_cast<size_t>(b) * n_part + blockIdx.x * gridDim.y + blockIdx.y));
}

// grid (cdiv(T, kDwRows), cdiv(H, kDwCols), B)
__global__ void __launch_bounds__(kThreads)
dw_prelu_stats(const float* __restrict__ h1, const float* __restrict__ stats,
               const float* __restrict__ g1, const float* __restrict__ be1,
               const float* __restrict__ w_dw, const float* __restrict__ b_dw,
               const float* __restrict__ alpha, float* __restrict__ h2,
               float* __restrict__ part2, int T, int H, int d) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.z;
  const float mean = stats[4 * b], rstd = stats[4 * b + 1];

  const int c0 = blockIdx.y * kDwCols, c = c0 + threadIdx.x % kDwCols;
  const int r = threadIdx.x / kDwCols, t0 = blockIdx.x * kDwRows;
  const bool c_ok = c < H;
  float g = 0.f, be = 0.f, w0 = 0.f, w1 = 0.f, w2 = 0.f, bd = 0.f;
  if (c_ok) {
    g = g1[c];
    be = be1[c];
    w0 = w_dw[c];
    w1 = w_dw[H + c];
    w2 = w_dw[2 * H + c];
    bd = b_dw[c];
  }
  const float a2 = *alpha;
  const float* hb = h1 + static_cast<size_t>(b) * T * H;
  // y1 is zero outside [0, T): the conv pads the normalized signal
  auto y1 = [&](int t) {
    return (t >= 0 && t < T) ? (hb[static_cast<size_t>(t) * H + c] - mean) * rstd * g + be
                             : 0.f;
  };
  float v[kDwPer];
  bool ok[kDwPer];
#pragma unroll
  for (int i = 0; i < kDwPer; ++i) {
    const int t = t0 + r + (kThreads / kDwCols) * i;
    const bool in = c_ok && t < T;
    float z = 0.f;
    if (in) {
      z = y1(t - d) * w0 + y1(t) * w1 + y1(t + d) * w2 + bd;
      z = z >= 0.f ? z : a2 * z;
      h2[(static_cast<size_t>(b) * T + t) * H + c] = z;
    }
    v[i] = z;
    ok[i] = in;
  }
  const int n_part = gridDim.x * gridDim.y;
  const float count = static_cast<float>(min(kDwRows, T - t0) * min(kDwCols, H - c0));
  tile_moments(v, ok, count, red,
               part2 + 3 * (static_cast<size_t>(b) * n_part + blockIdx.x * gridDim.y + blockIdx.y));
}

// grid (cdiv(T, kBM), cdiv(n_res + Cs, kBN), B); n_res is C, or 0 on the
// last block (no residual output).
__global__ void __launch_bounds__(kThreads)
out_gemm(const float* __restrict__ h2, const float* __restrict__ stats,
         const float* __restrict__ g2, const float* __restrict__ be2,
         const float* __restrict__ w_res, const float* __restrict__ b_res,
         const float* __restrict__ w_skip, const float* __restrict__ b_skip,
         const float* __restrict__ x,
         float* __restrict__ res, float* __restrict__ skip, int T, int H, int C, int Cs,
         int n_res) {
  const int b = blockIdx.z, t0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float mean = stats[4 * b + 2], rstd = stats[4 * b + 3];
  const int n_out = n_res + Cs;
  const float* hb = h2 + static_cast<size_t>(b) * T * H;
  float acc[4][4] = {};
  gemm_tile<true, true>(
      acc, H,
      [&](int m, int k) {
        const int t = t0 + m;
        return (t < T && k < H) ? (hb[static_cast<size_t>(t) * H + k] - mean) * rstd * g2[k] + be2[k]
                                : 0.f;
      },
      [&](int k, int n) {
        n += n0;
        if (k >= H || n >= n_out) return 0.f;
        // select the row pointer, then index it: indexing either matrix
        // inside the ?: took 99 registers against 64 and ran 1.5x slower
        // on an H100
        const float* w = n < n_res ? w_res + static_cast<size_t>(n) * H
                                   : w_skip + static_cast<size_t>(n - n_res) * H;
        return w[k];
      });

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
    const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < n_res) {
        res[row * C + n] = x[row * C + n] + (acc[i][j] + b_res[n]);
      } else if (n < n_out) {
        skip[row * Cs + (n - n_res)] = acc[i][j] + b_skip[n - n_res];
      }
    }
  }
}

}  // namespace

extern "C" {

// Number of (count, mean, M2) partials per batch row written by each stage.
int tcn_in_partials(int T, int H) { return cdiv(T, kBM) * cdiv(H, kBN); }
int tcn_dw_partials(int T, int H) { return cdiv(T, kDwRows) * cdiv(H, kDwCols); }

int tcn_in_gemm_prelu_stats(const float* x, const float* w, const float* bias,
                            const float* alpha, float* h1, float* part, int B, int T, int C,
                            int H, void* stream) {
  const dim3 grid(cdiv(T, kBM), cdiv(H, kBN), B);
  in_gemm_prelu_stats<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, alpha, h1, part, T, C, H);
  return static_cast<int>(cudaGetLastError());
}

int tcn_row_stats(const float* part, int n_part, float* stats, int slot, int B, float eps,
                  void* stream) {
  row_stats<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(part, n_part, eps, stats, slot);
  return static_cast<int>(cudaGetLastError());
}

int tcn_dw_prelu_stats(const float* h1, const float* stats, const float* g1, const float* be1,
                       const float* w_dw, const float* b_dw, const float* alpha, float* h2,
                       float* part2, int B, int T, int H, int dilation, void* stream) {
  const dim3 grid(cdiv(T, kDwRows), cdiv(H, kDwCols), B);
  dw_prelu_stats<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h1, stats, g1, be1, w_dw, b_dw, alpha, h2, part2, T, H, dilation);
  return static_cast<int>(cudaGetLastError());
}

int tcn_out_gemm(const float* h2, const float* stats, const float* g2, const float* be2,
                 const float* w_res, const float* b_res, const float* w_skip,
                 const float* b_skip, const float* x, float* res, float* skip, int B, int T,
                 int H, int C, int Cs, int last, void* stream) {
  const int n_res = last ? 0 : C;
  const dim3 grid(cdiv(T, kBM), cdiv(n_res + Cs, kBN), B);
  out_gemm<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h2, stats, g2, be2, w_res, b_res, w_skip, b_skip, x, res, skip, T, H, C, Cs, n_res);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
