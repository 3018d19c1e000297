// Device helpers shared by the TCN block forward (tcn_block.cu) and
// backward (tcn_block_bwd.cu): a fixed-order block sum, a tile's moments,
// Chan's merge of partial moments, and the float32 route's product z1 = x
// W_in^T + b_in that both form on simt_gemm.cuh's body, so that the
// backward's z1 is the forward's, bit for bit; and the bf16 route's
// tensor-core launchers (tcn_block_bf16.cu) that their C entries call.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "simt_gemm.cuh"

namespace tcn {

constexpr int kThreads = 256;
constexpr int kDwRows = 32;   // K1's depthwise tile: time rows
constexpr int kDwCols = 128;  // K1's depthwise tile: channels

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sum over the block; every thread gets the same value, summed in a fixed
// order. `red` holds kThreads / 32 values of shared memory.
template <class T>
__device__ inline T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Write the tile's (count, mean, M2) from the N values this thread holds,
// val(i) where ok(i): two passes over registers, so M2 carries no
// cancellation.
template <int N, class Val, class Ok>
__device__ void tile_moments(Val val, Ok ok, float count, float* red, float* out) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += ok(i) ? val(i) : 0.f;
  const float mean = block_sum(s, red) / count;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = val(i) - mean;
    q += ok(i) ? e * e : 0.f;
  }
  const float m2 = block_sum(q, red);
  if (threadIdx.x == 0) {
    out[0] = count;
    out[1] = mean;
    out[2] = m2;
  }
}

// Chan's parallel merge of (count, mean, M2) moments.
__device__ inline void merge(double& n, double& mean, double& m2, double nb, double mb,
                             double m2b) {
  if (nb == 0.0) return;
  if (n == 0.0) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const double tot = n + nb;
  const double delta = mb - mean;
  const double w = nb / tot;
  mean += delta * w;
  m2 += m2b + delta * delta * n * w;
  n = tot;
}

__device__ inline float prelu(float z, float a) { return z >= 0.f ? z : a * z; }

// z1's k loop: both operands are stored with k contiguous (x (T, C) and the
// torch Linear weight W_in (H, C)), so both are staged through registers
// and transposed into the (k, 128) slices; no copy of W_in^T is needed.
template <bool kVec>
struct Z1Op {
  const float *xrow, *wrow;  // the staged rows of x (null past T) and W_in (null past H)
  int C;
  simt::RowStage<kVec> a, b;

  __device__ __forceinline__ void fetch(int s, float*, float*) {
    a.load(xrow, s * simt::kGK, C);
    b.load(wrow, s * simt::kGK, C);
  }
  __device__ __forceinline__ void store(float* As) {
    a.store(As);
    b.store(As + simt::kGSlice);
  }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

// The block's 128 x 128 tile of z1 = x W_in^T + b_in for batch row b (grid
// (cdiv(T, 128), cdiv(H, 128), B), 256 threads, sm: 4 kGSlice floats):
// every output an fmaf chain from 0 over k ascending, then + the bias, in
// float32. K1 and K2 both call this, so their z1 are the same bits (the
// bf16 route's z1_tile_mma of tcn_block_bf16.cu does the same for K1-bf16
// and K2-bf16).
template <bool kVec>
__device__ __forceinline__ void z1_tile(float (&acc)[8][8], const float* __restrict__ x,
                                        const float* __restrict__ w_in,
                                        const float* __restrict__ bias, int T, int C, int H,
                                        float* sm) {
  using namespace simt;
  const int m = blockIdx.x * kGM + threadIdx.x % kGM, n = blockIdx.y * kGM + threadIdx.x % kGM;
  Z1Op<kVec> op;
  op.xrow = m < T ? x + (static_cast<size_t>(blockIdx.z) * T + m) * C : nullptr;
  op.wrow = n < H ? w_in + static_cast<size_t>(n) * C : nullptr;
  op.C = C;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gemm_loop(op, acc, cdiv(C, kGK), sm);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = blockIdx.y * kGM + frag_col(j);
    const float bn = col < H ? bias[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = acc[i][j] + bn;
  }
}

}  // namespace tcn

// The bf16 route's launchers (tcn_block_bf16.cu): the products of K1-bf16
// and K2-bf16 on the bf16 tensor cores, each a launch on s returning its
// CUDA error code, or 0. Pointers are dense; h2 and gz1 are bf16 rows of
// ld(H) elements, the folded output weights wf (B, n_res + Cs, ld(H)).
namespace tcn_bf16 {

using bf16 = __nv_bfloat16;

int ld(int H);
int in_mma(const bf16* x, const bf16* w_in, const bf16* b_in, const bf16* a1, float* h1,
           float* part, int B, int T, int C, int H, cudaStream_t s);
int z1(const bf16* x, const bf16* w_in, const bf16* b_in, float* z1, int B, int T, int C, int H,
       cudaStream_t s);
int dw(const float* h1, const float* stats, const bf16* g1, const bf16* be1, const bf16* w_dw,
       const bf16* b_dw, const bf16* a2, bf16* h2, float* part2, int B, int T, int H, int d,
       cudaStream_t s);
int fold(const float* stats, const bf16* g2, const bf16* be2, const bf16* w_res,
         const bf16* b_res, const bf16* w_skip, const bf16* b_skip, bf16* wf, float* fb, int B,
         int H, int n_res, int Cs, cudaStream_t s);
int out_mma(const bf16* h2, const bf16* wf, const float* fb, const bf16* x, bf16* res,
            bf16* skip, int B, int T, int H, int C, int Cs, int n_res, cudaStream_t s);
int gy2(const bf16* g_res, const bf16* g_skip, const bf16* w_res, const bf16* w_skip,
        const float* z2, const bf16* a2, float* gy2, float* part, int B, int T, int H, int C,
        int Cs, int n_res, cudaStream_t s);
int wout(const bf16* g_res, const bf16* g_skip, const bf16* h2, const float* stats,
         const bf16* g2, const bf16* be2, float* part, float* part_db, int B, int T, int H, int C,
         int Cs, int n_res, int chunks, int chunk, cudaStream_t s);
int dx(const bf16* gz1, const bf16* w_in, const bf16* g_res, bf16* dx, int B, int T, int H, int C,
       cudaStream_t s);
int win(const bf16* gz1, const bf16* x, float* part, int B, int T, int H, int C, int chunks,
        int chunk, cudaStream_t s);

}  // namespace tcn_bf16
