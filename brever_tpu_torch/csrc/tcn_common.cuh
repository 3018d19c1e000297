// Device helpers shared by the TCN block forward (tcn_block.cu) and
// backward (tcn_block_bwd.cu): a fixed-order block sum, Chan's merge of
// partial moments, and the product z1 = x W_in^T + b_in that both form on
// simt_gemm.cuh's body, so that the backward's z1 is the forward's, bit
// for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "simt_gemm.cuh"

namespace tcn {

constexpr int kThreads = 256;

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
// S: float32, or bfloat16 (the bf16 route), converted as it is loaded.
template <bool kVec, class S>
struct Z1Op {
  const S *xrow, *wrow;  // the staged rows of x (null past T) and W_in (null past H)
  int C;
  simt::RowStage<kVec, S> a, b;

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
// float32 from float32 or bfloat16 x, W_in and b_in. K1 and K2 both call
// this, so their z1 are the same bits, on either route.
template <bool kVec, class S>
__device__ __forceinline__ void z1_tile(float (&acc)[8][8], const S* __restrict__ x,
                                        const S* __restrict__ w_in, const S* __restrict__ bias,
                                        int T, int C, int H, float* sm) {
  using namespace simt;
  const int m = blockIdx.x * kGM + threadIdx.x % kGM, n = blockIdx.y * kGM + threadIdx.x % kGM;
  Z1Op<kVec, S> op;
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
    const float bn = col < H ? ldf(bias + col) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = acc[i][j] + bn;
  }
}

}  // namespace tcn
