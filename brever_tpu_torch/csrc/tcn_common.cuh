// Device helpers shared by the TCN block forward (tcn_block.cu) and
// backward (tcn_block_bwd.cu): tile sizes, a fixed-order block sum, Chan's
// merge of partial moments and a float32 SIMT GEMM tile.
#pragma once

#include <cuda_runtime.h>

namespace tcn {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // GEMM tile rows
constexpr int kBN = 64;  // GEMM tile columns
constexpr int kBK = 16;  // GEMM tile depth

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

// One kBM x kBN output tile of A (kBM x K) @ B (K x kBN) in float32, for a
// block of kThreads threads. Thread (tx, ty) owns rows ty + 16 i and columns
// tx + 16 j, i, j < 4; every output sums its products in ascending k.
// kAlongKA: neighbouring threads load neighbouring k of A (A is stored with k
// contiguous); otherwise neighbouring m. kAlongKB likewise for B and n.
template <bool kAlongKA, bool kAlongKB, class LoadA, class LoadB>
__device__ void gemm_tile(float (&acc)[4][4], int K, LoadA load_a, LoadB load_b) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = kAlongKA ? i / kBK : i % kBM;
      const int kk = kAlongKA ? i % kBK : i / kBM;
      As[kk][m] = load_a(m, k0 + kk);
    }
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int n = kAlongKB ? i / kBK : i % kBN;
      const int kk = kAlongKB ? i % kBK : i / kBN;
      Bs[kk][n] = load_b(k0 + kk, n);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ inline float prelu(float z, float a) { return z >= 0.f ? z : a * z; }

}  // namespace tcn
