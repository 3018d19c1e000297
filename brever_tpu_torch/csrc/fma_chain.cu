// The elementwise-rate probe (K10) for NVIDIA Hopper, float32 and bfloat16.
//
// Replaces the Pallas TPU kernel benchmarks/bench_vpu_dtype.py _kernel: for
// each element of x, acc = x, then passes x k / 2 times acc = acc * x + x,
// in x's own type, and out = acc. The benchmark runs it over (8, 1024, 512)
// with k = 64 and passes = 8 (256 dependent steps an element) to ask
// whether the chip's vector unit runs bfloat16 multiply-adds at twice the
// float32 rate.
//
// Bound. 2 operations a step (the multiply and the add) over 4 M elements:
// 2.15 G operations against 33.6 MB (float32) or 16.8 MB (bfloat16) of
// input and output. At the H100 SXM's non-tensor rates (67 TFLOP/s float32,
// 133.8 TFLOP/s bfloat16) the operations take 32 and 16 us, the bytes 10
// and 5 us: the probe is bound by the operations, which is what it exists
// to measure. The design:
//
// * Each thread loads one 16-byte vector: 4 floats, or 8 bfloat16 as 4
//   __nv_bfloat162 pairs. Its 4 lanes are 4 independent chains, so the
//   dependent FMA's latency overlaps across them and across the warps of
//   an SM.
// * float32 chains fmaf (FFMA); bfloat16 chains __hfma2 on the pairs, one
//   HFMA2.BF16 instruction for two elements on the card's bfloat16 pipe,
//   without a conversion to float. The step rounds once where the JAX
//   kernel's acc * x + x rounds twice.
// * k and passes are run-time arguments; the inner loop over k / 2 steps is
//   unrolled 16 deep.
// * Nothing but the vector is read or written; no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 8 bfloat16 in one 16-byte vector, as 4 pairs
struct __align__(16) Bf16x8 {
  __nv_bfloat162 v[4];
};

__device__ __forceinline__ void step(float4& acc, const float4& x) {
  acc.x = fmaf(acc.x, x.x, x.x);
  acc.y = fmaf(acc.y, x.y, x.y);
  acc.z = fmaf(acc.z, x.z, x.z);
  acc.w = fmaf(acc.w, x.w, x.w);
}

__device__ __forceinline__ void step(Bf16x8& acc, const Bf16x8& x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc.v[j] = __hfma2(acc.v[j], x.v[j], x.v[j]);
}

// out[i] = the chain of x[i], one 16-byte vector a thread. grid
// (cdiv(n_vec, kThreads))
template <typename V>
__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const V* __restrict__ x, V* __restrict__ out, long long n_vec, int half_k,
                 int passes) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const V xv = x[i];
  V acc = xv;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 16
    for (int s = 0; s < half_k; ++s) step(acc, xv);
  }
  out[i] = acc;
}

template <typename V>
int launch(const void* x, void* out, long long n_vec, int k, int passes, cudaStream_t s) {
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  fma_chain_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n_vec, k / 2, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K10: out = the chain of x over n elements, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1). x and out are 16-byte aligned, n a multiple of the
// elements a vector holds (4 or 8), fewer than 2**31 blocks of 256 vectors,
// k even.
// Returns a CUDA error code, or 0.
int fma_chain(const void* x, void* out, long long n, int k, int passes, int bf16,
              void* stream) {
  const int per_vec = bf16 ? 8 : 4;
  if (n <= 0 || n % per_vec || k < 0 || k % 2 || passes < 0 ||
      (n / per_vec + kThreads - 1) / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<Bf16x8>(x, out, n / per_vec, k, passes, s)
              : launch<float4>(x, out, n / per_vec, k, passes, s);
}

}  // extern "C"
