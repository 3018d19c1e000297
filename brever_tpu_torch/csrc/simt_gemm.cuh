// A float32 SIMT GEMM body for NVIDIA Hopper, shared by K1's two products
// (tcn_block.cu), K2's five (tcn_block_bwd.cu) and K4's and K6's
// (lstm_scan.cuh), and the cp.async copies it and K3's ring stage their
// operands with. Bound on this card: float32 FFMA at 67 TFLOP/s, against
// which these products reach about 30-36 TFLOP/s (PERF.md); the block tile
// of 8 x 8 outputs a thread keeps four shared-memory wavefronts to 64
// FFMAs a k, and the two-stage ring hides the loads of slice s + 1 behind
// the multiply of slice s. (K1's and K2's bf16 route runs its products on
// the bf16 tensor cores instead: mma_bf16.cuh, tcn_block_bf16.cu.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace simt {

using bf16 = __nv_bfloat16;

// Loads and stores of float32 or bfloat16 storage as float32 values: one
// element, or four neighbours (16 bytes of float32, 8 of bfloat16; p aligned
// to that).
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldgf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldgf(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// v rounded to bfloat16 (nearest even), as float32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// A block computes a 128 x 128 tile of C = A B with 256 threads, 8 x 8
// outputs a thread: warp w owns rows (w / 4) 64 .. + 63 and columns (w % 4)
// 32 .. + 31 of the tile; lane l rows l / 4 * 4 + {0..3} and 32 + that,
// columns l % 4 * 4 + {0..3} and 16 + that, so each of a warp's four float4
// fragment loads a k is one 128-byte (or broadcast 64-byte) wavefront. Both
// operands are staged as 16-deep k slices, (k, 128) with a padded row, in
// two stages: while the block multiplies one, the next arrives, by
// cp.async for an operand whose rows are k (stage_direct: K4's w_ih, w_hh,
// w_ih^T and its weight gradient's x, h and dgates), through registers for
// one stored with k contiguous (RowStage: the rows of K4's x, h and dgates,
// of x and h2 and of the torch Linear weights in K1 and K2), which the
// staging transposes, or for one transformed on load (K1's y2, K2's y2). Every
// output sums its products over k ascending with fmaf, from 0. (3xTF32
// mma.sync on the tensor cores for K4's dx and weight GEMM was timed: a
// small gain, and weight gradients less accurate than the plain float32
// path's; PERF.md.)

constexpr int kGemmThreads = 256;
constexpr int kGM = 128;              // block tile rows and columns
constexpr int kGK = 16;               // k slice
constexpr int kGLd = kGM + 4;         // floats a staged k row
constexpr int kGSlice = kGK * kGLd;   // floats of one operand's slice

// acc += As (kGK, kGLd) Bs (kGK, kGLd) for the thread's 8 x 8 outputs
__device__ __forceinline__ void slice_fma(float (&acc)[8][8], const float* As, const float* Bs) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const float* a = As + (w / 4) * 64 + (l / 4) * 4;
  const float* b = Bs + (w % 4) * 32 + (l % 4) * 4;
#pragma unroll
  for (int k = 0; k < kGK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kGLd);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kGLd + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kGLd);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * kGLd + 16);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the tile row of the thread's output row i < 8, the tile column of its
// column j < 8 (j = 0 and j = 4 start its two float4 groups)
__device__ __forceinline__ int frag_row(int i) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return (w / 4) * 64 + (i / 4) * 32 + (l / 4) * 4 + i % 4;
}
__device__ __forceinline__ int frag_col(int j) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return (w % 4) * 32 + (j / 4) * 16 + (l % 4) * 4 + j % 4;
}

// The thread's two float4 pieces of a (kGK, 128) slice whose rows are k:
// piece q is row (tid + 256 q) / 32, columns 4 ((tid + 256 q) % 32) .. + 3;
// src(k, c) is the source of slice row k, column c, or null for zeros
// (any: a valid address that is not read). kVec: each piece one 16-byte
// copy (the source's rows and widths on the float4 grid); else four 4-byte
// copies, src asked for each column (an operand off that grid).
template <bool kVec = true, class Src>
__device__ __forceinline__ void stage_direct(float* S, Src src, const float* any) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = threadIdx.x + q * kGemmThreads, k = i / 32, c = i % 32 * 4;
    if constexpr (kVec) {
      const float* p = src(k, c);
      cp_async<16>(S + k * kGLd + c, p ? p : any, p != nullptr);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p = src(k, c + e);
        cp_async<4>(S + k * kGLd + c + e, p ? p : any, p != nullptr);
      }
    }
  }
}

// A (128, kGK) slice of 128 rows stored with k contiguous, through
// registers: the thread stages row tid % 128 at k groups 4 (tid / 128) and
// 8 + that, loading them before the block multiplies the previous slice
// and storing them transposed after. kVec: a group is one float4 load
// (rows 16-byte aligned, kmax % 4 == 0); else four single loads.
template <bool kVec = true>
struct RowStage {
  float4 v[2];

  // from row (null: zeros) at k0; columns k >= kmax are zeros
  __device__ __forceinline__ void load(const float* row, int k0, int kmax) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = k0 + (threadIdx.x / kGM) * 4 + 8 * q;
      if constexpr (kVec) {
        v[q] = row && k < kmax ? ldg4(row + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float e[4] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row && k + j < kmax) e[j] = ldgf(row + k + j);
        v[q] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* S) const {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float* s = S + ((threadIdx.x / kGM) * 4 + 8 * q) * kGLd + threadIdx.x % kGM;
      s[0] = v[q].x;
      s[kGLd] = v[q].y;
      s[2 * kGLd] = v[q].z;
      s[3 * kGLd] = v[q].w;
    }
  }
};

// The block's k loop over n slices, two stages in sm (4 kGSlice floats):
// op.fetch(s, As, Bs) issues slice s's cp.async copies and register loads,
// op.store(As) writes the registers' part, op.after(s, acc, Bs) runs once
// slice s is in acc.
template <class Op>
__device__ __forceinline__ void gemm_loop(Op& op, float (&acc)[8][8], int n, float* sm) {
  op.fetch(0, sm, sm + kGSlice);
  cp_async_commit();
  op.store(sm);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    float* cur = sm + (s & 1) * 2 * kGSlice;
    float* nxt = sm + ((s + 1) & 1) * 2 * kGSlice;
    if (s + 1 < n) op.fetch(s + 1, nxt, nxt + kGSlice);
    cp_async_commit();
    slice_fma(acc, cur, cur + kGSlice);
    op.after(s, acc, cur + kGSlice);
    if (s + 1 < n) op.store(nxt);
    cp_async_wait<0>();
    __syncthreads();  // slice s + 1 whole; every thread done with slice s
  }
}

// acc's rows into out: the output row of tile row m (null: none), column
// groups of 4 at column n0 + frag_col(0) and n0 + frag_col(4), columns at
// or past n_max left out. The rows are float32, or bfloat16 (each value
// rounded to nearest even). kVec: a group is one float4 store (rows 16-byte
// aligned, n_max % 4 == 0), or one 8-byte store of 4 bfloat16; else four
// single stores.
template <bool kVec = true, class RowOf>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8], RowOf row_of, int n0,
                                           int n_max) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    auto* out = row_of(frag_row(i));
    if (!out) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + frag_col(4 * h);
      if constexpr (kVec) {
        if (n < n_max)
          st4(out + n, acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < n_max) stf(out + n + e, acc[i][4 * h + e]);
      }
    }
  }
}

}  // namespace simt
