// A bf16 tensor-core GEMM body for NVIDIA Hopper, and the warp-level pieces
// it is built from: K4's three products on the bf16 route (the gates, dx =
// dgates w_ih^T and the weight gradient, which K6's bf16 route runs too)
// and the serial steps' products of K3-bf16 and K4-bf16's reverse scan
// (lstm_scan_bf16.cu). simt_gemm.cuh keeps the float32 routes' SIMT body.
//
// Operands are bf16 in shared memory, copied there by cp.async in 16-byte
// pieces (a piece whose source is out of range is filled with zeros);
// fragments are read with ldmatrix and multiplied by
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 into float32
// accumulators (HMMA.16816.F32.BF16 in the SASS). The product of two bf16
// values is exact in float32; each mma adds its 16 products and the
// accumulator in the tensor core's own order, the same for every element,
// so a sum taken over the same k16 chunks in the same order, from the same
// accumulator, gives the same bits in every kernel that uses this
// instruction (K3-bf16's gates are K4-bf16's).
//
// Bound on this card: the bf16 tensor cores at 989 TFLOP/s dense. mma.sync
// reaches a part of it (wgmma, four warps on a 64-row tile from shared
// memory, reaches the rest); a block tile of 128 x 128 with a warp tile of
// 64 x 32 reads 6 ldmatrix.x4 a k16 step for 16 mma, and a ring of
// kTcStages stages keeps three 32-deep k slices in flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"

namespace tc {

using simt::bf16;

// bf16 a staged row is padded by: a padded row is an odd number of 16-byte
// units (48, 80, 272, 1040 bytes, ...), so the 8 rows of an ldmatrix 8 x 8
// matrix fall in 8 different 16-byte bank groups
constexpr int kPadBf16 = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8 bf16 (16 bytes) from global to shared memory by cp.async; zeros where
// !valid (src any valid address then)
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool valid) {
  simt::cp_async<16>(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), valid);
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Fragments of m16n8k16 (lane l: g = l / 4, t = l % 4). A (16 x 16 at rows
// m0, columns k0): a[0] (g, 2t..2t+1), a[1] (g + 8, ..), a[2] (g, 2t + 8..),
// a[3] (g + 8, 2t + 8..). B of two neighbouring 16 x 8 tiles (k0 .. k0 + 15,
// columns n0 .. n0 + 15): b[0], b[1] the k halves of columns n0 .. n0 + 7
// (column n0 + g, rows 2t..2t+1 and 2t + 8..), b[2], b[3] of n0 + 8 ...
// A tile stored [m][k] (k contiguous, ld elements a row) is read by
// ldmatrix, one stored [k][m] by ldmatrix.trans; B stored [n][k] by
// ldmatrix, [k][n] by ldmatrix.trans.
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4(a, s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
__device__ __forceinline__ void frag_a_t(unsigned (&a)[4], const bf16* s, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x % 32, q = l >> 3;
  ldsm4t(a, s + (k0 + (q >> 1) * 8 + (l & 7)) * ld + m0 + (q & 1) * 8);
}
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32, q = l >> 3;
  ldsm4(b, s + (n0 + (q >> 1) * 8 + (l & 7)) * ld + k0 + (q & 1) * 8);
}
__device__ __forceinline__ void frag_b_t(unsigned (&b)[4], const bf16* s, int ld, int n0,
                                         int k0) {
  const int l = threadIdx.x % 32, q = l >> 3;
  ldsm4t(b, s + (k0 + (q & 1) * 8 + (l & 7)) * ld + n0 + (q >> 1) * 8);
}

// d += a b on the bf16 tensor cores: d[0], d[1] at (g, 2t..2t+1), d[2],
// d[3] at (g + 8, 2t..2t+1) of the 16 x 8 tile
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as a bf16 pair (nearest even) at p (4-byte aligned), or as
// float32 at p (8-byte aligned)
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// The block GEMM: a 128 x 128 tile of C = A B with 256 threads, 8 warps as
// 2 x 4, warp (wm, wn) = (w / 4, w % 4) owning rows wm 64 .. + 63 and
// columns wn 32 .. + 31 (4 m16 x 4 n8 tiles, 64 float32 accumulators a
// thread). k runs in 32-deep slices (two k16 steps) through kTcStages
// stages of shared memory, each operand staged [row][k] (kTcLdK a row) or
// [k][row] (kTcLdW a row) as its source lies.
constexpr int kTcThreads = 256;
constexpr int kTcTile = 128;                         // block tile rows and columns
constexpr int kTcSlice = 32;                         // k of a stage
constexpr int kTcStages = 4;
constexpr int kTcLdK = kTcSlice + kPadBf16;          // a [row][k] tile's row (80 bytes)
constexpr int kTcLdW = kTcTile + kPadBf16;           // a [k][row] tile's row (272 bytes)
constexpr int kTcOperand = kTcTile * kTcLdK;         // bf16 of a staged operand (>= kTcSlice kTcLdW)
constexpr int kTcSmem = kTcStages * 2 * kTcOperand * 2;  // bytes of dynamic shared memory
static_assert(kTcOperand >= kTcSlice * kTcLdW, "a [k][row] slice fits an operand's room");

using Acc = float[4][4][4];  // [m16 tile][n8 tile][mma element]

// the tile row and column of accumulator (mi, ni, e) of this thread
__device__ __forceinline__ int tc_row(int mi, int e) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return (w / 4) * 64 + mi * 16 + l / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int tc_col(int ni, int e) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return (w % 4) * 32 + ni * 8 + 2 * (l % 4) + e % 2;
}

// acc += the k16 step at column kk of the staged As and Bs (A [m][k] or,
// kAT, [k][m]; B [n][k] or, kBT, [k][n])
template <bool kAT, bool kBT>
__device__ __forceinline__ void tc_k16(Acc& acc, const bf16* As, const bf16* Bs, int kk) {
  const int w = threadIdx.x / 32, wm = w / 4, wn = w % 4;
  unsigned b[2][4];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    if constexpr (kBT)
      frag_b_t(b[nj], Bs, kTcLdW, wn * 32 + nj * 16, kk);
    else
      frag_b(b[nj], Bs, kTcLdK, wn * 32 + nj * 16, kk);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    unsigned a[4];
    if constexpr (kAT)
      frag_a_t(a, As, kTcLdW, wm * 64 + mi * 16, kk);
    else
      frag_a(a, As, kTcLdK, wm * 64 + mi * 16, kk);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma(acc[mi][ni], a, b[ni / 2][(ni % 2) * 2], b[ni / 2][(ni % 2) * 2 + 1]);
  }
}

// The block's k loop over n16 k16 chunks (two a stage), in sm (kTcSmem
// bytes): op.load(s, As, Bs) issues stage s's cp.async pieces (chunks 2s,
// 2s + 1; zeros past n16), op.after(c, acc, Bs, kk) runs once chunk c is in
// acc (Bs, kk: its stage's B and its k column there). Chunks are summed in
// ascending order from acc.
template <bool kAT, bool kBT, class Op>
__device__ __forceinline__ void tc_gemm(Op& op, Acc& acc, int n16, bf16* sm) {
  const int n_st = (n16 + 1) / 2;
  auto As = [&](int s) { return sm + (s % kTcStages) * 2 * kTcOperand; };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_st) op.load(s, As(s), As(s) + kTcOperand);
    simt::cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    simt::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage s in; every thread done with stage s - 1
    const int next = s + kTcStages - 1;
    if (next < n_st) op.load(next, As(next), As(next) + kTcOperand);
    simt::cp_async_commit();
    const bf16* a = As(s);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c = 2 * s + kk;
      if (c < n16) {
        tc_k16<kAT, kBT>(acc, a, a + kTcOperand, kk * 16);
        op.after(c, acc, a + kTcOperand, kk * 16);
      }
    }
  }
  simt::cp_async_wait<0>();
}

// acc into out: row_of(tile row) is the output row (null: none), its
// columns n0 + tile column; pairs at columns >= n_max (even) left out
template <class T, class RowOf>
__device__ __forceinline__ void tc_store(const Acc& acc, RowOf row_of, int n0, int n_max) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* out = row_of(tc_row(mi, 2 * h));
      if (!out) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + tc_col(ni, 0);
        if (n < n_max) st2(out + n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// acc as bf16 into out through shared memory: the tile's pairs into sm
// ([128][kTcLdW], the k loop's stages, free once every warp is past them),
// then each row's 16-byte pieces by neighbouring threads, so that a warp
// stores whole 128-byte lines; row_of as tc_store's, columns n0 + 8p at or
// past n_max (a multiple of 8) left out
template <class RowOf>
__device__ __forceinline__ void tc_store_staged(const Acc& acc, RowOf row_of, int n0, int n_max,
                                                bf16* sm) {
  __syncthreads();  // every warp done with the k loop's stages
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        st2(sm + tc_row(mi, 2 * h) * kTcLdW + tc_col(ni, 0), acc[mi][ni][2 * h],
            acc[mi][ni][2 * h + 1]);
  __syncthreads();
  constexpr int kPieces = kTcTile / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < kTcTile * kPieces; i += kTcThreads) {
    const int r = i / kPieces, n = n0 + (i % kPieces) * 8;
    bf16* out = row_of(r);
    if (out && n < n_max)
      *reinterpret_cast<uint4*>(out + n) =
          *reinterpret_cast<const uint4*>(sm + r * kTcLdW + (i % kPieces) * 8);
  }
}

}  // namespace tc
