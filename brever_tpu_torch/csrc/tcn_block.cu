// Conv-TasNet TCN block forward (flash-TCN) for NVIDIA Hopper, float32 or
// bfloat16 I/O.
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
//   1. tcn_in_gemm: z1 = x W_in^T + b_in on simt_gemm.cuh's body
//      (tcn_common.cuh's z1_tile, the product K2 recomputes, so K2's z1 is
//      this z1 bit for bit); the epilogue applies the PReLU, writes h1 and
//      the 128 x 128 tile's (count, mean, M2) partial moments.
//   2. row_stats: one block per batch row merges the row's partials
//      (Chan's formula in double, fixed order, so deterministic) and writes
//      (mean1, rstd1) into stats (B, 4).
//   3. dw_prelu_stats: normalizes h1 on load (zero outside [0, T): the
//      padding comes after the norm), dilated 3-tap depthwise conv + PReLU,
//      writes h2 and its partial moments; row_stats then writes
//      (mean2, rstd2).
//   4. tcn_out_gemm: [res | skip] = y2 [W_res; W_skip]^T on the same body,
//      y2 normalised from h2 with its row's statistics and g2, be2 in
//      registers on the way to shared memory; the epilogue adds the biases
//      and the residual. Column tiles of res come first, then those of skip.
//
// stats (B, 4) = (mean1, rstd1, mean2, rstd2) is what the backward
// (tcn_block_bwd.cu) recomputes the block from.
//
// Bound on the H100: 2 T H (2C + Cs) flops a batch row (25.2 GFLOP at
// B=16, T=3999, C=Cs=128, H=512: 0.378 ms at 67 TFLOP/s in float32), which
// is more than the bytes (h1 and h2 make one round trip through device
// memory each, 2 x 8 MB a row). The first design ran both products on a
// 64 x 64 tile with 4 x 4 outputs a thread and synchronous scalar staging
// (16-19 TFLOP/s); both now run on the 128 x 128 tile with 8 x 8 outputs a
// thread and a two-stage ring that loads slice s + 1 while slice s is
// multiplied, K2's and K4's body. Both operands of both products are stored
// with k contiguous (x and h2 rows, and the torch Linear weights), so both
// are staged through registers and transposed into the k slices: no copy
// of a transposed weight is made. The design keeps z1, z2, y1 and y2 out
// of device memory by fusing them into a load or an epilogue, and carries
// only 3 floats per tile across the barriers, merged once per row. Folding
// the gLN affines into the weights, bf16 and wgmma/TMA tiles are later
// work.
//
// The bf16 route (tcn_block_fwd_bf16: x, every parameter, res and skip
// bfloat16; h1, the partials and stats float32) is the TPU kernel's own
// under amp, which the reference engages only in bf16, at its rounding
// points. Its products run on the bf16 tensor cores (tcn_block_bf16.cu):
// z1 from bf16 operands summed in float32, then h1, the statistics, the
// depthwise taps and h2 in float32 (h2 stored rounded to bf16 in rows of
// tcn_bf16::ld(H)), the PReLU slopes float32 (bf16 values), its depthwise
// stage tcn_block_bf16.cu's on this file's tile (kDwRows x kDwCols, the
// same partials) with 4 channels a thread; the output product takes the gLN2
// affine folded into the weights as the TPU kernel does, w_f = bf16(W hs2)
// (hs2 = g2 rstd2, per batch row) against bf16(h2), plus the float32 bias
// cv2 W^T + b (cv2 = be2 - mean2 hs2), and res/skip are rounded to bf16 on
// store.
//
// Every pointer is a dense buffer, 16-byte aligned (the wrapper
// copies one that is not). 2-D weights are in the storage of a torch Linear
// weight, (N, K) = (out, in) row-major, which the model passes as it is.
// Where C, H and Cs are multiples of 4 the GEMMs move float4s (kVec); at
// any other width the same kernels with kVec = false move single floats,
// with the same sums in the same order.

#include "tcn_common.cuh"

namespace {

using namespace tcn;
using namespace simt;

constexpr int kDwPer = kDwRows / (kThreads / kDwCols);  // rows per thread

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

// grid (cdiv(T, 128), cdiv(H, 128), B)
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_in_gemm(const float* __restrict__ x, const float* __restrict__ w_in,
            const float* __restrict__ bias, const float* __restrict__ alpha,
            float* __restrict__ h1, float* __restrict__ part, int T, int C, int H) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  __shared__ float red[kThreads / 32];
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGM;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * T;
  float acc[8][8];
  z1_tile<kVec>(acc, x, w_in, bias, T, C, H, sm);
  const float a1 = *alpha;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = prelu(acc[i][j], a1);
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < T ? h1 + (row0 + m0 + i) * H : nullptr;
  }, n0, H);
  const int n_part = gridDim.x * gridDim.y;
  const float count = static_cast<float>(min(kGM, T - m0) * min(kGM, H - n0));
  tile_moments<64>([&](int i) { return acc[i / 8][i % 8]; },
                   [&](int i) { return m0 + frag_row(i / 8) < T && n0 + frag_col(i % 8) < H; },
                   count, red,
                   part + 3 * (static_cast<size_t>(blockIdx.z) * n_part +
                               blockIdx.x * gridDim.y + blockIdx.y));
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
  tile_moments<kDwPer>([&](int i) { return v[i]; }, [&](int i) { return ok[i]; }, count, red,
                       part2 + 3 * (static_cast<size_t>(b) * n_part + blockIdx.x * gridDim.y +
                                    blockIdx.y));
}

// The output product's k loop: A is y2 = (h2 - mean2) rstd2 g2 + be2 of the
// staged row of h2 (k = H contiguous), normalised in registers after the
// block has multiplied the previous slice; B the staged row of W_res or
// W_skip ((out, H), k contiguous). Past H, and for rows past T, A is 0.
template <bool kVec>
struct OutOp {
  const float *hrow, *wrow, *g2, *be2;
  float mean, rstd;
  int H, k0 = 0;
  RowStage<kVec> a, b;

  __device__ __forceinline__ void fetch(int s, float*, float*) {
    k0 = s * kGK;
    a.load(hrow, k0, H);
    b.load(wrow, k0, H);
  }
  __device__ __forceinline__ void store(float* As) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = k0 + (threadIdx.x / kGM) * 4 + 8 * q;
      float e[4] = {a.v[q].x, a.v[q].y, a.v[q].z, a.v[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = hrow && k + j < H ? (e[j] - mean) * rstd * __ldg(g2 + k + j) + __ldg(be2 + k + j)
                                 : 0.f;
      a.v[q] = make_float4(e[0], e[1], e[2], e[3]);
    }
    a.store(As);
    b.store(As + kGSlice);
  }
  __device__ __forceinline__ void after(int, float (&)[8][8], const float*) {}
};

// grid (cdiv(T, 128), cdiv(n_res, 128) + cdiv(Cs, 128), B); n_res is C,
// or 0 on the last block (no residual output)
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2)
tcn_out_gemm(const float* __restrict__ h2, const float* __restrict__ stats,
             const float* __restrict__ g2, const float* __restrict__ be2,
             const float* __restrict__ w_res, const float* __restrict__ b_res,
             const float* __restrict__ w_skip, const float* __restrict__ b_skip,
             const float* __restrict__ x, float* __restrict__ res, float* __restrict__ skip,
             int T, int H, int C, int Cs, int n_res) {
  __shared__ __align__(16) float sm[4 * kGSlice];
  const int b = blockIdx.z, m0 = blockIdx.x * kGM, mr = cdiv(n_res, kGM);
  const bool is_res = static_cast<int>(blockIdx.y) < mr;
  const int n0 = (is_res ? blockIdx.y : blockIdx.y - mr) * kGM, N = is_res ? n_res : Cs;
  const float* w = is_res ? w_res : w_skip;
  const float* bias = is_res ? b_res : b_skip;
  float* out = is_res ? res : skip;
  const size_t row0 = static_cast<size_t>(b) * T;
  const int m = m0 + threadIdx.x % kGM, n = n0 + threadIdx.x % kGM;
  float acc[8][8] = {};
  OutOp<kVec> op;
  op.hrow = m < T ? h2 + (row0 + m) * H : nullptr;
  op.wrow = n < N ? w + static_cast<size_t>(n) * H : nullptr;
  op.g2 = g2;
  op.be2 = be2;
  op.mean = stats[4 * b + 2];
  op.rstd = stats[4 * b + 3];
  op.H = H;
  gemm_loop(op, acc, cdiv(H, kGK), sm);
  // the sum, then the bias, then (res) x + that
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + frag_col(j);
    const float bn = col < N ? bias[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = acc[i][j] + bn;
  }
  if (is_res) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = m0 + frag_row(i);
      if (t >= T) continue;
      const float* xr = x + (row0 + t) * C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + frag_col(4 * h);
        if (col >= N) continue;
        float e[4] = {};
        if constexpr (kVec) {
          const float4 q = ldg4(xr + col);
          e[0] = q.x, e[1] = q.y, e[2] = q.z, e[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < N) e[j] = xr[col + j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * h + j] = e[j] + acc[i][4 * h + j];
      }
    }
  }
  store_tile<kVec>(acc, [&](int i) -> float* {
    return m0 + i < T ? out + (row0 + m0 + i) * N : nullptr;
  }, n0, N);
}

// every width on the float4 grid: the kVec GEMMs
bool vec_widths(int C, int H, int Cs) { return C % 4 == 0 && H % 4 == 0 && Cs % 4 == 0; }

}  // namespace

extern "C" {

// Number of (count, mean, M2) partials per batch row written by each stage.
int tcn_in_partials(int T, int H) { return cdiv(T, kGM) * cdiv(H, kGM); }
int tcn_dw_partials(int T, int H) { return cdiv(T, kDwRows) * cdiv(H, kDwCols); }

// The float32 route's five launches, one entry each; every pointer float32.
int tcn_in_gemm_prelu_stats(const float* x, const float* w, const float* bias,
                            const float* alpha, float* h1, float* part, int B, int T, int C, int H,
                            void* stream) {
  const dim3 grid(cdiv(T, kGM), cdiv(H, kGM), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_widths(C, H, 4))
    tcn_in_gemm<true><<<grid, kGemmThreads, 0, s>>>(x, w, bias, alpha, h1, part, T, C, H);
  else
    tcn_in_gemm<false><<<grid, kGemmThreads, 0, s>>>(x, w, bias, alpha, h1, part, T, C, H);
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
  dw_prelu_stats<<<dim3(cdiv(T, kDwRows), cdiv(H, kDwCols), B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(h1, stats, g1, be1, w_dw, b_dw, alpha,
                                                        h2, part2, T, H, dilation);
  return static_cast<int>(cudaGetLastError());
}

int tcn_out_gemm(const float* h2, const float* stats, const float* g2, const float* be2,
                 const float* w_res, const float* b_res, const float* w_skip,
                 const float* b_skip, const float* x, float* res, float* skip, int B, int T,
                 int H, int C, int Cs, int last, void* stream) {
  const int n_res = last ? 0 : C;
  const dim3 grid(cdiv(T, kGM), cdiv(n_res, kGM) + cdiv(Cs, kGM), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_widths(C, H, Cs))
    tcn_out_gemm<true><<<grid, kGemmThreads, 0, s>>>(h2, stats, g2, be2, w_res, b_res, w_skip,
                                                     b_skip, x, res, skip, T, H, C, Cs, n_res);
  else
    tcn_out_gemm<false><<<grid, kGemmThreads, 0, s>>>(h2, stats, g2, be2, w_res, b_res, w_skip,
                                                      b_skip, x, res, skip, T, H, C, Cs, n_res);
  return static_cast<int>(cudaGetLastError());
}

// Everything one K1-bf16 call reads and writes: x, the parameters, res and
// skip bfloat16 (w_res, b_res and res unused on the last block); h1 (B, T,
// H), the partials (tcn_in_partials, tcn_dw_partials a row, 3 floats each),
// stats (B, 4) and fb (B, n_res + Cs) float32; h2 (B, T, ld) and wf (B,
// n_res + Cs, ld) bfloat16, ld = tcn_bf16_ld(H).
struct TcnFwdBf16Args {
  const void *x, *w_in, *b_in, *a1, *g1, *be1, *w_dw, *b_dw, *a2, *g2, *be2, *w_res, *b_res,
      *w_skip, *b_skip;
  float *h1, *part1, *part2, *stats, *fb;
  void *h2, *wf, *res, *skip;
  int B, T, C, H, Cs, last, dilation;
  float eps;
};

// K1-bf16's six launches on `stream`: z1 and h1 on the tensor cores, the
// two statistics, the depthwise stage (bf16 h2), the folded output weights
// and the output product; returns the first launch's CUDA error code, or 0.
int tcn_block_fwd_bf16(const TcnFwdBf16Args* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = a->B, T = a->T, C = a->C, H = a->H, Cs = a->Cs, n_res = a->last ? 0 : C;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  int err = tcn_bf16::in_mma(in(a->x), in(a->w_in), in(a->b_in), in(a->a1), a->h1, a->part1, B,
                             T, C, H, s);
  if (err || (err = tcn_row_stats(a->part1, tcn_in_partials(T, H), a->stats, 0, B, a->eps, s)))
    return err;
  if ((err = tcn_bf16::dw(a->h1, a->stats, in(a->g1), in(a->be1), in(a->w_dw), in(a->b_dw),
                          in(a->a2), static_cast<bf16*>(a->h2), a->part2, B, T, H, a->dilation,
                          s)) ||
      (err = tcn_row_stats(a->part2, tcn_dw_partials(T, H), a->stats, 1, B, a->eps, s)))
    return err;
  bf16* wf = static_cast<bf16*>(a->wf);
  if ((err = tcn_bf16::fold(a->stats, in(a->g2), in(a->be2), in(a->w_res), in(a->b_res),
                            in(a->w_skip), in(a->b_skip), wf, a->fb, B, H, n_res, Cs, s)))
    return err;
  return tcn_bf16::out_mma(static_cast<const bf16*>(a->h2), wf, a->fb, in(a->x),
                           static_cast<bf16*>(a->res), static_cast<bf16*>(a->skip), B, T, H, C,
                           Cs, n_res, s);
}

}  // extern "C"
