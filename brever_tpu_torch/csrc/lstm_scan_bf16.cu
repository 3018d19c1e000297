// The bf16 route of the LSTM kernels K3-K6, in its own translation unit so
// that nvcc compiles the two routes in parallel. K5-bf16 and K6-bf16's scan
// are lstm_scan.cuh's clusters instantiated on bf16 storage. K3-bf16 and
// K4-bf16 are this file's own kernels, their products on the bf16 tensor
// cores (mma.sync m16n8k16, mma_bf16.cuh) with float32 accumulators, the
// float32 route's plans and launches kept where they fit:
//
// * K3-bf16 (lstm_fwd_ring_mma) scans a tile of 64 or 32 rows of one
//   direction over all T steps in one launch, as lstm_fwd_ring does: one
//   block a tile holding w_hh whole up to H = kResidentMax (bf16, 128 KB at
//   H = 128), x[t]'s columns and w_ih's rows streamed through a cp.async
//   ring of kFwdStagesBf16 stages of one k16 slice, kFwdStagesBf16 - 1
//   slices ahead, across steps (no slice depends on h); above kResidentMax
//   w_hh's slices follow x's through the ring. h w_hh of a 64-row tile is
//   taken in two 32-row halves to keep its accumulators within 255
//   registers. 2H threads, each warp owning units with their four gates
//   for every row of the tile, so each thread holds all four gates of its
//   (row, unit) pairs and updates their cells in registers.
// * K4-bf16: the float32 route's five steps (lstm_scan.cuh), its GEMMs on
//   tc_gemm: the gates (lstm_bwd_gates_mma), the reverse scan
//   (lstm_bwd_rscan_mma), dx = dgates w_ih^T (lstm_bwd_dx_mma, w_ih itself
//   as the [n][k] operand: no transpose), the weight gradient over
//   fixed-order chunks of the (t, r) pairs (lstm_bwd_wgrad_mma, db summed
//   from the staged dgates) and the partial sums (sum_partials). The
//   reverse scan keeps the float32 route's elementwise step (thread (ry,
//   ux), dc in registers) and forms dh_rec = dgates[t] w_hh^T on the tensor
//   cores from dgates[t] and w_hh in shared memory (w_hh whole up to
//   kResidentMax, else a ring of kRscanChunkBf16-column chunks); dh_rec is
//   rounded to bf16 into shared memory, where the next step reads it.
//
// Rounding points: the Pallas kernels' (lstm_scan.cuh's bf16 notes): gx =
// bf16(x w_ih + bias), x's k16 chunks ascending from 0, then the bias, one
// rounding; gates = bf16(gx + bf16(h w_hh)), h's chunks ascending from 0;
// dh_rec, dx rounded once from their float32 sums; dW and db float32 sums
// over the chunks, summed in chunk order. K3-bf16 and K4-bf16's gates GEMM
// sum each gate with the same mma over the same chunks in the same order
// from 0: K4 recomputes K3's bits. No atomics: two runs are bitwise equal.
// E is a multiple of 16 (the wrapper pads with zeros), H of 32 up to 256.
//
// K3-bf16 and K4-bf16 replace brever_tpu/ops/pallas/lstm_scan.py
// _fwd_x_kernel and _bwd_x_kernel on bf16 operands. Bound on this card (at
// TF-GridNet's intra BLSTM, PERF.md): K3-bf16's 139.5 GFLOP take 0.141 ms at
// the tensor cores' 989 TFLOP/s; it runs at about a tenth of that, each step
// a serial chain of mma steps, the cells' SIMT math and a barrier. K4-bf16's
// reverse scan loads and stores about 1.5 GB (0.45 ms at 3.35 TB/s), a step
// at a time: each step's loads are issued together, while the step before
// runs its product (a few microseconds on the tensor cores).

#include "lstm_scan.cuh"
#include "mma_bf16.cuh"

namespace {

using tc::kPadBf16;

constexpr int kResidentMax = 128;    // largest H whose bf16 w_hh a block holds whole
constexpr int kFwdStagesBf16 = 4;    // stages of K3-bf16's ring
constexpr int kSliceBf16 = 16;       // k of a K3-bf16 ring slice: one m16n8k16 step
constexpr int kRscanRingBf16 = 4;    // stages of K4-bf16's reverse-scan ring past kResidentMax
constexpr int kRscanChunkBf16 = 32;  // w_hh columns a stage of that ring

// K3-bf16's plan: the float32 route's tile rows (64 where H <= 128 and
// 64-row tiles give the 132 SMs a block each, else 32), 2H threads, and
// the shared memory of w_hh (resident where H <= kResidentMax), h[t-1] of
// the tile and the ring's stages; ops/lstm_scan.py ``fwd_plan(...,
// bf16=True)`` mirrors this.
struct FwdPlanBf16 {
  int rows, slice, threads, tiles, smem;
  bool resident;

  FwdPlanBf16(int D, int R, int H) {
    rows = H <= 128 && D * cdiv(R, 64) >= kSMs ? 64 : 32;
    resident = H <= kResidentMax;
    slice = kSliceBf16;
    threads = 2 * H;
    tiles = cdiv(R, rows);
    const size_t ld = 4 * static_cast<size_t>(H) + kPadBf16;
    smem = static_cast<int>(
        2 * ((resident ? H * ld : 0) + static_cast<size_t>(rows) * (H + kPadBf16) +
             kFwdStagesBf16 * (kSliceBf16 * ld + static_cast<size_t>(rows) *
                                                     (kSliceBf16 + kPadBf16))));
  }
};

// K4-bf16's plan: the float32 route's (scan tiles, threads, weight-GEMM
// chunks) with the reverse scan's shared memory: w_hh [u][4H] whole (H <=
// kResidentMax) or the ring, dgates[t] [row][4H] and dh_rec [row][H];
// ops/lstm_scan.py ``bwd_plan(..., bf16=True)`` mirrors this.
struct BwdPlanBf16 : BwdPlan {
  BwdPlanBf16(int T, int D, int R, int E, int H) : BwdPlan(T, D, R, E, H) {
    const size_t ld = 4 * static_cast<size_t>(H) + kPadBf16;
    const size_t w = H <= kResidentMax
                         ? H * ld
                         : static_cast<size_t>(kRscanRingBf16) * H * (kRscanChunkBf16 + kPadBf16);
    smem = static_cast<int>(2 * (w + rows * ld + static_cast<size_t>(rows) * (H + kPadBf16)));
  }
};

bool shape_ok_bf16(int E, int H) { return shape_ok(E, H) && E % kSliceBf16 == 0; }

// ---------------------------------------------------------------------------
// K3-bf16

// acc[mi][2 gi + j] += A (kMb m16 blocks at a: [row][k], lda) x the k16
// rows of [k][4H] weights at b (ldb), over the warp's units u0 .. u0 + 15
// of each gate gi (n8 tiles at columns gi H + u0 + 8 j)
template <int kMb>
__device__ __forceinline__ void gates_k16(float (&acc)[kMb][8][4], const bf16* a, int lda,
                                          const bf16* b, int ldb, int H, int u0) {
  unsigned bf[4][4];
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) tc::frag_b_t(bf[gi], b, ldb, gi * H + u0, 0);
#pragma unroll
  for (int mi = 0; mi < kMb; ++mi) {
    unsigned af[4];
    tc::frag_a(af, a, lda, mi * 16, 0);
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      tc::mma(acc[mi][2 * gi], af, bf[gi][0], bf[gi][1]);
      tc::mma(acc[mi][2 * gi + 1], af, bf[gi][2], bf[gi][3]);
    }
  }
}

// K3-bf16: h_seq and c_seq (T, D, R, H) from x (T, D, R, E); kKeep: the
// gate pre-activations to gates_out (T, D, R, 4H) too. grid (cdiv(R,
// kRows), D), 2H threads, FwdPlanBf16's shared memory. Thread (warp w, lane
// g t) owns rows 16 mi + g (+ 8) of the tile and units 16 w + 8 j + 2t (+
// 1), all four gates of each.
template <int kRows, bool kResident, bool kKeep>
__global__ void __launch_bounds__(kResident ? 2 * kResidentMax : 2 * kMaxHiddenWide, 1)
lstm_fwd_ring_mma(const bf16* __restrict__ x, const bf16* __restrict__ w_ih,
                  const bf16* __restrict__ bias, const bf16* __restrict__ w_hh,
                  bf16* __restrict__ h_seq, bf16* __restrict__ c_seq,
                  bf16* __restrict__ gates_out, int T, int D, int R, int E, int H) {
  static_assert(kResident || kRows == 32, "a tile past kResidentMax has 32 rows");
  extern __shared__ float smem[];
  constexpr int kM = kRows / 16, kLdx = kSliceBf16 + kPadBf16;
  const int G = 4 * H, ldw = G + kPadBf16, ldh = H + kPadBf16;
  const int d = blockIdx.y, r0 = blockIdx.x * kRows, nthr = blockDim.x;
  bf16* wres = reinterpret_cast<bf16*>(smem);                          // (H, ldw): w_hh
  bf16* hs = wres + (kResident ? static_cast<size_t>(H) * ldw : 0);    // (kRows, ldh): h[t-1]
  bf16* ring = hs + kRows * ldh;  // stages: (16, ldw) weight rows | (kRows, kLdx) x[t] columns
  const int stage = kSliceBf16 * ldw + kRows * kLdx;
  const int lane = threadIdx.x % 32, lg = lane / 4, lt = lane % 4, u0 = threadIdx.x / 32 * 16;
  const int nx = E / kSliceBf16, nh = H / kSliceBf16, n_step = nx + (kResident ? 0 : nh);
  const bf16* wi = w_ih + static_cast<size_t>(d) * E * G;
  const bf16* wh = w_hh + static_cast<size_t>(d) * H * G;
  // the next slice to issue: step it, slice isl (x's, then w_hh's where not
  // resident), stage iq % kFwdStagesBf16; one commit group each (empty past
  // the last step). A slice's 16 weight rows are 8H pieces, 4 a thread.
  int it = 0, isl = 0, iq = 0;
  auto issue = [&]() {
    if (it < T) {
      bf16* st = ring + (iq % kFwdStagesBf16) * stage;
      const bool xs = isl < nx;
      const bf16* src = xs ? wi + static_cast<size_t>(isl) * kSliceBf16 * G
                           : wh + static_cast<size_t>(isl - nx) * kSliceBf16 * G;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = threadIdx.x + m * nthr, row = i / (G / 8), p = i % (G / 8);
        tc::cp16(st + row * ldw + p * 8, src + static_cast<size_t>(row) * G + p * 8, true);
      }
      if (xs) {
        bf16* xst = st + kSliceBf16 * ldw;
        const bf16* xt = x + at(it, d, 0, D, R) * E + isl * kSliceBf16;
        for (int i = threadIdx.x; i < 2 * kRows; i += nthr) {
          const int row = i / 2, p = i % 2;
          const bool ok = r0 + row < R;
          tc::cp16(xst + row * kLdx + p * 8,
                   ok ? xt + static_cast<size_t>(r0 + row) * E + p * 8 : x, ok);
        }
      }
      if (++isl == n_step) isl = 0, ++it;
    }
    ++iq;
    cp_async_commit();
  };
  if constexpr (kResident)  // in the first commit group
    for (int i = threadIdx.x; i < H * G / 8; i += nthr) {
      const int row = i / (G / 8), p = i % (G / 8);
      tc::cp16(wres + row * ldw + p * 8, wh + static_cast<size_t>(row) * G + p * 8, true);
    }
  for (int i = threadIdx.x; i < kRows * ldh; i += nthr) hs[i] = __float2bfloat16_rn(0.f);  // h[-1]
  for (int q = 0; q < kFwdStagesBf16 - 1; ++q) issue();
  unsigned bq[4][2];  // the thread's bias pairs: gate gi, n8 tile j
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bq[gi][j] = *reinterpret_cast<const unsigned*>(bias + d * G + gi * H + u0 + 8 * j + 2 * lt);
  unsigned c[kM][2][2] = {};  // c (bf16 pairs): [m block][n8 tile][row half]
  int q = 0;                  // slices consumed
  // the next slice of the ring in, its stage
  auto next_stage = [&]() {
    cp_async_wait<kFwdStagesBf16 - 2>();
    __syncthreads();  // slice q in; every thread done with slice q - 1 (and, at
                      // the step's first slice, h[t-1] whole in hs)
    issue();          // slice q + kFwdStagesBf16 - 1, into the stage of slice q - 1
    return ring + (q++ % kFwdStagesBf16) * stage;
  };
  for (int t = 0; t < T; ++t) {
    float acc[kM][8][4] = {};  // x w_ih
    for (int sl = 0; sl < nx; ++sl) {
      const bf16* st = next_stage();
      gates_k16<kM>(acc, st + kSliceBf16 * ldw, kLdx, st, ldw, H, u0);
    }
    unsigned gx[kM][8][2];  // bf16(x w_ih + bias), pairs of the rows g, g + 8
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b = unpack2(bq[n / 2][n % 2]);
        gx[mi][n][0] = pack2(acc[mi][n][0] + b.x, acc[mi][n][1] + b.y);
        gx[mi][n][1] = pack2(acc[mi][n][2] + b.x, acc[mi][n][3] + b.y);
      }
    // the cells of the rows of half hf (m blocks 2 hf, 2 hf + 1) from gx and
    // their h w_hh; h[t] into hs, h, c (and the gates) to device memory
    auto cells = [&](int hf, const float (&hw)[2][8][4]) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int mi = 2 * hf + mb;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mi * 16 + 8 * hr + lg;
          const bool live = r0 + row < R;
          const size_t o = live ? at(t, d, r0 + row, D, R) : 0;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int unit = u0 + 8 * j + 2 * lt;
            float z[4][2], hv[2];
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) {
              const float2 v = unpack2(gx[mi][2 * gi + j][hr]);
              z[gi][0] = round_bf16(v.x + round_bf16(hw[mb][2 * gi + j][2 * hr]));
              z[gi][1] = round_bf16(v.y + round_bf16(hw[mb][2 * gi + j][2 * hr + 1]));
            }
            const float2 cp = unpack2(c[mi][j][hr]);
            float cv[2] = {cp.x, cp.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) cell_bf16(z[0][e], z[1][e], z[2][e], z[3][e], cv[e], hv[e]);
            c[mi][j][hr] = pack2(cv[0], cv[1]);
            const unsigned hp = pack2(hv[0], hv[1]);
            *reinterpret_cast<unsigned*>(hs + row * ldh + unit) = hp;
            if (live) {
              *reinterpret_cast<unsigned*>(h_seq + o * H + unit) = hp;
              *reinterpret_cast<unsigned*>(c_seq + o * H + unit) = c[mi][j][hr];
              if constexpr (kKeep)
#pragma unroll
                for (int gi = 0; gi < 4; ++gi)
                  *reinterpret_cast<unsigned*>(gates_out + o * G + gi * H + unit) =
                      pack2(z[gi][0], z[gi][1]);
            }
          }
        }
      }
    };
    if constexpr (kResident) {
#pragma unroll
      for (int hf = 0; hf < kRows / 32; ++hf) {
        float hw[2][8][4] = {};
        for (int k = 0; k < nh; ++k)
          gates_k16<2>(hw, hs + (32 * hf) * ldh + k * kSliceBf16, ldh,
                       wres + k * kSliceBf16 * ldw, ldw, H, u0);
        __syncthreads();  // every warp done reading these rows of h[t-1]
        cells(hf, hw);
      }
    } else {
      float hw[2][8][4] = {};
      for (int k = 0; k < nh; ++k) {
        const bf16* st = next_stage();
        gates_k16<2>(hw, hs + k * kSliceBf16, ldh, st, ldw, H, u0);
      }
      __syncthreads();  // every warp done reading h[t-1]
      cells(0, hw);
    }
  }
}

// ---------------------------------------------------------------------------
// K4-bf16's GEMMs on tc_gemm (grid as the float32 route's: 128 x 128 tiles)

// The gates: pre[t, d, r] = bf16(bf16(x w_ih + bias) + bf16(h[t-1] w_hh))
// over k16 chunks c, x's for c < nx and h's after (zeros past T R rows and
// for h[-1]); A [m][k] from the rows, B [k][n] from w_ih and w_hh.
struct TcGatesOp {
  const bf16 *xrow[2], *hrow[2];  // the rows this thread stages (null: zeros)
  const bf16 *wi, *wh, *bias;
  int nx, n16, n0, G;
  unsigned gx[4][4][2];  // bf16(x w_ih + bias), pairs of the rows g, g + 8

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * tc::kTcThreads, row = i >> 2, p = i & 3;
      const int c = 2 * s + (p >> 1), off = (p & 1) * 8;
      const bf16* src = nullptr;
      if (c < nx) {
        if (xrow[q]) src = xrow[q] + c * 16 + off;
      } else if (c < n16 && hrow[q]) {
        src = hrow[q] + (c - nx) * 16 + off;
      }
      tc::cp16(As + row * tc::kTcLdK + p * 8, src ? src : wi, src != nullptr);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * tc::kTcThreads, k = i >> 4, col = (i & 15) * 8;
      const int c = 2 * s + (k >> 4), kr = k & 15;
      const bf16* src = c < nx    ? wi + (static_cast<size_t>(c) * 16 + kr) * G + n0 + col
                        : c < n16 ? wh + (static_cast<size_t>(c - nx) * 16 + kr) * G + n0 + col
                                  : nullptr;
      tc::cp16(Bs + k * tc::kTcLdW + col, src ? src : wi, src != nullptr);
    }
  }
  __device__ __forceinline__ void after(int c, tc::Acc& acc, const bf16*, int) {
    if (c != nx - 1) return;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float2 b =
          unpack2(*reinterpret_cast<const unsigned*>(bias + n0 + tc::tc_col(ni, 0)));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        gx[mi][ni][0] = pack2(acc[mi][ni][0] + b.x, acc[mi][ni][1] + b.y);
        gx[mi][ni][1] = pack2(acc[mi][ni][2] + b.x, acc[mi][ni][3] + b.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
  }
  // the gates from gx and h's sums
  __device__ __forceinline__ void finish(tc::Acc& acc) const {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = unpack2(gx[mi][ni][h]);
          acc[mi][ni][2 * h] = round_bf16(v.x + round_bf16(acc[mi][ni][2 * h]));
          acc[mi][ni][2 * h + 1] = round_bf16(v.y + round_bf16(acc[mi][ni][2 * h + 1]));
        }
  }
};

// grid (cdiv(T R, 128) 4H / 128, 1, D): rows m = t R + r of direction d,
// the column tiles of a row tile neighbouring blocks (they read its x and
// h rows from L2)
__global__ void __launch_bounds__(tc::kTcThreads, 2)
lstm_bwd_gates_mma(const bf16* __restrict__ x, const bf16* __restrict__ w_ih,
                   const bf16* __restrict__ bias, const bf16* __restrict__ w_hh,
                   const bf16* __restrict__ h_seq, bf16* __restrict__ pre, int T, int D, int R,
                   int E, int H) {
  extern __shared__ float smem[];
  const int d = blockIdx.z, G = 4 * H, M = T * R, nt = G / tc::kTcTile;
  const int m0 = blockIdx.x / nt * tc::kTcTile;
  TcGatesOp op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + (threadIdx.x >> 2) + 64 * q;
    op.xrow[q] = op.hrow[q] = nullptr;
    if (m < M) {
      const int t = m / R, r = m % R;
      op.xrow[q] = x + at(t, d, r, D, R) * E;
      if (t > 0) op.hrow[q] = h_seq + at(t - 1, d, r, D, R) * H;
    }
  }
  op.wi = w_ih + static_cast<size_t>(d) * E * G;
  op.wh = w_hh + static_cast<size_t>(d) * H * G;
  op.bias = bias + d * G;
  op.nx = E / 16;
  op.n16 = op.nx + H / 16;
  op.n0 = blockIdx.x % nt * tc::kTcTile;
  op.G = G;
  float acc[4][4][4] = {};
  tc::tc_gemm<false, true>(op, acc, op.n16, reinterpret_cast<bf16*>(smem));
  op.finish(acc);
  tc::tc_store_staged(acc, [&](int i) -> bf16* {
    const int mm = m0 + i;
    return mm < M ? pre + at(mm / R, d, mm % R, D, R) * G : nullptr;
  }, op.n0, G, reinterpret_cast<bf16*>(smem));
}

// dx = dgates w_ih^T: A [m][k] the dgates rows, B [n][k] w_ih's rows (E,
// 4H): k is dgates' column
struct TcDxOp {
  const bf16* grow[2];  // the dgates rows this thread stages (null: zeros)
  const bf16* wi;
  int G, E, n0;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * tc::kTcThreads, row = i >> 2, p = i & 3;
      const int k = s * tc::kTcSlice + p * 8, e = n0 + row;
      tc::cp16(As + row * tc::kTcLdK + p * 8, grow[q] ? grow[q] + k : wi, grow[q] != nullptr);
      tc::cp16(Bs + row * tc::kTcLdK + p * 8, e < E ? wi + static_cast<size_t>(e) * G + k : wi,
               e < E);
    }
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16*, int) {}
};

// grid (cdiv(T R, 128), cdiv(E, 128), D)
__global__ void __launch_bounds__(tc::kTcThreads, 2)
lstm_bwd_dx_mma(const bf16* __restrict__ dgates, const bf16* __restrict__ w_ih,
                bf16* __restrict__ dx, int T, int D, int R, int E, int H) {
  extern __shared__ float smem[];
  const int d = blockIdx.z, G = 4 * H, M = T * R, m0 = blockIdx.x * tc::kTcTile;
  TcDxOp op;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + (threadIdx.x >> 2) + 64 * q;
    op.grow[q] = m < M ? dgates + at(m / R, d, m % R, D, R) * G : nullptr;
  }
  op.wi = w_ih + static_cast<size_t>(d) * E * G;
  op.G = G;
  op.E = E;
  op.n0 = blockIdx.y * tc::kTcTile;
  float acc[4][4][4] = {};
  tc::tc_gemm<false, false>(op, acc, G / 16, reinterpret_cast<bf16*>(smem));
  tc::tc_store_staged(acc, [&](int i) -> bf16* {
    const int mm = m0 + i;
    return mm < M ? dx + at(mm / R, d, mm % R, D, R) * E : nullptr;
  }, op.n0, E, reinterpret_cast<bf16*>(smem));
}

// Weight-gradient partials over the pairs p in [p0, p1) of a chunk, p = t R
// + r: A [k][m] the rows of [x[t] | h[t-1]] (h[-1] = 0), B [k][n] dgates[p];
// with kDb the first row tile's threads tid < 128 also sum dgates' column
// n0 + tid from the staged B (the row of ones), p ascending.
template <bool kDb>
struct TcWgradOp {
  const bf16 *x, *h_seq, *dg;
  int D, R, E, H, d, p0, p1, m0, n0;
  float db = 0.f;

  __device__ __forceinline__ void load(int s, bf16* As, bf16* Bs) {
    const int G = 4 * H;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * tc::kTcThreads, k = i >> 4, col = (i & 15) * 8;
      const int p = p0 + s * tc::kTcSlice + k, m = m0 + col;
      const bf16 *pa = nullptr, *pb = nullptr;
      if (p < p1) {
        const int t = p / R;
        const size_t row = at(t, d, p % R, D, R);
        if (m < E)
          pa = x + row * E + m;
        else if (m < E + H && t > 0)
          pa = h_seq + (row - static_cast<size_t>(D) * R) * H + (m - E);
        pb = dg + row * G + n0 + col;
      }
      tc::cp16(As + k * tc::kTcLdW + col, pa ? pa : dg, pa != nullptr);
      tc::cp16(Bs + k * tc::kTcLdW + col, pb ? pb : dg, pb != nullptr);
    }
  }
  __device__ __forceinline__ void after(int, tc::Acc&, const bf16* Bs, int kk) {
    if constexpr (kDb) {
      if (blockIdx.x != 0 || threadIdx.x >= tc::kTcTile) return;
#pragma unroll
      for (int k = 0; k < 16; ++k) db += __bfloat162float(Bs[(kk + k) * tc::kTcLdW + threadIdx.x]);
    }
  }
};

// part[d][c] (E + H + kDb, 4H) float32 of chunk c of `chunk` pairs; grid
// (cdiv(E + H, 128), 4H / 128, D chunks). x is not read when E = 0 (K6).
template <bool kDb>
__global__ void __launch_bounds__(tc::kTcThreads, 2)
lstm_bwd_wgrad_mma(const bf16* __restrict__ x, const bf16* __restrict__ h_seq,
                   const bf16* __restrict__ dgates, float* __restrict__ part, int T, int D, int R,
                   int E, int H, int chunks, int chunk) {
  extern __shared__ float smem[];
  const int G = 4 * H, rows = E + H + (kDb ? 1 : 0);
  TcWgradOp<kDb> op;
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
  op.m0 = blockIdx.x * tc::kTcTile;
  op.n0 = blockIdx.y * tc::kTcTile;
  float acc[4][4][4] = {};
  tc::tc_gemm<true, true>(op, acc, cdiv(op.p1 - op.p0, 16), reinterpret_cast<bf16*>(smem));
  float* out = part + static_cast<size_t>(blockIdx.z) * rows * G;
  tc::tc_store<float>(acc, [&](int i) -> float* {
    return op.m0 + i < E + H ? out + static_cast<size_t>(op.m0 + i) * G : nullptr;
  }, op.n0, G);
  if (kDb && blockIdx.x == 0 && threadIdx.x < tc::kTcTile)
    out[static_cast<size_t>(E + H) * G + op.n0 + threadIdx.x] = op.db;
}

// ---------------------------------------------------------------------------
// K4-bf16's reverse scan

// g: the gates (T, D, R, 4H) in, dgates out, in place; w_hh (D, H, 4H)
// itself, the [n][k] operand of dh_rec = dgates w_hh^T. grid (cdiv(R,
// kRows), D), (kRows / kRt) (H / 8) threads, BwdPlanBf16's shared memory.
// Thread (ry, ux) owns rows ry kRt .. + kRt - 1 of the tile and units ux 4
// .. + 3 and H / 2 + that in the step's elementwise phase (the float32
// route's, bwd_cell_bf16), dc in its registers; warp w computes dh_rec of
// 8 kRt rows x 32 units on the tensor cores, k ascending over the 4H
// columns, rounded to bf16 into the shared dh_rec tile.
template <int kRows, int kRt, bool kResident>
__global__ void __launch_bounds__(kGemmThreads, 1)
lstm_bwd_rscan_mma(bf16* __restrict__ g, const bf16* __restrict__ w_hh,
                   const bf16* __restrict__ c_seq, const bf16* __restrict__ dh_seq, int T, int D,
                   int R, int H) {
  extern __shared__ float smem[];
  constexpr int kSub = 8 * kRt, kMt = kSub / 16, kLdc = kRscanChunkBf16 + kPadBf16;
  const int G = 4 * H, half = H / 2, tx = H / 8, ldg = G + kPadBf16, ldr = H + kPadBf16;
  bf16* ws = reinterpret_cast<bf16*>(smem);  // w_hh (H, ldg), or the ring (stages, H, kLdc)
  bf16* dgt = ws + (kResident ? static_cast<size_t>(H) * ldg
                              : static_cast<size_t>(kRscanRingBf16) * H * kLdc);  // (kRows, ldg)
  bf16* rec = dgt + static_cast<size_t>(kRows) * ldg;                               // (kRows, ldr)
  const int d = blockIdx.y, r0 = blockIdx.x * kRows;
  int ry, ux;
  scan_owner(tx, ry, ux);
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, wu = H / 32;
  const int pm = (w / wu) * kSub, pn = (w % wu) * 32;  // the warp's dh_rec rows and units
  const bf16* wd = w_hh + static_cast<size_t>(d) * H * G;
  const int per_step = G / kRscanChunkBf16, total = (T - 1) * per_step;
  // ring chunk s (columns (s % per_step) 32 .. + 31 of w_hh) into its
  // stage; one commit group each
  auto issue = [&](int s) {
    if (s < total) {
      const int n0 = (s % per_step) * kRscanChunkBf16;
      bf16* dst = ws + (s % kRscanRingBf16) * H * kLdc;
      for (int i = threadIdx.x; i < 4 * H; i += blockDim.x) {
        const int u = i >> 2, p = i & 3;
        tc::cp16(dst + u * kLdc + p * 8, wd + static_cast<size_t>(u) * G + n0 + p * 8, true);
      }
    }
    cp_async_commit();
  };
  if constexpr (kResident) {
    for (int i = threadIdx.x; i < H * G / 8; i += blockDim.x) {
      const int u = i / (G / 8), p = i % (G / 8);
      tc::cp16(ws + u * ldg + p * 8, wd + static_cast<size_t>(u) * G + p * 8, true);
    }
    cp_async_commit();
  } else {
    for (int s = 0; s < kRscanRingBf16 - 1; ++s) issue(s);
  }
  for (int i = threadIdx.x; i < kRows * ldr; i += blockDim.x) rec[i] = __float2bfloat16_rn(0.f);
  float dc[kRt][8];
#pragma unroll
  for (int i = 0; i < kRt; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dc[i][j] = 0.f;
  if constexpr (kResident) cp_async_wait<0>();
  __syncthreads();  // dh_rec zero; w_hh in (resident)
  int s = 0;        // ring chunks consumed
  // raw[q][i]: the four gates, c[t], c[t-1] and dh[t] of the thread's 4
  // units at u = q H / 2 + 4 ux of row ry kRt + i, bf16. A step's inputs
  // are all loaded together, and the next step's while this step's product
  // runs: none depends on the recurrence (the gates are overwritten in
  // place, step by step, only after they are loaded).
  uint2 raw[2][kRt][7];
  auto load_step = [&](int t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = q * half + ux * 4;
#pragma unroll
      for (int i = 0; i < kRt; ++i) {
        const int row = r0 + ry * kRt + i;
#pragma unroll
        for (int k = 0; k < 7; ++k) raw[q][i][k] = make_uint2(0u, 0u);
        if (row < R) {
          const size_t o = at(t, d, row, D, R);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            raw[q][i][k] = *reinterpret_cast<const uint2*>(g + o * G + k * H + u);
          raw[q][i][4] = __ldg(reinterpret_cast<const uint2*>(c_seq + o * H + u));
          if (t > 0)
            raw[q][i][5] = __ldg(reinterpret_cast<const uint2*>(
                c_seq + (o - static_cast<size_t>(D) * R) * H + u));
          raw[q][i][6] = __ldg(reinterpret_cast<const uint2*>(dh_seq + o * H + u));
        }
      }
    }
  };
  load_step(T - 1);
  for (int t = T - 1; t >= 0; --t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = q * half + ux * 4;
#pragma unroll
      for (int i = 0; i < kRt; ++i) {
        const int tr = ry * kRt + i, row = r0 + tr;
        const bool live = row < R;
        const size_t o = live ? at(t, d, row, D, R) : 0;
        float4 v[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          const float2 a = unpack2(raw[q][i][k].x), b = unpack2(raw[q][i][k].y);
          v[k] = make_float4(a.x, a.y, b.x, b.y);
        }
        const float4 rv = lds4(rec + tr * ldr + u);
        float dg[4][4];  // [gate][unit]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float z[4] = {lane(v[0], j), lane(v[1], j), lane(v[2], j), lane(v[3], j)};
          float dgj[4];
          bwd_cell_bf16(z, lane(v[4], j), lane(v[5], j), lane(v[6], j), lane(rv, j),
                        dc[i][4 * q + j], dgj);
#pragma unroll
          for (int k = 0; k < 4; ++k) dg[k][j] = live ? dgj[k] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (live) st4(g + o * G + k * H + u, dg[k][0], dg[k][1], dg[k][2], dg[k][3]);
          st4(dgt + tr * ldg + k * H + u, dg[k][0], dg[k][1], dg[k][2], dg[k][3]);
        }
      }
    }
    if (t == 0) break;
    load_step(t - 1);
    __syncthreads();  // dgates[t] whole in dgt; every thread done reading dh_rec
    float acc[kMt][4][4];
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    // the k16 step at column k of dgt against w_hh's columns there (wb, ld)
    auto k16 = [&](const bf16* wb, int ld, int kb, int k) {
      unsigned b[2][4];
      tc::frag_b(b[0], wb, ld, pn, kb);
      tc::frag_b(b[1], wb, ld, pn + 16, kb);
#pragma unroll
      for (int mi = 0; mi < kMt; ++mi) {
        unsigned a[4];
        tc::frag_a(a, dgt, ldg, pm + mi * 16, k);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::mma(acc[mi][ni], a, b[ni / 2][(ni % 2) * 2], b[ni / 2][(ni % 2) * 2 + 1]);
      }
    };
    if constexpr (kResident) {
      for (int k = 0; k < G; k += 16) k16(ws, ldg, k, k);
    } else {
      for (int cc = 0; cc < per_step; ++cc, ++s) {
        cp_async_wait<kRscanRingBf16 - 2>();
        __syncthreads();  // chunk s in; every thread done with chunk s - 1
        issue(s + kRscanRingBf16 - 1);
        const bf16* wc = ws + (s % kRscanRingBf16) * H * kLdc;
        k16(wc, kLdc, 0, cc * kRscanChunkBf16);
        k16(wc, kLdc, 16, cc * kRscanChunkBf16 + 16);
      }
    }
    // dh_rec of step t - 1, rounded to bf16
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = pm + mi * 16 + l / 4 + 8 * h;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tc::st2(rec + row * ldr + pn + ni * 8 + 2 * (l % 4), acc[mi][ni][2 * h],
                  acc[mi][ni][2 * h + 1]);
      }
    __syncthreads();  // dh_rec whole; every thread done reading dgt
  }
}

// ---------------------------------------------------------------------------
// launches

int set_tc_smem(const void* kernel) { return set_smem(kernel, tc::kTcSmem); }

template <bool kKeep>
int launch_fwd_mma(const FwdPlanBf16& P, const bf16* x, const bf16* w_ih, const bf16* bias,
                   const bf16* w_hh, bf16* h_seq, bf16* c_seq, bf16* gates, int T, int D, int R,
                   int E, int H, cudaStream_t s) {
  const auto kernel = P.rows == 64  ? lstm_fwd_ring_mma<64, true, kKeep>
                      : P.resident ? lstm_fwd_ring_mma<32, true, kKeep>
                                   : lstm_fwd_ring_mma<32, false, kKeep>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), P.smem);
  if (err) return err;
  kernel<<<dim3(P.tiles, D), P.threads, P.smem, s>>>(x, w_ih, bias, w_hh, h_seq, c_seq, gates, T,
                                                     D, R, E, H);
  return last_error();
}

int launch_gates_mma(const bf16* x, const bf16* w_ih, const bf16* bias, const bf16* w_hh,
                     const bf16* h_seq, bf16* pre, int T, int D, int R, int E, int H,
                     cudaStream_t s) {
  const int err = set_tc_smem(reinterpret_cast<const void*>(lstm_bwd_gates_mma));
  if (err) return err;
  lstm_bwd_gates_mma<<<dim3(cdiv(T * R, tc::kTcTile) * (4 * H / tc::kTcTile), 1, D),
                       tc::kTcThreads, tc::kTcSmem, s>>>(x, w_ih, bias, w_hh, h_seq, pre, T, D, R,
                                                         E, H);
  return last_error();
}

int launch_rscan_mma(const BwdPlanBf16& P, bf16* g, const bf16* w_hh, const bf16* c_seq,
                     const bf16* dh_seq, int T, int D, int R, int H, cudaStream_t s) {
  // the plan's tiles: 64 rows (4 a thread) only at H <= 128, 32 rows of 2
  // a thread at H <= 128, else 4
  const auto kernel = P.rows == 64        ? lstm_bwd_rscan_mma<64, 4, true>
                      : H > kResidentMax ? lstm_bwd_rscan_mma<32, 4, false>
                                         : lstm_bwd_rscan_mma<32, 2, true>;
  const int err = set_smem(reinterpret_cast<const void*>(kernel), P.smem);
  if (err) return err;
  kernel<<<dim3(P.tiles, D), P.threads, P.smem, s>>>(g, w_hh, c_seq, dh_seq, T, D, R, H);
  return last_error();
}

// dW (and, with kDb, db) from dgates by the weight GEMM and its sums
template <bool kDb>
int weight_grads_mma(const bf16* x, const bf16* h_seq, const bf16* dgates, float* part, float* dw,
                     float* db, const WgSplit& wg, int T, int D, int R, int E, int H,
                     cudaStream_t s) {
  const auto kernel = lstm_bwd_wgrad_mma<kDb>;
  int err = set_tc_smem(reinterpret_cast<const void*>(kernel));
  if (err) return err;
  kernel<<<dim3(cdiv(E + H, tc::kTcTile), 4 * H / tc::kTcTile, D * wg.chunks), tc::kTcThreads,
           tc::kTcSmem, s>>>(x, h_seq, dgates, part, T, D, R, E, H, wg.chunks, wg.chunk);
  if ((err = last_error())) return err;
  return sum_weight_partials<kDb>(part, dw, db, wg, D, E, H, s);
}

}  // namespace

namespace lstm_bf16 {

using B = simt::bf16;

int fwd(bool keep_gates, const void* x, const void* w_ih, const void* bias, const void* w_hh,
        void* h_seq, void* c_seq, void* gates, int T, int D, int R, int E, int H, cudaStream_t s) {
  if (!shape_ok_bf16(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlanBf16 P(D, R, H);
  if (keep_gates)
    return launch_fwd_mma<true>(P, in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh),
                                out<B>(h_seq), out<B>(c_seq), out<B>(gates), T, D, R, E, H, s);
  return launch_fwd_mma<false>(P, in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), out<B>(h_seq),
                               out<B>(c_seq), static_cast<B*>(nullptr), T, D, R, E, H, s);
}

int bwd_gates(const void* x, const void* w_ih, const void* bias, const void* w_hh,
              const void* h_seq, void* gates, int T, int D, int R, int E, int H, cudaStream_t s) {
  if (!shape_ok_bf16(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gates_mma(in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), in<B>(h_seq),
                          out<B>(gates), T, D, R, E, H, s);
}

// K4-bf16: w_ih_t and w_hh_t are not read (w_ih and w_hh serve as the
// [n][k] operands)
int bwd(const void* x, const void* w_ih, const void*, const void* bias, const void* w_hh,
        const void*, const void* h_seq, const void* c_seq, const void* dh_seq, void* dx,
        float* dw, float* db, float* work, int T, int D, int R, int E, int H, cudaStream_t s) {
  if (!shape_ok_bf16(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlanBf16 P(T, D, R, E, H);
  const Layout L(T, D, R, E, H, P.wg);
  B* g = reinterpret_cast<B*>(work + L.dgates);
  int err = launch_gates_mma(in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), in<B>(h_seq), g, T,
                             D, R, E, H, s);
  if (err || (err = launch_rscan_mma(P, g, in<B>(w_hh), in<B>(c_seq), in<B>(dh_seq), T, D, R, H,
                                     s)))
    return err;
  if ((err = set_tc_smem(reinterpret_cast<const void*>(lstm_bwd_dx_mma)))) return err;
  lstm_bwd_dx_mma<<<dim3(cdiv(T * R, tc::kTcTile), cdiv(E, tc::kTcTile), D), tc::kTcThreads,
                    tc::kTcSmem, s>>>(g, in<B>(w_ih), out<B>(dx), T, D, R, E, H);
  if ((err = last_error())) return err;
  return weight_grads_mma<true>(in<B>(x), in<B>(h_seq), g, work + L.wg_part, dw, db, P.wg, T, D,
                                R, E, H, s);
}

int scan_fwd(const void* gates_x, const void* w_hh, void* h_seq, void* c_seq, int T, int D, int R,
             int H, cudaStream_t s) {
  return scan_fwd_cluster(in<B>(gates_x), in<B>(w_hh), out<B>(h_seq), out<B>(c_seq), T, D, R, H,
                          s);
}

// K6-bf16: the cluster scan, then the weight gradient on the tensor cores
int scan_bwd(const void* gates_x, const void* w_hh, const void* h_seq, const void* c_seq,
             const void* dh_seq, void* dgates, float* dw_hh, float* work, int T, int D, int R,
             int H, cudaStream_t s) {
  const WgSplit wg(T * R, wgrad_tiles(0, H, D));
  const Layout L(T, D, R, 0, H, wg);
  const int err = scan_bwd_cluster(in<B>(gates_x), in<B>(w_hh), in<B>(h_seq), in<B>(c_seq),
                                   in<B>(dh_seq), out<B>(dgates), T, D, R, H, s);
  if (err) return err;
  return weight_grads_mma<false>(static_cast<const B*>(nullptr), in<B>(h_seq),
                                 out<B>(dgates), work + L.wg_part, dw_hh, nullptr, wg, T, D, R,
                                 0, H, s);
}

}  // namespace lstm_bf16

extern "C" {

// K3-bf16's plan at a shape, as lstm_fwd_plan gives K3's
int lstm_fwd_plan_bf16(int T, int D, int R, int E, int H, int* info) {
  if (!shape_ok_bf16(E, H) || T < 1 || D < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlanBf16 P(D, R, H);
  const int out[5] = {P.rows, P.slice, P.threads, P.tiles, P.smem};
  for (int i = 0; i < 5; ++i) info[i] = out[i];
  return 0;
}

// K4-bf16's plan at a shape, as lstm_bwd_plan gives K4's
int lstm_bwd_plan_bf16(int T, int D, int R, int E, int H, int* info) {
  if (!shape_ok_bf16(E, H) || T < 1 || D < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlanBf16 P(T, D, R, E, H);
  const int out[7] = {P.rows, P.rt, P.threads, P.tiles, P.smem, P.wg.chunks, P.wg.chunk};
  for (int i = 0; i < 7; ++i) info[i] = out[i];
  return 0;
}

}  // extern "C"
