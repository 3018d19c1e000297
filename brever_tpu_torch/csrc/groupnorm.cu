// GroupNorm with an optional SiLU or ReLU (flash-GN), forward (K7) and
// backward (K8), for NVIDIA Hopper, float32.
//
// Replaces the Pallas TPU kernels brever_tpu/ops/pallas/groupnorm.py
// _fwd_kernel (launched by _fwd_pallas) and _bwd_kernel (launched by
// _bwd_pallas). Over x (B, C, N), channels first and contiguous, with G groups
// of C/G channels, so that group g of batch row b is one contiguous slab of
// (C/G) N floats:
//
//   mean, rstd per (b, g):  var = E[x^2] - mean^2,  rstd = 1 / sqrt(var + eps)
//                           (the fast-variance form, no clamp, as the Pallas
//                           kernel and nn.GroupNorm have it)
//   y = act(x a + b),  a = scale[c] rstd,  b = bias[c] - mean a
//                           (act: none, SiLU or ReLU)
//
// and back, with z = x a + b, dz = dy act'(z), xhat = (x - mean) rstd and
// n = (C/G) N:
//
//   dscale[c] = sum_{b, i} dz xhat,    dbias[c] = sum_{b, i} dz
//   m1 = sum_{c in g} scale[c] sum_i dz / n,  m2 = sum_{c in g} scale[c]
//        sum_i dz xhat / n                                     per (b, g)
//   dx = rstd (dz scale[c] - m1 - xhat m2)
//
// Bound: bytes. The forward reads x once and writes y once, 8 bytes an
// element; the backward reads x and dy once and writes dx once, 12 bytes an
// element (scale, bias, the statistics and the affine's gradients are a few
// KB). At the NCSN++ U-Net's width one evaluation at 4 x 4 s sends 1.567 G
// elements through its 109 GroupNorms: 3.74 ms forward and 5.61 ms backward
// at 3.35 TB/s. A few flops an element (one exp for SiLU) are far below the
// card's rate.
//
// Design (gn_fwd_cluster, gn_bwd_cluster). The Pallas kernel walks (b,
// phase, chunk) in order and keeps its sums in VMEM, so it reads x twice. A
// group's statistics come before its first output, so here the group's slab
// of x stays on chip across that barrier:
//
// * A thread-block cluster of n blocks (n in 1, 2, 4, 8, 16) takes one (b,
//   g) group at a time. The slab is cut into tasks of up to kTask floats of
//   one row (channel), each taken by one warp; block r of the cluster takes
//   tasks [r T / n, (r + 1) T / n) of the group's T, a contiguous share of
//   the slab. The plan (gn_plan, mirrored by ops/groupnorm.py; one plan for
//   K7 and K8) takes the smallest n whose widest share fits a block's shared
//   memory (kSmemMost less kScratch; one block an SM), at most kMostCluster
//   (16, a non-portable size). The wrapper launches as many clusters as
//   cudaOccupancyMaxActiveClusters says the card holds at once of both
//   kernels (stepping n down where it holds none), at most one a group, and
//   each walks the groups that many apart.
// * A warp copies its tasks' held floats of x into shared memory with TMA
//   bulk copies (cp.async.bulk) that complete on its own mbarrier, and
//   copies a task of its next group over one of this group as soon as its
//   lanes have written that task's outputs: the next group's reads overlap
//   this group's writes. Where a share is wider than a block can hold (the
//   U-Net's (4, 256, 256, 501): 3.91 MiB a group, 16 x 225 KB held), the
//   first part is held and the rest is read from device memory in both
//   passes, the second time mostly from L2. Unaligned tensors and N off the
//   float4 grid take 4-byte loads (kVec = false); their first pass stores
//   what it reads where held. What a lane reads from device memory or L2 it
//   reads four float4s of a tensor at a time, all four before it uses the
//   first (in named registers: an array of them spilled), so that the loads
//   stream.
// * K7, one launch: each block's (sum x, sum x^2) in double (a lane's four
//   floats summed in float, then lanes, warps and the block in a fixed
//   order); the n block sums are read over DSMEM after a cluster barrier
//   and summed in rank order, so every block holds the same mean and rstd
//   bits (rank 0 writes them); then y = act(x a + b) from shared memory,
//   written once.
// * K8, two launches: gn_bwd_cluster holds x as K7 does and reads dy from
//   device memory; it forms each task's (sum dz, sum dz xhat) in double as
//   one warp and writes them to `work`; after a cluster barrier
//   (release/acquire at cluster scope) every block sums each row's tasks
//   and the group's m1 and m2 in row order from L2, then writes dx from the
//   held x and dy read again (from L2: the cluster read it a pass before),
//   with dz recomputed by the first pass's expression; rank 0 writes each
//   (b, c) row's two sums. gn_bwd_channels sums dscale and dbias over the
//   batch in order. Holding dy as well would halve the x a block holds,
//   double the cluster and halve the clusters in flight; measured on an
//   H100, that design was slower than split passes through device memory
//   wherever clusters of 16 ran (PERF.md).

// flash-BN, forward (K7-BN) and backward (K8-BN), replaces the same Pallas
// kernels as gn_act_stats_pallas launches them for a BatchNorm (num_groups =
// C over a (1, N, C) view). Here the statistics of channel c span all B rows
// of x (B, C, N): the (b, c) slabs are B contiguous runs of N floats, so
// passes split at the merges that span the batch rows serve, with no copy to
// (C, B N):
//
//   mean, var, rstd per c over the B N elements of the channel
//   y = act(x a + b),  a = scale[c] rstd,  b = bias[c] - mean a
//   m1 = scale[c] sum_{b, i} dz / (B N),  m2 = scale[c] sum_{b, i} dz xhat
//        / (B N),  dscale[c] and dbias[c] the same sums
//   dx = rstd (dz scale[c] - m1 - xhat m2)
//
// A task there is one segment of up to kSeg elements of one (b, c) row,
// taken by one warp, kWarps tasks a block. bn_fwd: gn_stats (each task's
// (sum x, sum x^2) in double), bn_merge (one warp a channel, B x segs
// partials in order, writes mean, var and rstd and the folded affine of
// every (b, c) row), gn_apply. bn_bwd: gn_bwd_partials with the channel's
// statistics, bn_bwd_channels (one warp a channel: dscale, dbias and m1, m2
// from B x segs partials in order), gn_bwd_dx. No channel cap and no byte
// floor (the Pallas path's are Mosaic's). Bound: bytes, as K7/K8's.
//
// Loads and stores are 16 bytes a lane where N is a multiple of 4 and the
// tensors are 16-byte aligned (every shape of the U-Net), else 4. No float
// atomics: two runs give bitwise-equal outputs and gradients. The
// statistics and every reduction are summed in double. Every pointer is a
// dense float32 buffer; K8's `work` is gn_bwd_workspace(B, C, N, G) bytes,
// the flash-BN passes' bn_workspace(B, C, N).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kWarps = 8;               // tasks (warps) of a flash-BN block
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 4096;              // elements of a row one task takes
constexpr unsigned kFull = 0xffffffffu;
// K7/K8's cluster blocks
constexpr int kGnThreads = 512;         // threads of a cluster block
constexpr int kTask = 1024;             // floats of a row one warp takes
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kSmemMost = 232448;       // shared memory a block may have
constexpr int kScratch = 2048;          // bytes of it ahead of the slabs
constexpr int kMostCluster = 16;        // blocks of the largest cluster
constexpr int kRowChunk = 64;           // row sums K8 gathers at once

enum Act { kNone = 0, kSilu = 1, kRelu = 2 };

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ double warp_sum(double v) {
  // a fixed tree: the result (in lane 0) has the same bits on every run
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The folded affine of one channel; the forward and the backward compute it
// with the same rounding, so both see the same z.
__device__ __forceinline__ float2 fold(float scale, float bias, float mean,
                                       float rstd) {
  const float a = __fmul_rn(scale, rstd);
  return make_float2(a, __fsub_rn(bias, __fmul_rn(mean, a)));
}

__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == kSilu) return z / (1.f + expf(-z));
  if (act == kRelu) return fmaxf(z, 0.f);
  return z;
}

// dy act'(z)
__device__ __forceinline__ float act_bwd(float z, float dy, int act) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-z));
    return dy * (s * (1.f + z * (1.f - s)));
  }
  if (act == kRelu) return z > 0.f ? dy : 0.f;
  return dy;
}

template <bool kVec>
__device__ __forceinline__ void load(const float* p, long long i,
                                     float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = p[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store(float* p, long long i,
                                      const float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[i] = v[0];
  }
}

// The task of this warp: its row, and the segment [start, start + len).
struct Task {
  long long row, start;
  int len;
};

__device__ __forceinline__ bool my_task(int N, int segs, long long tasks,
                                        Task& t) {
  const long long task = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);
  if (task >= tasks) return false;
  t.row = task / segs;
  const int seg = static_cast<int>(task - t.row * segs);
  t.start = t.row * N + static_cast<long long>(seg) * kSeg;
  t.len = min(kSeg, N - seg * kSeg);
  return true;
}

// ---------------------------------------------------------------------------
// K7-BN's passes

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_stats(const float* __restrict__ x, int N, int segs, long long tasks,
         double2* __restrict__ part) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31;
  double s = 0.0, q = 0.0;
  for (int j = lane * kW; j < t.len; j += 32 * kW) {
    float v[kW];
    load<kVec>(x, t.start + j, v);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      s += v[k];
      q += static_cast<double>(v[k]) * v[k];
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) part[blockIdx.x * kWarps + (threadIdx.x >> 5)] =
      make_double2(s, q);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_apply(const float* __restrict__ x, const float2* __restrict__ coef,
         int N, int segs, long long tasks, int act, float* __restrict__ y) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const float2 ab = coef[t.row];
  for (int j = (threadIdx.x & 31) * kW; j < t.len; j += 32 * kW) {
    float v[kW];
    load<kVec>(x, t.start + j, v);
#pragma unroll
    for (int k = 0; k < kW; ++k) v[k] = act_fwd(__fmaf_rn(v[k], ab.x, ab.y),
                                                act);
    store<kVec>(y, t.start + j, v);
  }
}

// ---------------------------------------------------------------------------
// K8-BN's passes, and K8's second launch (gn_bwd_channels)

// The per-row constants of the backward: the folded affine, mean, rstd and
// scale of the row's channel.
struct RowConst {
  float2 ab;
  float mean, rstd, scale;
};

// The constants of a row of x (B, C, N), whose statistics are its
// channel's.
__device__ __forceinline__ RowConst row_const(
    long long row, int C, const float* scale, const float* bias,
    const float* mean, const float* rstd) {
  const int c = static_cast<int>(row % C);
  RowConst k;
  k.mean = mean[c];
  k.rstd = rstd[c];
  k.scale = scale[c];
  k.ab = fold(k.scale, bias[c], k.mean, k.rstd);
  return k;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partials(const float* __restrict__ x, const float* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, int C, int N,
                int segs, long long tasks, int act,
                double2* __restrict__ part) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const RowConst k = row_const(t.row, C, scale, bias, mean, rstd);
  double s1 = 0.0, s2 = 0.0;
  for (int j = lane * kW; j < t.len; j += 32 * kW) {
    float v[kW], d[kW];
    load<kVec>(x, t.start + j, v);
    load<kVec>(dy, t.start + j, d);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float dz = act_bwd(__fmaf_rn(v[i], k.ab.x, k.ab.y), d[i], act);
      const float xhat = __fmul_rn(__fsub_rn(v[i], k.mean), k.rstd);
      s1 += dz;
      s2 += static_cast<double>(dz) * xhat;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) part[blockIdx.x * kWarps + (threadIdx.x >> 5)] =
      make_double2(s1, s2);
}

// One thread a channel: dscale and dbias summed over the batch in order.
__global__ void __launch_bounds__(kThreads)
gn_bwd_channels(const double2* __restrict__ rowsum, int B, int C,
                float* __restrict__ dscale, float* __restrict__ dbias) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  double s1 = 0.0, s2 = 0.0;
  for (int b = 0; b < B; ++b) {
    const double2 r = rowsum[static_cast<long long>(b) * C + c];
    s1 += r.x;
    s2 += r.y;
  }
  dbias[c] = static_cast<float>(s1);
  dscale[c] = static_cast<float>(s2);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ scale, const float* __restrict__ bias,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float2* __restrict__ m, int C, int N, int segs,
          long long tasks, int act, float* __restrict__ dx) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const RowConst k = row_const(t.row, C, scale, bias, mean, rstd);
  const float2 mg = m[t.row % C];
  for (int j = (threadIdx.x & 31) * kW; j < t.len; j += 32 * kW) {
    float v[kW], d[kW];
    load<kVec>(x, t.start + j, v);
    load<kVec>(dy, t.start + j, d);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float dz = act_bwd(__fmaf_rn(v[i], k.ab.x, k.ab.y), d[i], act);
      const float xhat = __fmul_rn(__fsub_rn(v[i], k.mean), k.rstd);
      v[i] = k.rstd * (dz * k.scale - mg.x - xhat * mg.y);
    }
    store<kVec>(dx, t.start + j, v);
  }
}

// ---------------------------------------------------------------------------
// K7-BN and K8-BN's merges

// One warp a channel c: the partials of its B rows, row by row and segment
// by segment in a fixed order; the channel's mean, var and rstd, and the
// folded affine of each of its B rows.
__global__ void __launch_bounds__(kThreads)
bn_merge(const double2* __restrict__ part, const float* __restrict__ scale,
         const float* __restrict__ bias, int B, int C, int segs, double n,
         float eps, float* __restrict__ mean, float* __restrict__ var,
         float* __restrict__ rstd, float2* __restrict__ coef) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  double s = 0.0, q = 0.0;
  for (int b = 0; b < B; ++b) {
    const double2* row = part + (static_cast<long long>(b) * C + c) * segs;
    for (int i = lane; i < segs; i += 32) {
      s += row[i].x;
      q += row[i].y;
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  float m = 0.f, r = 0.f;
  if (lane == 0) {
    const double md = s / n, vd = q / n - md * md;
    m = static_cast<float>(md);
    r = static_cast<float>(1.0 / sqrt(vd + eps));
    mean[c] = m;
    var[c] = static_cast<float>(vd);
    rstd[c] = r;
  }
  m = __shfl_sync(kFull, m, 0);
  r = __shfl_sync(kFull, r, 0);
  const float2 ab = fold(scale[c], bias[c], m, r);
  for (int b = lane; b < B; b += 32) coef[static_cast<long long>(b) * C + c] =
      ab;
}

// One warp a channel c: sum dz and sum dz xhat over its B rows in a fixed
// order, as dbias and dscale, and m1, m2 for dx.
__global__ void __launch_bounds__(kThreads)
bn_bwd_channels(const double2* __restrict__ part,
                const float* __restrict__ scale, int B, int C, int segs,
                double n, float* __restrict__ dscale,
                float* __restrict__ dbias, float2* __restrict__ m) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  double s1 = 0.0, s2 = 0.0;
  for (int b = 0; b < B; ++b) {
    const double2* row = part + (static_cast<long long>(b) * C + c) * segs;
    for (int i = lane; i < segs; i += 32) {
      s1 += row[i].x;
      s2 += row[i].y;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    dbias[c] = static_cast<float>(s1);
    dscale[c] = static_cast<float>(s2);
    const double sc = scale[c];
    m[c] = make_float2(static_cast<float>(sc * s1 / n),
                       static_cast<float>(sc * s2 / n));
  }
}

// ---------------------------------------------------------------------------
// K7 and K8's first launch: thread-block clusters that walk the (b, g)
// groups, one group at a time

namespace cg = cooperative_groups;

// The scratch ahead of a cluster block's slabs in its dynamic shared memory.
struct Scratch {
  unsigned long long bar[kGnWarps];  // each warp's bulk copies of a group
  double2 warp[kGnWarps];            // K7: each warp's (sum x, sum x^2)
  double2 block[2];                  // K7: the block's, read over DSMEM, by
                                     // the parity of the block's group
  float2 stat;                       // K7: (mean, rstd); K8: (m1, m2)
  double2 rows[kRowChunk];           // K8: a chunk of the group's row sums,
                                     // times the rows' scale
};
static_assert(sizeof(Scratch) <= kScratch, "kScratch too small");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(1u)
               : "memory");
}

// The thread's arrival, expecting `bytes` from the bulk copies that follow.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The first float of task t (row t / segs, segment t % segs) in its slab;
// task T starts past the slab's end.
__host__ __device__ __forceinline__ long long task_start(long long t, int N,
                                                         int segs) {
  return t / segs * N + t % segs * kTask;
}

// This block's share of every group (`chans` rows of N floats): tasks [t0,
// t1), floats [p0, p0 + len) of the slab, `held` of them in shared memory.
// The cluster (rank `rank` of n) walks groups grp0, grp0 + step, ...
struct Share {
  long long t0, t1, p0, len;
  long long grp0, step;
  int held, chans, n, rank;
};

__device__ __forceinline__ Share my_share(int C, int G, int N, int segs,
                                          int res) {
  cg::cluster_group cluster = cg::this_cluster();
  Share s;
  s.n = static_cast<int>(cluster.num_blocks());
  s.rank = static_cast<int>(cluster.block_rank());
  s.grp0 = blockIdx.x / s.n;
  s.step = gridDim.x / s.n;
  s.chans = C / G;
  const long long T = static_cast<long long>(s.chans) * segs;
  s.t0 = s.rank * T / s.n;
  s.t1 = (s.rank + 1) * T / s.n;
  s.p0 = task_start(s.t0, N, segs);
  s.len = task_start(s.t1, N, segs) - s.p0;
  s.held = static_cast<int>(s.len < res ? s.len : res);
  return s;
}

// One task of this block: row k of the group, floats [off, off + len) of
// the share.
struct Piece {
  int k, len;
  long long off;
};

__device__ __forceinline__ Piece piece(const Share& s, long long t, int N,
                                       int segs) {
  Piece p;
  p.k = static_cast<int>(t / segs);
  const int seg = static_cast<int>(t - static_cast<long long>(p.k) * segs);
  p.off = task_start(t, N, segs) - s.p0;
  p.len = min(kTask, N - seg * kTask);
  return p;
}

// Lane 0 of a warp sets its mbarrier to expect the held part of the warp's
// tasks of a group.
__device__ __forceinline__ void expect(const Share& s, int N, int segs,
                                       unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned bytes = 0;
  for (long long t = s.t0 + (threadIdx.x >> 5); t < s.t1; t += kGnWarps) {
    const Piece p = piece(s, t, N, segs);
    if (p.off < s.held)
      bytes += 4u * static_cast<unsigned>(min(
          static_cast<long long>(p.len), s.held - p.off));
  }
  mbar_expect(bar, bytes);
}

// Lane 0 copies the held part of one task of a group (of `a`, at the
// share's first float, to sa) with a bulk copy completing on the warp's
// mbarrier. A warp owns its tasks' shared memory in every pass, so it
// copies a task of the next group over one of this group as soon as its
// lanes are done with it.
__device__ __forceinline__ void copy_task(const Share& s, const Piece& p,
                                          const float* a, float* sa,
                                          unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0 || p.off >= s.held) return;
  // the lanes' reads of these floats (generic proxy) come before the
  // copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const unsigned n = 4u * static_cast<unsigned>(min(
      static_cast<long long>(p.len), s.held - p.off));
  bulk_load(sa + p.off, a + p.off, n, bar);
}

// With kVec thread 0 sets up one mbarrier a warp, and each warp copies its
// share of the block's first group.
template <bool kVec>
__device__ __forceinline__ void start(const Share& s, int N, int segs,
                                      const float* a, float* sa,
                                      Scratch& sc) {
  if constexpr (kVec) {
    if (threadIdx.x == 0) {
      for (int w = 0; w < kGnWarps; ++w) mbar_init(&sc.bar[w]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    unsigned long long* bar = &sc.bar[threadIdx.x >> 5];
    expect(s, N, segs, bar);
    for (long long t = s.t0 + (threadIdx.x >> 5); t < s.t1; t += kGnWarps)
      copy_task(s, piece(s, t, N, segs), a, sa, bar);
  }
}

// Float i of the share of a group: from shared memory where held (with
// kVec: copied there by bulk copies, which the warp has waited for), else
// from `g` (the share in device memory).
template <bool kVec>
__device__ __forceinline__ void fetch(const float* s, const float* g,
                                      int held, long long i,
                                      float (&v)[kVec ? 4 : 1]) {
  if (i < held) {
    load<kVec>(s, i, v);
  } else {
    load<kVec>(g, i, v);
  }
}

// Float i of the share in a group's first pass: with kVec as fetch (the
// warp has waited for its bulk copies), else from device memory (the pass
// stores what it reads where held, for the second).
template <bool kVec>
__device__ __forceinline__ void fetch_first(const float* s, const float* g,
                                            int held, long long i,
                                            float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    fetch<kVec>(s, g, held, i, v);
  } else {
    load<kVec>(g, i, v);
  }
}

// A lane's float4s that come from device memory are read four at a time,
// all four before the first is used (named registers, so that the loads
// stay in flight together).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// K7's sums of one float4, as its loop forms them
__device__ __forceinline__ void add_stats(float4 v, double& sum, double& sq) {
  float a = v.x, q = __fmul_rn(v.x, v.x);
  a = __fadd_rn(a, v.y);
  q = __fmaf_rn(v.y, v.y, q);
  a = __fadd_rn(a, v.z);
  q = __fmaf_rn(v.z, v.z, q);
  a = __fadd_rn(a, v.w);
  q = __fmaf_rn(v.w, v.w, q);
  sum += a;
  sq += q;
}

__device__ __forceinline__ float4 apply4(float4 v, float2 ab, int act) {
  return make_float4(act_fwd(__fmaf_rn(v.x, ab.x, ab.y), act),
                     act_fwd(__fmaf_rn(v.y, ab.x, ab.y), act),
                     act_fwd(__fmaf_rn(v.z, ab.x, ab.y), act),
                     act_fwd(__fmaf_rn(v.w, ab.x, ab.y), act));
}

// K8's sums of one float4 of x and of dy, as its loop forms them
__device__ __forceinline__ void add_grad1(float x, float d, float2 ab,
                                          float mu, float rs, int act,
                                          float& a, float& q) {
  const float dz = act_bwd(__fmaf_rn(x, ab.x, ab.y), d, act);
  a = __fadd_rn(a, dz);
  q = __fmaf_rn(dz, __fmul_rn(__fsub_rn(x, mu), rs), q);
}

__device__ __forceinline__ void add_grads(float4 x, float4 d, float2 ab,
                                          float mu, float rs, int act,
                                          double& s1, double& s2) {
  float a = 0.f, q = 0.f;
  add_grad1(x.x, d.x, ab, mu, rs, act, a, q);
  add_grad1(x.y, d.y, ab, mu, rs, act, a, q);
  add_grad1(x.z, d.z, ab, mu, rs, act, a, q);
  add_grad1(x.w, d.w, ab, mu, rs, act, a, q);
  s1 += a;
  s2 += q;
}

__device__ __forceinline__ float dx1(float x, float d, float2 ab, float mu,
                                     float rs, float w, float2 mg, int act) {
  const float dz = act_bwd(__fmaf_rn(x, ab.x, ab.y), d, act);
  const float xhat = __fmul_rn(__fsub_rn(x, mu), rs);
  return rs * (dz * w - mg.x - xhat * mg.y);
}

__device__ __forceinline__ float4 dx4(float4 x, float4 d, float2 ab, float mu,
                                      float rs, float w, float2 mg, int act) {
  return make_float4(dx1(x.x, d.x, ab, mu, rs, w, mg, act),
                     dx1(x.y, d.y, ab, mu, rs, w, mg, act),
                     dx1(x.z, d.z, ab, mu, rs, w, mg, act),
                     dx1(x.w, d.w, ab, mu, rs, w, mg, act));
}

// K7. B G groups, each taken by one cluster of n blocks; grid: up to B G
// clusters (as many as the card holds at once), kGnThreads threads,
// kScratch + 4 res bytes of dynamic shared memory (res: floats a block
// holds).
template <bool kVec>
__global__ void __launch_bounds__(kGnThreads, 1)
gn_fwd_cluster(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, int B, int C, int G, int N,
               int segs, int res, float eps, int act, float* __restrict__ y,
               float* __restrict__ mean, float* __restrict__ rstd) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  float* sx = reinterpret_cast<float*>(smem + kScratch);
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Share s = my_share(C, G, N, segs, res);
  const long long slab = static_cast<long long>(s.chans) * N;
  const long long groups = static_cast<long long>(B) * G;
  start<kVec>(s, N, segs, x + s.grp0 * slab + s.p0, sx, sc);
  unsigned parity = 0;
  for (long long grp = s.grp0; grp < groups; grp += s.step, parity ^= 1) {
    const float* xs = x + grp * slab + s.p0;
    if constexpr (kVec) mbar_wait(&sc.bar[warp], parity);
    double sum = 0.0, sq = 0.0;
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece(s, t, N, segs);
      if (kVec && p.off >= s.held) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const float* g = xs + p.off + j;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 v0 = ld4(g), v1 = h1 ? ld4(g + 128) : v0,
                       v2 = h2 ? ld4(g + 256) : v0,
                       v3 = h3 ? ld4(g + 384) : v0;
          add_stats(v0, sum, sq);
          if (h1) add_stats(v1, sum, sq);
          if (h2) add_stats(v2, sum, sq);
          if (h3) add_stats(v3, sum, sq);
        }
        continue;
      }
#pragma unroll 4
      for (int j = lane * kW; j < p.len; j += 32 * kW) {
        float v[kW];
        fetch_first<kVec>(sx, xs, s.held, p.off + j, v);
        if (!kVec && p.off + j < s.held) store<kVec>(sx, p.off + j, v);
        // a lane's kW floats in float, then into the double sums: two
        // conversions to double (a quarter-rate instruction) per kW floats
        float a = v[0], q = __fmul_rn(v[0], v[0]);
#pragma unroll
        for (int i = 1; i < kW; ++i) {
          a = __fadd_rn(a, v[i]);
          q = __fmaf_rn(v[i], v[i], q);
        }
        sum += a;
        sq += q;
      }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if (lane == 0) sc.warp[warp] = make_double2(sum, sq);
    __syncthreads();
    if (warp == 0) {
      double2 w = lane < kGnWarps ? sc.warp[lane] : make_double2(0.0, 0.0);
      w.x = warp_sum(w.x);
      w.y = warp_sum(w.y);
      if (lane == 0) sc.block[parity] = w;
    }
    cluster_sync();  // every block's sums of the group are in its memory
    if (warp == 0) {
      // lane r reads block r's sums; lane 0 adds them in rank order
      cg::cluster_group cluster = cg::this_cluster();
      double2 w = make_double2(0.0, 0.0);
      if (lane < s.n) w = *cluster.map_shared_rank(&sc.block[parity], lane);
      double a = 0.0, q = 0.0;
      for (int r = 0; r < s.n; ++r) {
        a += __shfl_sync(kFull, w.x, r);
        q += __shfl_sync(kFull, w.y, r);
      }
      const double n = static_cast<double>(slab), md = a / n;
      const float m = static_cast<float>(md);
      const float rs = static_cast<float>(1.0 / sqrt(q / n - md * md + eps));
      if (lane == 0) {
        sc.stat = make_float2(m, rs);
        if (s.rank == 0) {
          mean[grp] = m;
          rstd[grp] = rs;
        }
      }
    }
    __syncthreads();
    const float2 st = sc.stat;
    const int g = static_cast<int>(grp % G);
    float* ys = y + grp * slab + s.p0;
    const bool next = kVec && grp + s.step < groups;
    if (next) expect(s, N, segs, &sc.bar[warp]);
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece(s, t, N, segs);
      const int c = g * s.chans + p.k;
      const float2 ab = fold(scale[c], bias[c], st.x, st.y);
      if (kVec && p.off >= s.held) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const float* g = xs + p.off + j;
          float* o = ys + p.off + j;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 v0 = ld4(g), v1 = h1 ? ld4(g + 128) : v0,
                       v2 = h2 ? ld4(g + 256) : v0,
                       v3 = h3 ? ld4(g + 384) : v0;
          st4(o, apply4(v0, ab, act));
          if (h1) st4(o + 128, apply4(v1, ab, act));
          if (h2) st4(o + 256, apply4(v2, ab, act));
          if (h3) st4(o + 384, apply4(v3, ab, act));
        }
      } else {
#pragma unroll 4
      for (int j = lane * kW; j < p.len; j += 32 * kW) {
        float v[kW];
        fetch<kVec>(sx, xs, s.held, p.off + j, v);
#pragma unroll
        for (int i = 0; i < kW; ++i) v[i] = act_fwd(__fmaf_rn(v[i], ab.x,
                                                              ab.y), act);
        store<kVec>(ys, p.off + j, v);
      }
      }
      if (next) {
        __syncwarp();
        copy_task(s, p, xs + s.step * slab, sx, &sc.bar[warp]);
      }
    }
  }
  cluster_sync();  // no block leaves while another may read its sums
}

// K8's first launch: each task's (sum dz, sum dz xhat) to `part` (B C segs),
// each (b, c) row's to `rowsum` (B C), and dx. The groups, grid, clusters
// and shared memory as K7's: x is held as there; dy is read from device
// memory in the first pass and again (mostly from L2) in the second, where
// dz is recomputed with the first pass's expression.
template <bool kVec>
__global__ void __launch_bounds__(kGnThreads, 1)
gn_bwd_cluster(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const float* __restrict__ mean,
               const float* __restrict__ rstd, int B, int C, int G, int N,
               int segs, int res, int act, double2* __restrict__ part,
               double2* __restrict__ rowsum, float* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  float* sx = reinterpret_cast<float*>(smem + kScratch);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Share s = my_share(C, G, N, segs, res);
  const long long slab = static_cast<long long>(s.chans) * N;
  const long long groups = static_cast<long long>(B) * G;
  start<kVec>(s, N, segs, x + s.grp0 * slab + s.p0, sx, sc);
  unsigned parity = 0;
  for (long long grp = s.grp0; grp < groups; grp += s.step, parity ^= 1) {
    const float* xs = x + grp * slab + s.p0;
    const float* ds = dy + grp * slab + s.p0;
    const float mu = mean[grp], rs = rstd[grp];
    const int g = static_cast<int>(grp % G);
    const long long first = grp * s.chans;
    if constexpr (kVec) mbar_wait(&sc.bar[warp], parity);
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece(s, t, N, segs);
      const int c = g * s.chans + p.k;
      const float2 ab = fold(scale[c], bias[c], mu, rs);
      double s1 = 0.0, s2 = 0.0;
      if (kVec) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const long long i = p.off + j;
          const float* e = ds + i;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 d0 = ld4(e), d1 = h1 ? ld4(e + 128) : d0,
                       d2 = h2 ? ld4(e + 256) : d0,
                       d3 = h3 ? ld4(e + 384) : d0;
          const float4 v0 = ld4(i < s.held ? sx + i : xs + i);
          const float4 v1 = h1 ? ld4(i + 128 < s.held ? sx + i + 128
                                                      : xs + i + 128) : v0;
          const float4 v2 = h2 ? ld4(i + 256 < s.held ? sx + i + 256
                                                      : xs + i + 256) : v0;
          const float4 v3 = h3 ? ld4(i + 384 < s.held ? sx + i + 384
                                                      : xs + i + 384) : v0;
          add_grads(v0, d0, ab, mu, rs, act, s1, s2);
          if (h1) add_grads(v1, d1, ab, mu, rs, act, s1, s2);
          if (h2) add_grads(v2, d2, ab, mu, rs, act, s1, s2);
          if (h3) add_grads(v3, d3, ab, mu, rs, act, s1, s2);
        }
      } else {
        for (int j = lane; j < p.len; j += 32) {
          float v[1], dd[1];
          load<false>(xs, p.off + j, v);
          load<false>(ds, p.off + j, dd);
          if (p.off + j < s.held) store<false>(sx, p.off + j, v);
          float a = 0.f, q = 0.f;
          add_grad1(v[0], dd[0], ab, mu, rs, act, a, q);
          s1 += a;
          s2 += q;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) part[first * segs + t] = make_double2(s1, s2);
    }
    cluster_sync();  // every task's sums of the group are in `part`

    // m1 and m2: each row's tasks in order (lanes, then the warp's tree),
    // the rows in order
    double m1 = 0.0, m2 = 0.0;
    for (int k0 = 0; k0 < s.chans; k0 += kRowChunk) {
      const int rows = min(kRowChunk, s.chans - k0);
      for (int k = warp; k < rows; k += kGnWarps) {
        const double2* row = part + (first + k0 + k) * segs;
        double s1 = 0.0, s2 = 0.0;
        for (int i = lane; i < segs; i += 32) {
          const double2 q = __ldcg(row + i);
          s1 += q.x;
          s2 += q.y;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          const double w = scale[g * s.chans + k0 + k];
          sc.rows[k] = make_double2(w * s1, w * s2);
          if (s.rank == 0) rowsum[first + k0 + k] = make_double2(s1, s2);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int k = 0; k < rows; ++k) {
          m1 += sc.rows[k].x;
          m2 += sc.rows[k].y;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const double n = static_cast<double>(slab);
      sc.stat = make_float2(static_cast<float>(m1 / n),
                            static_cast<float>(m2 / n));
    }
    __syncthreads();
    const float2 mg = sc.stat;
    float* dxs = dx + grp * slab + s.p0;
    const bool next = kVec && grp + s.step < groups;
    if (next) expect(s, N, segs, &sc.bar[warp]);
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece(s, t, N, segs);
      const int c = g * s.chans + p.k;
      const float w = scale[c];
      const float2 ab = fold(w, bias[c], mu, rs);
      if (kVec) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const long long i = p.off + j;
          const float* e = ds + i;
          float* o = dxs + i;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 d0 = ld4(e), d1 = h1 ? ld4(e + 128) : d0,
                       d2 = h2 ? ld4(e + 256) : d0,
                       d3 = h3 ? ld4(e + 384) : d0;
          const float4 v0 = ld4(i < s.held ? sx + i : xs + i);
          const float4 v1 = h1 ? ld4(i + 128 < s.held ? sx + i + 128
                                                      : xs + i + 128) : v0;
          const float4 v2 = h2 ? ld4(i + 256 < s.held ? sx + i + 256
                                                      : xs + i + 256) : v0;
          const float4 v3 = h3 ? ld4(i + 384 < s.held ? sx + i + 384
                                                      : xs + i + 384) : v0;
          st4(o, dx4(v0, d0, ab, mu, rs, w, mg, act));
          if (h1) st4(o + 128, dx4(v1, d1, ab, mu, rs, w, mg, act));
          if (h2) st4(o + 256, dx4(v2, d2, ab, mu, rs, w, mg, act));
          if (h3) st4(o + 384, dx4(v3, d3, ab, mu, rs, w, mg, act));
        }
      } else {
        for (int j = lane; j < p.len; j += 32) {
          float v[1], dd[1];
          fetch<false>(sx, xs, s.held, p.off + j, v);
          load<false>(ds, p.off + j, dd);
          dxs[p.off + j] = dx1(v[0], dd[0], ab, mu, rs, w, mg, act);
        }
      }
      if (next) {
        __syncwarp();
        copy_task(s, p, xs + s.step * slab, sx, &sc.bar[warp]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

struct Plan {
  int segs;
  long long tasks;
  unsigned blocks;
  size_t part_bytes;
};

Plan plan(int B, int C, int N) {
  Plan p;
  p.segs = static_cast<int>(cdiv(N, kSeg));
  p.tasks = static_cast<long long>(B) * C * p.segs;
  p.blocks = static_cast<unsigned>(cdiv(p.tasks, kWarps));
  // a whole block's slots, so that a warp past the last task has a slot too
  p.part_bytes = static_cast<size_t>(p.blocks) * kWarps * sizeof(double2);
  return p;
}

bool aligned(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

bool bad_shape(int B, int C, int N, int G, int act) {
  return B < 1 || C < 1 || N < 1 || G < 1 || C % G != 0 || act < kNone
         || act > kRelu;
}

// The floats of a group's slab a cluster block can hold.
constexpr long long kHeldMost = (kSmemMost - kScratch) / 4 / 4 * 4;

// The cluster plan of a group of C/G rows of N floats at n blocks a cluster:
// the floats a block holds (the widest share, rounded up to whole float4s,
// at most kHeldMost) and the floats of the group left in device memory.
struct GnPlan {
  int n, segs;
  long long tasks, res, remainder;
  size_t smem;
};

GnPlan gn_plan_at(int C, int N, int G, int n) {
  GnPlan p;
  p.n = n;
  p.segs = static_cast<int>(cdiv(N, kTask));
  p.tasks = static_cast<long long>(C / G) * p.segs;
  long long len[kMostCluster], widest = 0;
  for (int r = 0; r < n; ++r) {
    len[r] = task_start((r + 1) * p.tasks / n, N, p.segs)
             - task_start(r * p.tasks / n, N, p.segs);
    widest = len[r] > widest ? len[r] : widest;
  }
  p.res = (widest + 3) / 4 * 4;
  if (p.res > kHeldMost) p.res = kHeldMost;
  p.remainder = 0;
  for (int r = 0; r < n; ++r)
    if (len[r] > p.res) p.remainder += len[r] - p.res;
  p.smem = kScratch + 4 * static_cast<size_t>(p.res);
  return p;
}

// The smallest cluster (1, 2, 4, ... most blocks) whose blocks hold the
// whole slab; `most` where none does.
GnPlan gn_choose(int C, int N, int G, int most) {
  int n = 1;
  while (n < most && gn_plan_at(C, N, G, n).remainder > 0) n *= 2;
  return gn_plan_at(C, N, G, n);
}

bool cluster_size_ok(int n) {
  return n >= 1 && n <= kMostCluster && (n & (n - 1)) == 0;
}

using FwdKernel = void (*)(const float*, const float*, const float*, int,
                           int, int, int, int, int, float, int, float*,
                           float*, float*);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*, int, int,
                           int, int, int, int, int, double2*, double2*,
                           float*);

// Set a cluster kernel's attributes (dynamic shared memory up to
// kSmemMost, the non-portable cluster size) once a device.
int prepare(const void* kernel) {
  static std::mutex lock;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  const std::lock_guard<std::mutex> hold(lock);
  if (err || done.count({kernel, dev})) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMost));
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  if (!err) done.insert({kernel, dev});
  return err;
}

// The launch of a cluster kernel: `blocks` blocks in clusters of n,
// kGnThreads threads, `smem` bytes of dynamic shared memory.
struct GnLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int err = 0;

  GnLaunch(const void* kernel, long long blocks, int n, size_t smem,
           cudaStream_t s) {
    err = prepare(kernel);
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kGnThreads);
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

}  // namespace

// The cluster plan of K7 and K8 at (B, C, N) in G groups, the cluster at
// most `most` blocks (a power of two up to 16): info[0..7] = blocks a
// cluster, floats a block holds, dynamic shared memory a block in bytes,
// threads a block, tasks a group, floats of a group read from device memory
// again (0 where the cluster holds the slab), blocks of the launch, and the
// clusters of that size the card can hold at once of both kernels
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one).
extern "C" int gn_plan(int B, int C, int N, int G, int most,
                       long long* info) {
  if (bad_shape(B, C, N, G, kNone) || !cluster_size_ok(most))
    return cudaErrorInvalidValue;
  const GnPlan p = gn_choose(C, N, G, most);
  info[0] = p.n;
  info[1] = p.res;
  info[2] = static_cast<long long>(p.smem);
  info[3] = kGnThreads;
  info[4] = p.tasks;
  info[5] = p.remainder;
  info[6] = static_cast<long long>(B) * G * p.n;
  info[7] = 0;
  const void* kernels[] = {
      reinterpret_cast<const void*>(gn_fwd_cluster<true>),
      reinterpret_cast<const void*>(gn_bwd_cluster<true>)};
  for (int k = 0; k < 2; ++k) {
    const GnLaunch l(kernels[k], p.n, p.n, p.smem, 0);
    if (l.err) return l.err;
    int clusters = 0;
    const int err = static_cast<int>(cudaOccupancyMaxActiveClusters(
        &clusters, kernels[k], &l.cfg));
    if (err) return err;
    info[7] = k == 0 || clusters < info[7] ? clusters : info[7];
  }
  return 0;
}

// K7: y (B, C, N), mean and rstd (B, G); one launch of `clusters` clusters
// (at most B G) of `cluster` blocks (gn_plan's), each walking the groups
// clusters apart. Returns a CUDA error code, or 0.
extern "C" int gn_fwd(const float* x, const float* scale, const float* bias,
                      float* y, float* mean, float* rstd, int B, int C, int N,
                      int G, float eps, int act, int cluster, int clusters,
                      cudaStream_t stream) {
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan p = gn_plan_at(C, N, G, cluster);
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && aligned(x) && aligned(y);
  const FwdKernel kernel = vec ? gn_fwd_cluster<true> : gn_fwd_cluster<false>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   p.smem, stream);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, scale, bias, B, C, G, N, p.segs,
      static_cast<int>(p.res), eps, act, y, mean, rstd));
}

// Bytes of the `work` buffer gn_bwd takes: each task's and each (b, c)
// row's two sums.
extern "C" size_t gn_bwd_workspace(int B, int C, int N, int G) {
  const size_t rows = static_cast<size_t>(B) * C;
  return (rows * cdiv(N, kTask) + rows) * sizeof(double2);
}

// K8: dx (B, C, N), dscale and dbias (C), from x, dy and K7's mean and rstd;
// two launches: gn_bwd_cluster in `clusters` clusters of `cluster` blocks,
// as K7's, then gn_bwd_channels. Returns a CUDA error code, or 0.
extern "C" int gn_bwd(const float* x, const float* dy, const float* scale,
                      const float* bias, const float* mean, const float* rstd,
                      float* dx, float* dscale, float* dbias, void* work,
                      int B, int C, int N, int G, int act, int cluster,
                      int clusters, cudaStream_t stream) {
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan p = gn_plan_at(C, N, G, cluster);
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  auto* part = static_cast<double2*>(work);
  auto* rowsum = part + static_cast<size_t>(B) * C * p.segs;
  const bool vec = N % 4 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  const BwdKernel kernel = vec ? gn_bwd_cluster<true> : gn_bwd_cluster<false>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   p.smem, stream);
  if (l.err) return l.err;
  int err = static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, dy, scale, bias, mean, rstd, B, C, G, N, p.segs,
      static_cast<int>(p.res), act, part, rowsum, dx));
  if (err) return err;
  gn_bwd_channels<<<static_cast<unsigned>(cdiv(C, kThreads)), kThreads, 0,
                    stream>>>(rowsum, B, C, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the `work` buffer bn_fwd and bn_bwd take.
extern "C" size_t bn_workspace(int B, int C, int N) {
  const Plan p = plan(B, C, N);
  const size_t fwd = static_cast<size_t>(B) * C * sizeof(float2);
  const size_t bwd = static_cast<size_t>(C) * sizeof(float2);
  return p.part_bytes + (fwd > bwd ? fwd : bwd);
}

// K7-BN: y (B, C, N), mean, var and rstd (C): 3 launches.
extern "C" int bn_fwd(const float* x, const float* scale, const float* bias,
                      float* y, float* mean, float* var, float* rstd,
                      void* work, int B, int C, int N, float eps, int act,
                      cudaStream_t stream) {
  if (bad_shape(B, C, N, C, act)) return cudaErrorInvalidValue;
  const Plan p = plan(B, C, N);
  auto* part = static_cast<double2*>(work);
  auto* coef = reinterpret_cast<float2*>(static_cast<char*>(work)
                                         + p.part_bytes);
  const bool vec = N % 4 == 0 && aligned(x) && aligned(y);
  if (vec) {
    gn_stats<true><<<p.blocks, kThreads, 0, stream>>>(x, N, p.segs, p.tasks,
                                                      part);
  } else {
    gn_stats<false><<<p.blocks, kThreads, 0, stream>>>(x, N, p.segs,
                                                       p.tasks, part);
  }
  bn_merge<<<static_cast<unsigned>(cdiv(C, kWarps)), kThreads, 0, stream>>>(
      part, scale, bias, B, C, p.segs, static_cast<double>(B) * N, eps, mean,
      var, rstd, coef);
  if (vec) {
    gn_apply<true><<<p.blocks, kThreads, 0, stream>>>(x, coef, N, p.segs,
                                                      p.tasks, act, y);
  } else {
    gn_apply<false><<<p.blocks, kThreads, 0, stream>>>(x, coef, N, p.segs,
                                                       p.tasks, act, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8-BN: dx (B, C, N), dscale and dbias (C) from x, dy and the forward's
// per-channel mean and rstd: 3 launches.
extern "C" int bn_bwd(const float* x, const float* dy, const float* scale,
                      const float* bias, const float* mean, const float* rstd,
                      float* dx, float* dscale, float* dbias, void* work,
                      int B, int C, int N, int act, cudaStream_t stream) {
  if (bad_shape(B, C, N, C, act)) return cudaErrorInvalidValue;
  const Plan p = plan(B, C, N);
  auto* part = static_cast<double2*>(work);
  auto* m = reinterpret_cast<float2*>(static_cast<char*>(work)
                                      + p.part_bytes);
  const bool vec = N % 4 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  if (vec) {
    gn_bwd_partials<true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, N, p.segs, p.tasks, act, part);
  } else {
    gn_bwd_partials<false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, N, p.segs, p.tasks, act, part);
  }
  bn_bwd_channels<<<static_cast<unsigned>(cdiv(C, kWarps)), kThreads, 0,
                    stream>>>(part, scale, B, C, p.segs,
                              static_cast<double>(B) * N, dscale, dbias, m);
  if (vec) {
    gn_bwd_dx<true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, N, p.segs, p.tasks, act, dx);
  } else {
    gn_bwd_dx<false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, N, p.segs, p.tasks, act, dx);
  }
  return static_cast<int>(cudaGetLastError());
}
