// GroupNorm with an optional SiLU or ReLU (flash-GN), forward (K7) and
// backward (K8), for NVIDIA Hopper: the kernels, templated on the storage
// type S (float, or __nv_bfloat16 for the bf16 route), and their plans.
// groupnorm.cu holds the C entry points and the float32 instantiation,
// groupnorm_bf16.cu the bf16 one, so that nvcc compiles the two in parallel.
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
//   float4 grid take 4-byte loads (kVec = false), and each lane copies the
//   held floats it reads with 4-byte cp.async, ahead as the bulk copies
//   are. What a lane reads from device memory or L2 it
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
// of x (B, C, N):
//
//   mean, var, rstd per c over the B N elements of the channel
//   y = act(x a + b),  a = scale[c] rstd,  b = bias[c] - mean a
//   m1 = scale[c] sum_{b, i} dz / (B N),  m2 = scale[c] sum_{b, i} dz xhat
//        / (B N),  dscale[c] and dbias[c] the same sums
//   dx = rstd (dz scale[c] - m1 - xhat m2)
//
// A BatchNorm "group" is one channel: B rows of N floats, the first at c N
// and each next C N further on. K7-BN and K8-BN are K7's and K8's cluster
// kernels with kBn set: the groups are the C channels, a row of a group
// sits a row stride of C N after the last (GroupNorm's: N), and scale,
// bias and the statistics are indexed by the group. bn_plan (mirrored by
// ops/batchnorm.py) is K7's plan over B rows. K8-BN needs no per-row sums:
// the channel's (sum dz, sum dz xhat) are its dbias and dscale, so each
// block's pair is reduced over DSMEM in rank order as K7's statistics are
// (no gather from L2, no second launch), rank 0 writes dbias and dscale,
// and every block forms m1 and m2 for its dx. One launch each. Where one
// block holds a channel (N <= 1000 and the attention's gates at 16 x 4 s:
// 3,984 to 34,816 floats) a channel's chain of barriers and reductions
// costs about as much as its bytes: the block skips the cluster barrier
// (it is the cluster), and where a channel has at most 16 tasks both
// kernels run blocks of half the threads, two or three an SM (bn_ring),
// with a ring of two buffers where two such blocks fit (the next channel
// copied in while this one is reduced and written).
//
// By bn_plan's rule a channel past a 16-block cluster's shared memory
// (MANNER's (16, 60, 64084): 4.1 MB a channel) takes the partial cluster
// route in K7-BN (the held part on chip, the rest read twice from device
// memory) and two passes through device memory in K8-BN, the faster of the
// two for each on an H100 (PERF.md); K8-BN takes the passes off the float4
// grid too. The passes: a warp a segment of up to kSeg floats of one row,
// kWarps segments a block; bn_bwd_partials writes each segment's two sums
// in double, bn_bwd_dx adds the channel's B x segs sums in one fixed order
// in every warp (so every warp holds the same bits), then writes dx (the
// channel's first segment's warp dscale and dbias). A lane keeps four
// float4s of a tensor in flight. Bound: bytes, as K7/K8's; no channel cap
// and no byte floor (the Pallas path's are Mosaic's).
//
// Loads and stores are 16 bytes a lane where N is a multiple of 4 and the
// tensors are 16-byte aligned, else 4. No float atomics: two runs give
// bitwise-equal outputs and gradients. The statistics and every reduction
// are summed in double (K7-BN's and K8-BN's each float's term: a channel's
// sums cancel, as the C = 1 attention gates' dscale does). Every pointer is
// a dense buffer (x, y, dy and dx of the storage type, the rest float32);
// K8's `work` is gn_bwd_workspace(B, C, N, G) bytes, the flash-BN passes' the
// workspace bn_plan names.
//
// The bf16 route (S = __nv_bfloat16) computes what the Pallas kernels do at
// bf16 I/O: x and dy are loaded as bf16 and converted to float, every
// statistic and sum is formed as above (float32 arithmetic, double sums),
// and y = act(x a + b) and dx are each rounded to bf16 once, where they are
// written; scale and bias are float32 (the wrapper widens a bf16 affine,
// exactly), and the statistics, dscale and dbias stay float32 (the wrapper
// casts the affine's gradients to its dtype). The slabs are held in shared
// memory as bf16, so a block holds twice the elements and a group fits a
// cluster half the size. GroupNorm on the 16-byte grid (N % 8 == 0, every
// tensor 16-byte aligned: every class of an SGMSE+ or IDMSE evaluation)
// takes kernels of its own (groupnorm_bf16.cu: gn_fwd16, gn_bwd16): TMA
// bulk copies of the held slab, and of dy beside it, and 16-byte vectors
// of 8 elements. These templates at bf16 take the rest: every BatchNorm
// (MANNER's N = 64084 and 16020 leave 8-byte rows, which a bulk copy's
// 16-byte granule does not take) and GroupNorm off that grid. There a
// lane's vector is four elements (8 bytes), copied to shared memory with
// 8-byte cp.async, each lane the vectors it reads, and off the 8-byte grid
// (N % 4 != 0, an unaligned view) one element at a time with plain loads
// and stores (cp.async has no 2-byte copy).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <set>
#include <utility>

// The bf16 route's instantiations (groupnorm_bf16.cu); the arguments are
// the C entries' (groupnorm.cu), with x, y, dy and dx bf16.
namespace gn_bf16 {
int gn_plan(int B, int C, int N, int G, int most, long long* info);
int gn_fwd(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* rstd, int B, int C, int N, int G, float eps,
           int act, int cluster, int clusters, cudaStream_t stream);
int gn_bwd(const void* x, const void* dy, const float* scale,
           const float* bias, const float* mean, const float* rstd, void* dx,
           float* dscale, float* dbias, void* work, int B, int C, int N,
           int G, int act, int cluster, int clusters, cudaStream_t stream);
int bn_plan(int B, int C, int N, int most, long long* info);
int bn_fwd(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* var, float* rstd, int B, int C, int N,
           float eps, int act, int route, int cluster, int clusters,
           cudaStream_t stream);
int bn_bwd(const void* x, const void* dy, const float* scale,
           const float* bias, const float* mean, const float* rstd, void* dx,
           float* dscale, float* dbias, void* work, int B, int C, int N,
           int act, int route, int cluster, int clusters,
           cudaStream_t stream);
}  // namespace gn_bf16

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
constexpr int kSmemSm = 233472;         // shared memory of an SM
constexpr int kSmemReserved = 1024;     // of it the system's a block
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

// The storage types: float, and bf16 (the bf16 route). An element is
// loaded as float; an output is rounded to S once, where it is written.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four elements at p (a float4, or 8 bytes of bf16), as float4. A lane's
// vectors that come from device memory are read four at a time, all four
// before the first is used (named registers, so that the loads stay in
// flight together).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y),
                                            pack2(v.z, v.w));
}

template <bool kVec, typename S>
__device__ __forceinline__ void load(const S* p, long long i,
                                     float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    const float4 q = ld4(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = to_f(p[i]);
  }
}

template <bool kVec, typename S>
__device__ __forceinline__ void store(S* p, long long i,
                                      const float (&v)[kVec ? 4 : 1]) {
  if constexpr (kVec) {
    st4(p + i, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    p[i] = from_f<S>(v[0]);
  }
}

// Whether a route copies its held elements with TMA bulk copies: float32
// on the vector grid (see the bf16 route's note above).
template <bool kVec, typename S>
constexpr bool kTmaRoute = kVec && sizeof(S) == 4;

// ---------------------------------------------------------------------------
// K8's second launch

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

// ---------------------------------------------------------------------------
// K7, K8's first launch, K7-BN and K8-BN: thread-block clusters that walk
// the groups ((b, g), or a BatchNorm's channels), one group at a time

namespace cg = cooperative_groups;

// The scratch ahead of a cluster block's slabs in its dynamic shared memory.
struct Scratch {
  unsigned long long bar[2][kGnWarps];  // each warp's bulk copies of a
                                        // group, by the ring's buffer
  double2 warp[kGnWarps];            // K7, K8-BN: each warp's two sums
  double2 block[2];                  // the block's, read over DSMEM, by the
                                     // parity of the block's group
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

// The groups a cluster kernel walks. GroupNorm's: the B G (b, g) groups,
// each a slab of C/G contiguous rows. A BatchNorm's (kBn): the C channels,
// each B rows of N floats, one every C N.
struct Groups {
  int rows;                // rows of N floats a group
  long long count;         // groups
  long long step;          // floats from a group's first float to the next's
  long long skip;          // floats between a row's end and the next row's
};

template <bool kBn>
__device__ __forceinline__ Groups groups(int B, int C, int G, int N) {
  Groups L;
  if constexpr (kBn) {
    L.rows = B;
    L.count = C;
    L.step = N;
    L.skip = static_cast<long long>(C - 1) * N;
  } else {
    L.rows = C / G;
    L.count = static_cast<long long>(B) * G;
    L.step = static_cast<long long>(L.rows) * N;
    L.skip = 0;
  }
  return L;
}

// The channel of row k of group grp (G groups a batch row for GroupNorm).
template <bool kBn>
__device__ __forceinline__ int channel(long long grp, int k, int G,
                                       int rows) {
  if constexpr (kBn) {
    return static_cast<int>(grp);
  } else {
    return static_cast<int>(grp % G) * rows + k;
  }
}

// This block's share of every group (`rows` rows of N floats): tasks [t0,
// t1), floats [p0, p0 + len) of the slab (the group's rows end to end),
// `held` of them in shared memory. The cluster (rank `rank` of n) walks
// groups grp0, grp0 + step, ...
struct Share {
  long long t0, t1, p0, len;
  long long grp0, step;
  int held, n, rank;
};

__device__ __forceinline__ Share my_share(int rows, int N, int segs,
                                          int res) {
  cg::cluster_group cluster = cg::this_cluster();
  Share s;
  s.n = static_cast<int>(cluster.num_blocks());
  s.rank = static_cast<int>(cluster.block_rank());
  s.grp0 = blockIdx.x / s.n;
  s.step = gridDim.x / s.n;
  const long long T = static_cast<long long>(rows) * segs;
  s.t0 = s.rank * T / s.n;
  s.t1 = (s.rank + 1) * T / s.n;
  s.p0 = task_start(s.t0, N, segs);
  s.len = task_start(s.t1, N, segs) - s.p0;
  s.held = static_cast<int>(s.len < res ? s.len : res);
  return s;
}

// One task of this block: row k of the group, floats [off, off + len) of
// the share; float i of the share lies at `shift + i` of the group in
// device memory (GroupNorm's: p0, the slab being contiguous).
struct Piece {
  int k, len;
  long long off, shift;
};

template <bool kBn>
__device__ __forceinline__ Piece piece(const Share& s, long long t, int N,
                                       int segs, long long skip) {
  Piece p;
  p.k = static_cast<int>(t / segs);
  const int seg = static_cast<int>(t - static_cast<long long>(p.k) * segs);
  p.off = task_start(t, N, segs) - s.p0;
  p.len = min(kTask, N - seg * kTask);
  if constexpr (kBn) {
    p.shift = s.p0 + p.k * skip;
  } else {
    p.shift = s.p0;
  }
  return p;
}

// Lane 0 of a warp sets its mbarrier to expect the held part of the warp's
// tasks of a group (kWarps2 warps a block).
template <int kWarps2>
__device__ __forceinline__ void expect(const Share& s, int N, int segs,
                                       unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned bytes = 0;
  for (long long t = s.t0 + (threadIdx.x >> 5); t < s.t1; t += kWarps2) {
    const Piece p = piece<false>(s, t, N, segs, 0);
    if (p.off < s.held)
      bytes += 4u * static_cast<unsigned>(min(
          static_cast<long long>(p.len), s.held - p.off));
  }
  mbar_expect(bar, bytes);
}

// A 4-byte asynchronous copy from device to shared memory; a thread waits
// for its own with cp_async_wait.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// An 8-byte asynchronous copy (four bf16), as cp_async4.
__device__ __forceinline__ void cp_async8(bf16* dst, const bf16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The held part of one task of a group, of `a` (the group's first float)
// to sa. With TMA (kTmaRoute) lane 0 issues a bulk copy completing on the
// warp's mbarrier; else each lane copies the elements it reads in every
// pass (j = lane + 32 i, or the vectors at 4 lane + 128 i) with cp.async,
// or, for bf16 off the vector grid, with plain loads and stores. A warp
// owns its tasks' shared memory in every pass, so with one buffer it copies
// a task of the next group over one of this group as soon as its lanes are
// done with it.
template <bool kVec, typename S>
__device__ __forceinline__ void copy_task(const Share& s, const Piece& p,
                                          const S* a, S* sa,
                                          unsigned long long* bar) {
  if (p.off >= s.held) return;
  const long long held = min(static_cast<long long>(p.len), s.held - p.off);
  if constexpr (kTmaRoute<kVec, S>) {
    if ((threadIdx.x & 31) != 0) return;
    // the lanes' reads of these floats (generic proxy) come before the
    // copy's writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(sa + p.off, a + p.shift + p.off,
              4u * static_cast<unsigned>(held), bar);
  } else if constexpr (kVec) {
    for (long long j = (threadIdx.x & 31) * 4; j < held; j += 128)
      cp_async8(sa + p.off + j, a + p.shift + p.off + j);
  } else if constexpr (sizeof(S) == 4) {
    for (long long j = threadIdx.x & 31; j < held; j += 32)
      cp_async4(sa + p.off + j, a + p.shift + p.off + j);
  } else {
    for (long long j = threadIdx.x & 31; j < held; j += 32)
      sa[p.off + j] = a[p.shift + p.off + j];
  }
}

// Each warp copies its tasks of a group (whose first float is `a`) into a
// buffer of the ring (sa), on the buffer's mbarrier `bar` with TMA, else
// as one group of cp.async copies.
template <bool kVec, bool kBn, int kWarps2, typename S>
__device__ __forceinline__ void copy_group(const Share& s, int N, int segs,
                                           long long skip, const S* a,
                                           S* sa,
                                           unsigned long long* bar) {
  __syncwarp();   // the warp's lanes are done with the buffer's last group
  if constexpr (kTmaRoute<kVec, S>) expect<kWarps2>(s, N, segs, bar);
  for (long long t = s.t0 + (threadIdx.x >> 5); t < s.t1; t += kWarps2)
    copy_task<kVec>(s, piece<kBn>(s, t, N, segs, skip), a, sa, bar);
  if constexpr (!kTmaRoute<kVec, S>)
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// With TMA thread 0 sets up one mbarrier a warp and buffer of the ring;
// then each warp copies its share of the block's first group into the
// first buffer.
template <bool kVec, bool kBn, int kWarps2, typename S>
__device__ __forceinline__ void start(const Share& s, int N, int segs,
                                      long long skip, const S* a,
                                      S* sa, Scratch& sc) {
  if constexpr (kTmaRoute<kVec, S>) {
    if (threadIdx.x == 0) {
      for (int w = 0; w < kGnWarps; ++w) {
        mbar_init(&sc.bar[0][w]);
        mbar_init(&sc.bar[1][w]);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  copy_group<kVec, kBn, kWarps2>(s, N, segs, skip, a, sa,
                                 &sc.bar[0][threadIdx.x >> 5]);
}

// Group k of the block is held in shared memory: with TMA the warp waits
// for its mbarrier (the buffer's, used once every `stages` groups), else
// each thread for its own copies (all but the next group's, `ahead`: copied
// before this group was waited for).
template <bool kTma>
__device__ __forceinline__ void wait_held(unsigned long long* bar,
                                          unsigned k, int stages,
                                          bool ahead) {
  if constexpr (kTma) {
    mbar_wait(bar, (k / stages) & 1);
  } else if (ahead) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    cp_async_wait();
  }
}

// Float i of the share of a group: from shared memory where held (copied
// there, which the thread has waited for), else from `g` (the share's
// origin in device memory).
template <bool kVec, typename S>
__device__ __forceinline__ void fetch(const S* s, const S* g,
                                      int held, long long i,
                                      float (&v)[kVec ? 4 : 1]) {
  if (i < held) {
    load<kVec>(s, i, v);
  } else {
    load<kVec>(g, i, v);
  }
}

// fetch, one element
template <typename S>
__device__ __forceinline__ float fetch1(const S* s, const S* g,
                                        int held, long long i) {
  return to_f(i < held ? s[i] : g[i]);
}

// Warp 0 gets the cluster's sums of a group's (a, q) pairs: each thread's
// pair, then the lanes', warps' and blocks' in a fixed order (the blocks'
// read over DSMEM after a cluster barrier, in rank order), so that every
// block holds the same bits. The block's sums are kept by the parity of
// the block's group: a block writes them again two groups on, past the
// next group's barrier, which every block reaches after its reads. A
// `solo` block (a BatchNorm channel's only one) skips the cluster barrier
// and adds its own sums alone.
template <int kWarps2>
__device__ __forceinline__ double2 cluster_sum(double a, double q,
                                               Scratch& sc, unsigned parity,
                                               int n, bool solo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) sc.warp[warp] = make_double2(a, q);
  __syncthreads();
  double2 out = make_double2(0.0, 0.0);
  if (warp == 0) {
    double2 w = lane < kWarps2 ? sc.warp[lane] : make_double2(0.0, 0.0);
    w.x = warp_sum(w.x);
    w.y = warp_sum(w.y);
    if (solo) {
      out.x += __shfl_sync(kFull, w.x, 0);
      out.y += __shfl_sync(kFull, w.y, 0);
      return out;
    }
    if (lane == 0) sc.block[parity] = w;
  }
  if (solo) return out;
  cluster_sync();  // every block's sums of the group are in its memory
  if (warp == 0) {
    // lane r reads block r's sums; every lane adds them in rank order
    cg::cluster_group cluster = cg::this_cluster();
    double2 w = make_double2(0.0, 0.0);
    if (lane < n) w = *cluster.map_shared_rank(&sc.block[parity], lane);
    for (int r = 0; r < n; ++r) {
      out.x += __shfl_sync(kFull, w.x, r);
      out.y += __shfl_sync(kFull, w.y, r);
    }
  }
  return out;
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

// K8's sums of one float of x and of dy, as the 4-byte loop forms them
__device__ __forceinline__ void add_grad(float x, float d, float2 ab,
                                         float mu, float rs, int act,
                                         double& s1, double& s2) {
  float a = 0.f, q = 0.f;
  add_grad1(x, d, ab, mu, rs, act, a, q);
  s1 += a;
  s2 += q;
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

// K7-BN's and K8-BN's sums, each float's term in double (products exact),
// as the flash-BN passes always formed them: a BatchNorm's sums over a
// channel cancel (the C = 1 attention gates' dscale), so they are not
// rounded to float on the way
__device__ __forceinline__ void add_stats_exact(float4 v, double& sum,
                                                double& sq) {
  sum += v.x;
  sq += static_cast<double>(v.x) * v.x;
  sum += v.y;
  sq += static_cast<double>(v.y) * v.y;
  sum += v.z;
  sq += static_cast<double>(v.z) * v.z;
  sum += v.w;
  sq += static_cast<double>(v.w) * v.w;
}

__device__ __forceinline__ void add_grad_exact(float x, float d, float2 ab,
                                               float mu, float rs, int act,
                                               double& s1, double& s2) {
  const float dz = act_bwd(__fmaf_rn(x, ab.x, ab.y), d, act);
  s1 += dz;
  s2 += static_cast<double>(dz) * __fmul_rn(__fsub_rn(x, mu), rs);
}

__device__ __forceinline__ void add_grads_exact(float4 x, float4 d, float2 ab,
                                                float mu, float rs, int act,
                                                double& s1, double& s2) {
  add_grad_exact(x.x, d.x, ab, mu, rs, act, s1, s2);
  add_grad_exact(x.y, d.y, ab, mu, rs, act, s1, s2);
  add_grad_exact(x.z, d.z, ab, mu, rs, act, s1, s2);
  add_grad_exact(x.w, d.w, ab, mu, rs, act, s1, s2);
}

// A float4's sums: K7's (kBn false) or K7-BN's
template <bool kBn>
__device__ __forceinline__ void stats4(float4 v, double& sum, double& sq) {
  if constexpr (kBn) {
    add_stats_exact(v, sum, sq);
  } else {
    add_stats(v, sum, sq);
  }
}

// A float4's or a float's sums: K8's (kBn false) or K8-BN's
template <bool kBn>
__device__ __forceinline__ void grads4(float4 x, float4 d, float2 ab,
                                       float mu, float rs, int act,
                                       double& s1, double& s2) {
  if constexpr (kBn) {
    add_grads_exact(x, d, ab, mu, rs, act, s1, s2);
  } else {
    add_grads(x, d, ab, mu, rs, act, s1, s2);
  }
}

template <bool kBn>
__device__ __forceinline__ void grad1(float x, float d, float2 ab, float mu,
                                      float rs, int act, double& s1,
                                      double& s2) {
  if constexpr (kBn) {
    add_grad_exact(x, d, ab, mu, rs, act, s1, s2);
  } else {
    add_grad(x, d, ab, mu, rs, act, s1, s2);
  }
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

// K7, and K7-BN with kBn. The groups (B G, or C), each taken by one
// cluster of n blocks; grid: up to one cluster a group (as many as the card
// holds at once), 32 kWarps2 threads (kGnThreads, or half where up to three
// blocks share an SM), kScratch + 4 res stages bytes of dynamic shared memory
// (res: floats a block holds; K7-BN's `stages`, 1 or 2: the buffers of its
// ring). `var` is written with kBn alone. x and y of S (float, bf16).
template <bool kVec, bool kBn, int kWarps2, typename S>
__global__ void __launch_bounds__(32 * kWarps2, kWarps2 == kGnWarps ? 1 : 3)
gn_fwd_cluster(const S* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, int B, int C, int G, int N,
               int segs, int res, int stages, float eps, int act,
               S* __restrict__ y,
               float* __restrict__ mean, float* __restrict__ rstd,
               float* __restrict__ var) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  S* sx = reinterpret_cast<S*>(smem + kScratch);
  constexpr bool kTma = kTmaRoute<kVec, S>;
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Groups L = groups<kBn>(B, C, G, N);
  const Share s = my_share(L.rows, N, segs, res);
  const int ring = kBn ? stages : 1;
  start<kVec, kBn, kWarps2>(s, N, segs, L.skip, x + s.grp0 * L.step, sx,
                            sc);
  unsigned k = 0;   // the block's groups so far
  for (long long grp = s.grp0; grp < L.count; grp += s.step, ++k) {
    const unsigned parity = k & 1;
    const int b = ring == 2 ? parity : 0;   // the ring's buffer of the group
    S* const bx = sx + b * res;
    const S* xg = x + grp * L.step;
    const bool next = grp + s.step < L.count;
    if (ring == 2 && next)   // the next group into the other buffer
      copy_group<kVec, kBn, kWarps2>(s, N, segs, L.skip,
                                     xg + s.step * L.step,
                                     sx + (b ^ 1) * res,
                                     &sc.bar[b ^ 1][warp]);
    // K7-BN's affine: the group's channel's, read ahead of the barriers
    const float bn_w = kBn ? scale[grp] : 0.f, bn_b = kBn ? bias[grp] : 0.f;
    wait_held<kTma>(&sc.bar[b][warp], k, ring, ring == 2 && next);
    double sum = 0.0, sq = 0.0;
    for (long long t = s.t0 + warp; t < s.t1; t += kWarps2) {
      const Piece p = piece<kBn>(s, t, N, segs, L.skip);
      const S* xs = xg + p.shift;
      if (kVec && p.off >= s.held) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const S* g = xs + p.off + j;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 v0 = ld4(g), v1 = h1 ? ld4(g + 128) : v0,
                       v2 = h2 ? ld4(g + 256) : v0,
                       v3 = h3 ? ld4(g + 384) : v0;
          stats4<kBn>(v0, sum, sq);
          if (h1) stats4<kBn>(v1, sum, sq);
          if (h2) stats4<kBn>(v2, sum, sq);
          if (h3) stats4<kBn>(v3, sum, sq);
        }
        continue;
      }
#pragma unroll 4
      for (int j = lane * kW; j < p.len; j += 32 * kW) {
        float v[kW];
        fetch<kVec>(bx, xs, s.held, p.off + j, v);
        if constexpr (kBn) {
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            sum += v[i];
            sq += static_cast<double>(v[i]) * v[i];
          }
          continue;
        }
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
    const double2 tot = cluster_sum<kWarps2>(sum, sq, sc, parity, s.n,
                                             kBn && s.n == 1);
    if (threadIdx.x == 0) {
      const double n = static_cast<double>(L.rows) * N, md = tot.x / n;
      const double vd = tot.y / n - md * md;
      const float m = static_cast<float>(md);
      const float rs = static_cast<float>(1.0 / sqrt(vd + eps));
      sc.stat = make_float2(m, rs);
      if (s.rank == 0) {
        mean[grp] = m;
        rstd[grp] = rs;
        if constexpr (kBn) var[grp] = static_cast<float>(vd);
      }
    }
    __syncthreads();
    const float2 st = sc.stat;
    S* yg = y + grp * L.step;
    // with one buffer, each task of the next group as this one's is done
    const bool refill = ring == 1 && next;
    if (kTma && refill) expect<kWarps2>(s, N, segs, &sc.bar[0][warp]);
    for (long long t = s.t0 + warp; t < s.t1; t += kWarps2) {
      const Piece p = piece<kBn>(s, t, N, segs, L.skip);
      const S* xs = xg + p.shift;
      S* ys = yg + p.shift;
      const int c = channel<kBn>(grp, p.k, G, L.rows);
      const float2 ab = kBn ? fold(bn_w, bn_b, st.x, st.y)
                            : fold(scale[c], bias[c], st.x, st.y);
      if (kVec && p.off >= s.held) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const S* g = xs + p.off + j;
          S* o = ys + p.off + j;
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
        fetch<kVec>(bx, xs, s.held, p.off + j, v);
#pragma unroll
        for (int i = 0; i < kW; ++i) v[i] = act_fwd(__fmaf_rn(v[i], ab.x,
                                                              ab.y), act);
        store<kVec>(ys, p.off + j, v);
      }
      }
      if (refill) {
        __syncwarp();
        copy_task<kVec>(s, p, xg + s.step * L.step, bx, &sc.bar[0][warp]);
      }
    }
  }
  // no block leaves while another may read its sums
  if (!kBn || s.n > 1) cluster_sync();
}

// K8's first launch, and K8-BN (one launch) with kBn. The groups, grid,
// clusters and shared memory as K7's: x is held as there; dy is read from
// device memory in the first pass and again (mostly from L2) in the
// second, where dz is recomputed with the first pass's expression. K8
// writes each task's (sum dz, sum dz xhat) to `part` (B C segs) and reads
// them back after a cluster barrier, each (b, c) row's to `rowsum` (B C);
// K8-BN reduces the channel's pair over DSMEM as K7 does its statistics
// and writes dscale and dbias (rank 0); `stages` buffers of its ring as
// K7-BN's.
template <bool kVec, bool kBn, int kWarps2, typename S>
__global__ void __launch_bounds__(32 * kWarps2, kGnWarps / kWarps2)
gn_bwd_cluster(const S* __restrict__ x, const S* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const float* __restrict__ mean,
               const float* __restrict__ rstd, int B, int C, int G, int N,
               int segs, int res, int stages, int act,
               double2* __restrict__ part,
               double2* __restrict__ rowsum, S* __restrict__ dx,
               float* __restrict__ dscale, float* __restrict__ dbias) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  S* sx = reinterpret_cast<S*>(smem + kScratch);
  constexpr bool kTma = kTmaRoute<kVec, S>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Groups L = groups<kBn>(B, C, G, N);
  const Share s = my_share(L.rows, N, segs, res);
  const int ring = kBn ? stages : 1;
  start<kVec, kBn, kWarps2>(s, N, segs, L.skip, x + s.grp0 * L.step, sx,
                            sc);
  unsigned k = 0;   // the block's groups so far
  for (long long grp = s.grp0; grp < L.count; grp += s.step, ++k) {
    const unsigned parity = k & 1;
    const int b = ring == 2 ? parity : 0;   // the ring's buffer of the group
    S* const bx = sx + b * res;
    const S* xg = x + grp * L.step;
    const S* dg = dy + grp * L.step;
    const bool next = grp + s.step < L.count;
    if (ring == 2 && next)   // the next group into the other buffer
      copy_group<kVec, kBn, kWarps2>(s, N, segs, L.skip,
                                     xg + s.step * L.step,
                                     sx + (b ^ 1) * res,
                                     &sc.bar[b ^ 1][warp]);
    const float mu = mean[grp], rs = rstd[grp];
    const long long first = grp * L.rows;
    wait_held<kTma>(&sc.bar[b][warp], k, ring, ring == 2 && next);
    double w1 = 0.0, w2 = 0.0;   // K8-BN: the lane's sums over its tasks
    for (long long t = s.t0 + warp; t < s.t1; t += kWarps2) {
      const Piece p = piece<kBn>(s, t, N, segs, L.skip);
      const S* xs = xg + p.shift;
      const S* ds = dg + p.shift;
      const int c = channel<kBn>(grp, p.k, G, L.rows);
      const float2 ab = fold(scale[c], bias[c], mu, rs);
      double s1 = 0.0, s2 = 0.0;
      if (kVec) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const long long i = p.off + j;
          const S* e = ds + i;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 d0 = ld4(e), d1 = h1 ? ld4(e + 128) : d0,
                       d2 = h2 ? ld4(e + 256) : d0,
                       d3 = h3 ? ld4(e + 384) : d0;
          const float4 v0 = ld4(i < s.held ? bx + i : xs + i);
          const float4 v1 = h1 ? ld4(i + 128 < s.held ? bx + i + 128
                                                      : xs + i + 128) : v0;
          const float4 v2 = h2 ? ld4(i + 256 < s.held ? bx + i + 256
                                                      : xs + i + 256) : v0;
          const float4 v3 = h3 ? ld4(i + 384 < s.held ? bx + i + 384
                                                      : xs + i + 384) : v0;
          grads4<kBn>(v0, d0, ab, mu, rs, act, s1, s2);
          if (h1) grads4<kBn>(v1, d1, ab, mu, rs, act, s1, s2);
          if (h2) grads4<kBn>(v2, d2, ab, mu, rs, act, s1, s2);
          if (h3) grads4<kBn>(v3, d3, ab, mu, rs, act, s1, s2);
        }
      } else {
        // a lane's four floats of dy in flight, then each in order
        for (int j = lane; j < p.len; j += 128) {
          const long long i = p.off + j;
          const bool h1 = j + 32 < p.len, h2 = j + 64 < p.len,
                     h3 = j + 96 < p.len;
          const float d0 = to_f(ds[i]), d1 = h1 ? to_f(ds[i + 32]) : 0.f,
                      d2 = h2 ? to_f(ds[i + 64]) : 0.f,
                      d3 = h3 ? to_f(ds[i + 96]) : 0.f;
          grad1<kBn>(fetch1(bx, xs, s.held, i), d0, ab, mu, rs, act, s1,
                     s2);
          if (h1) grad1<kBn>(fetch1(bx, xs, s.held, i + 32), d1, ab, mu, rs,
                             act, s1, s2);
          if (h2) grad1<kBn>(fetch1(bx, xs, s.held, i + 64), d2, ab, mu, rs,
                             act, s1, s2);
          if (h3) grad1<kBn>(fetch1(bx, xs, s.held, i + 96), d3, ab, mu, rs,
                             act, s1, s2);
        }
      }
      if constexpr (kBn) {
        w1 += s1;
        w2 += s2;
      } else {
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) part[first * segs + t] = make_double2(s1, s2);
      }
    }
    if constexpr (kBn) {
      const double2 tot = cluster_sum<kWarps2>(w1, w2, sc, parity, s.n,
                                               s.n == 1);
      if (threadIdx.x == 0) {
        const double n = static_cast<double>(L.rows) * N;
        const double w = scale[grp];
        sc.stat = make_float2(static_cast<float>(w * tot.x / n),
                              static_cast<float>(w * tot.y / n));
        if (s.rank == 0) {
          dbias[grp] = static_cast<float>(tot.x);
          dscale[grp] = static_cast<float>(tot.y);
        }
      }
      __syncthreads();
    } else {
      cluster_sync();  // every task's sums of the group are in `part`

      // m1 and m2: each row's tasks in order (lanes, then the warp's tree),
      // the rows in order
      const int g = static_cast<int>(grp % G);
      double m1 = 0.0, m2 = 0.0;
      for (int k0 = 0; k0 < L.rows; k0 += kRowChunk) {
        const int rows = min(kRowChunk, L.rows - k0);
        for (int k = warp; k < rows; k += kWarps2) {
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
            const double w = scale[g * L.rows + k0 + k];
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
        const double n = static_cast<double>(L.step);
        sc.stat = make_float2(static_cast<float>(m1 / n),
                              static_cast<float>(m2 / n));
      }
      __syncthreads();
    }
    const float2 mg = sc.stat;
    S* dxg = dx + grp * L.step;
    // with one buffer, each task of the next group as this one's is done
    const bool refill = ring == 1 && next;
    if (kTma && refill) expect<kWarps2>(s, N, segs, &sc.bar[0][warp]);
    for (long long t = s.t0 + warp; t < s.t1; t += kWarps2) {
      const Piece p = piece<kBn>(s, t, N, segs, L.skip);
      const S* xs = xg + p.shift;
      const S* ds = dg + p.shift;
      S* dxs = dxg + p.shift;
      const int c = channel<kBn>(grp, p.k, G, L.rows);
      const float w = scale[c];
      const float2 ab = fold(w, bias[c], mu, rs);
      if (kVec) {
        for (int j = lane * 4; j < p.len; j += 512) {
          const long long i = p.off + j;
          const S* e = ds + i;
          S* o = dxs + i;
          const bool h1 = j + 128 < p.len, h2 = j + 256 < p.len,
                     h3 = j + 384 < p.len;
          const float4 d0 = ld4(e), d1 = h1 ? ld4(e + 128) : d0,
                       d2 = h2 ? ld4(e + 256) : d0,
                       d3 = h3 ? ld4(e + 384) : d0;
          const float4 v0 = ld4(i < s.held ? bx + i : xs + i);
          const float4 v1 = h1 ? ld4(i + 128 < s.held ? bx + i + 128
                                                      : xs + i + 128) : v0;
          const float4 v2 = h2 ? ld4(i + 256 < s.held ? bx + i + 256
                                                      : xs + i + 256) : v0;
          const float4 v3 = h3 ? ld4(i + 384 < s.held ? bx + i + 384
                                                      : xs + i + 384) : v0;
          st4(o, dx4(v0, d0, ab, mu, rs, w, mg, act));
          if (h1) st4(o + 128, dx4(v1, d1, ab, mu, rs, w, mg, act));
          if (h2) st4(o + 256, dx4(v2, d2, ab, mu, rs, w, mg, act));
          if (h3) st4(o + 384, dx4(v3, d3, ab, mu, rs, w, mg, act));
        }
      } else {
        for (int j = lane; j < p.len; j += 128) {
          const long long i = p.off + j;
          const bool h1 = j + 32 < p.len, h2 = j + 64 < p.len,
                     h3 = j + 96 < p.len;
          const float d0 = to_f(ds[i]), d1 = h1 ? to_f(ds[i + 32]) : 0.f,
                      d2 = h2 ? to_f(ds[i + 64]) : 0.f,
                      d3 = h3 ? to_f(ds[i + 96]) : 0.f;
          dxs[i] = from_f<S>(dx1(fetch1(bx, xs, s.held, i), d0, ab, mu, rs,
                                 w, mg, act));
          if (h1) dxs[i + 32] = from_f<S>(dx1(fetch1(bx, xs, s.held, i + 32),
                                              d1, ab, mu, rs, w, mg, act));
          if (h2) dxs[i + 64] = from_f<S>(dx1(fetch1(bx, xs, s.held, i + 64),
                                              d2, ab, mu, rs, w, mg, act));
          if (h3) dxs[i + 96] = from_f<S>(dx1(fetch1(bx, xs, s.held, i + 96),
                                              d3, ab, mu, rs, w, mg, act));
        }
      }
      if (refill) {
        __syncwarp();
        copy_task<kVec>(s, p, xg + s.step * L.step, bx, &sc.bar[0][warp]);
      }
    }
  }
  // no block leaves while another may read its sums
  if (kBn && s.n > 1) cluster_sync();
}

// ---------------------------------------------------------------------------
// K8-BN's passes, for a channel past the largest cluster's shared memory

// The segment of this warp: task blockIdx.x kWarps + warp of the B C segs
// (row `row` of x, segment `seg`), floats [start, start + len) of x.
struct Segment {
  long long row, task, start;
  int len;
};

__device__ __forceinline__ bool my_segment(int N, int segs, long long tasks,
                                           Segment& t) {
  t.task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t.task >= tasks) return false;
  t.row = t.task / segs;
  const int seg = static_cast<int>(t.task - t.row * segs);
  t.start = t.row * N + static_cast<long long>(seg) * kSeg;
  t.len = min(kSeg, N - seg * kSeg);
  return true;
}

// The warp's sums of channel c's B x segs pairs in `part`: lane l adds rows
// l, l + 32, ... segment by segment, then the lanes' tree; every warp of
// the channel forms the same bits. Every lane gets them.
__device__ __forceinline__ double2 channel_sum(const double2* part, int B,
                                               int C, int segs, int c) {
  double a = 0.0, q = 0.0;
  for (int b = threadIdx.x & 31; b < B; b += 32) {
    const double2* row = part + (static_cast<long long>(b) * C + c) * segs;
    for (int i = 0; i < segs; ++i) {
      const double2 v = row[i];
      a += v.x;
      q += v.y;
    }
  }
  return make_double2(__shfl_sync(kFull, warp_sum(a), 0),
                      __shfl_sync(kFull, warp_sum(q), 0));
}

// K8-BN's first pass: each segment's (sum dz, sum dz xhat) in double.
template <bool kVec, typename S>
__global__ void __launch_bounds__(kThreads)
bn_bwd_partials(const S* __restrict__ x, const S* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, int C, int N, int segs,
                long long tasks, int act, double2* __restrict__ part) {
  Segment t;
  if (!my_segment(N, segs, tasks, t)) return;
  const int lane = threadIdx.x & 31;
  const int c = static_cast<int>(t.row % C);
  const float mu = mean[c], rs = rstd[c];
  const float2 ab = fold(scale[c], bias[c], mu, rs);
  const S* g = x + t.start;
  const S* e = dy + t.start;
  double s1 = 0.0, s2 = 0.0;
  if constexpr (kVec) {
    for (int j = lane * 4; j < t.len; j += 512) {
      const bool h1 = j + 128 < t.len, h2 = j + 256 < t.len,
                 h3 = j + 384 < t.len;
      const float4 d0 = ld4(e + j), d1 = h1 ? ld4(e + j + 128) : d0,
                   d2 = h2 ? ld4(e + j + 256) : d0,
                   d3 = h3 ? ld4(e + j + 384) : d0;
      const float4 v0 = ld4(g + j), v1 = h1 ? ld4(g + j + 128) : v0,
                   v2 = h2 ? ld4(g + j + 256) : v0,
                   v3 = h3 ? ld4(g + j + 384) : v0;
      add_grads_exact(v0, d0, ab, mu, rs, act, s1, s2);
      if (h1) add_grads_exact(v1, d1, ab, mu, rs, act, s1, s2);
      if (h2) add_grads_exact(v2, d2, ab, mu, rs, act, s1, s2);
      if (h3) add_grads_exact(v3, d3, ab, mu, rs, act, s1, s2);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < t.len; j += 32)
      add_grad_exact(to_f(g[j]), to_f(e[j]), ab, mu, rs, act, s1, s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) part[t.task] = make_double2(s1, s2);
}

// K8-BN's second pass: the warp's channel's sums from `part` (the warp of
// the channel's first segment writes dbias and dscale), m1 and m2, then dx.
// A lane's first four floats (float4s) of x and dy are loaded before the
// sums are added, the next four as each four are written.
template <bool kVec, typename S>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx(const S* __restrict__ x, const S* __restrict__ dy,
          const double2* __restrict__ part, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ mean,
          const float* __restrict__ rstd, int B, int C, int N, int segs,
          long long tasks, int act, S* __restrict__ dx,
          float* __restrict__ dscale, float* __restrict__ dbias) {
  Segment t;
  if (!my_segment(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;   // floats a load
  constexpr int kStep = 128 * kW;    // floats of a lane's four loads
  const int lane = threadIdx.x & 31;
  const int c = static_cast<int>(t.row % C);
  const S* g = x + t.start;
  const S* e = dy + t.start;
  S* o = dx + t.start;
  float v[4][kW], d[4][kW];
  auto fetch4 = [&](int j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + 32 * kW * k < t.len) {
        load<kVec>(g, j + 32 * kW * k, v[k]);
        load<kVec>(e, j + 32 * kW * k, d[k]);
      }
    }
  };
  fetch4(lane * kW);
  const double2 tot = channel_sum(part, B, C, segs, c);
  if (t.task == static_cast<long long>(c) * segs && lane == 0) {
    dbias[c] = static_cast<float>(tot.x);
    dscale[c] = static_cast<float>(tot.y);
  }
  const double r = scale[c] / (static_cast<double>(B) * N);
  const float2 mg = make_float2(static_cast<float>(r * tot.x),
                                static_cast<float>(r * tot.y));
  const float mu = mean[c], rs = rstd[c], w = scale[c];
  const float2 ab = fold(w, bias[c], mu, rs);
  for (int j = lane * kW; j < t.len; j += kStep) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + 32 * kW * k < t.len) {
#pragma unroll
        for (int i = 0; i < kW; ++i)
          v[k][i] = dx1(v[k][i], d[k][i], ab, mu, rs, w, mg, act);
        store<kVec>(o, j + 32 * kW * k, v[k]);
      }
    }
    if (j + kStep < t.len) fetch4(j + kStep);
  }
}

// ---------------------------------------------------------------------------
// host side

// Whether p is aligned to `bytes`: a lane's vector (16 bytes of float, 8 of
// bf16).
bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

bool bad_shape(int B, int C, int N, int G, int act) {
  return B < 1 || C < 1 || N < 1 || G < 1 || C % G != 0 || act < kNone
         || act > kRelu;
}

// The elements of a group's slab a cluster block can hold, at `esize` bytes
// an element.
constexpr long long held_most(int esize) {
  return (kSmemMost - kScratch) / esize / 4 * 4;
}

// The cluster plan of a group of `rows` rows of N elements of `esize` bytes
// at n blocks a cluster: the elements a block holds (the widest share,
// rounded up to whole vectors of four, at most held_most) and the elements
// of the group left in device memory.
struct GnPlan {
  int n, segs;
  long long tasks, res, remainder;
  size_t smem;
};

GnPlan plan_at(long long rows, int N, int n, int esize) {
  GnPlan p;
  p.n = n;
  p.segs = static_cast<int>(cdiv(N, kTask));
  p.tasks = rows * p.segs;
  long long len[kMostCluster], widest = 0;
  for (int r = 0; r < n; ++r) {
    len[r] = task_start((r + 1) * p.tasks / n, N, p.segs)
             - task_start(r * p.tasks / n, N, p.segs);
    widest = len[r] > widest ? len[r] : widest;
  }
  p.res = (widest + 3) / 4 * 4;
  if (p.res > held_most(esize)) p.res = held_most(esize);
  p.remainder = 0;
  for (int r = 0; r < n; ++r)
    if (len[r] > p.res) p.remainder += len[r] - p.res;
  p.smem = kScratch + static_cast<size_t>(esize) * p.res;
  return p;
}

// The smallest cluster (1, 2, 4, ... most blocks) whose blocks hold the
// whole slab; `most` where none does.
GnPlan choose(long long rows, int N, int most, int esize) {
  int n = 1;
  while (n < most && plan_at(rows, N, n, esize).remainder > 0) n *= 2;
  return plan_at(rows, N, n, esize);
}

bool cluster_size_ok(int n) {
  return n >= 1 && n <= kMostCluster && (n & (n - 1)) == 0;
}

template <typename S>
using FwdKernel = void (*)(const S*, const float*, const float*, int, int,
                           int, int, int, int, int, float, int, S*, float*,
                           float*, float*);
template <typename S>
using BwdKernel = void (*)(const S*, const S*, const float*, const float*,
                           const float*, const float*, int, int, int, int,
                           int, int, int, int, double2*, double2*, S*,
                           float*, float*);

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
// `threads` threads, `smem` bytes of dynamic shared memory.
struct GnLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int err = 0;

  GnLaunch(const void* kernel, long long blocks, int n, size_t smem,
           cudaStream_t s, int threads = kGnThreads) {
    err = prepare(kernel);
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(threads);
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

// info[0..7] of a cluster plan (see gn_plan) for `groups` groups, blocks
// of `threads` threads; the clusters the card holds at once of the forward
// and backward kernels (their blocks with `fwd_smem` and `bwd_smem` bytes
// of shared memory).
int plan_info(const GnPlan& p, long long groups, int threads,
              const void* fwd, size_t fwd_smem, const void* bwd,
              size_t bwd_smem, long long* info) {
  info[0] = p.n;
  info[1] = p.res;
  info[2] = static_cast<long long>(p.smem);
  info[3] = threads;
  info[4] = p.tasks;
  info[5] = p.remainder;
  info[6] = groups * p.n;
  info[7] = 0;
  const void* kernels[] = {fwd, bwd};
  const size_t smem[] = {fwd_smem, bwd_smem};
  for (int k = 0; k < 2; ++k) {
    const GnLaunch l(kernels[k], p.n, p.n, smem[k], 0, threads);
    if (l.err) return l.err;
    int clusters = 0;
    const int err = static_cast<int>(cudaOccupancyMaxActiveClusters(
        &clusters, kernels[k], &l.cfg));
    if (err) return err;
    info[7] = k == 0 || clusters < info[7] ? clusters : info[7];
  }
  return 0;
}

// flash-BN's routes: one block a channel, a cluster that holds it, a
// cluster that holds part of it (the rest read twice from device memory),
// or the two passes through device memory.
enum Route { kBlock = 0, kCluster = 1, kPartial = 2, kPasses = 3 };
// The route of a channel past the largest cluster: K7-BN's, and K8-BN's;
// K8-BN takes the passes off the vector grid too (N % 4 != 0), where its
// 4-byte cluster kernel lost to them on an H100 (PERF.md)
constexpr int kBnFwdPast = kPartial;
constexpr int kBnBwdPast = kPasses;

// Where one block takes a channel of at most kGnWarps tasks, K7-BN and
// K8-BN run blocks of kGnThreads / 2 threads, two an SM, so that one
// block's reduction and barriers overlap the other's loads and writes; and
// each block keeps a ring of two buffers (the next channel copied in while
// this one is reduced and written) where two such blocks fit an SM's
// kSmemSm bytes of shared memory (kSmemReserved of them the system's a
// block). Elsewhere blocks of kGnThreads, one buffer refilled task by
// task.
struct BnRing {
  int warps, stages;
  size_t smem;
};

BnRing bn_ring(const GnPlan& p, int esize) {
  BnRing r = {kGnWarps, 1, p.smem};
  if (p.n > 1 || p.tasks > kGnWarps) return r;
  r.warps = kGnWarps / 2;
  const size_t two = kScratch + 2 * static_cast<size_t>(esize) * p.res;
  if (2 * (two + kSmemReserved) <= kSmemSm) {
    r.stages = 2;
    r.smem = two;
  }
  return r;
}

template <bool kVec, typename S>
FwdKernel<S> bn_fwd_kernel(int warps) {
  return warps == kGnWarps ? gn_fwd_cluster<kVec, true, kGnWarps, S>
                           : gn_fwd_cluster<kVec, true, kGnWarps / 2, S>;
}

template <bool kVec, typename S>
BwdKernel<S> bn_bwd_kernel(int warps) {
  return warps == kGnWarps ? gn_bwd_cluster<kVec, true, kGnWarps, S>
                           : gn_bwd_cluster<kVec, true, kGnWarps / 2, S>;
}

// The passes' segments a row.
int bn_segs(int N) { return static_cast<int>(cdiv(N, kSeg)); }

// The C entries of groupnorm.cu, at storage type S (x, y, dy and dx; the
// rest float32); see there.

template <typename S>
int plan_gn(int B, int C, int N, int G, int most, long long* info) {
  if (bad_shape(B, C, N, G, kNone) || !cluster_size_ok(most))
    return cudaErrorInvalidValue;
  const GnPlan p = choose(C / G, N, most, sizeof(S));
  info[8] = 0;   // dy is not held
  return plan_info(
      p, static_cast<long long>(B) * G, kGnThreads,
      reinterpret_cast<const void*>(gn_fwd_cluster<true, false, kGnWarps, S>),
      p.smem,
      reinterpret_cast<const void*>(gn_bwd_cluster<true, false, kGnWarps, S>),
      p.smem, info);
}

template <typename S>
int launch_gn_fwd(const void* xv, const float* scale, const float* bias,
                  void* yv, float* mean, float* rstd, int B, int C, int N,
                  int G, float eps, int act, int cluster, int clusters,
                  cudaStream_t stream) {
  const S* x = static_cast<const S*>(xv);
  S* y = static_cast<S*>(yv);
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan p = plan_at(C / G, N, cluster, sizeof(S));
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  const size_t vb = 4 * sizeof(S);
  const bool vec = N % 4 == 0 && aligned(x, vb) && aligned(y, vb);
  const FwdKernel<S> kernel = vec ? gn_fwd_cluster<true, false, kGnWarps, S>
                                  : gn_fwd_cluster<false, false, kGnWarps, S>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   p.smem, stream);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, scale, bias, B, C, G, N, p.segs,
      static_cast<int>(p.res), 1, eps, act, y, mean, rstd,
      static_cast<float*>(nullptr)));
}

template <typename S>
int launch_gn_bwd(const void* xv, const void* dyv, const float* scale,
                  const float* bias, const float* mean, const float* rstd,
                  void* dxv, float* dscale, float* dbias, void* work, int B,
                  int C, int N, int G, int act, int cluster, int clusters,
                  cudaStream_t stream) {
  const S* x = static_cast<const S*>(xv);
  const S* dy = static_cast<const S*>(dyv);
  S* dx = static_cast<S*>(dxv);
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan p = plan_at(C / G, N, cluster, sizeof(S));
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  auto* part = static_cast<double2*>(work);
  auto* rowsum = part + static_cast<size_t>(B) * C * p.segs;
  const size_t vb = 4 * sizeof(S);
  const bool vec = N % 4 == 0 && aligned(x, vb) && aligned(dy, vb)
                   && aligned(dx, vb);
  const BwdKernel<S> kernel = vec ? gn_bwd_cluster<true, false, kGnWarps, S>
                                  : gn_bwd_cluster<false, false, kGnWarps, S>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   p.smem, stream);
  if (l.err) return l.err;
  int err = static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, dy, scale, bias, mean, rstd, B, C, G, N, p.segs,
      static_cast<int>(p.res), 1, act, part, rowsum, dx,
      static_cast<float*>(nullptr), static_cast<float*>(nullptr)));
  if (err) return err;
  gn_bwd_channels<<<static_cast<unsigned>(cdiv(C, kThreads)), kThreads, 0,
                    stream>>>(rowsum, B, C, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int plan_bn(int B, int C, int N, int most, long long* info) {
  if (bad_shape(B, C, N, 1, kNone) || !cluster_size_ok(most))
    return cudaErrorInvalidValue;
  const GnPlan p = choose(B, N, most, sizeof(S));
  const BnRing r = bn_ring(p, sizeof(S));
  const int err = plan_info(
      p, C, 32 * r.warps,
      reinterpret_cast<const void*>(bn_fwd_kernel<true, S>(r.warps)), r.smem,
      reinterpret_cast<const void*>(bn_bwd_kernel<true, S>(r.warps)), r.smem,
      info);
  if (err) return err;
  const int held = p.remainder ? -1 : p.n == 1 ? kBlock : kCluster;
  info[8] = held < 0 ? kBnFwdPast : held;
  // K8-BN: the passes also off the vector grid, and on the bf16 route for
  // a channel only the largest cluster holds (MANNER's (16, 60, 64084):
  // 0.228 ms against 0.293 on an H100, PERF.md)
  const bool passes = N % 4 || (sizeof(S) == 2 && p.n == kMostCluster);
  info[9] = held < 0 ? kBnBwdPast : passes ? kPasses : held;
  info[10] = info[8] == kPasses || info[9] == kPasses
                 ? static_cast<long long>(B) * C * bn_segs(N)
                       * static_cast<long long>(sizeof(double2))
                 : 0;
  info[11] = r.stages;
  info[12] = static_cast<long long>(r.smem);
  return 0;
}

template <typename S>
int launch_bn_fwd(const void* xv, const float* scale, const float* bias,
                  void* yv, float* mean, float* var, float* rstd, int B,
                  int C, int N, float eps, int act, int route, int cluster,
                  int clusters, cudaStream_t stream) {
  const S* x = static_cast<const S*>(xv);
  S* y = static_cast<S*>(yv);
  if (bad_shape(B, C, N, 1, act) || route < kBlock || route >= kPasses)
    return cudaErrorInvalidValue;
  const size_t vb = 4 * sizeof(S);
  const bool vec = N % 4 == 0 && aligned(x, vb) && aligned(y, vb);
  if (!cluster_size_ok(cluster) || clusters < 1 || clusters > C)
    return cudaErrorInvalidValue;
  const GnPlan p = plan_at(B, N, cluster, sizeof(S));
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  const BnRing r = bn_ring(p, sizeof(S));
  const FwdKernel<S> kernel = vec ? bn_fwd_kernel<true, S>(r.warps)
                                  : bn_fwd_kernel<false, S>(r.warps);
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   r.smem, stream, 32 * r.warps);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, scale, bias, B, C, C, N, p.segs,
      static_cast<int>(p.res), r.stages, eps, act, y, mean, rstd, var));
}

template <typename S>
int launch_bn_bwd(const void* xv, const void* dyv, const float* scale,
                  const float* bias, const float* mean, const float* rstd,
                  void* dxv, float* dscale, float* dbias, void* work, int B,
                  int C, int N, int act, int route, int cluster, int clusters,
                  cudaStream_t stream) {
  const S* x = static_cast<const S*>(xv);
  const S* dy = static_cast<const S*>(dyv);
  S* dx = static_cast<S*>(dxv);
  if (bad_shape(B, C, N, 1, act) || route < kBlock || route > kPasses)
    return cudaErrorInvalidValue;
  const size_t vb = 4 * sizeof(S);
  const bool vec = N % 4 == 0 && aligned(x, vb) && aligned(dy, vb)
                   && aligned(dx, vb);
  if (route == kPasses) {
    const int segs = bn_segs(N);
    const long long tasks = static_cast<long long>(B) * C * segs;
    const unsigned blocks = static_cast<unsigned>(cdiv(tasks, kWarps));
    auto* part = static_cast<double2*>(work);
    if (vec) {
      bn_bwd_partials<true, S><<<blocks, kThreads, 0, stream>>>(
          x, dy, scale, bias, mean, rstd, C, N, segs, tasks, act, part);
      bn_bwd_dx<true, S><<<blocks, kThreads, 0, stream>>>(
          x, dy, part, scale, bias, mean, rstd, B, C, N, segs, tasks, act,
          dx, dscale, dbias);
    } else {
      bn_bwd_partials<false, S><<<blocks, kThreads, 0, stream>>>(
          x, dy, scale, bias, mean, rstd, C, N, segs, tasks, act, part);
      bn_bwd_dx<false, S><<<blocks, kThreads, 0, stream>>>(
          x, dy, part, scale, bias, mean, rstd, B, C, N, segs, tasks, act,
          dx, dscale, dbias);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (!cluster_size_ok(cluster) || clusters < 1 || clusters > C)
    return cudaErrorInvalidValue;
  const GnPlan p = plan_at(B, N, cluster, sizeof(S));
  if (p.tasks < cluster) return cudaErrorInvalidValue;
  const BnRing r = bn_ring(p, sizeof(S));
  const BwdKernel<S> kernel = vec ? bn_bwd_kernel<true, S>(r.warps)
                                  : bn_bwd_kernel<false, S>(r.warps);
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   r.smem, stream, 32 * r.warps);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, x, dy, scale, bias, mean, rstd, B, C, C, N, p.segs,
      static_cast<int>(p.res), r.stages, act,
      static_cast<double2*>(nullptr),
      static_cast<double2*>(nullptr), dx, dscale, dbias));
}

}  // namespace
