// The bf16 route of flash-GN and flash-BN (K7, K8, K7-BN, K8-BN;
// groupnorm.cuh): the bf16 instantiations behind groupnorm.cu's C entries,
// in their own translation unit so that nvcc compiles the two routes in
// parallel, and K7-bf16's and K8-bf16's kernels of their own for the
// GroupNorm grid.
//
// K7-bf16 and K8-bf16 on the 16-byte grid (gn_fwd16, gn_bwd16: N % 8 == 0
// and x, y, dy and dx 16-byte aligned, every class of an SGMSE+ or IDMSE
// evaluation). Bound, as the float32 route's: bytes, 2 an element each way
// (K7 4 an element, K8 6). Each (b, g) group is one cluster's, as in
// gn_fwd_cluster / gn_bwd_cluster, with the same tasks, shares and cluster
// plan (the smallest cluster whose blocks hold the slab of x); what differs
// is the memory path (PERF.md has each step's time on an H100):
//
// * Every task and share starts on a 16-byte boundary (N % 8 == 0), so a
//   warp copies its tasks' held part with TMA bulk copies on its mbarrier
//   (the next group's as each task's outputs are out), a lane moves 8
//   elements (16 bytes) at a time, and a task's outputs over its held part
//   are written in place of x in shared memory and leave in one TMA bulk
//   store: the warps go on computing while their stores drain (on an
//   H100 the forward took 0.359 ms at (4, 256, 256, 501) with per-lane
//   stores, which it waited for, and 0.32 with these).
// * K8 holds dy as well, in the shared memory the slab of x leaves (a
//   bf16 slab takes half the bytes of a float32 one, so the cluster does
//   not grow): a block's first res_dy elements of dy (plan16) arrive
//   with x, and the first pass and the dx pass read both from shared
//   memory. Where dy does not fit beside x (the U-Net's (4, 256, 256, 501):
//   50,688 of a block's 64,512), the rest is read from device memory in
//   both passes, a task's four vectors at once, the second time mostly
//   from L2. The float32 route's finding that a held dy costs more than it
//   saves (groupnorm.cuh) came from the cluster doubling to hold it; here
//   it does not.
// * K8's m1 and m2 need only the group's sums weighted by each row's
//   scale: each lane adds scale[c] times its task sums, and the cluster
//   reduces them over DSMEM in rank order as K7 does its statistics, so no
//   sums go through L2 between the two passes. Each task's (sum dz, sum dz
//   xhat) still goes to `part`, and a second launch (gn_bwd_rows, a warp a
//   channel, 0.008 ms at that shape on an H100) sums dscale and dbias over
//   the segments and then the batch in order. Folding it into the cluster
//   kernel needs the last cluster of a channel to know it is last (an
//   integer ticket that must read zero at every call): the second launch
//   is kept.
// * SiLU's sigmoid comes from the SFU's ex2 and reciprocal (sigmoid16).
//
// Both keep what the 8-byte route keeps: statistics and sums in double in a
// fixed order (a lane's 8 elements in float, then double), no float
// atomics (two runs are bitwise equal), dz recomputed by one expression in
// both passes, y and dx rounded to bf16 once, where they are written, and
// mean, rstd, dscale and dbias float32. Off that grid (N % 8 != 0, an
// unaligned view) K7-bf16 and K8-bf16 take the template kernels at bf16
// (8-byte vectors, or one element at a time), with the same cluster.

#include <initializer_list>

#include "groupnorm.cuh"

namespace {

constexpr int kV = 8;                   // bf16 a 16-byte vector
constexpr int kVecs = kTask / (32 * kV);   // vectors a lane of a task
// elements of x and dy a block's shared memory holds on the 16-byte route
constexpr long long kHeld16 = (kSmemMost - kScratch) / 2 / kV * kV;

__device__ __forceinline__ void unpack8(uint4 q, float (&v)[kV]) {
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
  v[4] = __uint_as_float(q.z << 16);
  v[5] = __uint_as_float(q.z & 0xffff0000u);
  v[6] = __uint_as_float(q.w << 16);
  v[7] = __uint_as_float(q.w & 0xffff0000u);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[kV]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// 16 bytes at p (shared or device memory)
__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The activation at compile time (Act), SiLU's sigmoid from the SFU's ex2
// and reciprocal (__expf, __fdividef): a relative error near 1e-6, far
// under bf16's half ulp (2^-9) on y and dx and under float32's 100 dB on
// the double sums, in a fifth of the instructions of expf and an IEEE
// divide (with those K8 took 0.686 ms against 0.605-0.629 on an H100,
// PERF.md; K7 the same within the spread). The forward and both passes of
// the backward use these, so dz has one expression.
__device__ __forceinline__ float sigmoid16(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

template <int kAct>
__device__ __forceinline__ float act16(float z) {
  if constexpr (kAct == kSilu) return z * sigmoid16(z);
  if constexpr (kAct == kRelu) return fmaxf(z, 0.f);
  return z;
}

// dy act'(z)
template <int kAct>
__device__ __forceinline__ float act16_bwd(float z, float dy) {
  if constexpr (kAct == kSilu) {
    const float s = sigmoid16(z);
    return dy * (s * (1.f + z * (1.f - s)));
  }
  if constexpr (kAct == kRelu) return z > 0.f ? dy : 0.f;
  return dy;
}

// What a block holds of each group on the 16-byte route: its share of x
// (Share::held elements, at sx) and the first held_dy elements of its share
// of dy (at sd).
struct Held16 {
  const Share& s;
  int held_dy;
  bf16 *sx, *sd;
};

// A task's held elements of a tensor whose first `held` elements of the
// share sit in shared memory
__device__ __forceinline__ unsigned held_of(const Piece& p, int held) {
  return p.off < held ? static_cast<unsigned>(min(
             static_cast<long long>(p.len), held - p.off))
                      : 0u;
}

// Lane 0 of each warp sets its mbarrier to expect the held bytes of x and
// dy (none for K7) of its tasks of a group.
__device__ __forceinline__ void expect16(const Held16& h, int N, int segs,
                                         unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned n = 0;
  for (long long t = h.s.t0 + (threadIdx.x >> 5); t < h.s.t1; t += kGnWarps) {
    const Piece p = piece<false>(h.s, t, N, segs, 0);
    n += held_of(p, h.s.held) + held_of(p, h.held_dy);
  }
  mbar_expect(bar, 2u * n);
}

// The held part of one task of a group (xg, dg: the group's share in device
// memory; K7 holds no dy): lane 0 issues the bulk copies, completing on the
// warp's mbarrier. The lanes' reads of this part of the buffers (generic
// proxy) come before the copies' writes (async proxy).
__device__ __forceinline__ void copy16(const Held16& h, const Piece& p,
                                       const bf16* xg, const bf16* dg,
                                       unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  const unsigned nx = held_of(p, h.s.held), nd = held_of(p, h.held_dy);
  if (nx + nd == 0) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (nx)
    bulk_load(reinterpret_cast<float*>(h.sx + p.off),
              reinterpret_cast<const float*>(xg + p.off), 2u * nx, bar);
  if (nd)
    bulk_load(reinterpret_cast<float*>(h.sd + p.off),
              reinterpret_cast<const float*>(dg + p.off), 2u * nd, bar);
}

// A task's output over its held part, written in place of x in shared
// memory, goes to device memory (og: the group's share) in one TMA bulk
// store that lane 0 issues once every lane's writes are visible to the
// async proxy: the warp does not wait for its stores to drain.
__device__ __forceinline__ void store16(const Held16& h, const Piece& p,
                                        bf16* og) {
  const unsigned n = held_of(p, h.s.held);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) != 0 || n == 0) return;
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          og + p.off),
      "r"(smem_addr(h.sx + p.off)), "r"(2u * n)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Lane 0 waits until its bulk stores have read their shared memory (before
// the next group's copy overwrites it), or, with kDone, have completed.
template <bool kDone = false>
__device__ __forceinline__ void stores_read() {
  if ((threadIdx.x & 31) != 0) return;
  if constexpr (kDone) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The warp's tasks of the block's first group (xg, dg as copy16's): the
// mbarrier's expectation, then the copies.
__device__ __forceinline__ void copy_group16(const Held16& h, int N,
                                             int segs, const bf16* xg,
                                             const bf16* dg,
                                             unsigned long long* bar) {
  expect16(h, N, segs, bar);
  for (long long t = h.s.t0 + (threadIdx.x >> 5); t < h.s.t1; t += kGnWarps)
    copy16(h, piece<false>(h.s, t, N, segs, 0), xg, dg, bar);
}

// A lane's vectors of a task of x (K7) or dy (K8; sm: the held part in
// shared memory, g: the share in device memory): from shared memory where
// held, else from device memory, all loaded before any is used (so that
// the loads from device memory are in flight together). K8 loads x a
// vector at a time beside them: four of each would pass a thread's 128
// registers.
__device__ __forceinline__ void load_vecs(const bf16* sm, const bf16* g,
                                          int held, const Piece& p,
                                          uint4 (&q)[kVecs]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    const int j = lane * kV + 32 * kV * m;
    if (j < p.len) {
      const long long i = p.off + j;
      q[m] = ld16(i < held ? sm + i : g + i);
    }
  }
}

// Thread 0 sets up each warp's mbarrier.
__device__ __forceinline__ void init_bars(Scratch& sc) {
  if (threadIdx.x == 0) {
    for (int w = 0; w < kGnWarps; ++w) mbar_init(&sc.bar[0][w]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// K7-bf16 on the 16-byte grid, activation kAct. The groups, clusters and
// shares as gn_fwd_cluster's (GroupNorm, one buffer); kScratch + 2 res
// bytes of dynamic shared memory.
template <int kAct>
__global__ void __launch_bounds__(kGnThreads, 1)
gn_fwd16(const bf16* __restrict__ x, const float* __restrict__ scale,
         const float* __restrict__ bias, int B, int C, int G, int N,
         int segs, int res, float eps, bf16* __restrict__ y,
         float* __restrict__ mean, float* __restrict__ rstd) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Groups L = groups<false>(B, C, G, N);
  const Share s = my_share(L.rows, N, segs, res);
  const Held16 h{s, 0, reinterpret_cast<bf16*>(smem + kScratch), nullptr};
  unsigned long long* bar = &sc.bar[0][warp];
  init_bars(sc);
  copy_group16(h, N, segs, x + s.grp0 * L.step + s.p0, nullptr, bar);
  unsigned k = 0;   // the block's groups so far
  for (long long grp = s.grp0; grp < L.count; grp += s.step, ++k) {
    const bf16* xg = x + grp * L.step + s.p0;
    const bool next = grp + s.step < L.count;
    mbar_wait(bar, k & 1);
    double sum = 0.0, sq = 0.0;
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece<false>(s, t, N, segs, 0);
      uint4 q[kVecs];
      load_vecs(h.sx, xg, s.held, p, q);
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        if (lane * kV + 32 * kV * m >= p.len) continue;
        float v[kV];
        unpack8(q[m], v);
        // a lane's 8 elements in float, then into the double sums
        float a = v[0], qq = __fmul_rn(v[0], v[0]);
#pragma unroll
        for (int i = 1; i < kV; ++i) {
          a = __fadd_rn(a, v[i]);
          qq = __fmaf_rn(v[i], v[i], qq);
        }
        sum += a;
        sq += qq;
      }
    }
    const double2 tot = cluster_sum<kGnWarps>(sum, sq, sc, k & 1, s.n,
                                              false);
    if (threadIdx.x == 0) {
      const double n = static_cast<double>(L.step), md = tot.x / n;
      const double vd = tot.y / n - md * md;
      const float m = static_cast<float>(md);
      const float rs = static_cast<float>(1.0 / sqrt(vd + eps));
      sc.stat = make_float2(m, rs);
      if (s.rank == 0) {
        mean[grp] = m;
        rstd[grp] = rs;
      }
    }
    __syncthreads();
    const float2 st = sc.stat;
    bf16* yg = y + grp * L.step + s.p0;
    // each task of the next group copied in as this one's is written
    if (next) expect16(h, N, segs, bar);
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece<false>(s, t, N, segs, 0);
      const int c = channel<false>(grp, p.k, G, L.rows);
      const float2 ab = fold(scale[c], bias[c], st.x, st.y);
      uint4 q[kVecs];
      load_vecs(h.sx, xg, s.held, p, q);
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int j = lane * kV + 32 * kV * m;
        if (j >= p.len) continue;
        float v[kV];
        unpack8(q[m], v);
#pragma unroll
        for (int i = 0; i < kV; ++i)
          v[i] = act16<kAct>(__fmaf_rn(v[i], ab.x, ab.y));
        const long long i = p.off + j;
        *reinterpret_cast<uint4*>(i < s.held ? h.sx + i : yg + i) = pack8(v);
      }
      store16(h, p, yg);
      if (next) {
        stores_read();
        copy16(h, p, xg + s.step * L.step, nullptr, bar);
      }
    }
  }
  stores_read<true>();
  // no block leaves while another may read its sums
  cluster_sync();
}

// dz's two sums over a lane's 8 elements of x and dy, in float, then into
// the double sums (dx8 recomputes dz with the same expression)
template <int kAct>
__device__ __forceinline__ void grads8(uint4 qx, uint4 qd, float2 ab,
                                       float mu, float rs, double& s1,
                                       double& s2) {
  float xv[kV], dv[kV];
  unpack8(qx, xv);
  unpack8(qd, dv);
  float a = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float dz = act16_bwd<kAct>(__fmaf_rn(xv[i], ab.x, ab.y), dv[i]);
    a = __fadd_rn(a, dz);
    q = __fmaf_rn(dz, __fmul_rn(__fsub_rn(xv[i], mu), rs), q);
  }
  s1 += a;
  s2 += q;
}

template <int kAct>
__device__ __forceinline__ uint4 dx8(uint4 qx, uint4 qd, float2 ab, float mu,
                                     float rs, float w, float2 mg) {
  float xv[kV], dv[kV];
  unpack8(qx, xv);
  unpack8(qd, dv);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float dz = act16_bwd<kAct>(__fmaf_rn(xv[i], ab.x, ab.y), dv[i]);
    const float xhat = __fmul_rn(__fsub_rn(xv[i], mu), rs);
    xv[i] = rs * (dz * w - mg.x - xhat * mg.y);
  }
  return pack8(xv);
}

// K8-bf16's first launch on the 16-byte grid, activation kAct. The groups,
// clusters and shares as K7's; kScratch + 2 (res + res_dy) bytes of
// dynamic shared memory, the first res_dy elements of each block's share
// of dy held after its res of x. Writes each task's (sum dz, sum dz xhat)
// to `part` (B C segs) and dx.
template <int kAct>
__global__ void __launch_bounds__(kGnThreads, 1)
gn_bwd16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
         const float* __restrict__ scale, const float* __restrict__ bias,
         const float* __restrict__ mean, const float* __restrict__ rstd,
         int B, int C, int G, int N, int segs, int res, int res_dy,
         double2* __restrict__ part, bf16* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch& sc = *reinterpret_cast<Scratch*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Groups L = groups<false>(B, C, G, N);
  const Share s = my_share(L.rows, N, segs, res);
  const Held16 h{s, static_cast<int>(min(s.len, static_cast<long long>(
                                                    res_dy))),
                 reinterpret_cast<bf16*>(smem + kScratch),
                 reinterpret_cast<bf16*>(smem + kScratch) + res};
  unsigned long long* bar = &sc.bar[0][warp];
  init_bars(sc);
  copy_group16(h, N, segs, x + s.grp0 * L.step + s.p0,
               dy + s.grp0 * L.step + s.p0, bar);
  unsigned k = 0;   // the block's groups so far
  for (long long grp = s.grp0; grp < L.count; grp += s.step, ++k) {
    const bf16* xg = x + grp * L.step + s.p0;
    const bf16* dg = dy + grp * L.step + s.p0;
    const bool next = grp + s.step < L.count;
    const float mu = mean[grp], rs = rstd[grp];
    const long long first = grp * L.rows;
    mbar_wait(bar, k & 1);
    double w1 = 0.0, w2 = 0.0;   // the lane's sums, scale-weighted
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece<false>(s, t, N, segs, 0);
      const int c = channel<false>(grp, p.k, G, L.rows);
      const float w = scale[c];
      const float2 ab = fold(w, bias[c], mu, rs);
      uint4 qd[kVecs];
      load_vecs(h.sd, dg, h.held_dy, p, qd);
      double s1 = 0.0, s2 = 0.0;
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int j = lane * kV + 32 * kV * m;
        if (j >= p.len) continue;
        const long long i = p.off + j;
        grads8<kAct>(ld16(i < s.held ? h.sx + i : xg + i), qd[m], ab, mu, rs,
                     s1, s2);
      }
      w1 += w * s1;
      w2 += w * s2;
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) part[first * segs + t] = make_double2(s1, s2);
    }
    // m1 and m2: the group's scale-weighted sums over DSMEM, in rank order
    const double2 tot = cluster_sum<kGnWarps>(w1, w2, sc, k & 1, s.n,
                                              false);
    if (threadIdx.x == 0) {
      const double n = static_cast<double>(L.step);
      sc.stat = make_float2(static_cast<float>(tot.x / n),
                            static_cast<float>(tot.y / n));
    }
    __syncthreads();
    const float2 mg = sc.stat;
    bf16* dxg = dx + grp * L.step + s.p0;
    // each task of the next group copied in as this one's is written
    // each task of the next group copied in as this one's is written
    if (next) expect16(h, N, segs, bar);
    for (long long t = s.t0 + warp; t < s.t1; t += kGnWarps) {
      const Piece p = piece<false>(s, t, N, segs, 0);
      const int c = channel<false>(grp, p.k, G, L.rows);
      const float w = scale[c];
      const float2 ab = fold(w, bias[c], mu, rs);
      uint4 qd[kVecs];
      load_vecs(h.sd, dg, h.held_dy, p, qd);
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const int j = lane * kV + 32 * kV * m;
        if (j >= p.len) continue;
        const long long i = p.off + j;
        const uint4 out = dx8<kAct>(ld16(i < s.held ? h.sx + i : xg + i),
                                    qd[m], ab, mu, rs, w, mg);
        *reinterpret_cast<uint4*>(i < s.held ? h.sx + i : dxg + i) = out;
      }
      store16(h, p, dxg);
      if (next) {
        stores_read();
        copy16(h, p, xg + s.step * L.step, dg + s.step * L.step, bar);
      }
    }
  }
  stores_read<true>();
  // no block leaves while another may read its sums
  cluster_sync();
}

// K8-bf16's second launch on the 16-byte grid: a warp a channel c sums each
// (b, c) row's task pairs in `part` (lanes over the segments, then the
// warp's tree), then the rows over the batch in order: dbias and dscale.
__global__ void __launch_bounds__(kThreads)
gn_bwd_rows(const double2* __restrict__ part, int B, int C, int segs,
            float* __restrict__ dscale, float* __restrict__ dbias) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  double t1 = 0.0, t2 = 0.0;
  for (int b = 0; b < B; ++b) {
    const double2* row = part + (static_cast<long long>(b) * C + c) * segs;
    double s1 = 0.0, s2 = 0.0;
    for (int i = lane; i < segs; i += 32) {
      const double2 q = row[i];
      s1 += q.x;
      s2 += q.y;
    }
    t1 += warp_sum(s1);
    t2 += warp_sum(s2);
  }
  if (lane == 0) {
    dbias[c] = static_cast<float>(t1);
    dscale[c] = static_cast<float>(t2);
  }
}

// The 16-byte route's plan at n blocks a cluster: the template plan's (the
// same cluster), the held elements of x rounded up to whole vectors, and
// the elements of dy held in the shared memory x leaves; smem is K8's,
// smem_fwd K7's.
struct GnPlan16 {
  GnPlan p;
  long long res_dy;
  size_t smem_fwd, smem;
};

GnPlan16 plan16(long long rows, int N, int n) {
  GnPlan16 q;
  q.p = plan_at(rows, N, n, sizeof(bf16));
  q.p.res = (q.p.res + kV - 1) / kV * kV;
  if (q.p.res > kHeld16) q.p.res = kHeld16;
  q.res_dy = q.p.res < kHeld16 - q.p.res ? q.p.res : kHeld16 - q.p.res;
  q.smem_fwd = kScratch + sizeof(bf16) * q.p.res;
  q.smem = q.smem_fwd + sizeof(bf16) * q.res_dy;
  q.p.smem = q.smem;
  return q;
}

// Whether K7/K8-bf16 take the 16-byte route: N a whole number of vectors
// and every tensor 16-byte aligned.
bool grid16(int N, std::initializer_list<const void*> ptrs) {
  if (N % kV) return false;
  for (const void* q : ptrs)
    if (!aligned(q, 16)) return false;
  return true;
}

}  // namespace

namespace gn_bf16 {

// The plan of the 16-byte route (the off-grid route takes the same cluster
// with its own held elements): info[0..7] as plan_gn's, info[1] the held
// elements of x and info[2] K8's shared memory, info[8] the held elements
// of dy.
int gn_plan(int B, int C, int N, int G, int most, long long* info) {
  if (bad_shape(B, C, N, G, kNone) || !cluster_size_ok(most))
    return cudaErrorInvalidValue;
  const int n = choose(C / G, N, most, sizeof(bf16)).n;
  const GnPlan16 q = plan16(C / G, N, n);
  info[8] = q.res_dy;
  return plan_info(q.p, static_cast<long long>(B) * G, kGnThreads,
                   reinterpret_cast<const void*>(gn_fwd16<kSilu>),
                   q.smem_fwd,
                   reinterpret_cast<const void*>(gn_bwd16<kSilu>), q.smem,
                   info);
}

int gn_fwd(const void* xv, const float* scale, const float* bias, void* yv,
           float* mean, float* rstd, int B, int C, int N, int G, float eps,
           int act, int cluster, int clusters, cudaStream_t stream) {
  if (!grid16(N, {xv, yv}))
    return launch_gn_fwd<bf16>(xv, scale, bias, yv, mean, rstd, B, C, N, G,
                               eps, act, cluster, clusters, stream);
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan16 q = plan16(C / G, N, cluster);
  if (q.p.tasks < cluster) return cudaErrorInvalidValue;
  const auto kernel = act == kSilu   ? gn_fwd16<kSilu>
                      : act == kRelu ? gn_fwd16<kRelu>
                                     : gn_fwd16<kNone>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   q.smem_fwd, stream);
  if (l.err) return l.err;
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, static_cast<const bf16*>(xv), scale, bias, B, C, G, N,
      q.p.segs, static_cast<int>(q.p.res), eps, static_cast<bf16*>(yv), mean,
      rstd));
}

int gn_bwd(const void* xv, const void* dyv, const float* scale,
           const float* bias, const float* mean, const float* rstd, void* dxv,
           float* dscale, float* dbias, void* work, int B, int C, int N,
           int G, int act, int cluster, int clusters, cudaStream_t stream) {
  if (!grid16(N, {xv, dyv, dxv}))
    return launch_gn_bwd<bf16>(xv, dyv, scale, bias, mean, rstd, dxv, dscale,
                               dbias, work, B, C, N, G, act, cluster,
                               clusters, stream);
  if (bad_shape(B, C, N, G, act) || !cluster_size_ok(cluster)
      || clusters < 1 || clusters > static_cast<long long>(B) * G)
    return cudaErrorInvalidValue;
  const GnPlan16 q = plan16(C / G, N, cluster);
  if (q.p.tasks < cluster) return cudaErrorInvalidValue;
  auto* part = static_cast<double2*>(work);
  const auto kernel = act == kSilu   ? gn_bwd16<kSilu>
                      : act == kRelu ? gn_bwd16<kRelu>
                                     : gn_bwd16<kNone>;
  const GnLaunch l(reinterpret_cast<const void*>(kernel),
                   static_cast<long long>(clusters) * cluster, cluster,
                   q.smem, stream);
  if (l.err) return l.err;
  int err = static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, kernel, static_cast<const bf16*>(xv),
      static_cast<const bf16*>(dyv), scale, bias, mean, rstd, B, C, G, N,
      q.p.segs, static_cast<int>(q.p.res), static_cast<int>(q.res_dy), part,
      static_cast<bf16*>(dxv)));
  if (err) return err;
  gn_bwd_rows<<<static_cast<unsigned>(cdiv(C, kWarps)), kThreads, 0,
                stream>>>(part, B, C, q.p.segs, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

int bn_plan(int B, int C, int N, int most, long long* info) {
  return plan_bn<bf16>(B, C, N, most, info);
}

int bn_fwd(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* var, float* rstd, int B, int C, int N,
           float eps, int act, int route, int cluster, int clusters,
           cudaStream_t stream) {
  return launch_bn_fwd<bf16>(x, scale, bias, y, mean, var, rstd, B, C, N,
                             eps, act, route, cluster, clusters, stream);
}

int bn_bwd(const void* x, const void* dy, const float* scale,
           const float* bias, const float* mean, const float* rstd, void* dx,
           float* dscale, float* dbias, void* work, int B, int C, int N,
           int act, int route, int cluster, int clusters,
           cudaStream_t stream) {
  return launch_bn_bwd<bf16>(x, dy, scale, bias, mean, rstd, dx, dscale,
                             dbias, work, B, C, N, act, route, cluster,
                             clusters, stream);
}

}  // namespace gn_bf16
