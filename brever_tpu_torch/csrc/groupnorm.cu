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
// flash-BN, forward (K7-BN) and backward (K8-BN), replaces the same Pallas
// kernels as gn_act_stats_pallas launches them for a BatchNorm (num_groups =
// C over a (1, N, C) view). Here the statistics of channel c span all B rows
// of x (B, C, N): the (b, c) slabs are B contiguous runs of N floats, so the
// same passes serve with merges that span the batch rows, and no copy to
// (C, B N):
//
//   mean, var, rstd per c over the B N elements of the channel
//   y = act(x a + b),  a = scale[c] rstd,  b = bias[c] - mean a
//   m1 = scale[c] sum_{b, i} dz / (B N),  m2 = scale[c] sum_{b, i} dz xhat
//        / (B N),  dscale[c] and dbias[c] the same sums
//   dx = rstd (dz scale[c] - m1 - xhat m2)
//
// bn_fwd: gn_stats, bn_merge (one warp a channel, B x segs partials in
// order, writes mean, var and rstd and the folded affine of every (b, c)
// row), gn_apply. bn_bwd: gn_bwd_partials with the channel's statistics,
// bn_bwd_channels (one warp a channel: dscale, dbias and m1, m2 from B x segs
// partials in order), gn_bwd_dx. No channel cap and no byte floor (the Pallas
// path's are Mosaic's). Bound: bytes, as K7/K8's: 8 bytes an element forward
// (x read, y written) and 12 backward (x, dy read, dx written) at the least.
//
// Bound: bytes. The forward must read x twice (the statistics come before
// the first output) and write y once, 12 bytes an element; the backward reads
// x and dy twice and writes dx, 20 bytes an element. At the NCSN++ U-Net's
// width one evaluation of a 4 s item sends 1.567 GB of GroupNorm input
// through, 1.40 ms of forward and 2.34 ms of backward at 3.35 TB/s. A few
// flops an element (one exp for SiLU) are far below the card's rate.
//
// Design. The Pallas kernel walks (b, phase, chunk) in order and carries its
// sums in VMEM; blocks here run in no order, so each direction is split at
// its reductions:
//
// * A task is one segment of up to kSeg elements of one (b, c) row, taken by
//   one warp; a block holds kWarps tasks. A row of N = 128,256 (256 x 501) is
//   32 tasks, a row of 32 (4 x 8) one, so the large tensors get thousands of
//   blocks and the small ones no empty ones.
// * K7: gn_stats writes each task's (sum x, sum x^2) in double; gn_merge sums
//   a group's partials in a fixed order (one warp a group) into mean and rstd
//   and folds the affine into one (a, b) pair a channel; gn_apply writes y.
// * K8: gn_bwd_partials writes each task's (sum dz, sum dz xhat), recomputing
//   z and the activation's derivative from x; gn_bwd_groups sums each row's
//   partials and each group's m1 and m2 in a fixed order; gn_bwd_channels
//   sums dscale and dbias over the batch in order; gn_bwd_dx writes dx.
// * Loads and stores are 16 bytes a lane where N is a multiple of 4 and the
//   tensors are 16-byte aligned (every shape of the U-Net), else 4.
//
// No float atomics: two runs give bitwise-equal outputs and gradients. The
// statistics and every reduction are summed in double. Every pointer is a
// dense float32 buffer; `work` is gn_workspace(B, C, N, G) bytes.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;               // tasks (warps) of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 4096;              // elements of a row one task takes
constexpr unsigned kFull = 0xffffffffu;

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
// K7

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

// One warp a group (b, g): its C/G rows' partials in order.
__global__ void __launch_bounds__(kThreads)
gn_merge(const double2* __restrict__ part, const float* __restrict__ scale,
         const float* __restrict__ bias, int B, int C, int G, int segs,
         double n, float eps, float* __restrict__ mean,
         float* __restrict__ rstd, float2* __restrict__ coef) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= B * G) return;
  const int lane = threadIdx.x & 31;
  const int cg = C / G, b = w / G, g = w - b * G;
  const long long first = (static_cast<long long>(b) * C + g * cg) * segs;
  const int count = cg * segs;
  double s = 0.0, q = 0.0;
  for (int i = lane; i < count; i += 32) {
    const double2 p = part[first + i];
    s += p.x;
    q += p.y;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  float m = 0.f, r = 0.f;
  if (lane == 0) {
    const double md = s / n;
    m = static_cast<float>(md);
    r = static_cast<float>(1.0 / sqrt(q / n - md * md + eps));
    mean[w] = m;
    rstd[w] = r;
  }
  m = __shfl_sync(kFull, m, 0);
  r = __shfl_sync(kFull, r, 0);
  for (int k = lane; k < cg; k += 32) {
    const int c = g * cg + k;
    coef[static_cast<long long>(b) * C + c] = fold(scale[c], bias[c], m, r);
  }
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
// K8

// The per-row constants of the backward: the folded affine, mean, rstd and
// scale of the row's channel.
struct RowConst {
  float2 ab;
  float mean, rstd, scale;
};

// The index of a row's statistics: its (b, g), or with kBatch (flash-BN)
// its channel.
template <bool kBatch>
__device__ __forceinline__ long long stat_index(long long row, int C, int G) {
  const int c = static_cast<int>(row % C);
  return kBatch ? c : (row / C) * G + c / (C / G);
}

template <bool kBatch>
__device__ __forceinline__ RowConst row_const(
    long long row, int C, int G, const float* scale, const float* bias,
    const float* mean, const float* rstd) {
  const int c = static_cast<int>(row % C);
  const long long bg = stat_index<kBatch>(row, C, G);
  RowConst k;
  k.mean = mean[bg];
  k.rstd = rstd[bg];
  k.scale = scale[c];
  k.ab = fold(k.scale, bias[c], k.mean, k.rstd);
  return k;
}

template <bool kVec, bool kBatch>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partials(const float* __restrict__ x, const float* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, int C, int G, int N,
                int segs, long long tasks, int act,
                double2* __restrict__ part) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const RowConst k = row_const<kBatch>(t.row, C, G, scale, bias, mean, rstd);
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

// One warp a group (b, g): each row's (sum dz, sum dz xhat) in order, then
// m1 and m2 over the group's channels in order.
__global__ void __launch_bounds__(kThreads)
gn_bwd_groups(const double2* __restrict__ part,
              const float* __restrict__ scale, int B, int C, int G, int segs,
              double n, double2* __restrict__ rowsum,
              float2* __restrict__ m) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= B * G) return;
  const int lane = threadIdx.x & 31;
  const int cg = C / G, b = w / G, g = w - b * G;
  double m1 = 0.0, m2 = 0.0;
  for (int k = 0; k < cg; ++k) {
    const long long row = static_cast<long long>(b) * C + g * cg + k;
    double s1 = 0.0, s2 = 0.0;
    for (int i = lane; i < segs; i += 32) {
      const double2 p = part[row * segs + i];
      s1 += p.x;
      s2 += p.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      rowsum[row] = make_double2(s1, s2);
      const double sc = scale[g * cg + k];
      m1 += sc * s1;
      m2 += sc * s2;
    }
  }
  if (lane == 0) m[w] = make_float2(static_cast<float>(m1 / n),
                                    static_cast<float>(m2 / n));
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

template <bool kVec, bool kBatch>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ scale, const float* __restrict__ bias,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float2* __restrict__ m, int C, int G, int N, int segs,
          long long tasks, int act, float* __restrict__ dx) {
  Task t;
  if (!my_task(N, segs, tasks, t)) return;
  constexpr int kW = kVec ? 4 : 1;
  const RowConst k = row_const<kBatch>(t.row, C, G, scale, bias, mean, rstd);
  const float2 mg = m[stat_index<kBatch>(t.row, C, G)];
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

}  // namespace

// Bytes of the `work` buffer gn_fwd and gn_bwd take.
extern "C" size_t gn_workspace(int B, int C, int N, int G) {
  const Plan p = plan(B, C, N);
  const size_t rows = static_cast<size_t>(B) * C;
  const size_t fwd = p.part_bytes + rows * sizeof(float2);
  const size_t bwd = p.part_bytes + rows * sizeof(double2)
                     + static_cast<size_t>(B) * G * sizeof(float2);
  return fwd > bwd ? fwd : bwd;
}

// y (B, C, N), mean and rstd (B, G): 3 launches.
extern "C" int gn_fwd(const float* x, const float* scale, const float* bias,
                      float* y, float* mean, float* rstd, void* work, int B,
                      int C, int N, int G, float eps, int act,
                      cudaStream_t stream) {
  if (bad_shape(B, C, N, G, act)) return cudaErrorInvalidValue;
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
  const unsigned groups = static_cast<unsigned>(cdiv(
      static_cast<long long>(B) * G, kWarps));
  gn_merge<<<groups, kThreads, 0, stream>>>(
      part, scale, bias, B, C, G, p.segs,
      static_cast<double>(C / G) * N, eps, mean, rstd, coef);
  if (vec) {
    gn_apply<true><<<p.blocks, kThreads, 0, stream>>>(x, coef, N, p.segs,
                                                      p.tasks, act, y);
  } else {
    gn_apply<false><<<p.blocks, kThreads, 0, stream>>>(x, coef, N, p.segs,
                                                       p.tasks, act, y);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (B, C, N), dscale and dbias (C): 4 launches.
extern "C" int gn_bwd(const float* x, const float* dy, const float* scale,
                      const float* bias, const float* mean, const float* rstd,
                      float* dx, float* dscale, float* dbias, void* work,
                      int B, int C, int N, int G, int act,
                      cudaStream_t stream) {
  if (bad_shape(B, C, N, G, act)) return cudaErrorInvalidValue;
  const Plan p = plan(B, C, N);
  auto* part = static_cast<double2*>(work);
  auto* rowsum = reinterpret_cast<double2*>(static_cast<char*>(work)
                                            + p.part_bytes);
  auto* m = reinterpret_cast<float2*>(
      static_cast<char*>(work) + p.part_bytes
      + static_cast<size_t>(B) * C * sizeof(double2));
  const bool vec = N % 4 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  if (vec) {
    gn_bwd_partials<true, false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, G, N, p.segs, p.tasks, act, part);
  } else {
    gn_bwd_partials<false, false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, G, N, p.segs, p.tasks, act, part);
  }
  const unsigned groups = static_cast<unsigned>(cdiv(
      static_cast<long long>(B) * G, kWarps));
  gn_bwd_groups<<<groups, kThreads, 0, stream>>>(
      part, scale, B, C, G, p.segs, static_cast<double>(C / G) * N, rowsum,
      m);
  gn_bwd_channels<<<static_cast<unsigned>(cdiv(C, kThreads)), kThreads, 0,
                    stream>>>(rowsum, B, C, dscale, dbias);
  if (vec) {
    gn_bwd_dx<true, false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, G, N, p.segs, p.tasks, act, dx);
  } else {
    gn_bwd_dx<false, false><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, G, N, p.segs, p.tasks, act, dx);
  }
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
    gn_bwd_partials<true, true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, C, N, p.segs, p.tasks, act, part);
  } else {
    gn_bwd_partials<false, true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, C, C, N, p.segs, p.tasks, act, part);
  }
  bn_bwd_channels<<<static_cast<unsigned>(cdiv(C, kWarps)), kThreads, 0,
                    stream>>>(part, scale, B, C, p.segs,
                              static_cast<double>(B) * N, dscale, dbias, m);
  if (vec) {
    gn_bwd_dx<true, true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, C, N, p.segs, p.tasks, act, dx);
  } else {
    gn_bwd_dx<false, true><<<p.blocks, kThreads, 0, stream>>>(
        x, dy, scale, bias, mean, rstd, m, C, C, N, p.segs, p.tasks, act, dx);
  }
  return static_cast<int>(cudaGetLastError());
}
