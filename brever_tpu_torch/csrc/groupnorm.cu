// flash-GN and flash-BN for NVIDIA Hopper (K7, K8, K7-BN, K8-BN;
// groupnorm.cuh has the kernels and their design): the C entry points, with
// the float32 route compiled here and the bf16 route (bf16 = 1: x, y, dy and
// dx bfloat16) in groupnorm_bf16.cu. scale, bias, the statistics, dscale,
// dbias and `work` are float32 (double) on both.

#include "groupnorm.cuh"

// The cluster plan of K7 and K8 at (B, C, N) in G groups, the cluster at
// most `most` blocks (a power of two up to 16), on the float32 route or the
// bf16 one (bf16 = 1): info[0..7] = blocks a cluster, elements a block
// holds, dynamic shared memory a block in bytes, threads a block, tasks a
// group, elements of a group read from device memory again (0 where the
// cluster holds the slab), blocks of the launch, and the clusters of that
// size the card can hold at once of both kernels
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one); info[8] = the
// elements of dy a block holds (the bf16 route's K8 on the 16-byte grid;
// 0 on the float32 route). On the bf16 route info[1] and info[2] are its
// 16-byte route's (groupnorm_bf16.cu plan16).
extern "C" int gn_plan(int B, int C, int N, int G, int most, int bf16,
                       long long* info) {
  if (bf16) return gn_bf16::gn_plan(B, C, N, G, most, info);
  return plan_gn<float>(B, C, N, G, most, info);
}

// K7: y (B, C, N), mean and rstd (B, G); one launch of `clusters` clusters
// (at most B G) of `cluster` blocks (gn_plan's), each walking the groups
// clusters apart. Returns a CUDA error code, or 0.
extern "C" int gn_fwd(const void* x, const float* scale, const float* bias,
                      void* y, float* mean, float* rstd, int B, int C, int N,
                      int G, float eps, int act, int cluster, int clusters,
                      int bf16, cudaStream_t stream) {
  if (bf16)
    return gn_bf16::gn_fwd(x, scale, bias, y, mean, rstd, B, C, N, G, eps,
                           act, cluster, clusters, stream);
  return launch_gn_fwd<float>(x, scale, bias, y, mean, rstd, B, C, N, G, eps,
                              act, cluster, clusters, stream);
}

// Bytes of the `work` buffer gn_bwd takes: each task's and each (b, c)
// row's two sums (either route).
extern "C" size_t gn_bwd_workspace(int B, int C, int N, int G) {
  const size_t rows = static_cast<size_t>(B) * C;
  return (rows * cdiv(N, kTask) + rows) * sizeof(double2);
}

// K8: dx (B, C, N), dscale and dbias (C), from x, dy and K7's mean and rstd;
// two launches: gn_bwd_cluster in `clusters` clusters of `cluster` blocks,
// as K7's, then gn_bwd_channels. Returns a CUDA error code, or 0.
extern "C" int gn_bwd(const void* x, const void* dy, const float* scale,
                      const float* bias, const float* mean, const float* rstd,
                      void* dx, float* dscale, float* dbias, void* work,
                      int B, int C, int N, int G, int act, int cluster,
                      int clusters, int bf16, cudaStream_t stream) {
  if (bf16)
    return gn_bf16::gn_bwd(x, dy, scale, bias, mean, rstd, dx, dscale, dbias,
                           work, B, C, N, G, act, cluster, clusters, stream);
  return launch_gn_bwd<float>(x, dy, scale, bias, mean, rstd, dx, dscale,
                              dbias, work, B, C, N, G, act, cluster, clusters,
                              stream);
}

// The plan of K7-BN and K8-BN at (B, C, N), the cluster at most `most`
// blocks, on either route: info[0..7] as gn_plan's for the C channels (a
// group of B rows; threads a block and the clusters the card holds at once
// as bn_ring sets the blocks), then info[8] and info[9], K7-BN's and
// K8-BN's route (Route: kBlock where one block holds the channel, kCluster
// where a cluster of 2 to `most` does, past it kBnFwdPast and kBnBwdPast;
// K8-BN's kPasses off the vector grid), info[10], the bytes of the `work`
// buffer the routes take (the passes' segment sums; else 0), and info[11]
// and info[12], the buffers of a block's ring and its dynamic shared memory
// in bytes.
extern "C" int bn_plan(int B, int C, int N, int most, int bf16,
                       long long* info) {
  if (bf16) return gn_bf16::bn_plan(B, C, N, most, info);
  return plan_bn<float>(B, C, N, most, info);
}

// K7-BN: y (B, C, N), mean, var and rstd (C), on `route` (bn_plan's: any
// but kPasses): one launch of `clusters` clusters (at most C) of `cluster`
// blocks, each walking the channels clusters apart. Returns a CUDA error
// code, or 0.
extern "C" int bn_fwd(const void* x, const float* scale, const float* bias,
                      void* y, float* mean, float* var, float* rstd,
                      int B, int C, int N, float eps, int act, int route,
                      int cluster, int clusters, int bf16,
                      cudaStream_t stream) {
  if (bf16)
    return gn_bf16::bn_fwd(x, scale, bias, y, mean, var, rstd, B, C, N, eps,
                           act, route, cluster, clusters, stream);
  return launch_bn_fwd<float>(x, scale, bias, y, mean, var, rstd, B, C, N,
                              eps, act, route, cluster, clusters, stream);
}

// K8-BN: dx (B, C, N), dscale and dbias (C) from x, dy and the forward's
// per-channel mean and rstd, on `route` as bn_fwd's: one launch, or two.
extern "C" int bn_bwd(const void* x, const void* dy, const float* scale,
                      const float* bias, const float* mean, const float* rstd,
                      void* dx, float* dscale, float* dbias, void* work,
                      int B, int C, int N, int act, int route, int cluster,
                      int clusters, int bf16, cudaStream_t stream) {
  if (bf16)
    return gn_bf16::bn_bwd(x, dy, scale, bias, mean, rstd, dx, dscale, dbias,
                           work, B, C, N, act, route, cluster, clusters,
                           stream);
  return launch_bn_bwd<float>(x, dy, scale, bias, mean, rstd, dx, dscale,
                              dbias, work, B, C, N, act, route, cluster,
                              clusters, stream);
}
