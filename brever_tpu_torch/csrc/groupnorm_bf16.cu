// The bf16 route of flash-GN and flash-BN (K7, K8, K7-BN, K8-BN;
// groupnorm.cuh): the bf16 instantiations behind groupnorm.cu's C entries,
// in their own translation unit so that nvcc compiles the two routes in
// parallel.

#include "groupnorm.cuh"

namespace gn_bf16 {

int gn_plan(int B, int C, int N, int G, int most, long long* info) {
  return plan_gn<bf16>(B, C, N, G, most, info);
}

int gn_fwd(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* rstd, int B, int C, int N, int G, float eps,
           int act, int cluster, int clusters, cudaStream_t stream) {
  return launch_gn_fwd<bf16>(x, scale, bias, y, mean, rstd, B, C, N, G, eps,
                             act, cluster, clusters, stream);
}

int gn_bwd(const void* x, const void* dy, const float* scale,
           const float* bias, const float* mean, const float* rstd, void* dx,
           float* dscale, float* dbias, void* work, int B, int C, int N,
           int G, int act, int cluster, int clusters, cudaStream_t stream) {
  return launch_gn_bwd<bf16>(x, dy, scale, bias, mean, rstd, dx, dscale,
                             dbias, work, B, C, N, G, act, cluster, clusters,
                             stream);
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
