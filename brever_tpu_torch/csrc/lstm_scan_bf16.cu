// The bf16 route of the LSTM kernels K3-K6 (lstm_scan.cuh): the bf16
// instantiations behind lstm_scan.cu's C entries, in their own translation
// unit so that nvcc compiles the two routes in parallel.

#include "lstm_scan.cuh"

namespace lstm_bf16 {

using B = simt::bf16;

int fwd(bool keep_gates, const void* x, const void* w_ih, const void* bias, const void* w_hh,
        void* h_seq, void* c_seq, void* gates, int T, int D, int R, int E, int H,
        cudaStream_t s) {
  const FwdPlan P(D, R, H);
  if (keep_gates)
    return launch_ring<true>(P, in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), out<B>(h_seq),
                             out<B>(c_seq), out<B>(gates), T, D, R, E, H, s);
  return launch_ring<false>(P, in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), out<B>(h_seq),
                            out<B>(c_seq), static_cast<B*>(nullptr), T, D, R, E, H, s);
}

int bwd_gates(const void* x, const void* w_ih, const void* bias, const void* w_hh,
              const void* h_seq, void* gates, int T, int D, int R, int E, int H, cudaStream_t s) {
  lstm_bwd_gates_gemm<B><<<dim3(cdiv(T * R, kGM), 4 * H / kGM, D), kGemmThreads, 0, s>>>(
      in<B>(x), in<B>(w_ih), in<B>(bias), in<B>(w_hh), in<B>(h_seq), out<B>(gates), T, D, R, E,
      H);
  return last_error();
}

int bwd(const void* x, const void* w_ih, const void* w_ih_t, const void* bias, const void* w_hh,
        const void* w_hh_t, const void* h_seq, const void* c_seq, const void* dh_seq, void* dx,
        float* dw, float* db, float* work, int T, int D, int R, int E, int H, cudaStream_t s) {
  return lstm_bwd_route(in<B>(x), in<B>(w_ih), in<B>(w_ih_t), in<B>(bias), in<B>(w_hh),
                        in<B>(w_hh_t), in<B>(h_seq), in<B>(c_seq), in<B>(dh_seq), out<B>(dx), dw,
                        db, work, T, D, R, E, H, s);
}

int scan_fwd(const void* gates_x, const void* w_hh, void* h_seq, void* c_seq, int T, int D, int R,
             int H, cudaStream_t s) {
  return scan_fwd_cluster(in<B>(gates_x), in<B>(w_hh), out<B>(h_seq), out<B>(c_seq), T, D, R, H,
                          s);
}

int scan_bwd(const void* gates_x, const void* w_hh, const void* h_seq, const void* c_seq,
             const void* dh_seq, void* dgates, float* dw_hh, float* work, int T, int D, int R,
             int H, cudaStream_t s) {
  const WgSplit wg(T * R, wgrad_tiles(0, H, D));
  const Layout L(T, D, R, 0, H, wg);
  const int err = scan_bwd_cluster(in<B>(gates_x), in<B>(w_hh), in<B>(h_seq), in<B>(c_seq),
                                   in<B>(dh_seq), out<B>(dgates), T, D, R, H, s);
  if (err) return err;
  return weight_grads<false>(static_cast<const B*>(nullptr), in<B>(h_seq), out<B>(dgates),
                             work + L.wg_part, dw_hh, nullptr, wg, T, D, R, 0, H, s);
}

}  // namespace lstm_bf16
