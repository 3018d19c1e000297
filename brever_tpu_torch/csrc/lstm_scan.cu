// LSTM recurrence for NVIDIA Hopper (K3-K6; lstm_scan.cuh has the kernels
// and their design): the C entry points, with the float32 route compiled
// here and the bf16 route (bf16 = 1) in lstm_scan_bf16.cu (K3-bf16 and
// K4-bf16 on the bf16 tensor cores; their plans' entries are there too).

#include "lstm_scan.cuh"

extern "C" {

// K3's plan at a shape: info[0..4] = tile rows, k slice, threads a block,
// tiles a direction and shared memory a block (bytes). Returns
// cudaErrorInvalidValue for a shape K3 does not take, else 0.
int lstm_fwd_plan(int T, int D, int R, int E, int H, int* info) {
  if (!shape_ok(E, H) || T < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan P(D, R, H);
  const int out[5] = {P.rows, P.slice, P.threads, P.tiles, P.smem};
  for (int i = 0; i < 5; ++i) info[i] = out[i];
  return 0;
}

// K4's plan at a shape: info[0..6] = the scan's tile rows, rows a thread,
// threads a block, tiles a direction and shared memory a block (bytes),
// the weight GEMM's chunks a direction and pairs a chunk. Returns
// cudaErrorInvalidValue for a shape K4 does not take, else 0.
int lstm_bwd_plan(int T, int D, int R, int E, int H, int* info) {
  if (!shape_ok(E, H) || T < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan P(T, D, R, E, H);
  const int out[7] = {P.rows, P.rt, P.threads, P.tiles, P.smem, P.wg.chunks, P.wg.chunk};
  for (int i = 0; i < 7; ++i) info[i] = out[i];
  return 0;
}

size_t lstm_bwd_workspace(int T, int D, int R, int E, int H) {
  return Layout(T, D, R, E, H, WgSplit(T * R, wgrad_tiles(E, H, D))).total;
}

// The entries below take every tensor as float32, or, with bf16 = 1, as
// bfloat16 (the bf16 route); dw, db, dw_hh and work are float32 on both.

// K3: h_seq and c_seq (T, D, R, H) from x (T, D, R, E). Returns a CUDA
// error code, or 0.
int lstm_fwd(const void* x, const void* w_ih, const void* bias, const void* w_hh, void* h_seq,
             void* c_seq, int T, int D, int R, int E, int H, int bf16, void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan P(D, R, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return lstm_bf16::fwd(false, x, w_ih, bias, w_hh, h_seq, c_seq, nullptr, T, D, R, E, H, s);
  return launch_ring<false>(P, in<float>(x), in<float>(w_ih), in<float>(bias), in<float>(w_hh),
                            out<float>(h_seq), out<float>(c_seq), static_cast<float*>(nullptr),
                            T, D, R, E, H, s);
}

// K3 writing, besides h and c, the gate pre-activations it formed (T, D,
// R, 4H), and K4's first launch alone (its recomputed gates, from the
// saved h): the pair the check that K4 recomputes K3's bits compares.
// Return a CUDA error code, or 0.
int lstm_fwd_gates(const void* x, const void* w_ih, const void* bias, const void* w_hh,
                   void* h_seq, void* c_seq, void* gates, int T, int D, int R, int E, int H,
                   int bf16, void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan P(D, R, H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return lstm_bf16::fwd(true, x, w_ih, bias, w_hh, h_seq, c_seq, gates, T, D, R, E, H, s);
  return launch_ring<true>(P, in<float>(x), in<float>(w_ih), in<float>(bias), in<float>(w_hh),
                           out<float>(h_seq), out<float>(c_seq), out<float>(gates), T, D, R, E,
                           H, s);
}

int lstm_bwd_gates(const void* x, const void* w_ih, const void* bias, const void* w_hh,
                   const void* h_seq, void* gates, int T, int D, int R, int E, int H, int bf16,
                   void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(T * R, kGM), 4 * H / kGM, D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return lstm_bf16::bwd_gates(x, w_ih, bias, w_hh, h_seq, gates, T, D, R, E, H, s);
  lstm_bwd_gates_gemm<<<grid, kGemmThreads, 0, s>>>(
      in<float>(x), in<float>(w_ih), in<float>(bias), in<float>(w_hh), in<float>(h_seq),
      out<float>(gates), T, D, R, E, H);
  return last_error();
}

// K4: dx (T, D, R, E), dw = [dW_ih; dW_hh] (D, E + H, 4H) and db (D, 4H)
// from the forward's inputs (w_ih and its transpose w_ih_t (D, 4H, E),
// w_hh and w_hh_t (D, 4H, H)), its h and c, and dh; work holds
// lstm_bwd_workspace floats. Every output is written whole. Returns the
// first launch's CUDA error code, or 0.
int lstm_bwd(const void* x, const void* w_ih, const void* w_ih_t, const void* bias,
             const void* w_hh, const void* w_hh_t, const void* h_seq, const void* c_seq,
             const void* dh_seq, void* dx, float* dw, float* db, float* work, int T, int D,
             int R, int E, int H, int bf16, void* stream) {
  if (!shape_ok(E, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lstm_bf16::bwd(x, w_ih, w_ih_t, bias, w_hh, w_hh_t, h_seq, c_seq, dh_seq, dx, dw, db,
                          work, T, D, R, E, H, s);
  return lstm_bwd_route(in<float>(x), in<float>(w_ih), in<float>(w_ih_t), in<float>(bias),
                        in<float>(w_hh), in<float>(w_hh_t), in<float>(h_seq), in<float>(c_seq),
                        in<float>(dh_seq), out<float>(dx), dw, db, work, T, D, R, E, H, s);
}

// The cluster of K5/K6 at hidden size H <= 256: info[0..5] = blocks a
// cluster (kClusterBlocks), K5's and K6's shared memory a block in bytes,
// threads a block, and the clusters of K5 and of K6 the card can hold at
// once (cudaOccupancyMaxActiveClusters). Returns a CUDA error code, or 0;
// cudaErrorInvalidValue where the cluster cannot take H.
int lstm_scan_cluster_info(int H, int* info) {
  if (!hidden_ok(H, kMaxHiddenWide) || !cluster_fits(H))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpt = gate_rows(H / kClusterBlocks);
  const size_t fwd = sizeof(float) * cluster_fwd_floats(H);
  const size_t bwd = sizeof(float) * cluster_bwd_floats(H);
  info[0] = kClusterBlocks;
  info[1] = static_cast<int>(fwd);
  info[2] = static_cast<int>(bwd);
  info[3] = kClusterThreads;
  const auto fk = reinterpret_cast<const void*>(cluster_fwd_kernel<float>(rpt));
  const auto bk = reinterpret_cast<const void*>(cluster_bwd_kernel<float>(rpt));
  const ClusterLaunch lf(fk, 1, 1, fwd, 0);
  if (lf.err) return lf.err;
  int err = static_cast<int>(cudaOccupancyMaxActiveClusters(&info[4], fk, &lf.cfg));
  if (err) return err;
  const ClusterLaunch lb(bk, 1, 1, bwd, 0);
  if (lb.err) return lb.err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(&info[5], bk, &lb.cfg));
}

size_t lstm_scan_bwd_workspace(int T, int D, int R, int H) {
  return Layout(T, D, R, 0, H, WgSplit(T * R, wgrad_tiles(0, H, D))).total;
}

// K6's shared memory a block at 256 < H <= 8192 (its tile's rows x 6H
// floats), in bytes; 0 for another H
size_t lstm_scan_tile_smem(int H) {
  return H > kMaxHiddenWide && hidden_ok(H, kMaxHidden) ? bwd_smem(tile_rows(H), H) : 0;
}

// K5: h_seq and c_seq (T, D, R, H) from gates_x (T, D, R, 4H) and w_hh
// (D, H, 4H); H <= 256 on clusters, above on row tiles (tile_rows) up to
// 8192 (float32 only: the bf16 route takes H <= 256). Returns a CUDA error
// code, or 0.
int lstm_scan_fwd(const void* gates_x, const void* w_hh, void* h_seq, void* c_seq, int T, int D,
                  int R, int H, int bf16, void* stream) {
  if (!hidden_ok(H, bf16 ? kMaxHiddenWide : kMaxHidden))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return lstm_bf16::scan_fwd(gates_x, w_hh, h_seq, c_seq, T, D, R, H, s);
  if (H > kMaxHiddenWide) {
    const auto tiles = tile_rows(H) == 16  ? scan_fwd_tiles<16>
                       : tile_rows(H) == 8 ? scan_fwd_tiles<8>
                       : tile_rows(H) == 4 ? scan_fwd_tiles<4>
                       : tile_rows(H) == 2 ? scan_fwd_tiles<2>
                                           : scan_fwd_tiles<1>;
    return tiles(in<float>(gates_x), in<float>(w_hh), out<float>(h_seq), out<float>(c_seq), T, D,
                 R, H, s);
  }
  return scan_fwd_cluster(in<float>(gates_x), in<float>(w_hh), out<float>(h_seq),
                          out<float>(c_seq), T, D, R, H, s);
}

// K6: dgates (T, D, R, 4H) and dw_hh (D, H, 4H) from the forward's inputs,
// its h and c, and dh; work holds lstm_scan_bwd_workspace floats; w_hh_t is
// read above H = 256 only (may be null below; float32 only). Every output is
// written whole. Returns the first launch's CUDA error code, or 0.
int lstm_scan_bwd(const void* gates_x, const void* w_hh, const void* w_hh_t, const void* h_seq,
                  const void* c_seq, const void* dh_seq, void* dgates, float* dw_hh, float* work,
                  int T, int D, int R, int H, int bf16, void* stream) {
  if (!hidden_ok(H, bf16 ? kMaxHiddenWide : kMaxHidden))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lstm_bf16::scan_bwd(gates_x, w_hh, h_seq, c_seq, dh_seq, dgates, dw_hh, work, T, D, R,
                               H, s);
  const WgSplit wg(T * R, wgrad_tiles(0, H, D));
  const Layout L(T, D, R, 0, H, wg);
  int err = 0;
  if (H > kMaxHiddenWide) {
    if (!w_hh_t) return static_cast<int>(cudaErrorInvalidValue);
    const auto tiles = tile_rows(H) == 16  ? scan_bwd_tiles<16>
                       : tile_rows(H) == 8 ? scan_bwd_tiles<8>
                       : tile_rows(H) == 4 ? scan_bwd_tiles<4>
                       : tile_rows(H) == 2 ? scan_bwd_tiles<2>
                                           : scan_bwd_tiles<1>;
    err = tiles(in<float>(gates_x), in<float>(w_hh), in<float>(w_hh_t), in<float>(h_seq),
                in<float>(c_seq), in<float>(dh_seq), out<float>(dgates), T, D, R, H, s);
  } else {
    err = scan_bwd_cluster(in<float>(gates_x), in<float>(w_hh), in<float>(h_seq),
                           in<float>(c_seq), in<float>(dh_seq), out<float>(dgates), T, D, R, H,
                           s);
  }
  if (err) return err;
  return weight_grads<false>(static_cast<const float*>(nullptr), in<float>(h_seq),
                             out<float>(dgates), work + L.wg_part, dw_hh, nullptr, wg, T, D, R,
                             0, H, s);
}

}  // extern "C"
