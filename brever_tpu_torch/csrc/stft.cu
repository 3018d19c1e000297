// The fused STFT forward (K9) for NVIDIA Hopper, float32: framing, the
// window and the onesided DFT in one kernel, as a product against the
// windowed rDFT basis.
//
// Replaces the Pallas TPU kernel brever_tpu/ops/pallas/stft_kernel.py
// _stft_kernel (launched by _pallas_stft_padded through PallasSTFT). Over a
// padded signal x (rows, n) and the basis W (n_fft, 2 bins), the window
// folded into it (column j < bins the real part of bin j, bins + j its
// imaginary part), with hop | n_fft as the Pallas kernel requires:
//
//   out[r, f, j] = sum_{k < n_fft} x[r, f hop + k] W[k, j],
//   f < frames = (n - n_fft) / hop + 1
//
// Frames are never written: the A operand of the product is read straight
// from x at row offset f hop (neighbouring frames overlap by n_fft - hop).
//
// Bound: bytes. At 16 x 4 s and n_fft 512 / hop 128 the function reads 4 MB
// of x and writes 16.5 MB of spectrum, 6 us at 3.35 TB/s; a real FFT a frame
// (2.5 n log2 n operations, 0.19 GFLOP in all) takes 3 us at the card's
// 67 TFLOP/s in float32 outside the tensor cores. The dense product this
// kernel does is 2 (16 x 501) 512 514 = 4.2 GFLOP, 0.063 ms at that rate:
// the Pallas kernel's choice for the TPU's matrix unit, kept here as the
// kernel to port, so K9 cannot reach the function's bound (cuFFT can come
// near it).
//
// Design: a SIMT tiled product. A block computes a 64-frame x 64-column tile
// of one row's output, 256 threads each owning 4 x 4 outputs; it walks n_fft
// in steps of 32, staging the 64 x 32 slice of frames (gathered from x, each
// frame's 32 samples contiguous) and the 32 x 64 slice of the basis in shared
// memory (16.6 KB). The basis (n_fft x 2 bins: 1 MB at n_fft 512) does not
// fit shared memory; the column tiles split it, and each block reads only its
// 64 columns. Every output is written once; no atomics.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileF = 64;   // frames of a block
constexpr int kTileJ = 64;   // basis columns of a block
constexpr int kTileK = 32;   // basis rows a step
constexpr int kThreads = 256;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// grid (cdiv(frames, kTileF), cdiv(N, kTileJ), rows)
__global__ void __launch_bounds__(kThreads)
stft_basis_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                  float* __restrict__ out, int n, int n_fft, int hop,
                  int frames, int N) {
  __shared__ float As[kTileK][kTileF + 1];   // frames, k-major
  __shared__ float Bs[kTileK][kTileJ];
  const int f0 = blockIdx.x * kTileF, j0 = blockIdx.y * kTileJ;
  const float* xr = x + static_cast<size_t>(blockIdx.z) * n;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n_fft; k0 += kTileK) {
    for (int i = tid; i < kTileF * kTileK; i += kThreads) {
      const int k = i % kTileK, f = i / kTileK;
      const bool ok = f0 + f < frames && k0 + k < n_fft;
      As[k][f] = ok ? __ldg(xr + static_cast<size_t>(f0 + f) * hop + k0 + k)
                    : 0.f;
    }
    for (int i = tid; i < kTileK * kTileJ; i += kThreads) {
      const int j = i % kTileJ, k = i / kTileJ;
      const bool ok = j0 + j < N && k0 + k < n_fft;
      Bs[k][j] = ok ? __ldg(basis + static_cast<size_t>(k0 + k) * N + j0 + j)
                    : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + static_cast<size_t>(blockIdx.z) * frames * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f >= frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx + 16 * j;
      if (c < N) o[static_cast<size_t>(f) * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// K9: out (rows, frames, N) from x (rows, n) and basis (n_fft, N), frames =
// (n - n_fft) / hop + 1. Returns a CUDA error code, or 0.
extern "C" int stft_basis(const float* x, const float* basis, float* out,
                          int rows, int n, int n_fft, int hop, int N,
                          cudaStream_t stream) {
  if (rows < 1 || n_fft < 1 || hop < 1 || N < 1 || n < n_fft
      || rows > 65535) {
    return cudaErrorInvalidValue;
  }
  const int frames = (n - n_fft) / hop + 1;
  const dim3 grid(static_cast<unsigned>(cdiv(frames, kTileF)),
                  static_cast<unsigned>(cdiv(N, kTileJ)),
                  static_cast<unsigned>(rows));
  stft_basis_kernel<<<grid, kThreads, 0, stream>>>(x, basis, out, n, n_fft,
                                                   hop, frames, N);
  return static_cast<int>(cudaGetLastError());
}
