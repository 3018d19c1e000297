// The fused STFT forward (K9) for NVIDIA Hopper, float32: framing, the
// window and the onesided DFT in one kernel, on two routes chosen from the
// shape before any launch.
//
// Replaces the Pallas TPU kernel brever_tpu/ops/pallas/stft_kernel.py
// _stft_kernel (launched by _pallas_stft_padded through PallasSTFT). Over a
// padded signal x (rows, n), with hop | n_fft as the Pallas kernel requires,
// frames = (n - n_fft) / hop + 1, the output is (rows, frames, 2 bins):
// bins = n_fft / 2 + 1, the real parts of bins 0 .. n_fft / 2, then their
// imaginary parts. Frames are never written: each route reads them straight
// from x at offset f hop (neighbouring frames overlap by n_fft - hop).
//
// Bound: bytes. At 16 x 4 s and n_fft 512 / hop 128 the function reads 4 MB
// of x and writes 16.5 MB of spectrum, 6 us at 3.35 TB/s; a real FFT a frame
// (2.5 n log2 n operations, 0.19 GFLOP in all) takes 3 us at the card's
// 67 TFLOP/s in float32 outside the tensor cores.
//
// The FFT route (stft_fft_kernel; n_fft a power of two from 16 to 4096).
// The Pallas kernel's dense product against the windowed rDFT basis suits
// the TPU's matrix unit, but is 2 (16 x 501) 512 514 = 4.2 GFLOP at 512,
// 22x the FFT's flops and 10x the function's bytes bound on this card. A
// frame's n_fft windowed samples are packed as N = n_fft / 2 complex values
// z[m] = x[2m] + i x[2m + 1], which go through an N-point complex FFT, and
// the N + 1 bins of the real FFT are split from it in the last step:
//
//   X[k] = (Z[k] + conj Z[N-k]) / 2 - i W^k (Z[k] - conj Z[N-k]) / 2,
//   W = exp(-2 pi i / n_fft), Z[N] = Z[0].
//
// The complex FFT is a Stockham autosort FFT in radix-8 passes (a radix-4
// or radix-2 pass last where log2 N is not a multiple of 3: 8, 8, 4 at
// N = 256): N / 8 threads a frame, 8 values a thread in registers, each
// pass a twiddle and an in-register DFT of its radix per butterfly, and one
// exchange through shared memory between passes, its index padded by one
// slot every 8 so that a warp's strided writes and reads meet no bank
// conflict. A block of 256 threads takes 256 / (N / 8) frames (8 at n_fft
// 512, one at 4096); the first pass loads its values straight from x,
// windowed on load (the window, the basis's column 0, copied into shared
// memory), and the split writes each
// frame's real row and imaginary row with neighbouring threads on
// neighbouring bins. The twiddles W^m, m < n_fft, are a float32 table built
// on the host in float64 (ops/stft_kernel.py fft_twiddles). Every output is
// written once; no atomics, no library call.
//
// The dense route (stft_basis_kernel; any other n_fft): the product against
// the windowed basis W (n_fft, 2 bins) as the Pallas kernel does it,
//
//   out[r, f, j] = sum_{k < n_fft} x[r, f hop + k] W[k, j].
//
// A block computes a 64-frame x 64-column tile of one row's output, 256
// threads each owning 4 x 4 outputs; it walks n_fft in steps of 32, staging
// the 64 x 32 slice of frames (gathered from x, each frame's 32 samples
// contiguous) and the 32 x 64 slice of the basis in shared memory (16.6
// KB). Each block reads only its 64 columns of the basis.
//
// Both routes take the same basis: the FFT route reads only its column 0,
// the real part of bin 0, which is the window itself.

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

constexpr int kFftThreads = 256;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// -i a and i a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 mul_pi(float2 a) { return make_float2(-a.y, a.x); }

// In-register DFTs of R values, forward (exp(-2 pi i r s / R)), in place, in
// natural order.
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

__device__ __forceinline__ void dft4(float2* v) {
  const float2 a = cadd(v[0], v[2]), b = csub(v[0], v[2]);
  const float2 c = cadd(v[1], v[3]), d = csub(v[1], v[3]);
  v[0] = cadd(a, c);
  v[2] = csub(a, c);
  v[1] = cadd(b, mul_mi(d));
  v[3] = cadd(b, mul_pi(d));
}

__device__ __forceinline__ void dft8(float2* v) {
  constexpr float h = 0.70710678118654752f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft4(e);
  dft4(o);
  // o[s] times exp(-2 pi i s / 8)
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v[s] = cadd(e[s], o[s]);
    v[s + 4] = csub(e[s], o[s]);
  }
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 8) dft8(v);
  else if constexpr (R == 4) dft4(v);
  else dft2(v);
}

// a frame's complex slot i in shared memory: one slot of padding every 8
__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }

// One Stockham pass of radix R over the N values of a frame in S, after
// passes whose product is ns (the sub-transforms' length so far): thread t
// of the frame takes butterflies j = t + q N / 8, q < 8 / R, reading
// values j + r N / R, twiddling value r by W_{ns R}^{r (j mod ns)} and
// writing the DFT's output s to (j - j mod ns) R + j mod ns + s ns. tw[m] =
// exp(-2 pi i m / 2N).
template <int R, int N>
__device__ __forceinline__ void fft_pass(float2* S, const float2* __restrict__ tw, int t,
                                         int ns) {
  constexpr int Q = 8 / R;
  float2 v[8];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) v[q * R + r] = S[slot(t + q * (N / 8) + r * (N / R))];
  __syncthreads();  // every value of the pass read before any is written
  const int step = 2 * N / (ns * R);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * (N / 8), k = j & (ns - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) v[q * R + r] = cmul(v[q * R + r], __ldg(tw + r * k * step));
    dft<R>(v + q * R);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) S[slot(base + r * ns)] = v[q * R + r];
  }
  __syncthreads();
}

// K9's FFT route at n_fft = 2N, N = 2^kLogN (3 <= kLogN <= 11).
// grid (cdiv(frames, 256 / (N / 8)), rows), 256 threads.
template <int kLogN>
__global__ void __launch_bounds__(kFftThreads)
stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                const float2* __restrict__ tw, float* __restrict__ out, int n, int hop,
                int frames) {
  constexpr int N = 1 << kLogN, P = N / 8, kFrames = kFftThreads / P, kLd = N + N / 8;
  __shared__ float2 S[kFrames * kLd];
  __shared__ float w[2 * N];
  // the window: the basis's column 0, one float a row of 2 (N + 1)
  for (int i = threadIdx.x; i < 2 * N; i += kFftThreads)
    w[i] = __ldg(basis + static_cast<size_t>(i) * (2 * (N + 1)));
  const int t = threadIdx.x % P, f = blockIdx.x * kFrames + threadIdx.x / P;
  const bool live = f < frames;
  float2* Sf = S + (threadIdx.x / P) * kLd;
  const float* xf = x + static_cast<size_t>(blockIdx.y) * n + static_cast<size_t>(f) * hop;
  __syncthreads();  // the window in shared memory
  // the first pass, radix 8 with no twiddle: values t + r N / 8 from x
  float2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = 2 * (t + r * P);
    v[r] = live ? make_float2(__ldg(xf + m) * w[m], __ldg(xf + m + 1) * w[m + 1])
                : make_float2(0.f, 0.f);
  }
  dft8(v);
#pragma unroll
  for (int r = 0; r < 8; ++r) Sf[slot(8 * t + r)] = v[r];
  __syncthreads();
  int ns = 8;
#pragma unroll
  for (int pass = 1; pass < kLogN / 3; ++pass, ns *= 8) fft_pass<8, N>(Sf, tw, t, ns);
  if constexpr (kLogN % 3 == 2) fft_pass<4, N>(Sf, tw, t, ns);
  if constexpr (kLogN % 3 == 1) fft_pass<2, N>(Sf, tw, t, ns);
  if (!live) return;
  // the real FFT's bins 0 .. N from Z
  float* o = out + (static_cast<size_t>(blockIdx.y) * frames + f) * (2 * (N + 1));
  for (int k = t; k <= N; k += P) {
    const float2 a = Sf[slot(k & (N - 1))], b = Sf[slot((N - k) & (N - 1))];
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 od = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
    const float2 X = cadd(e, cmul(__ldg(tw + k), od));
    o[k] = X.x;
    o[N + 1 + k] = X.y;
  }
}

using FftKernel = void (*)(const float*, const float*, const float2*, float*, int, int, int);

FftKernel fft_kernel(int log_n) {
  switch (log_n) {
    case 3: return stft_fft_kernel<3>;
    case 4: return stft_fft_kernel<4>;
    case 5: return stft_fft_kernel<5>;
    case 6: return stft_fft_kernel<6>;
    case 7: return stft_fft_kernel<7>;
    case 8: return stft_fft_kernel<8>;
    case 9: return stft_fft_kernel<9>;
    case 10: return stft_fft_kernel<10>;
    case 11: return stft_fft_kernel<11>;
    default: return nullptr;
  }
}

}  // namespace

// K9's dense route: out (rows, frames, N) from x (rows, n) and basis
// (n_fft, N), frames = (n - n_fft) / hop + 1. Returns a CUDA error code, or
// 0.
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

// K9's FFT route: out (rows, frames, 2 (n_fft / 2 + 1)) from x (rows, n),
// the basis (n_fft, 2 (n_fft / 2 + 1)), of which it reads the window in
// column 0, and the twiddle table tw (n_fft complex values exp(-2 pi i m /
// n_fft)); n_fft a power of two from 16 to 4096. Returns a CUDA error code,
// or 0.
extern "C" int stft_fft(const float* x, const float* basis, const float* tw, float* out,
                        int rows, int n, int n_fft, int hop, cudaStream_t stream) {
  int log_n = 0;
  while ((2 << log_n) < n_fft) ++log_n;
  const FftKernel kernel = fft_kernel(log_n);
  if (!kernel || (2 << log_n) != n_fft || rows < 1 || rows > 65535 || hop < 1 || n < n_fft) {
    return cudaErrorInvalidValue;
  }
  const int frames = (n - n_fft) / hop + 1, per_block = kFftThreads / ((n_fft / 2) / 8);
  const dim3 grid(static_cast<unsigned>(cdiv(frames, per_block)), static_cast<unsigned>(rows));
  kernel<<<grid, kFftThreads, 0, stream>>>(x, basis, reinterpret_cast<const float2*>(tw), out,
                                          n, hop, frames);
  return static_cast<int>(cudaGetLastError());
}
