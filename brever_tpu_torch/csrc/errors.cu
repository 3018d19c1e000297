// The one error-string entry point of the kernel library: every C entry
// point returns a CUDA error code, which the Python wrappers turn into a
// message with this.

#include <cuda_runtime.h>

extern "C" const char* brever_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
