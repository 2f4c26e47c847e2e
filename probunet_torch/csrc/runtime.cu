// Runtime helpers exported beside the kernels' C entry points.

#include <cuda_runtime.h>

// Message for a cudaError_t code returned by an entry point.
extern "C" const char* probunet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
