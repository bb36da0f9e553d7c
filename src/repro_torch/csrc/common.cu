// Shared C entry point of the kernel library: the text of a cudaError_t
// that a launch function returned, for the Python wrapper's exception.
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
