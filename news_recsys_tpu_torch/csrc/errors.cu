// The CUDA runtime's message for an error code returned by a launch entry point.

#include <cuda_runtime.h>

extern "C" const char* nrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
