// Error strings for the codes the kernels' C functions return.

#include <cuda_runtime.h>

extern "C" const char* normflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
