// Error text for the codes the launch functions return.
#include <cuda_runtime.h>

extern "C" const char* cmdlmc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
