// Error text for the codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
