// The text of a CUDA error code, for the Python wrappers' messages.
#include "common.cuh"

AMT_EXPORT const char* amt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
