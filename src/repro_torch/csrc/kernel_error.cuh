// The one symbol every kernel library of the port exports besides its
// launch function: cudaError_t -> message, for the Python wrappers'
// exceptions (`repro_torch.kernels.build.check`).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
