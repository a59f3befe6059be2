// KERNEL-CONTRACT fixture: the shared error-string export.  Read by the
// rule engine in tests, never compiled.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
