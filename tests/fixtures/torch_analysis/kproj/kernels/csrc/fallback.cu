// KERNEL-CONTRACT fixture kernel 'fallback'.  Read by the rule engine in tests,
// never compiled.
#include "common.cuh"

extern "C" int fallback_launch(int dtype, const void* x, void* y, int n,
                           void* stream) {
  return 0;
}
