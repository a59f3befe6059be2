// KERNEL-CONTRACT fixture kernel 'short_list'.  Read by the rule engine in tests,
// never compiled.
#include "common.cuh"

extern "C" int short_list_launch(int dtype, const void* x, void* y, int n,
                           void* stream) {
  return 0;
}
