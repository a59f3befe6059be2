// Cayley-Neumann rotation of a layer stack:
//   R = (I - Q) sum_{k<=K} (-Q)^k   by K Horner steps  S <- I - Q S.
//
// Replaces the TPU kernel src/repro/kernels/cayley_kernel.py,
// cayley_neumann_pallas.
//
//   q (L, r, r) fp32, dense (skew-symmetric in use).  Writes the partial
//   sums S_1 .. S_K as series (K, L, r, r) fp32 (the autograd function's
//   backward runs the reverse Horner recursion over them; S_0 = I is not
//   stored) and R (L, r, r) fp32.  K = 0 gives R = I - Q.
//
// What bounds it on the H100: operations.  K + 1 = 6 products of r x r by
// r x r per matrix, 6 * 2 * 352^3 = 0.52 GFLOP at r = 352, in fp32 on the
// CUDA cores (67 TFLOP/s), against ~1.5 MB of Q and R per matrix.
//
// Design: the TPU kernel holds S (r x r fp32, 496 KB at r = 352) in VMEM
// across the K serial steps in one block; a Hopper block has 227 KB of
// shared memory, so the single-block design does not carry over.  Instead:
// one elementwise launch writes S_1 = I - Q, then K - 1 launches of the
// batched fp32 tiled product of gemm_tiles.cuh with the fused epilogue
// S_k = I - Q S_{k-1}, then one with R = S_K - Q S_K.  Each launch's grid is
// (r/64, r/64, L): a whole layer stack per launch (28 x 36 blocks at
// r = 352), each S_k stays in L2 (14 MB per stack) for the next launch.
// Exact fp32 (no TF32), as the plain version.  A cluster holding S in
// distributed shared memory is later work.
#include "gemm_tiles.cuh"

namespace repro_torch {

constexpr int kMaxGridZ = 65535;

__global__ void eye_minus_kernel(const float* __restrict__ q,
                                 float* __restrict__ out, long n, int r) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long rc = i % ((long)r * r);
    out[i] = (rc / r == rc % r ? 1.f : 0.f) - q[i];
  }
}

cudaError_t launch_cayley(const float* q, float* series, float* rot, int L,
                          int r, int terms, cudaStream_t stream) {
  const long mat = (long)r * r;
  const long n = (long)L * mat;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  eye_minus_kernel<<<blocks, 256, 0, stream>>>(q, terms > 0 ? series : rot,
                                               n, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || terms == 0) return err;
  const Batch batch{mat, mat, mat, mat};
  // the product grid's z axis holds at most kMaxGridZ matrices: larger
  // stacks (an OFT family's (L, m, d/b) blocks) go in slices of the stack
  for (int l0 = 0; l0 < L; l0 += kMaxGridZ) {
    const int lc = L - l0 < kMaxGridZ ? L - l0 : kMaxGridZ;
    const long off = (long)l0 * mat;
    ASrc<float> qa{q + off, r, nullptr, nullptr, 0, nullptr, r, r, r, false,
                   false};
    for (int k = 2; k <= terms + 1; ++k) {
      const float* prev = series + (long)(k - 2) * n + off;  // S_{k-1}
      BSrc<float, float> sb{prev, r, 1, nullptr, 0, 0, r, r, r, false,
                            false};
      if (k <= terms) {  // S_k = I - Q S_{k-1}
        err = launch_simt(qa, sb, series + (long)(k - 1) * n + off, r, lc,
                          stream, kEyeMinus, nullptr, 0, batch);
      } else {  // R = S_K - Q S_K
        err = launch_simt(qa, sb, rot + off, r, lc, stream, kEMinus, prev,
                          r, batch);
      }
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace repro_torch

extern "C" int cayley_neumann_launch(const void* q, void* series, void* rot,
                                     int L, int r, int terms, void* stream) {
  if (L == 0 || r == 0) return 0;
  if (L < 0 || r < 0 || terms < 0) return (int)cudaErrorInvalidValue;
  return (int)repro_torch::launch_cayley(
      static_cast<const float*>(q), static_cast<float*>(series),
      static_cast<float*>(rot), L, r, terms,
      static_cast<cudaStream_t>(stream));
}
