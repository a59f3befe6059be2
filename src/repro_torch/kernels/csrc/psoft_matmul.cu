// Fused PSOFT linear: y = x (W_res + A diag(alpha) R diag(beta) B), and the
// same function on transposed operands for the backward's dx.
//
// Replaces the TPU kernel src/repro/kernels/psoft_matmul.py,
// psoft_matmul_pallas (its custom-VJP backward, kernels/ops.py
// _psoft_mm_bwd, computes dx in jnp; here dx is this kernel's transposed
// launch).
//
//   x (M, K), W_res (K, N), A (K, r), B (r, N) in the compute dtype (fp32 or
//   bf16); R (r, r), alpha, beta (r,) fp32.
//   forward  (transpose = 0):  u = x A,        t = (u . alpha) R,
//                              y = x W_res + (t . beta) B          (M, N)
//   backward (transpose = 1):  x is dy (M, N),  u = dy B^T,
//                              t = (u . beta) R^T,
//                              y = dx = dy W_res^T + (t . alpha) A^T (M, K)
//   u and t are written as (M, r) fp32: the autograd function keeps them
//   (forward: u1 = x A and u3; backward: du4 and du2) for the rank-r grads.
//
// What bounds it on the H100: operations.  At a llama32-3b gate/up linear
// (M = 2048 tokens, K = 3072, N = 8192, r = 352) the launch does ~120 GFLOP
// on ~105 MB, ~1100 flops per byte, far above the ~295 flops/byte ridge of
// bf16 tensor cores, so the tensor-core rate is the limit.
//
// Design: three launches on the caller's stream, each a tiled product from
// gemm_tiles.cuh.
//   1. u = x P_in (P_in = A, or B^T read in place): M x r over depth K, on
//      tensor cores in bf16 (fp32 CUDA cores in fp32), once per M block, not
//      once per N tile as the TPU grid recomputed it.
//   2. t = (u . s_in) R' (R' = R or R^T in place): M x r over depth r, fp32
//      on the CUDA cores (exact fp32, as the TPU kernel's finalize step).
//   3. y = [x | t . s_out] [W' ; P_out]: one tiled product over the extended
//      depth K + r, so the rank-r term is r more depth steps of the same
//      loop; W' = W_res or W_res^T and P_out = B or A^T, all read in place
//      through strides (no transposed copy of a 50 MB weight).  The rank-r
//      operand v = t . s_out is rounded to the compute dtype as it enters
//      the tile (bf16 tensor cores take bf16 operands); the plain version
//      rounds it at the same place.
// The TPU kernel kept a bm x r fp32 accumulator and the whole r x r R in
// VMEM (180 KB + 496 KB at r = 352), which does not fit beside the tiles in
// a block's 227 KB; here u and t make one 2.9 MB round trip through device
// memory (L2-resident) instead.  Ragged M, N, K and r = 352 are masked in the
// kernels; nothing is padded.  WMMA on mma.sync-class tensor cores; wgmma
// and TMA are later work.
#include "gemm_tiles.cuh"

namespace repro_torch {

template <typename T>
cudaError_t launch_psoft(bool transpose, const T* x, const T* w_res,
                         const T* a, const float* rot, const T* b,
                         const float* s_in, const float* s_out, float* u,
                         float* t, T* y, int M, int K, int N, int r,
                         cudaStream_t stream) {
  const int din = transpose ? N : K, dout = transpose ? K : N;
  // P_in (din x r): A (K, r) row-major, or B^T with B (r, N) row-major
  const T* p_in = transpose ? b : a;
  const long pin_sd = transpose ? 1 : r, pin_sc = transpose ? N : 1;
  // R' (r x r)
  const long rot_sd = transpose ? 1 : r, rot_sc = transpose ? r : 1;
  // W' (din x dout): W_res (K, N) row-major, or its transpose
  const long w_sd = transpose ? 1 : N, w_sc = transpose ? N : 1;
  // P_out (r x dout): B (r, N), or A^T with A (K, r)
  const T* p_out = transpose ? a : b;
  const long pout_sd = transpose ? 1 : N, pout_sc = transpose ? r : 1;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  cudaError_t err;

  if (r > 0) {
    ASrc<T> a1{x, din, nullptr, nullptr, 0, nullptr, M, din, din,
               false, false};
    BSrc<T, T> b1{p_in, pin_sd, pin_sc, nullptr, 0, 0, din, din, r,
                  false, false};
    if constexpr (kBf16) {
      a1.vec1 = din % 8 == 0 && aligned16(x);
      b1.vec1 = (transpose ? pin_sc : pin_sd) % 8 == 0 && aligned16(p_in);
      err = launch_tc(a1, b1, transpose, u, r, stream);
    } else {
      err = launch_simt(a1, b1, u, r, 1, stream);
    }
    if (err != cudaSuccess) return err;
    ASrc<float> a2{u, r, s_in, nullptr, 0, nullptr, M, r, r, false, false};
    BSrc<float, float> b2{rot, rot_sd, rot_sc, nullptr, 0, 0, r, r, r,
                          false, false};
    err = launch_simt(a2, b2, t, r, 1, stream);
    if (err != cudaSuccess) return err;
  }
  ASrc<T> a3{x, din, nullptr, t, r, s_out, M, din, din + r, false, false};
  BSrc<T, T> b3{w_res, w_sd, w_sc, p_out, pout_sd, pout_sc, din, din + r,
                dout, false, false};
  if constexpr (kBf16) {
    a3.vec1 = din % 8 == 0 && aligned16(x);
    a3.vec2 = r % 4 == 0 && din % 4 == 0 && aligned16(t) && aligned16(s_out);
    b3.vec1 = N % 8 == 0 && aligned16(w_res);
    b3.vec2 = (transpose ? pout_sc % 8 == 0 && din % 8 == 0
                         : pout_sd % 8 == 0) &&
              aligned16(p_out);
    return launch_tc(a3, b3, transpose, y, dout, stream);
  } else {
    return launch_simt(a3, b3, y, dout, 1, stream);
  }
}

}  // namespace repro_torch

extern "C" int psoft_matmul_launch(int dtype, int transpose, const void* x,
                                   const void* w_res, const void* a,
                                   const void* rot, const void* b,
                                   const void* s_in, const void* s_out,
                                   void* u, void* t, void* y, int M, int K,
                                   int N, int r, void* stream) {
  if (M == 0 || (transpose ? K : N) == 0) return 0;
  if (M < 0 || K <= 0 || N <= 0 || r < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rot);
  const float* si = static_cast<const float*>(s_in);
  const float* so = static_cast<const float*>(s_out);
  float* uf = static_cast<float*>(u);
  float* tf = static_cast<float*>(t);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch_psoft<float>(
        transpose != 0, static_cast<const float*>(x),
        static_cast<const float*>(w_res), static_cast<const float*>(a), rf,
        static_cast<const float*>(b), si, so, uf, tf, static_cast<float*>(y),
        M, K, N, r, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch_psoft<__nv_bfloat16>(
        transpose != 0, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w_res),
        static_cast<const __nv_bfloat16*>(a), rf,
        static_cast<const __nv_bfloat16*>(b), si, so, uf, tf,
        static_cast<__nv_bfloat16*>(y), M, K, N, r, s);
  return (int)cudaErrorInvalidValue;
}
