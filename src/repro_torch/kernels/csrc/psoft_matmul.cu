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
// Grouped (G > 1): every array is a stack of G of the above, one per expert
// of an MoE layer's expert stack (x (G, M, K), W_res (G, K, N), A (G, K, r),
// R (G, r, r), B (G, r, N), alpha and beta (G, r); u, t (G, M, r); y
// (G, M, N)), and group g computes the function above on its own slices.
// The reference vmaps one PSOFT linear over the expert axis
// (src/repro/models/moe.py, apply_linear_stacked); here the group is a grid
// axis of every launch, so a stack of 64 experts takes the same launches
// as one linear (the projection, the rotation, the output product) and its
// 64 x (M / 128) x (N / 128) output tiles fill the card together, where a
// launch per expert would leave most SMs idle (at deepseek-moe-16b's
// capacity buffer, M = 240 rows, one expert is 2 x 11 tiles on 132 SMs).
// The 2-D call is G = 1.
//
// What bounds it on the H100: operations.  At a llama32-3b gate/up linear
// (M = 2048 tokens, K = 3072, N = 8192, r = 352) the launch does ~120 GFLOP
// on ~105 MB, ~1100 flops per byte, far above the ~295 flops/byte ridge of
// bf16 tensor cores, so the tensor-core rate is the limit.
//
// Three engines, chosen per call by the wrapper (kernels/ops.py
// _psoft_engine) from dtype, shape and alignment, and passed here as a code
// that the entry point refuses if the shapes do not meet its requirements:
//
// wgmma (bf16; K, N and r multiples of 8, every array 16-byte aligned: what
// TMA takes), three launches of hopper_gemm.cuh's engine and one fp32 one:
//   1. u = x P_in on the Hopper engine with an fp32 epilogue, 64 x 64
//      tiles, N-fastest (the blocks in flight share x's rows): 192 blocks at
//      M = 2048, r = 352, so the card fills (128 x 128 tiles gave 48).
//      P_in = A is read MN-major, B^T (transposed launch) K-major, in place.
//   2. t = (u . s_in) R' and v = bf16(t . s_out): a register-tiled,
//      double-buffered fp32 product on the CUDA cores (exact fp32, as the
//      TPU kernel's finalize step), 64 x 64 tiles of 4 x 4 per thread.  v
//      is rounded where the plain version rounds it; TMA needs it as a bf16
//      array in memory, so it makes one (M, r) round trip through L2.
//   3. y = [x | v] [W' ; P_out] on the Hopper engine, 128 x 128 tiles, two
//      consumer warpgroups, a 5-stage ring, M-fastest (the blocks in flight
//      share the weights' columns, each weight read from HBM about once):
//      ceil(din / 64) depth steps over x and W', then ceil(r / 64) over v
//      and P_out; TMA's zero fill keeps the seam exact at r = 352 = 5.5 x 64
//      or any din.  W' = W_res and P_out = B are read MN-major (forward),
//      W_res^T and A^T K-major (transposed), all in place.
//   Tiles: 128 x 128 gives 384 tiles for q/o and every dx (2.9 waves on 132
//   SMs), 128 for k/v (one wave) and 1024 for gate/up (7.8 waves); 128 x 256
//   would leave k/v on 64 SMs, so 128 x 128 it is, one tile per block (no
//   persistent grid yet: each tile's epilogue does not overlap the next
//   tile's loads).
// wmma (any other bf16 shape, e.g. r = 9 or 33): the first design, three
//   launches of gemm_tiles.cuh:
//   1. u = x P_in on WMMA tensor cores, once per M block;
//   2. t = (u . s_in) R' in fp32 on the CUDA cores (simt_gemm);
//   3. y = [x | t . s_out] [W' ; P_out]: one tiled WMMA product over the
//      extended depth K + r, v rounded to bf16 as it enters the tile;
//      ragged M, N, K and r are masked, all operands read through strides.
// simt (fp32): the same three products on the CUDA cores, exact fp32.
// The TPU kernel kept a bm x r fp32 accumulator and the whole r x r R in
// VMEM (180 KB + 496 KB at r = 352), which does not fit beside the tiles in
// a block's 227 KB; here u, t (and v) make one round trip through device
// memory (L2-resident) instead.
#include <initializer_list>

#include "gemm_tiles.cuh"
#include "hopper_gemm.cuh"

namespace repro_torch {

// a pointer whose every group's slice starts 16-byte aligned
template <typename T>
bool aligned16_groups(const T* p, long group_elems, int G) {
  return aligned16(p) && (G == 1 || (group_elems * sizeof(T)) % 16 == 0);
}

template <typename T>
cudaError_t launch_psoft(bool transpose, const T* x, const T* w_res,
                         const T* a, const float* rot, const T* b,
                         const float* s_in, const float* s_out, float* u,
                         float* t, T* y, int G, int M, int K, int N, int r,
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
  // elements per group of each stacked array
  const long gx = (long)M * din, gw = (long)K * N, ga = (long)K * r,
             gb = (long)r * N, gr = (long)r * r, gu = (long)M * r,
             gy = (long)M * dout;
  const long gpin = transpose ? gb : ga, gpout = transpose ? ga : gb;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  cudaError_t err;

  if (r > 0) {
    ASrc<T> a1{x, din, nullptr, nullptr, 0, nullptr, M, din, din,
               false, false, gx, 0, 0, 0};
    BSrc<T, T> b1{p_in, pin_sd, pin_sc, nullptr, 0, 0, din, din, r,
                  false, false, gpin, 0};
    if constexpr (kBf16) {
      a1.vec1 = din % 8 == 0 && aligned16_groups(x, gx, G);
      b1.vec1 = (transpose ? pin_sc : pin_sd) % 8 == 0 &&
                aligned16_groups(p_in, gpin, G);
      err = launch_tc(a1, b1, transpose, u, r, stream, G, gu);
    } else {
      err = launch_simt(a1, b1, u, r, stream, G, gu);
    }
    if (err != cudaSuccess) return err;
    ASrc<float> a2{u, r, s_in, nullptr, 0, nullptr, M, r, r, false, false,
                   gu, r, 0, 0};
    BSrc<float, float> b2{rot, rot_sd, rot_sc, nullptr, 0, 0, r, r, r,
                          false, false, gr, 0};
    err = launch_simt(a2, b2, t, r, stream, G, gu);
    if (err != cudaSuccess) return err;
  }
  ASrc<T> a3{x, din, nullptr, t, r, s_out, M, din, din + r, false, false,
             gx, 0, gu, r};
  BSrc<T, T> b3{w_res, w_sd, w_sc, p_out, pout_sd, pout_sc, din, din + r,
                dout, false, false, gw, gpout};
  if constexpr (kBf16) {
    a3.vec1 = din % 8 == 0 && aligned16_groups(x, gx, G);
    a3.vec2 = r % 4 == 0 && din % 4 == 0 && aligned16_groups(t, gu, G) &&
              aligned16_groups(s_out, r, G);
    b3.vec1 = N % 8 == 0 && aligned16_groups(w_res, gw, G);
    b3.vec2 = (transpose ? pout_sc % 8 == 0 && din % 8 == 0
                         : pout_sd % 8 == 0) &&
              aligned16_groups(p_out, gpout, G);
    return launch_tc(a3, b3, transpose, y, dout, stream, G, gy);
  } else {
    return launch_simt(a3, b3, y, dout, stream, G, gy);
  }
}


// ---------------------------------------------------------------------------
// the wgmma engine's path
// ---------------------------------------------------------------------------

constexpr int kRotBM = 64, kRotBN = 64, kRotBK = 16, kRotThreads = 256;

// depth step k0 of rotate_kernel's operands into registers: ra the 4
// depth-contiguous (u . s_in) values of row m0 + tid / 4, rb 4 contiguous
// values of R'
template <bool kTransR>
__device__ __forceinline__ void rotate_load(const float* __restrict__ u,
                                            const float* __restrict__ s_in,
                                            const float* __restrict__ rot,
                                            int M, int r, int m0, int n0,
                                            int k0, float4& ra, float4& rb) {
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int row = m0 + tid / 4, da = k0 + (tid % 4) * 4;
  ra = zero;
  if (row < M && da < r) {
    ra = *reinterpret_cast<const float4*>(u + (long)row * r + da);
    ra.x *= s_in[da];
    ra.y *= s_in[da + 1];
    ra.z *= s_in[da + 2];
    ra.w *= s_in[da + 3];
  }
  rb = zero;
  if constexpr (kTransR) {  // R'(d, c) = R[c, d]: contiguous along d
    const int col = n0 + tid / 4, d = k0 + (tid % 4) * 4;
    if (col < r && d < r)
      rb = *reinterpret_cast<const float4*>(rot + (long)col * r + d);
  } else {
    const int d = k0 + tid / 16, col = n0 + (tid % 16) * 4;
    if (d < r && col < r)
      rb = *reinterpret_cast<const float4*>(rot + (long)d * r + col);
  }
}

// the registers of rotate_load into one shared-memory buffer, depth-major
template <bool kTransR>
__device__ __forceinline__ void rotate_store(float (*as)[kRotBM + 4],
                                             float (*bs)[kRotBN + 4],
                                             float4 ra, float4 rb) {
  const int tid = threadIdx.x;
  const int am = tid / 4, ad = (tid % 4) * 4;
  as[ad][am] = ra.x;
  as[ad + 1][am] = ra.y;
  as[ad + 2][am] = ra.z;
  as[ad + 3][am] = ra.w;
  if constexpr (kTransR) {
    const int bc = tid / 4, bd = (tid % 4) * 4;
    bs[bd][bc] = rb.x;
    bs[bd + 1][bc] = rb.y;
    bs[bd + 2][bc] = rb.z;
    bs[bd + 3][bc] = rb.w;
  } else {
    *reinterpret_cast<float4*>(&bs[tid / 16][(tid % 16) * 4]) = rb;
  }
}

// t = (u . s_in) R' (R' = R, or R^T read in place) and v = bf16(t . s_out),
// fp32 on the CUDA cores, for group blockIdx.z of a stack; r a multiple of
// 4 and u, R, t 16-byte aligned.
// Each thread computes 4 x 4 outputs; the next depth step is loaded into
// registers while the current one multiplies out of shared memory.  Two
// blocks per SM named: without a minimum ptxas capped it at 64 registers
// and spilled.
template <bool kTransR>
__global__ void __launch_bounds__(kRotThreads, 2)
    rotate_kernel(const float* __restrict__ u, const float* __restrict__ s_in,
                  const float* __restrict__ rot,
                  const float* __restrict__ s_out, float* __restrict__ t,
                  __nv_bfloat16* __restrict__ v, int M, int r) {
  __shared__ __align__(16) float As[2][kRotBK][kRotBM + 4];
  __shared__ __align__(16) float Bs[2][kRotBK][kRotBN + 4];
  const long g = blockIdx.z;
  u += g * M * r;
  t += g * M * r;
  v += g * M * r;
  rot += g * r * r;
  s_in += g * r;
  s_out += g * r;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kRotBM, n0 = blockIdx.x * kRotBN;
  float acc[4][4] = {};
  float4 ra, rb;
  rotate_load<kTransR>(u, s_in, rot, M, r, m0, n0, 0, ra, rb);
  rotate_store<kTransR>(As[0], Bs[0], ra, rb);
  __syncthreads();
  const int nk = (r + kRotBK - 1) / kRotBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk)
      rotate_load<kTransR>(u, s_in, rot, M, r, m0, n0, (kt + 1) * kRotBK, ra,
                           rb);
#pragma unroll
    for (int kk = 0; kk < kRotBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (kt + 1 < nk) rotate_store<kTransR>(As[buf ^ 1], Bs[buf ^ 1], ra, rb);
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= r) return;
  const float so[4] = {s_out[col], s_out[col + 1], s_out[col + 2],
                       s_out[col + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
    *reinterpret_cast<float4*>(t + (long)row * r + col) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __nv_bfloat162* vp =
        reinterpret_cast<__nv_bfloat162*>(v + (long)row * r + col);
    vp[0] = __floats2bfloat162_rn(acc[i][0] * so[0], acc[i][1] * so[1]);
    vp[1] = __floats2bfloat162_rn(acc[i][2] * so[2], acc[i][3] * so[3]);
  }
}

cudaError_t launch_psoft_wgmma(bool transpose, const __nv_bfloat16* x,
                               const __nv_bfloat16* w_res,
                               const __nv_bfloat16* a, const float* rot,
                               const __nv_bfloat16* b, const float* s_in,
                               const float* s_out, float* u, float* t,
                               __nv_bfloat16* v, __nv_bfloat16* y, int G,
                               int M, int K, int N, int r,
                               cudaStream_t stream) {
  using hopper::launch_gemm;
  using hopper::Operand;
  using bf16 = __nv_bfloat16;
  const int din = transpose ? N : K, dout = transpose ? K : N;
  // every operand as stored, G of each: x (M, din), W_res (K, N), A (K, r),
  // B (r, N), v (M, r); the engine reads B-side arrays MN-major (forward)
  // or K-major (transposed) from the same storage
  const Operand xs{x, din, M, G}, ws{w_res, N, K, G}, as{a, r, K, G},
      bs{b, N, r, G}, vs{v, r, M, G};
  cudaError_t err =
      transpose
          ? launch_gemm<1, 64, true, 4, float>(xs, bs, xs, xs, din, 0, u, M,
                                               r, false, stream, G)
          : launch_gemm<1, 64, false, 4, float>(xs, as, xs, xs, din, 0, u,
                                                M, r, false, stream, G);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + kRotBN - 1) / kRotBN, (M + kRotBM - 1) / kRotBM, G);
  if (transpose)
    rotate_kernel<true><<<grid, kRotThreads, 0, stream>>>(u, s_in, rot, s_out,
                                                         t, v, M, r);
  else
    rotate_kernel<false><<<grid, kRotThreads, 0, stream>>>(
        u, s_in, rot, s_out, t, v, M, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return transpose ? launch_gemm<2, 128, true, 5, bf16>(
                         xs, ws, vs, as, din, r, y, M, dout, true, stream, G)
                   : launch_gemm<2, 128, false, 5, bf16>(
                         xs, ws, vs, bs, din, r, y, M, dout, true, stream,
                         G);
}

}  // namespace repro_torch

// engine codes passed from kernels/ops.py
#define PSOFT_ENGINE_SIMT 0
#define PSOFT_ENGINE_WMMA 1
#define PSOFT_ENGINE_WGMMA 2

static bool aligned16_all(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!repro_torch::aligned16(p)) return false;
  return true;
}

// G stacked products (G = 1: one linear); v: (G, M, r) bf16 scratch, used
// by the wgmma engine only
extern "C" int psoft_matmul_launch(int dtype, int engine, int transpose,
                                   const void* x, const void* w_res,
                                   const void* a, const void* rot,
                                   const void* b, const void* s_in,
                                   const void* s_out, void* u, void* t,
                                   void* v, void* y, int G, int M, int K,
                                   int N, int r, void* stream) {
  if (G == 0 || M == 0 || (transpose ? K : N) == 0) return 0;
  if (G < 0 || G > 65535 || M < 0 || K <= 0 || N <= 0 || r < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rot);
  const float* si = static_cast<const float*>(s_in);
  const float* so = static_cast<const float*>(s_out);
  float* uf = static_cast<float*>(u);
  float* tf = static_cast<float*>(t);
  using bf16 = __nv_bfloat16;
  if (dtype == REPRO_DTYPE_F32 && engine == PSOFT_ENGINE_SIMT)
    return (int)repro_torch::launch_psoft<float>(
        transpose != 0, static_cast<const float*>(x),
        static_cast<const float*>(w_res), static_cast<const float*>(a), rf,
        static_cast<const float*>(b), si, so, uf, tf, static_cast<float*>(y),
        G, M, K, N, r, s);
  if (dtype == REPRO_DTYPE_BF16 && engine == PSOFT_ENGINE_WMMA)
    return (int)repro_torch::launch_psoft<bf16>(
        transpose != 0, static_cast<const bf16*>(x),
        static_cast<const bf16*>(w_res), static_cast<const bf16*>(a), rf,
        static_cast<const bf16*>(b), si, so, uf, tf, static_cast<bf16*>(y), G,
        M, K, N, r, s);
  if (dtype == REPRO_DTYPE_BF16 && engine == PSOFT_ENGINE_WGMMA) {
    // TMA's rules: 16-byte row pitches and bases
    if (r == 0 || K % 8 != 0 || N % 8 != 0 || r % 8 != 0 ||
        !aligned16_all({x, w_res, a, rot, b, u, t, v, y}))
      return (int)cudaErrorInvalidValue;
    return (int)repro_torch::launch_psoft_wgmma(
        transpose != 0, static_cast<const bf16*>(x),
        static_cast<const bf16*>(w_res), static_cast<const bf16*>(a), rf,
        static_cast<const bf16*>(b), si, so, uf, tf, static_cast<bf16*>(v),
        static_cast<bf16*>(y), G, M, K, N, r, s);
  }
  return (int)cudaErrorInvalidValue;
}
