// Tiled matrix products of psoft_matmul.cu's "wmma" and "simt" engines.
//
// C (M x N) = A (M x D) . B (D x N), fp32 accumulation, where each operand
// is read through a descriptor rather than as one dense array:
//
//   A(m, d) = p1[m*ld1 + d] * s1[d]          for d <  D1
//           = p2[m*ld2 + d - D1] * s2[d-D1]  for D1 <= d < D   (fp32 part)
//   B(d, c) = p1[d*sd1 + c*sc1]              for d <  D1
//           = p2[(d-D1)*sd2 + c*sc2]         for D1 <= d < D
//
// so one loop over the extended depth D computes [x | v] . [W ; B] (the
// rank-r term is D - D1 more depth steps), and a transposed operand is read
// in place through its strides (no transposed copy is ever made).  A null
// scale is 1.  Every ragged edge (M, N, D, the D1 seam) is masked: elements
// outside are read as 0 and never written.
//
// Grouped products (a stack of G independent products, one per expert of an
// MoE layer) put the group on the grid's z axis: group g reads every
// pointer advanced by g times its group stride (in elements) and writes C
// advanced by g times C's, so one launch covers the stack and no block ever
// reads or writes another group's rows.  Group strides of 0 (the default)
// are the single product.
//
// Two engines:
//   * tc_gemm: bf16 tensor cores through WMMA (16x16x16 bf16 fragments,
//     fp32 accumulators).  128x128 block tile, 32-deep steps, 8 warps of
//     64x32; the next depth step is loaded into registers (16-byte vector
//     loads where aligned) while the current one multiplies out of shared
//     memory, double-buffered with one barrier per step.  The fp32 part of
//     A is scaled and rounded to bf16 as it enters the tile.
//   * simt_gemm: fp32 on the CUDA cores (exact fp32, as the plain version),
//     64x64 block tile, 16-deep steps, 4x4 outputs per thread.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {

template <typename T1>
struct ASrc {
  const T1* p1;
  long ld1;
  const float* s1;
  const float* p2;
  long ld2;
  const float* s2;
  int M, D1, D;
  bool vec1, vec2;  // 16-byte vector loads allowed for part 1 / part 2
  long g1, gs1, g2, gs2;  // group strides of p1, s1, p2, s2
};

template <typename T1, typename T2>
struct BSrc {
  const T1* p1;
  long sd1, sc1;
  const T2* p2;
  long sd2, sc2;
  int D1, D, N;
  bool vec1, vec2;  // 16-byte vector loads along the contiguous index
  long g1, g2;      // group strides of p1, p2
};

// the operands of group g (a null pointer stays null)
template <typename T1>
__device__ __forceinline__ ASrc<T1> group_of(ASrc<T1> s, int g) {
  s.p1 += g * s.g1;
  if (s.s1) s.s1 += g * s.gs1;
  if (s.p2) s.p2 += g * s.g2;
  if (s.s2) s.s2 += g * s.gs2;
  return s;
}
template <typename T1, typename T2>
__device__ __forceinline__ BSrc<T1, T2> group_of(BSrc<T1, T2> s, int g) {
  s.p1 += g * s.g1;
  if (s.p2) s.p2 += g * s.g2;
  return s;
}

template <typename T1>
__device__ __forceinline__ float a_at(const ASrc<T1>& s, int m, int d) {
  if (m >= s.M || d >= s.D) return 0.f;
  if (d < s.D1) {
    const float v = to_float(s.p1[(long)m * s.ld1 + d]);
    return s.s1 ? v * s.s1[d] : v;
  }
  const int j = d - s.D1;
  const float v = s.p2[(long)m * s.ld2 + j];
  return s.s2 ? v * s.s2[j] : v;
}

template <typename T1, typename T2>
__device__ __forceinline__ float b_at(const BSrc<T1, T2>& s, int d, int c) {
  if (d >= s.D || c >= s.N) return 0.f;
  if (d < s.D1) return to_float(s.p1[(long)d * s.sd1 + (long)c * s.sc1]);
  return to_float(s.p2[(long)(d - s.D1) * s.sd2 + (long)c * s.sc2]);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core engine
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32;
constexpr int kTcPad = 8;  // bf16 elements of padding per shared-memory row
constexpr int kTcThreads = 256;
constexpr int kTcASize = kTcBM * (kTcBK + kTcPad);  // one A buffer, elements
constexpr int kTcBSize = kTcBN * (kTcBK + kTcPad);  // >= BK * (BN + pad)
constexpr int kTcSmemBytes = 2 * (kTcASize + kTcBSize) * 2;

union Pack8 {  // eight bf16 bit patterns in one 16-byte word
  uint4 u;
  unsigned short h[8];
};

// 8 depth-contiguous elements of A at (m, d0 .. d0+7), as bf16
__device__ __forceinline__ uint4 tc_load_a(const ASrc<__nv_bfloat16>& s,
                                           int m, int d0) {
  Pack8 out;
  if (m < s.M) {
    if (s.vec1 && d0 + 8 <= s.D1)
      return *reinterpret_cast<const uint4*>(s.p1 + (long)m * s.ld1 + d0);
    if (s.vec2 && d0 >= s.D1 && d0 + 8 <= s.D) {
      const int j = d0 - s.D1;
      const float4* src =
          reinterpret_cast<const float4*>(s.p2 + (long)m * s.ld2 + j);
      const float4 lo = src[0], hi = src[1];
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (s.s2) {
        const float4* sc = reinterpret_cast<const float4*>(s.s2 + j);
        const float4 a = sc[0], b = sc[1];
        const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= w[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out.h[e] = __bfloat16_as_ushort(__float2bfloat16(v[e]));
      return out.u;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = d0 + e;
    if (m < s.M && d < s.D1 && !s.s1)  // exact: no round trip
      out.h[e] = __bfloat16_as_ushort(s.p1[(long)m * s.ld1 + d]);
    else
      out.h[e] = __bfloat16_as_ushort(__float2bfloat16(a_at(s, m, d)));
  }
  return out.u;
}

// 8 elements of B contiguous along the output column: (d, c0 .. c0+7)
__device__ __forceinline__ uint4 tc_load_b_rows(
    const BSrc<__nv_bfloat16, __nv_bfloat16>& s, int d, int c0) {
  if (d < s.D && c0 + 8 <= s.N) {
    if (d < s.D1 && s.vec1)
      return *reinterpret_cast<const uint4*>(s.p1 + (long)d * s.sd1 + c0);
    if (d >= s.D1 && s.vec2)
      return *reinterpret_cast<const uint4*>(
          s.p2 + (long)(d - s.D1) * s.sd2 + c0);
  }
  Pack8 out;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (d < s.D && c < s.N)
      v = d < s.D1 ? s.p1[(long)d * s.sd1 + (long)c * s.sc1]
                   : s.p2[(long)(d - s.D1) * s.sd2 + (long)c * s.sc2];
    out.h[e] = __bfloat16_as_ushort(v);
  }
  return out.u;
}

// 8 elements of B contiguous along the depth: (d0 .. d0+7, c)
__device__ __forceinline__ uint4 tc_load_b_cols(
    const BSrc<__nv_bfloat16, __nv_bfloat16>& s, int d0, int c) {
  if (c < s.N) {
    if (s.vec1 && d0 + 8 <= s.D1)
      return *reinterpret_cast<const uint4*>(s.p1 + (long)c * s.sc1 + d0);
    if (s.vec2 && d0 >= s.D1 && d0 + 8 <= s.D)
      return *reinterpret_cast<const uint4*>(s.p2 + (long)c * s.sc2 +
                                             (d0 - s.D1));
  }
  Pack8 out;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = d0 + e;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (d < s.D && c < s.N)
      v = d < s.D1 ? s.p1[(long)d * s.sd1 + (long)c * s.sc1]
                   : s.p2[(long)(d - s.D1) * s.sd2 + (long)c * s.sc2];
    out.h[e] = __bfloat16_as_ushort(v);
  }
  return out.u;
}

// kTransB: B is contiguous along the depth (stored column-major in shared
// memory and read by col_major fragments); else along the output column.
template <bool kTransB, typename TC>
__global__ void __launch_bounds__(kTcThreads)
    tc_gemm(ASrc<__nv_bfloat16> a, BSrc<__nv_bfloat16, __nv_bfloat16> b,
            TC* __restrict__ c, long ldc, long c_group) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kTcSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * kTcASize;
  constexpr int lda = kTcBK + kTcPad;                          // 40
  constexpr int ldb = kTransB ? kTcBK + kTcPad : kTcBN + kTcPad;  // 40/136

  a = group_of(a, blockIdx.z);
  b = group_of(b, blockIdx.z);
  c += blockIdx.z * c_group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int nk = (a.D + kTcBK - 1) / kTcBK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * kTcBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kTcThreads;  // 512 chunks of 8 per operand
      ra[i] = tc_load_a(a, m0 + id / 4, k0 + (id % 4) * 8);
      if constexpr (kTransB)
        rb[i] = tc_load_b_cols(b, k0 + (id % 4) * 8, n0 + id / 4);
      else
        rb[i] = tc_load_b_rows(b, k0 + id / 16, n0 + (id % 16) * 8);
    }
  };
  auto store = [&](int buf) {
    __nv_bfloat16* as = As + buf * kTcASize;
    __nv_bfloat16* bs = Bs + buf * kTcBSize;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kTcThreads;
      *reinterpret_cast<uint4*>(as + (id / 4) * lda + (id % 4) * 8) = ra[i];
      if constexpr (kTransB)
        *reinterpret_cast<uint4*>(bs + (id / 4) * ldb + (id % 4) * 8) = rb[i];
      else
        *reinterpret_cast<uint4*>(bs + (id / 16) * ldb + (id % 16) * 8) =
            rb[i];
    }
  };

  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
    const __nv_bfloat16* as = As + buf * kTcASize;
    const __nv_bfloat16* bs = Bs + buf * kTcBSize;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[4];
      using LayoutB =
          typename std::conditional<kTransB, wmma::col_major,
                                    wmma::row_major>::type;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB>
          fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 64 + i * 16) * lda + kk,
                               lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        if constexpr (kTransB)
          wmma::load_matrix_sync(fb[j], bs + col * ldb + kk, ldb);
        else
          wmma::load_matrix_sync(fb[j], bs + kk * ldb + col, ldb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time in shared
  // memory (over the A buffers, free after the last barrier) and writes the
  // in-range elements
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rb0 = m0 + wm * 64 + i * 16, cb0 = n0 + wn * 32 + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + e * 32;
        const int row = rb0 + idx / 16, col = cb0 + idx % 16;
        if (row < a.M && col < b.N)
          c[(long)row * ldc + col] = from_float<TC>(stage[idx]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core engine
// ---------------------------------------------------------------------------

constexpr int kSimtBM = 64, kSimtBN = 64, kSimtBK = 16;
constexpr int kSimtThreads = 256;

template <typename T1, typename TB1, typename TB2, typename TC>
__global__ void __launch_bounds__(kSimtThreads)
    simt_gemm(ASrc<T1> a, BSrc<TB1, TB2> b, TC* __restrict__ c, long ldc,
              long c_group) {
  __shared__ __align__(16) float As[kSimtBK][kSimtBM + 4];
  __shared__ __align__(16) float Bs[kSimtBK][kSimtBN + 4];
  const bool b_trans = b.sd1 == 1 && b.sc1 != 1;  // contiguous along depth
  a = group_of(a, blockIdx.z);
  b = group_of(b, blockIdx.z);
  c += blockIdx.z * c_group;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSimtBM, n0 = blockIdx.x * kSimtBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.D; k0 += kSimtBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kSimtThreads;
      const int am = id / kSimtBK, ad = id % kSimtBK;
      As[ad][am] = a_at(a, m0 + am, k0 + ad);
      int bd, bc;
      if (b_trans) {
        bc = id / kSimtBK;
        bd = id % kSimtBK;
      } else {
        bd = id / kSimtBN;
        bc = id % kSimtBN;
      }
      Bs[bd][bc] = b_at(b, k0 + bd, n0 + bc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= b.N) continue;
      c[(long)row * ldc + col] = from_float<TC>(acc[i][j]);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long>(p) & 15u) == 0;
}

// ``groups`` products, C's group stride ``c_group`` elements
template <typename T1, typename TB1, typename TB2, typename TC>
cudaError_t launch_simt(const ASrc<T1>& a, const BSrc<TB1, TB2>& b, TC* c,
                        long ldc, cudaStream_t stream, int groups = 1,
                        long c_group = 0) {
  const dim3 grid((b.N + kSimtBN - 1) / kSimtBN,
                  (a.M + kSimtBM - 1) / kSimtBM, groups);
  simt_gemm<T1, TB1, TB2, TC><<<grid, kSimtThreads, 0, stream>>>(
      a, b, c, ldc, c_group);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t launch_tc(const ASrc<__nv_bfloat16>& a,
                      const BSrc<__nv_bfloat16, __nv_bfloat16>& b,
                      bool trans_b, TC* c, long ldc, cudaStream_t stream,
                      int groups = 1, long c_group = 0) {
  const dim3 grid((b.N + kTcBN - 1) / kTcBN, (a.M + kTcBM - 1) / kTcBM,
                  groups);
  if (trans_b)
    tc_gemm<true, TC><<<grid, kTcThreads, 0, stream>>>(a, b, c, ldc,
                                                       c_group);
  else
    tc_gemm<false, TC><<<grid, kTcThreads, 0, stream>>>(a, b, c, ldc,
                                                        c_group);
  return cudaGetLastError();
}

}  // namespace repro_torch
