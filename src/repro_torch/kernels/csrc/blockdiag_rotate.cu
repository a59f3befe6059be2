// Block-diagonal input rotation, the OFT family's hot spot:
//   y[m, g*b:(g+1)*b] = x[m, g*b:(g+1)*b] . R_g        (transpose: . R_g^T)
//
// Replaces the TPU kernel src/repro/kernels/blockdiag_rotate.py,
// blockdiag_rotate_pallas.
//
//   x (M, d) fp32 or bf16, row-major; rots (d/b, b, b) fp32 or x's type;
//   y (M, d) in x's type; fp32 accumulation.  Any M, and any block size b
//   from 1 to 128 that divides d.  Above 128 the launch returns
//   cudaErrorInvalidValue (the wrapper refuses it first): there is no tiled
//   path over R_g, whose fp32 copy alone would take 256 KB of shared memory
//   at b = 256.
//
// What bounds it on the H100: at M = 2048, d = 3072, b = 32 in bf16 it must
// move 25.2 MB (x in, y out: 7.5 us at 3.35 TB/s) for 2 M d b = 0.40 GFLOP,
// 0.4 us at the bf16 tensor-core peak: bytes.  This first kernel does its
// products on the CUDA cores in fp32 (67 TFLOP/s, 6.0 us for the same
// flops), so as written bytes and operations bound it about equally;
// mma.sync on each R_g is later work.
//
// Design: the TPU kernel batches gpt small MXU products per (bm x gpt b)
// slab over a sequential grid.  Here one block of 256 threads takes 64 rows
// by up to 128 columns (128 / b whole groups; one group when b = 128) and
// stages its groups' R_g (fp32; read transposed when ``transpose``) and its
// x tile (fp32, by 16-byte loads where the rows are aligned) in shared
// memory.  Each thread then owns one output column and 32 of the 64 rows,
// with 32 fp32 sums in registers: per 4 steps of k it reads 4 entries of
// its R column and one float4 of x per row, a broadcast, since the threads
// of a warp share the row and, for b >= 32, the group.  Blocks are
// independent; nothing carries between them.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kBdThreads = 256;
constexpr int kBdCols = 128;                              // columns a block
constexpr int kBdRowGroups = kBdThreads / kBdCols;        // 2
constexpr int kBdRows = 64;                               // rows a block
constexpr int kBdRowsPerThread = kBdRows / kBdRowGroups;  // 32
constexpr int kBdMaxBlock = 128;

// one 16-byte chunk of x, widened to fp32 in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

template <typename T, typename TR, bool kQuad>
__global__ void __launch_bounds__(kBdThreads)
    blockdiag_rotate_kernel(const T* __restrict__ x,
                            const TR* __restrict__ rots, T* __restrict__ y,
                            int M, int d, int b, int gpb, int transpose) {
  extern __shared__ float4 smem4[];
  const int bb = b * b;
  const int tile = gpb * b;                      // row stride of the x tile
  float* rs = reinterpret_cast<float*>(smem4);   // [gpb][b][b]
  float* xs = rs + round4(gpb * bb);             // [kBdRows][tile]
  const int col0 = blockIdx.y * tile;
  const int ncols = min(tile, d - col0);         // whole groups: b divides d
  const int row0 = blockIdx.x * kBdRows;

  // rs[(g * b + k) * b + c] = R_g[k][c], or R_g[c][k] when transposed
  const TR* rsrc = rots + (long)(col0 / b) * bb;
  const int rn = (ncols / b) * bb;
  for (int i = threadIdx.x; i < rn; i += kBdThreads) {
    int src = i;
    if (transpose) {
      const int g = i / bb, rem = i - g * bb, k = rem / b;
      src = g * bb + (rem - k * b) * b + k;
    }
    rs[i] = to_float(rsrc[src]);
  }
  // the x tile; rows past M are zeros and are never written back
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && col0 % V == 0 && ncols % V == 0 &&
                   tile % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    const int per_row = ncols / V;
    for (int i = threadIdx.x; i < kBdRows * per_row; i += kBdThreads) {
      const int r = i / per_row, ch = i - r * per_row;
      float* dst = xs + r * tile + ch * V;
      if (row0 + r < M) {
        load16(x + (long)(row0 + r) * d + col0 + ch * V, dst);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBdRows * ncols; i += kBdThreads) {
      const int r = i / ncols, c = i - r * ncols;
      xs[r * tile + c] =
          row0 + r < M ? to_float(x[(long)(row0 + r) * d + col0 + c]) : 0.f;
    }
  }
  __syncthreads();

  const int cl = threadIdx.x % kBdCols;
  const int rg = threadIdx.x / kBdCols;
  if (cl >= ncols) return;
  const int g = cl / b;
  const float* rcol = rs + g * bb + (cl - g * b);   // rcol[k * b] = R[k][c]
  const float* xrow = xs + rg * tile + g * b;       // row i at i * 2 * tile
  constexpr int kRowStep = kBdRowGroups;
  float acc[kBdRowsPerThread];
#pragma unroll
  for (int i = 0; i < kBdRowsPerThread; ++i) acc[i] = 0.f;
  if (kQuad) {
    for (int k = 0; k < b; k += 4) {
      const float r0 = rcol[k * b], r1 = rcol[(k + 1) * b],
                  r2 = rcol[(k + 2) * b], r3 = rcol[(k + 3) * b];
#pragma unroll
      for (int i = 0; i < kBdRowsPerThread; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xrow + i * kRowStep * tile + k);
        float a = acc[i];
        a = fmaf(v.x, r0, a);
        a = fmaf(v.y, r1, a);
        a = fmaf(v.z, r2, a);
        a = fmaf(v.w, r3, a);
        acc[i] = a;
      }
    }
  } else {
    for (int k = 0; k < b; ++k) {
      const float r0 = rcol[k * b];
#pragma unroll
      for (int i = 0; i < kBdRowsPerThread; ++i)
        acc[i] = fmaf(xrow[i * kRowStep * tile + k], r0, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kBdRowsPerThread; ++i) {
    const int m = row0 + rg + i * kRowStep;
    if (m < M) y[(long)m * d + col0 + cl] = from_float<T>(acc[i]);
  }
}

template <typename T, typename TR>
cudaError_t launch_blockdiag(const void* x, const void* rots, void* y, int M,
                             int d, int b, int transpose,
                             cudaStream_t stream) {
  const int gpb = b >= kBdCols ? 1 : kBdCols / b;   // groups a block
  const int tile = gpb * b;
  const int nb = d / b;
  const dim3 grid((M + kBdRows - 1) / kBdRows, (nb + gpb - 1) / gpb);
  const size_t smem =
      (size_t)(round4(gpb * b * b) + kBdRows * tile) * sizeof(float);
  void (*kernel)(const T*, const TR*, T*, int, int, int, int, int) =
      blockdiag_rotate_kernel<T, TR, false>;
  if (b % 4 == 0) kernel = blockdiag_rotate_kernel<T, TR, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TR*>(rots),
      static_cast<T*>(y), M, d, b, gpb, transpose);
  return cudaGetLastError();
}

}  // namespace repro_torch

// dtype: x and y; rdtype: rots (fp32, or x's dtype)
extern "C" int blockdiag_rotate_launch(int dtype, int rdtype, int transpose,
                                       const void* x, const void* rots,
                                       void* y, int M, int d, int b,
                                       void* stream) {
  using namespace repro_torch;
  if (M == 0 || d == 0) return 0;
  if (M < 0 || d < 0 || b < 1 || b > kBdMaxBlock || d % b)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32 && rdtype == REPRO_DTYPE_F32)
    return (int)launch_blockdiag<float, float>(x, rots, y, M, d, b,
                                               transpose, s);
  if (dtype == REPRO_DTYPE_BF16 && rdtype == REPRO_DTYPE_F32)
    return (int)launch_blockdiag<__nv_bfloat16, float>(x, rots, y, M, d, b,
                                                       transpose, s);
  if (dtype == REPRO_DTYPE_BF16 && rdtype == REPRO_DTYPE_BF16)
    return (int)launch_blockdiag<__nv_bfloat16, __nv_bfloat16>(
        x, rots, y, M, d, b, transpose, s);
  return (int)cudaErrorInvalidValue;
}
