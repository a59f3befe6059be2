// Gathered low-rank-delta matmul: heterogeneous-adapter decode over a
// stacked adapter bank (the punica / S-LoRA "BGMV" pattern).
//
// Replaces the TPU kernel src/repro/kernels/gather_delta_matmul.py,
// gather_delta_matmul_pallas.
//
//   x (B, K) and W (K, N) in the compute dtype, left (A, K, r) in the
//   compute dtype, right (A, r, N) in fp32 (uncast, as the reference passes
//   it), ids (B,) int32 adapter columns.
//   y[b] = x[b] W + (x[b] left[ids[b]]) right[ids[b]], fp32 accumulation,
//   y in the compute dtype.
//
// What bounds it on the H100: bytes.  At decode B is the slot count (a
// handful of rows), so the K x N base weight dominates the traffic at
// ~2 * B flops per weight element, far below the ~295 flops/byte ridge.
//
// Design: two launches on the caller's stream.  The first computes
// u = x left[ids] as (B, r) fp32, one block per (row, 32 rank columns),
// eight warps splitting K.  The second reads each W tile ONCE for all B rows
// (the TPU grid (B, N/bn) re-read every tile per row): one block per
// (32 output columns, up to 8 rows), eight warps splitting K, each thread
// keeping its rows' partial sums in registers while x streams through shared
// memory in chunks.  The rank-r term then walks the distinct adapters of
// the block's rows, reading each distinct right[id] tile once and adding it
// to every row that uses that adapter.  No tensor cores, no TMA: right
// first, fast later.
#include "common.cuh"

namespace repro_torch {

constexpr int kRows = 8;      // rows per block in the output kernel
constexpr int kKGroups = 8;   // warps splitting the reduction dimension
constexpr int kStage = 512;   // x / u columns staged per step

template <typename T>
__global__ void lowrank_in_kernel(const T* __restrict__ x,
                                  const T* __restrict__ left,
                                  const int* __restrict__ ids,
                                  float* __restrict__ u, int K, int r,
                                  int A) {
  __shared__ float red[kKGroups][32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int kg = threadIdx.x / 32;
  const int j = blockIdx.y * 32 + lane;
  const int id = clamp_index(ids[b], A);
  float acc = 0.f;
  if (j < r) {
    const T* xrow = x + (size_t)b * K;
    const T* lcol = left + (size_t)id * K * r + j;
    for (int kk = kg; kk < K; kk += kKGroups)
      acc += to_float(xrow[kk]) * to_float(lcol[(size_t)kk * r]);
  }
  red[kg][lane] = acc;
  __syncthreads();
  if (kg == 0 && j < r) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kKGroups; ++g) s += red[g][lane];
    u[(size_t)b * r + j] = s;
  }
}

template <typename T>
__global__ void delta_out_kernel(const T* __restrict__ x,
                                 const T* __restrict__ w,
                                 const float* __restrict__ u,
                                 const float* __restrict__ right,
                                 const int* __restrict__ ids,
                                 T* __restrict__ y, int B, int K, int N,
                                 int r, int A) {
  __shared__ float stage[kRows][kStage];
  __shared__ float red[kKGroups][kRows][32];
  __shared__ int ids_s[kRows];
  const int lane = threadIdx.x % 32;
  const int kg = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  if (threadIdx.x < kRows)
    ids_s[threadIdx.x] =
        threadIdx.x < nb ? clamp_index(ids[b0 + threadIdx.x], A) : -1;
  float acc[kRows];
#pragma unroll
  for (int bb = 0; bb < kRows; ++bb) acc[bb] = 0.f;

  // base term: x W, each W element read once for all the block's rows
  for (int k0 = 0; k0 < K; k0 += kStage) {
    const int kc = min(kStage, K - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kc; idx += blockDim.x) {
      const int bb = idx / kc;
      const int kk = idx % kc;
      stage[bb][kk] =
          bb < nb ? to_float(x[(size_t)(b0 + bb) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      for (int kk = kg; kk < kc; kk += kKGroups) {
        const float wv = to_float(w[(size_t)(k0 + kk) * N + n]);
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) acc[bb] += stage[bb][kk] * wv;
      }
    }
  }

  // rank-r term: each distinct adapter's right tile read once
  for (int j0 = 0; j0 < r; j0 += kStage) {
    const int jc = min(kStage, r - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * jc; idx += blockDim.x) {
      const int bb = idx / jc;
      const int jj = idx % jc;
      stage[bb][jj] = bb < nb ? u[(size_t)(b0 + bb) * r + j0 + jj] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      for (int lead = 0; lead < nb; ++lead) {
        const int id = ids_s[lead];
        bool first = true;
        for (int c = 0; c < lead; ++c) first = first && ids_s[c] != id;
        if (!first) continue;  // an earlier row already covered this adapter
        const float* rcol = right + ((size_t)id * r + j0) * N + n;
        for (int jj = kg; jj < jc; jj += kKGroups) {
          const float rv = rcol[(size_t)jj * N];
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb)
            if (bb >= lead && ids_s[bb] == id) acc[bb] += stage[bb][jj] * rv;
        }
      }
    }
  }

#pragma unroll
  for (int bb = 0; bb < kRows; ++bb) red[kg][bb][lane] = acc[bb];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * 32; idx += blockDim.x) {
    const int bb = idx / 32;
    const int col = blockIdx.x * 32 + idx % 32;
    if (bb < nb && col < N) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kKGroups; ++g) s += red[g][bb][idx % 32];
      y[(size_t)(b0 + bb) * N + col] = from_float<T>(s);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* left,
                   const void* right, const void* ids, void* u, void* y,
                   int B, int K, int N, int r, int A, cudaStream_t stream) {
  const int threads = 32 * kKGroups;
  if (r > 0) {
    const dim3 grid_u(B, (r + 31) / 32);
    lowrank_in_kernel<T><<<grid_u, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(left),
        static_cast<const int*>(ids), static_cast<float*>(u), K, r, A);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_y((N + 31) / 32, (B + kRows - 1) / kRows);
  delta_out_kernel<T><<<grid_y, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(right),
      static_cast<const int*>(ids), static_cast<T*>(y), B, K, N, r, A);
  return cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int gather_delta_matmul_launch(int dtype, const void* x,
                                          const void* w, const void* left,
                                          const void* right, const void* ids,
                                          void* u, void* y, int B, int K,
                                          int N, int r, int A, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (K <= 0 || r < 0 || A <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch<float>(x, w, left, right, ids, u, y, B, K,
                                           N, r, A, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch<__nv_bfloat16>(x, w, left, right, ids, u,
                                                   y, B, K, N, r, A, s);
  return (int)cudaErrorInvalidValue;
}
