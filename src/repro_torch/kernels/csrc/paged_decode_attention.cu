// Paged decode attention: one-token GQA over a block-paged KV cache.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention_pallas.
//
//   q (B, H, D); pools (P, pg, KH, D); page_table (B, maxp) int32 page ids in
//   position order; lengths (B,) int32 valid tokens per row.
//   out[b, h] = softmax(q[b, h] . K_b / sqrt(D)) V_b over the row's first
//   lengths[b] tokens, fp32 online softmax; a row of length 0 outputs exact
//   zeros.
//
// What bounds it on the H100: bytes.  Each row's K and V pages are read once
// (2 * len * KH * D elements) against ~4 flops per element, far below the
// card's ~295 flops/byte ridge, so the floor is HBM bandwidth.
//
// Design: one block per (row, kv head), so the G = H / KH query heads of a
// group share every K/V page load.  The TPU grid walked the pages in order
// with the softmax state in scratch; here the block loops over its own
// pages (ceil(len / pg) of them, read from the table itself), keeps the
// running max / sum / accumulator in shared memory, and touches only valid
// tokens, so masked positions never enter the sums.  Within a page, each
// warp computes the G scores of one token at a time (lanes split D, a
// shuffle reduction per head); one thread per head then folds the page into
// the running softmax; threads own head-dim columns for the V update.
// Simple and correct first: no split over the sequence (a long-context row
// runs on one SM), no tensor cores, no TMA.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int KH,
    int D, int P, int pg, int maxp, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  float* q_s = smem;            // [G][D] queries, fp32
  float* acc = q_s + G * D;     // [G][D] output accumulator
  float* s_s = acc + G * D;     // [G][pg] scores, then probabilities
  float* m_s = s_s + G * pg;    // [G] running max
  float* l_s = m_s + G;         // [G] running sum
  float* c_s = l_s + G;         // [G] rescale factor of the current page
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nthreads / 32;

  for (int i = tid; i < G * D; i += nthreads) {
    const int g = i / D;
    const int d = i % D;
    q_s[i] = to_float(q[((size_t)b * H + kh * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nthreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  int len = lengths[b];
  len = len < 0 ? 0 : (len > maxp * pg ? maxp * pg : len);
  const int npages = (len + pg - 1) / pg;
  for (int j = 0; j < npages; ++j) {
    const int page = clamp_index(page_table[(size_t)b * maxp + j], P);
    const int ntok = min(pg, len - j * pg);
    const size_t page_base = (size_t)page * pg;
    // scores of the page's valid tokens
    for (int t = warp; t < ntok; t += nwarps) {
      const T* krow = k_pool + ((page_base + t) * KH + kh) * D;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) {
          part += q_s[g * D + d] * to_float(krow[d]);
        }
        part = warp_sum(part);
        if (lane == 0) s_s[g * pg + t] = part * scale;
      }
    }
    __syncthreads();
    // fold the page into each head's running softmax
    for (int g = tid; g < G; g += nthreads) {
      float mx = m_s[g];
      for (int t = 0; t < ntok; ++t) mx = fmaxf(mx, s_s[g * pg + t]);
      const float corr = expf(m_s[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < ntok; ++t) {
        const float p = expf(s_s[g * pg + t] - mx);
        s_s[g * pg + t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int d = tid; d < D; d += nthreads) {
      for (int g = 0; g < G; ++g) acc[g * D + d] *= c_s[g];
      for (int t = 0; t < ntok; ++t) {
        const float vv =
            to_float(v_pool[((page_base + t) * KH + kh) * D + d]);
        for (int g = 0; g < G; ++g) acc[g * D + d] += s_s[g * pg + t] * vv;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += nthreads) {
    const int g = i / D;
    const int d = i % D;
    const float l = fmaxf(l_s[g], 1e-30f);  // length 0: 0 / 1e-30 == 0
    out[((size_t)b * H + kh * G + g) * D + d] = from_float<T>(acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   int B, int H, int KH, int D, int P, int pg, int maxp,
                   cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = (size_t)(2 * G * D + G * pg + 3 * G) * sizeof(float);
  cudaError_t err = allow_smem(paged_decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  paged_decode_attention_kernel<T><<<B * KH, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KH, D, P,
      pg, maxp, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int KH, int D, int P, int pg, int maxp, void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0 || D <= 0 || pg <= 0 || maxp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch<float>(q, k_pool, v_pool, page_table,
                                           lengths, out, B, H, KH, D, P, pg,
                                           maxp, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch<__nv_bfloat16>(q, k_pool, v_pool,
                                                   page_table, lengths, out,
                                                   B, H, KH, D, P, pg, maxp,
                                                   s);
  return (int)cudaErrorInvalidValue;
}
