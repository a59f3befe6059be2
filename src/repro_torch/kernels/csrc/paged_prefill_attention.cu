// Paged prefix-prefill attention: suffix tokens attend over the row's
// resident prefix pages, then causally over the suffix itself.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention.py,
// paged_prefill_attention_pallas.
//
//   q (B, S, H, D); k, v (B, S, KH, D) post-RoPE suffix projections; pools
//   (P, pg, KH, D); prefix_table (B, maxp >= 1) int32; prefix_len (B,) int32,
//   any value in [0, maxp * pg] (not page-aligned in general).
//   Query i of row b attends prefix tokens [0, prefix_len[b]) and suffix
//   keys j <= i, fp32 online softmax, scale 1/sqrt(D).
//
// What bounds it on the H100: at serving shapes (S of a few hundred, a
// prefix of a few pages) the work is ~4 * S * (Spre + S/2) * H * D flops on
// ~2 * (Spre + S) * KH * D + 2 * S * H * D elements, which lands near the
// ridge; this simple kernel does its dot products on the CUDA cores in fp32,
// so in practice its own arithmetic bounds it, far from either roofline.
//
// Design: one block per (query tile of TQ positions, kv head, row).  The TPU
// grid walked prefix pages in order with the softmax state in scratch; here
// the block walks its own keys in chunks of CK: first the prefix tokens
// (each chunk resolves page = table[pos / pg], so any page size and a
// prefix ending mid-page work), then the suffix keys up to the tile's last
// query.  Each chunk is staged in shared memory; one thread per (query,
// key) pair computes a score, one thread per query folds the chunk into
// that query's running max / sum, and threads own (query, column) pairs of
// the accumulator.  Masked pairs (a suffix key after the query) get an
// exact zero probability, so fully masked chunks add nothing.  TQ is chosen
// by the host so the tile fits in shared memory.
#include "common.cuh"

namespace repro_torch {

constexpr int kChunk = 16;  // keys staged per step

__host__ __device__ inline size_t prefill_smem_floats(int TQ, int G, int D) {
  const int R = TQ * G;
  const int DP = D + 1;  // padded row: conflict-free key reads
  return (size_t)R * DP + (size_t)R * D + (size_t)kChunk * DP +
         (size_t)kChunk * D + (size_t)R * kChunk + 3 * (size_t)R;
}

template <typename T>
__global__ void paged_prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ prefix_table, const int* __restrict__ prefix_len,
    T* __restrict__ out, int S, int H, int KH, int D, int P, int pg,
    int maxp, int TQ, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int i0 = blockIdx.x * TQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(TQ, S - i0);   // query positions in this tile
  const int R = nq * G;             // query rows; row r = (i - i0) * G + g
  const int RT = TQ * G;            // allocated rows
  const int DP = D + 1;
  float* q_s = smem;                // [RT][DP]
  float* acc = q_s + RT * DP;       // [RT][D]
  float* k_s = acc + RT * D;        // [kChunk][DP]
  float* v_s = k_s + kChunk * DP;   // [kChunk][D]
  float* s_s = v_s + kChunk * D;    // [RT][kChunk]
  float* m_s = s_s + RT * kChunk;   // [RT]
  float* l_s = m_s + RT;            // [RT]
  float* c_s = l_s + RT;            // [RT]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  for (int idx = tid; idx < R * D; idx += nthreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int i = i0 + r / G;
    const int g = r % G;
    q_s[r * DP + d] = to_float(q[(((size_t)b * S + i) * H + kh * G + g) * D + d]);
    acc[r * D + d] = 0.f;
  }
  for (int r = tid; r < R; r += nthreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int plen = prefix_len[b];
  plen = plen < 0 ? 0 : (plen > maxp * pg ? maxp * pg : plen);
  const int kend = i0 + nq;         // suffix keys this tile can see
  const int n_pre_chunks = (plen + kChunk - 1) / kChunk;
  const int n_chunks = n_pre_chunks + (kend + kChunk - 1) / kChunk;

  for (int c = 0; c < n_chunks; ++c) {
    const bool suffix = c >= n_pre_chunks;
    const int c0 = suffix ? (c - n_pre_chunks) * kChunk : c * kChunk;
    const int nk = min(kChunk, (suffix ? kend : plen) - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int idx = tid; idx < nk * D; idx += nthreads) {
      const int t = idx / D;
      const int d = idx % D;
      size_t off;
      if (suffix) {
        off = (((size_t)b * S + c0 + t) * KH + kh) * D + d;
        k_s[t * DP + d] = to_float(k[off]);
        v_s[t * D + d] = to_float(v[off]);
      } else {
        const int pos = c0 + t;
        const int page =
            clamp_index(prefix_table[(size_t)b * maxp + pos / pg], P);
        off = (((size_t)page * pg + pos % pg) * KH + kh) * D + d;
        k_s[t * DP + d] = to_float(k_pool[off]);
        v_s[t * D + d] = to_float(v_pool[off]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * nk; idx += nthreads) {
      const int r = idx / nk;
      const int t = idx % nk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[t * DP + d];
      s_s[r * kChunk + t] = dot * scale;
    }
    __syncthreads();
    for (int r = tid; r < R; r += nthreads) {
      // suffix key c0 + t is visible to query i iff c0 + t <= i
      const int last = suffix ? min(nk, i0 + r / G - c0 + 1) : nk;
      float mx = m_s[r];
      for (int t = 0; t < last; ++t) mx = fmaxf(mx, s_s[r * kChunk + t]);
      const float corr = expf(m_s[r] - mx);
      float sum = 0.f;
      for (int t = 0; t < nk; ++t) {
        const float p = t < last ? expf(s_s[r * kChunk + t] - mx) : 0.f;
        s_s[r * kChunk + t] = p;
        sum += p;
      }
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = mx;
      c_s[r] = corr;
    }
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += nthreads) {
      const int r = idx / D;
      const int d = idx % D;
      float a = acc[r * D + d] * c_s[r];
      for (int t = 0; t < nk; ++t) a += s_s[r * kChunk + t] * v_s[t * D + d];
      acc[r * D + d] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += nthreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int i = i0 + r / G;
    const int g = r % G;
    const float l = fmaxf(l_s[r], 1e-30f);
    out[(((size_t)b * S + i) * H + kh * G + g) * D + d] =
        from_float<T>(acc[r * D + d] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_pool, const void* v_pool,
                   const void* prefix_table, const void* prefix_len,
                   void* out, int B, int S, int H, int KH, int D, int P,
                   int pg, int maxp, cudaStream_t stream) {
  const int G = H / KH;
  int TQ = 16;
  while (TQ > 1 && prefill_smem_floats(TQ, G, D) * sizeof(float) >
                       96 * 1024)
    TQ /= 2;
  const size_t smem = prefill_smem_floats(TQ, G, D) * sizeof(float);
  cudaError_t err = allow_smem(paged_prefill_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((S + TQ - 1) / TQ, KH, B);
  paged_prefill_attention_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(prefix_table),
      static_cast<const int*>(prefix_len), static_cast<T*>(out), S, H, KH,
      D, P, pg, maxp, TQ, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int paged_prefill_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* k_pool, const void* v_pool, const void* prefix_table,
    const void* prefix_len, void* out, int B, int S, int H, int KH, int D,
    int P, int pg, int maxp, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KH <= 0 || H % KH != 0 || D <= 0 || pg <= 0 || maxp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch<float>(q, k, v, k_pool, v_pool,
                                           prefix_table, prefix_len, out, B,
                                           S, H, KH, D, P, pg, maxp, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch<__nv_bfloat16>(
        q, k, v, k_pool, v_pool, prefix_table, prefix_len, out, B, S, H, KH,
        D, P, pg, maxp, s);
  return (int)cudaErrorInvalidValue;
}
