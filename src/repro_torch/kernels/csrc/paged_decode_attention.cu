// Paged decode attention: one-token GQA over a block-paged KV cache, as
// split-page flash decoding.
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
// card's ~295 flops/byte ridge, so the floor is HBM bandwidth.  At serving
// sizes (8 rows of at most 512 tokens) the bytes take ~2 us: what sets the
// time is latency, so the design spreads a row over many SMs.
//
// Design, two kernels on the caller's stream:
//   1. split kernel, grid (B * KH, S): block (row b, kv head, split s) owns
//      pages [s * pps, (s + 1) * pps) of the row's table (the wrapper picks
//      pps so that B * KH * S fills the card about twice over).  The block
//      reads the row's length and its page ids from device memory (the host
//      never reads lengths); a split that starts past the row's end writes
//      an empty partial (l = 0) and returns.  Pages stream through a
//      double-buffered shared-memory ring with 16-byte cp.async copies (one
//      token's row for one kv head is D contiguous elements), the next page
//      loading while the current one computes.  The G = H / KH query heads
//      of the group share every page: scores come from 16-byte vector reads
//      of shared memory, the lanes of a token reduced by warp shuffles; one
//      warp per head folds the page into its online softmax with shuffle
//      reductions; threads own head-dim columns for the V update.  Masked
//      tokens never enter a sum.  The split writes (m, l, acc[D]) in fp32 to
//      scratch the wrapper allocated.
//   2. combine kernel, one block per (row, head): rescales the non-empty
//      splits to their common max, sums them and writes the output in q's
//      dtype; no non-empty split (a row of length 0) writes exact zeros.
//      Where the caller asks for it, it also writes the row's and head's
//      fp32 log-sum-exp of the scaled scores, mx + log(l), -inf for a row
//      of length 0: a decode over one slice of the sequence combines the
//      slices' outputs with it.  The log is the fast intrinsic (l >= 1, a
//      few ulp); the library's logf spills the combine's registers.
// Any D: where D * sizeof(T) is a multiple of 16 and the pools are 16-byte
// aligned, pages move by 16-byte cp.async and scores read 16 bytes of K at
// a time; otherwise (an odd bf16 head dim, say) the same kernel copies and
// reads element by element, the choice made by shape on the host.
#include "common.cuh"
#include "ptx.cuh"

namespace repro_torch {

constexpr int kDecodeThreads = 128;

// 16 bytes of T as fp32: 8 bf16 or 4 floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    // a bf16 is the top half of its fp32: shift, no conversion, and no
    // local copy of the vector (indexing one would spill it to the stack)
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Elements a lane moves and reads at once: 16 bytes (kVec16), else one
template <typename T, bool kVec16>
__host__ __device__ constexpr int chunk_elems() {
  return kVec16 ? Vec16<T>::kN : 1;
}

// dot(q, k) over one chunk of a token's row: q fp32 in shared memory
template <typename T, bool kVec16>
__device__ __forceinline__ float chunk_dot(const T* k, const float* q) {
  if constexpr (kVec16) {
    constexpr int kVec = Vec16<T>::kN;
    float kf[kVec];
    Vec16<T>::load(k, kf);
    const float4* qv = reinterpret_cast<const float4*>(q);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < kVec / 4; ++e) {
      const float4 qq = qv[e];
      dot += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1] + qq.z * kf[4 * e + 2] +
             qq.w * kf[4 * e + 3];
    }
    return dot;
  } else {
    return q[0] * to_float(k[0]);
  }
}

// Copy the K and V rows of table column j of row b, kv head kh, into ring
// buffer ``buf`` ([2][K, V][pg][D] at kv_s): by 16-byte cp.async as one
// commit group (kVec16), else element by element with plain loads
template <typename T, bool kVec16>
__device__ __forceinline__ void issue_page(T* kv_s, const T* k_pool,
                                           const T* v_pool,
                                           const int* page_table, int b,
                                           int kh, int j, int buf, int KH,
                                           int D, int P, int pg, int maxp) {
  constexpr int kVec = chunk_elems<T, kVec16>();
  const int chunks = D / kVec;
  const int tile = pg * D;
  const int page = clamp_index(page_table[(size_t)b * maxp + j], P);
  const size_t base = ((size_t)page * pg * KH + kh) * D;
  T* ks = kv_s + (2 * buf) * tile;
  T* vs = ks + tile;
  for (int i = threadIdx.x; i < pg * chunks; i += kDecodeThreads) {
    const int t = i / chunks, c = (i % chunks) * kVec;
    const size_t off = base + (size_t)t * KH * D + c;
    if constexpr (kVec16) {
      ptx::cp_async(ks + t * D + c, k_pool + off);
      ptx::cp_async(vs + t * D + c, v_pool + off);
    } else {
      ks[t * D + c] = k_pool[off];
      vs[t * D + c] = v_pool[off];
    }
  }
  if constexpr (kVec16) ptx::cp_async_commit();
}

// 4 blocks per SM fill one wave at serving sizes; naming them keeps ptxas
// from capping the registers at 40 and spilling loop invariants
template <typename T, bool kVec16>
__global__ void __launch_bounds__(kDecodeThreads, 4) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ part, int B, int H,
    int KH, int D, int P, int pg, int maxp, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = chunk_elems<T, kVec16>();
  const int G = H / KH;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int nwarps = kDecodeThreads / 32;

  // partials: acc (B, H, S, D), then m (B, H, S), then l (B, H, S)
  const size_t rows = (size_t)B * H * S;
  float* part_acc = part;
  float* part_m = part + rows * D;
  float* part_l = part_m + rows;
  const size_t head0 = ((size_t)b * H + (size_t)kh * G) * S + split;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > maxp * pg ? maxp * pg : len);
  const int npages_row = (len + pg - 1) / pg;
  const int j0 = split * pps;
  const int j1 = min(j0 + pps, npages_row);
  if (j0 >= j1) {  // empty split: nothing past the row's end is read
    for (int g = tid; g < G; g += kDecodeThreads) {
      part_m[head0 + (size_t)g * S] = kNegInf;
      part_l[head0 + (size_t)g * S] = 0.f;
    }
    return;
  }

  const int tile = pg * D;  // elements of one page's K (or V) for one head
  T* kv_s = reinterpret_cast<T*>(smem_raw);  // [2 buffers][K, V][pg][D]
  float* q_s = reinterpret_cast<float*>(                   // [G][D]
      smem_raw + ((4 * tile * sizeof(T) + 15) & ~(size_t)15));
  float* acc = q_s + G * D;                                // [G][D]
  float* s_s = acc + G * D;                                // [G][pg]
  float* m_s = s_s + G * pg;                               // [G]
  float* l_s = m_s + G;                                    // [G]
  float* c_s = l_s + G;                                    // [G]

  const int chunks = D / kVec;  // chunks per token row
  issue_page<T, kVec16>(kv_s, k_pool, v_pool, page_table, b, kh, j0, 0, KH, D,
                       P, pg, maxp);
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    q_s[i] = to_float(q[((size_t)b * H + kh * G) * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // lanes per token: the chunks of a row, rounded up to a power of two, at
  // most a warp
  int lpt = 1;
  while (lpt < chunks && lpt < 32) lpt <<= 1;
  const int tpw = 32 / lpt;  // tokens per warp pass
  const int sub = lane % lpt;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) {
      issue_page<T, kVec16>(kv_s, k_pool, v_pool, page_table, b, kh, j + 1,
                            buf ^ 1, KH, D, P, pg, maxp);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // page j landed for every thread; q and acc set
    const T* ks = kv_s + (2 * buf) * tile;
    const T* vs = ks + tile;
    const int ntok = min(pg, len - j * pg);

    // scores of the page's valid tokens, all G heads
    for (int t0 = warp * tpw; t0 < ntok; t0 += nwarps * tpw) {
      const int t = t0 + lane / lpt;
      const bool valid = t < ntok;
      for (int g = 0; g < G; ++g) {
        float part_dot = 0.f;
        if (valid) {
          for (int c = sub; c < chunks; c += lpt)
            part_dot += chunk_dot<T, kVec16>(ks + t * D + c * kVec,
                                             q_s + g * D + c * kVec);
        }
        for (int o = lpt / 2; o > 0; o >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
        if (valid && sub == 0) s_s[g * pg + t] = part_dot * scale;
      }
    }
    __syncthreads();

    // one warp per head folds the page into its running softmax
    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, s_s[g * pg + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float p = expf(s_s[g * pg + t] - m_new);
        s_s[g * pg + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int d = tid; d < D; d += kDecodeThreads) {
      for (int g = 0; g < G; ++g) {
        float a = acc[g * D + d] * c_s[g];
        for (int t = 0; t < ntok; ++t)
          a += s_s[g * pg + t] * to_float(vs[t * D + d]);
        acc[g * D + d] = a;
      }
    }
    __syncthreads();  // buffer buf and s_s free for the next page
  }

  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    part_acc[(head0 + (size_t)g * S) * D + d] = acc[i];
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    part_m[head0 + (size_t)g * S] = m_s[g];
    part_l[head0 + (size_t)g * S] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                          float* __restrict__ lse, int rows, int S, int D) {
  const int row = blockIdx.x;  // b * H + h
  const float* part_acc = part;
  const float* part_m = part + (size_t)rows * S * D;
  const float* part_l = part_m + (size_t)rows * S;
  float mx = kNegInf;
  for (int s = 0; s < S; ++s)
    if (part_l[(size_t)row * S + s] > 0.f)
      mx = fmaxf(mx, part_m[(size_t)row * S + s]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ls = part_l[(size_t)row * S + s];
    if (ls > 0.f) l += ls * expf(part_m[(size_t)row * S + s] - mx);
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = l > 0.f ? mx + __logf(l) : __int_as_float(0xff800000);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)row * S + s;
      if (part_l[i] > 0.f) a += part_acc[i * D + d] * expf(part_m[i] - mx);
    }
    out[(size_t)row * D + d] = from_float<T>(l > 0.f ? a / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   float* part, float* lse, int B, int H, int KH, int D,
                   int P, int pg, int maxp, int pps, cudaStream_t stream) {
  const int G = H / KH;
  const int S = (maxp + pps - 1) / pps;
  // q_s (fp32) follows the K/V ring: round the ring up to 16 bytes
  const size_t ring = ((size_t)4 * pg * D * sizeof(T) + 15) & ~(size_t)15;
  const size_t smem =
      ring + (size_t)(2 * G * D + G * pg + 3 * G) * sizeof(float);
  const bool vec16 = (D * sizeof(T)) % 16 == 0 &&
                     ((reinterpret_cast<size_t>(k_pool) |
                       reinterpret_cast<size_t>(v_pool)) & 15) == 0;
  void (*kernel)(const T*, const T*, const T*, const int*, const int*,
                 float*, int, int, int, int, int, int, int, int, float) =
      vec16 ? decode_split_kernel<T, true> : decode_split_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<dim3(B * KH, S), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), part, B, H, KH, D, P, pg, maxp, pps,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, kDecodeThreads, 0, stream>>>(
      part, static_cast<T*>(out), lse, B * H, S, D);
  return cudaGetLastError();
}

}  // namespace repro_torch

// part: B * H * S * (D + 2) fp32 scratch, S = ceil(maxp / pps); lse: null,
// or B * H fp32 for each row's and head's log-sum-exp
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, void* part,
    void* lse, int B, int H, int KH, int D, int P, int pg, int maxp, int pps,
    void* stream) {
  if (B == 0) return 0;
  if (KH <= 0 || H % KH != 0 || D <= 0 || pg <= 0 || maxp <= 0 || P <= 0 ||
      pps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  float* lf = static_cast<float*>(lse);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch<float>(q, k_pool, v_pool, page_table,
                                           lengths, out, pf, lf, B, H, KH, D,
                                           P, pg, maxp, pps, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch<__nv_bfloat16>(
        q, k_pool, v_pool, page_table, lengths, out, pf, lf, B, H, KH, D, P,
        pg, maxp, pps, s);
  return (int)cudaErrorInvalidValue;
}
