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
// What bounds it on the H100: at serving shapes (S of a few tens to a few
// hundred, a prefix of a few pages) the work is ~4 * S * (Spre + S/2) * H * D
// flops on ~2 * (Spre + S) * KH * D + 2 * S * H * D elements, near the
// bf16 ridge; at the serving path's shapes (4 x 64 suffix tokens, prefixes
// of 0-45 tokens) neither is more than ~1.4 us: a launch's latency and the
// first loads set the time.
//
// Two engines, chosen by dtype and head dim on the host
// (ops._prefill_engine); neither ever stands in for the other:
//
// "mma" (bf16, D in {32, 64, 128}): flash prefill on the tensor cores.  The
//   G = H / KH query heads of a kv head read the same keys, so a block owns
//   64 flattened query rows rho = i * G + g of one (row b, kv head): GQA's
//   groups fill whole tiles, and a tile may end mid-position; row rho's
//   position i = rho / G sets its causal limit.  Four warps own 16 rows
//   each and keep their Q fragments in registers.  Keys come in chunks of
//   64, first the prefix (each key resolves its page from the table on the
//   device, so any page size and a prefix ending mid-page work), then the
//   suffix up to the tile's last position (later chunks are skipped).  A
//   chunk's K and V rows (D * 2 contiguous bytes per page, slot and kv head)
//   land by 16-byte cp.async in a double-buffered shared-memory ring, chunk
//   c + 1 loading while chunk c computes; keys past the limit are
//   zero-filled.  S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate; operands by ldmatrix from rows padded by 16 bytes, so
//   the eight rows of each 8 x 8 matrix sit on distinct banks), P stays in
//   registers, and the online softmax runs in fp32 registers with quad
//   shuffles.  A masked score gives probability exactly 0, so a fully
//   masked chunk adds nothing; the diagonal is always visible, so no row is
//   left without a key.  mma.sync and not wgmma: a 64-row tile of 64 keys
//   is one m64n64k16 product per warpgroup step, and the serving shapes
//   launch ~100 blocks of two chunks each, so the asynchronous warpgroup
//   pipeline has nothing to overlap.
//
// "simt" (fp32, the tiny card-vs-CPU check, where TF32 would not meet the
//   fp32 limit; and bf16 at the head dims "mma" is not built for): the
//   first design, any D.  One block per (query tile of TQ positions,
//   kv head, row); the block walks its keys in chunks of 16 staged in
//   shared memory; one thread per (query, key) pair computes a score, one
//   thread per query folds the chunk into that query's running max / sum,
//   and threads own (query, column) pairs of the accumulator.  TQ is chosen
//   by the host so the tile fits in shared memory.
#include "common.cuh"
#include "ptx.cuh"

namespace repro_torch {

// ---------------------------------------------------------------------------
// "simt": fp32
// ---------------------------------------------------------------------------

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
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* k_pool, const void* v_pool,
                        const int* prefix_table, const int* prefix_len,
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
      static_cast<const T*>(v_pool), prefix_table, prefix_len,
      static_cast<T*>(out), S, H, KH, D, P, pg, maxp, TQ, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;    // flattened query rows per block
constexpr int kChunkKeys = 64;   // keys per chunk
constexpr int kMmaThreads = 128; // four warps of 16 rows

template <int D>
struct MmaTile {
  static constexpr int kPitch = D + 8;  // elements: +16 bytes a row
  static constexpr int kRowsElems = kTileRows * kPitch;
  static constexpr int kChunkElems = kChunkKeys * kPitch;
  // Q, then [2 buffers][K, V]
  static constexpr size_t kSmemBytes =
      (size_t)(kRowsElems + 4 * kChunkElems) * sizeof(__nv_bfloat16);
};

// Where a block's key chunks come from
struct ChunkSrc {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  const int* prefix_table;
  int b, kh, S, KH, P, pg, maxp;
  int n_pre;  // prefix chunks; chunk c >= n_pre is suffix chunk c - n_pre
  int plen;   // prefix keys
  int kend;   // suffix keys the tile can see
};

// chunk c's K and V rows into ring buffer ``buf`` ([2][K, V][64][pitch] at
// kv_s), zero-filled past the chunk's limit, as one commit group
template <int D>
__device__ __forceinline__ void issue_chunk(const ChunkSrc& src,
                                            __nv_bfloat16* kv_s, int c,
                                            int buf) {
  using Tl = MmaTile<D>;
  constexpr int kVecs = D / 8;
  __nv_bfloat16* ks = kv_s + (2 * buf) * Tl::kChunkElems;
  __nv_bfloat16* vs = ks + Tl::kChunkElems;
  const bool suffix = c >= src.n_pre;
  const int c0 = (suffix ? c - src.n_pre : c) * kChunkKeys;
  const int lim = suffix ? src.kend : src.plen;
  const __nv_bfloat16* kb = suffix ? src.k : src.k_pool;
  const __nv_bfloat16* vb = suffix ? src.v : src.v_pool;
#pragma unroll 1
  for (int i = threadIdx.x; i < kChunkKeys * kVecs; i += kMmaThreads) {
    const int t = i / kVecs, col = (i % kVecs) * 8;
    const int pos = c0 + t;
    const bool ok = pos < lim;
    size_t off = 0;
    if (ok) {
      if (suffix) {
        off = (((size_t)src.b * src.S + pos) * src.KH + src.kh) * D + col;
      } else {
        const int page = clamp_index(
            src.prefix_table[(size_t)src.b * src.maxp + pos / src.pg],
            src.P);
        off = (((size_t)page * src.pg + pos % src.pg) * src.KH + src.kh) *
                  D + col;
      }
    }
    ptx::cp_async(ks + t * Tl::kPitch + col, kb + off, ok ? 16 : 0);
    ptx::cp_async(vs + t * Tl::kPitch + col, vb + off, ok ? 16 : 0);
  }
  ptx::cp_async_commit();
}

// grid (tiles, KH, B): tiles = ceil(S * G / 64)
template <int D>
__global__ void __launch_bounds__(kMmaThreads) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ prefix_table, const int* __restrict__ prefix_len,
    __nv_bfloat16* __restrict__ out, int S, int H, int KH, int P, int pg,
    int maxp, float scale_log2) {
  using Tl = MmaTile<D>;
  constexpr int kPitch = Tl::kPitch;
  constexpr int kVecs = D / 8;        // 16-byte pieces of a row
  constexpr int kKSteps = D / 16;     // mma depth steps over D
  constexpr int kDTiles = D / 8;      // n-tiles of the output
  constexpr int kKeyTiles = kChunkKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + Tl::kRowsElems;

  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int rho0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, S * G - rho0);
  const int kend = (rho0 + nrows - 1) / G + 1;  // suffix keys the tile sees
  int plen = prefix_len[b];
  plen = plen < 0 ? 0 : (plen > maxp * pg ? maxp * pg : plen);
  const int n_pre = (plen + kChunkKeys - 1) / kChunkKeys;
  const int n_chunks = n_pre + (kend + kChunkKeys - 1) / kChunkKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the Q tile: row rho is q[b, rho / G, kh * G + rho % G, :]
#pragma unroll 1
  for (int i = tid; i < kTileRows * kVecs; i += kMmaThreads) {
    const int row = i / kVecs, c = (i % kVecs) * 8;
    const int rho = rho0 + row;
    const bool ok = row < nrows;
    const __nv_bfloat16* from =
        ok ? q + (((size_t)b * S + rho / G) * H + kh * G + rho % G) * D + c
           : q;
    ptx::cp_async(q_s + row * kPitch + c, from, ok ? 16 : 0);
  }
  const ChunkSrc src{k, v, k_pool, v_pool, prefix_table, b, kh, S, KH, P,
                     pg, maxp, n_pre, plen, kend};
  issue_chunk<D>(src, kv_s, 0, 0);  // commits the Q tile with chunk 0

  // this thread's rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int row_lo = warp * 16 + lane / 4;
  int pos_row[2];
  pos_row[0] = (rho0 + row_lo) / G;
  pos_row[1] = (rho0 + row_lo + 8) / G;
  unsigned qf[kKSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      issue_chunk<D>(src, kv_s, c + 1, buf ^ 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and at c = 0 the Q tile) landed
    if (c == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ptx::ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane >> 3 & 1) * 8 +
                                   (lane & 7)) * kPitch +
                                      ks * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks_s = kv_s + (2 * buf) * Tl::kChunkElems;
    const __nv_bfloat16* vs_s = ks_s + Tl::kChunkElems;
    const bool suffix = c >= n_pre;
    const int c0 = (suffix ? c - n_pre : c) * kChunkKeys;

    // S = Q K^T over the chunk: 16 rows x 64 keys a warp
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ks += 2) {
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        unsigned kf[4];
        ptx::ldmatrix_x4(kf, ks_s + (nt * 8 + (lane & 7)) * kPitch + ks * 16 +
                            (lane >> 3) * 8);
        ptx::mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
        ptx::mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
      }
    }

    // masks and the online softmax, in log2 units; s[nt][e] is row
    // (e >> 1 ? row_lo + 8 : row_lo), key c0 + nt * 8 + 2 * (lane % 4) +
    // (e & 1)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = suffix ? key <= pos_row[e >> 1] && key < kend
                               : key < plen;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked key: exactly 0, whatever the running max
        const float p =
            s[nt][e] > kNegInf ? exp2f(s[nt][e] - mx[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V: P from registers as the A operand, 16 keys a step
#pragma unroll
    for (int j = 0; j < kChunkKeys / 16; ++j) {
      const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned vf[4];
        ptx::ldmatrix_x4_trans(vf, vs_s + (j * 16 + (lane >> 3 & 1) * 8 +
                                      (lane & 7)) * kPitch +
                                  dp * 16 + (lane >> 4) * 8);
        ptx::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        ptx::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // buffer buf free for chunk c + 2
  }

  // normalise and store the valid rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_lo + 8 * h;
    if (row >= nrows) continue;
    const int rho = rho0 + row;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* dst =
        out + (((size_t)b * S + rho / G) * H + kh * G + rho % G) * D +
        2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < kDTiles; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) = __floats2bfloat162_rn(
          o[t][2 * h] * inv, o[t][2 * h + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v,
                         const __nv_bfloat16* k_pool,
                         const __nv_bfloat16* v_pool,
                         const int* prefix_table, const int* prefix_len,
                         __nv_bfloat16* out, int B, int S, int H, int KH,
                         int P, int pg, int maxp, int tiles,
                         cudaStream_t stream) {
  const size_t smem = MmaTile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  prefill_mma_kernel<D><<<dim3(tiles, KH, B), kMmaThreads, smem, stream>>>(
      q, k, v, k_pool, v_pool, prefix_table, prefix_len, out, S, H, KH, P,
      pg, maxp, scale_log2);
  return cudaGetLastError();
}

}  // namespace repro_torch

// engine: 0 "simt" (fp32 or bf16, any D), 1 "mma" (bf16 only, D in {32,
// 64, 128}, every array 16-byte aligned, tiles = ceil(S * (H / KH) / 64));
// any other combination is refused
extern "C" int paged_prefill_attention_launch(
    int dtype, int engine, const void* q, const void* k, const void* v,
    const void* k_pool, const void* v_pool, const void* prefix_table,
    const void* prefix_len, void* out, int B, int S, int H, int KH, int D,
    int P, int pg, int maxp, int tiles, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KH <= 0 || H % KH != 0 || D <= 0 || pg <= 0 || maxp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 0 && dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch_simt<float>(
        q, k, v, k_pool, v_pool, static_cast<const int*>(prefix_table),
        static_cast<const int*>(prefix_len), out, B, S, H, KH, D, P, pg,
        maxp, s);
  if (engine == 0 && dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch_simt<__nv_bfloat16>(
        q, k, v, k_pool, v_pool, static_cast<const int*>(prefix_table),
        static_cast<const int*>(prefix_len), out, B, S, H, KH, D, P, pg,
        maxp, s);
  if (engine != 1 || dtype != REPRO_DTYPE_BF16)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)S * (H / KH);
  const size_t ptrs = reinterpret_cast<size_t>(q) |
                      reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) |
                      reinterpret_cast<size_t>(k_pool) |
                      reinterpret_cast<size_t>(v_pool) |
                      reinterpret_cast<size_t>(out);
  if (ptrs % 16 != 0 ||
      (long)tiles != (rows + repro_torch::kTileRows - 1) /
                         repro_torch::kTileRows)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define REPRO_PREFILL_MMA(DIM)                                              \
  return (int)repro_torch::launch_mma_d<DIM>(                               \
      static_cast<const bf*>(q), static_cast<const bf*>(k),                 \
      static_cast<const bf*>(v), static_cast<const bf*>(k_pool),            \
      static_cast<const bf*>(v_pool), static_cast<const int*>(prefix_table), \
      static_cast<const int*>(prefix_len), static_cast<bf*>(out), B, S, H,  \
      KH, P, pg, maxp, tiles, s)
  if (D == 32) REPRO_PREFILL_MMA(32);
  if (D == 64) REPRO_PREFILL_MMA(64);
  if (D == 128) REPRO_PREFILL_MMA(128);
#undef REPRO_PREFILL_MMA
  return (int)cudaErrorInvalidValue;
}
