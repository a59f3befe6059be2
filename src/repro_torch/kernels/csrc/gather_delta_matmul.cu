// Gathered low-rank-delta matmul: heterogeneous-adapter decode over a
// stacked adapter bank (the punica / S-LoRA "BGMV" pattern).
//
// Replaces the TPU kernel src/repro/kernels/gather_delta_matmul.py,
// gather_delta_matmul_pallas.
//
//   x (B, K) and W (K, N) in the compute dtype, left (A, K, r) in the
//   compute dtype, right (A, r, N) in fp32 (uncast, as the reference passes
//   it), ids (B,) int32 adapter columns, clamped to [0, A).
//   y[b] = x[b] W + (x[b] left[ids[b]]) right[ids[b]], fp32 accumulation,
//   y in the compute dtype.
//
// What bounds it on the H100: bytes.  At decode B is the slot count (8 on
// the serving path), so W (K x N), each distinct adapter's left (K x r) and
// right (r x N, fp32) are read once for ~2 * B flops per element, far below
// the ~295 flops/byte ridge: 374 MB a llama32-3b layer, 0.112 ms at
// 3.35 TB/s.  A decode step holds 196 calls, so each call also has to
// spread its bytes over the whole card quickly: a few microseconds of
// latency per launch is the floor at k and v (6.3 MB of W).
//
// Design: three launches on the caller's stream, every grid planned on the
// host from shapes alone (ops.gather_delta_plan; nothing here or there
// reads ids on the host).  Every launch sums in a fixed order, so results
// do not change from run to run (no atomics).  256-thread blocks; a block
// serves a row group of up to 8 rows, whose distinct adapters one warp
// finds with __match_any_sync.
//   1. u launch: block (K slice of ku rows, 64 rank columns) streams each
//      distinct adapter's left tile ONCE for every row on it, into fp32
//      partials u_part[K slice][b][j] (one wave of blocks).
//   2. output launch, two kinds of blocks in one grid, so W and right
//      stream together:
//      - x-W blocks first: block (K split of ks rows, 64 output columns),
//        x's slice staged once in shared memory, into part[K split][b][n]
//        (about two blocks per SM of them, k and v included);
//      - rank blocks: block (r slice of rs rows, 256 output columns) sums
//        u's K-slice partials for its rows and slice, then streams
//        right[a]'s tile once for each distinct adapter a of its rows and
//        adds it to every row on a (fp32 FMAs on the CUDA cores: right stays
//        the fp32 it is stored in), into part[K splits + r slice][b][n]:
//        the rank-r term as extra depth of the same reduction.
//      It is a programmatic dependent launch of the u launch: the u blocks
//      let it start at once, its x-W blocks stream W while u is computed,
//      and only the rank blocks wait for u (griddepcontrol.wait).
//   3. finish launch: y = the planes summed in order, in the compute dtype.
// More than 8 rows take more row groups (grid.y), each reading W again.
//
// Compute units: in bf16 the u and x-W blocks run on the tensor cores
// (mma.sync, the matrix tile as the 16-row operand and the 8 rows as n = 8,
// see below).  On the CUDA cores a row group of 8 costs 8 FMAs per element
// loaded: at the byte rate that is ~13 T FMA/s, about 40% of the card's
// fp32 rate, too much to hide behind the loads.  fp32 (the tiny
// card-vs-CPU check) and rows that do not start on 16 bytes take the
// CUDA-core blocks.
//
// Streaming: a thread's next rows land by 16-byte cp.async in shared-memory
// ring slots, kStages rows deep (112 bytes in flight a thread for bf16, 224
// for fp32), so later rows load while this one computes, at no register
// cost; a thread reads back only what it (or, for the warp-wide copies of
// rank rows and tensor-core steps, its warp) copied, so the ring needs no
// block barrier.  A block of u walks (adapter, row) pairs as one sequence,
// so its ring stays full across adapters.  Every copy instruction of a warp
// reads whole 128-byte lines.  A matrix whose rows are not a multiple of 8
// elements or whose base is not 16-byte aligned is read element by element
// instead (no ring).
#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // rows per row group
constexpr int kCols = 8;        // columns a thread owns
constexpr int kBaseLanes = 8;   // x-W and u blocks: 64 columns, 32 K lanes
constexpr int kRankLanes = 32;  // rank blocks: 256 columns, 8 r lanes
constexpr int kStages = 8;      // rows in a thread's cp.async ring

// 8 consecutive elements of T, as 16 bytes (bf16: one uint4; fp32: two
// float4), loaded element by element where a row may not start on 16 bytes
// (the first ``valid`` elements; zeros after them)
template <typename T>
struct Load8;
template <>
struct Load8<__nv_bfloat16> {
  struct Raw {
    uint4 v;
  };
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p,
                                             int valid) {
    unsigned h[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      h[e] = e < valid ? (unsigned)__bfloat16_as_ushort(p[e]) : 0u;
    return Raw{make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                          h[4] | h[5] << 16, h[6] | h[7] << 16)};
  }
  // a bf16 is the top half of its fp32: shift, no conversion
  __device__ __forceinline__ static void unpack(const Raw& r, float* out) {
    const unsigned w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Load8<float> {
  struct Raw {
    float4 lo, hi;
  };
  __device__ __forceinline__ static Raw load(const float* p, int valid) {
    float f[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) f[e] = e < valid ? p[e] : 0.f;
    return Raw{make_float4(f[0], f[1], f[2], f[3]),
               make_float4(f[4], f[5], f[6], f[7])};
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float* out) {
    out[0] = r.lo.x, out[1] = r.lo.y, out[2] = r.lo.z, out[3] = r.lo.w;
    out[4] = r.hi.x, out[5] = r.hi.y, out[6] = r.hi.z, out[7] = r.hi.w;
  }
};

// acc[b] += mult[b] * row for the rows of ``mask`` (every row with kAll);
// mult: the row's kRows multipliers in shared memory, 32-byte aligned
template <typename T, bool kAll>
__device__ __forceinline__ void fma_row(const typename Load8<T>::Raw& raw,
                                        const float* mult, unsigned mask,
                                        float (&acc)[kRows][kCols]) {
  float v[kCols];
  Load8<T>::unpack(raw, v);
  const float4 m0 = reinterpret_cast<const float4*>(mult)[0];
  const float4 m1 = reinterpret_cast<const float4*>(mult)[1];
  const float xv[kRows] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    if (kAll || (mask >> b & 1u)) {
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        acc[b][e] = fmaf(xv[b], v[e], acc[b][e]);
    }
  }
}

// One thread's element-wise walk down a depth slice of nd rows (pitch ld
// elements; m points at this thread's first column of the slice's first
// row): rows k_lane, k_lane + k_lanes, ..., 64 bytes of loads in flight.
template <typename T, bool kAll>
__device__ __forceinline__ void stream_rows(const T* __restrict__ m,
                                            size_t ld, const float* mult_s,
                                            int nd, int k_lane, int k_lanes,
                                            int valid, unsigned mask,
                                            float (&acc)[kRows][kCols]) {
  constexpr int kU = 64 / (kCols * (int)sizeof(T));
  using L = Load8<T>;
  int d = k_lane;
  for (; d + (kU - 1) * k_lanes < nd; d += kU * k_lanes) {
    typename L::Raw raw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      raw[u] = L::load(m + (size_t)(d + u * k_lanes) * ld, valid);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      fma_row<T, kAll>(raw[u], mult_s + (d + u * k_lanes) * kRows, mask,
                       acc);
  }
  for (; d < nd; d += k_lanes)
    fma_row<T, kAll>(L::load(m + (size_t)d * ld, valid),
                     mult_s + d * kRows, mask, acc);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
// 16 bytes, of which the first ``bytes`` come from gmem and the rest are 0
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The distinct adapters of rows [b0, b0 + nb) and the rows on each (thread
// 0 writes them; the caller syncs)
struct AdapterGroups {
  int n;
  int adapter[kRows];
  unsigned mask[kRows];
};

// One thread's walk, through its cp.async ring, over n_groups x (its rows
// of a depth slice of nd rows): group g reads the matrix at mat +
// adapter[g] * astride (every row of the row group with kAll, one matrix);
// mat points at this thread's first column of the slice's first row, rows
// ld elements apart.  ring: kStages * kChunks * kThreads uint4 slots.
// kWarpRow (fp32, a warp's 32 lanes on 256 contiguous columns): lane l
// copies 16-byte pieces l and 32 + l of the warp's row, so each copy
// instruction reads 512 contiguous bytes, and reads back pieces 2l and
// 2l + 1 (its own 8 columns) after a __syncwarp; valid counts this lane's
// columns in range (a multiple of 4, or all 8).
template <typename T, bool kAll, bool kWarpRow>
__device__ __forceinline__ void stream_async(
    const T* __restrict__ mat, size_t astride, size_t ld,
    const float* mult_s, int nd, int k_lane, int k_lanes, int valid,
    const AdapterGroups* groups, int n_groups, uint4* ring,
    float (&acc)[kRows][kCols]) {
  constexpr int kChunks = (int)sizeof(T) * kCols / 16;
  constexpr int kPer = 16 / (int)sizeof(T);  // elements of a chunk
  static_assert(!kWarpRow || kChunks == 2, "warp rows are fp32");
  const int lane = threadIdx.x % 32;
  const int cnt = nd > k_lane ? (nd - k_lane + k_lanes - 1) / k_lanes : 0;
  const int total = cnt * n_groups;
  uint4* mine = ring + threadIdx.x;
  // kWarpRow: the warp's first column, and where piece c of this lane is
  const T* wmat = mat - lane * kCols;
  int ig = 0, ir = 0;  // group and row of the next item to issue
  auto issue = [&](int i) {
    if (i < total) {
      const size_t a = kAll ? 0 : (size_t)groups->adapter[ig];
      const size_t row = a * astride + (size_t)(k_lane + ir * k_lanes) * ld;
      const int slot = i % kStages;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if constexpr (kWarpRow) {
          // piece c * 32 + lane starts (c * 32 + lane) * 4 - lane * 8
          // columns past this lane's first
          const int off = (c * 32 + lane) * kPer - lane * kCols;
          const bool ok = off + kPer <= valid;
          cp_async16(mine + (slot * kChunks + c) * kThreads,
                     ok ? wmat + row + (c * 32 + lane) * kPer : mat,
                     ok ? 16 : 0);
        } else {
          cp_async16(mine + (slot * kChunks + c) * kThreads,
                     mat + row + c * kPer);
        }
      }
      if (++ir == cnt) ir = 0, ++ig;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  int cg = 0, cr = 0;  // group and row of the item consumed next
  // kWarpRow: pieces 2 lane and 2 lane + 1 of the warp's row
  const uint4* own_lo = kWarpRow ? ring + (threadIdx.x - lane) +
                                       (2 * lane) / 32 * kThreads +
                                       (2 * lane) % 32
                                 : mine;
  const uint4* own_hi = kWarpRow ? ring + (threadIdx.x - lane) +
                                       (2 * lane + 1) / 32 * kThreads +
                                       (2 * lane + 1) % 32
                                 : mine + kThreads;
  for (int i = 0; i < total; ++i) {
    if constexpr (kWarpRow) __syncwarp();  // slot i - 1 is read by all lanes
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();  // item i's group has landed
    if constexpr (kWarpRow) __syncwarp();  // ... for every lane's pieces
    const int slot = i % kStages;
    typename Load8<T>::Raw raw;
    if constexpr (kChunks == 1) {
      raw.v = mine[slot * kThreads];
    } else {
      const uint4 lo = own_lo[(slot * 2) * kThreads];
      const uint4 hi = own_hi[(slot * 2) * kThreads];
      raw.lo = make_float4(__uint_as_float(lo.x), __uint_as_float(lo.y),
                           __uint_as_float(lo.z), __uint_as_float(lo.w));
      raw.hi = make_float4(__uint_as_float(hi.x), __uint_as_float(hi.y),
                           __uint_as_float(hi.z), __uint_as_float(hi.w));
    }
    fma_row<T, kAll>(raw, mult_s + (k_lane + cr * k_lanes) * kRows,
                     kAll ? ~0u : groups->mask[cg], acc);
    if (++cr == cnt) cr = 0, ++cg;
  }
}

// Either walk: the ring where every row is 16-byte aligned (vec), else
// element-wise loads of the rows in range (valid columns of 8)
template <typename T, bool kAll, bool kWarpRow = false>
__device__ __forceinline__ void stream(const T* __restrict__ mat,
                                       size_t astride, size_t ld,
                                       const float* mult_s, int nd,
                                       int k_lane, int k_lanes, int valid,
                                       const AdapterGroups* groups,
                                       int n_groups, bool vec, uint4* ring,
                                       float (&acc)[kRows][kCols]) {
  if (vec) {
    // kWarpRow: every lane takes part in the warp's copies
    if (kWarpRow || valid > 0)
      stream_async<T, kAll, kWarpRow>(mat, astride, ld, mult_s, nd, k_lane,
                                      k_lanes, valid, groups, n_groups, ring,
                                      acc);
    return;
  }
  for (int g = 0; g < n_groups; ++g)
    stream_rows<T, kAll>(
        mat + (kAll ? 0 : (size_t)groups->adapter[g] * astride), ld, mult_s,
        nd, k_lane, k_lanes, valid, kAll ? ~0u : groups->mask[g], acc);
}

// Sum acc over a block's K lanes and store the block's (kRows, kLanes * 8)
// tile at out[(b0 + b) * ld + c0 + c] for rows < nb and columns < ncols.
// Thread t is K lane t / kLanes, column lane t % kLanes; the K lanes of a
// warp meet by shuffles, the warps in shared memory (red: kThreads / 32 *
// kRows * kLanes * 8 floats, which may alias the streaming ring).
template <int kLanes>
__device__ __forceinline__ void reduce_store(float (&acc)[kRows][kCols],
                                             float* red, float* out,
                                             size_t ld, int c0, int ncols,
                                             int b0, int nb) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTile = kLanes * kCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red aliases the ring: every thread is done with it
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  if (lane < kLanes) {
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      float4* dst = reinterpret_cast<float4*>(
          red + ((size_t)warp * kRows + b) * kTile + lane * kCols);
      dst[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      dst[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kTile; o += kThreads) {
    const int b = o / kTile, c = o % kTile;
    if (b >= nb || c0 + c >= ncols) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[((size_t)w * kRows + b) * kTile + c];
    out[(size_t)(b0 + b) * ld + c0 + c] = s;
  }
}

// The distinct adapters of rows [b0, b0 + nb) in order of their first row,
// and the rows on each: warp 0 loads one id a lane and matches them (the
// caller syncs)
__device__ __forceinline__ void find_groups(const int* __restrict__ ids,
                                            int b0, int nb, int A,
                                            AdapterGroups* g) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  // lanes past nb get distinct negative ids: groups of their own, dropped
  const int a = lane < nb ? clamp_index(ids[b0 + lane], A) : -1 - lane;
  const unsigned same = __match_any_sync(0xffffffffu, a);
  const bool lead = lane < nb && __ffs(same) - 1 == lane;
  const unsigned leads = __ballot_sync(0xffffffffu, lead);
  if (lead) {
    const int i = __popc(leads & ((1u << lane) - 1u));
    g->adapter[i] = a;
    g->mask[i] = same;
  }
  if (lane == 0) g->n = __popc(leads);
}

// x[b0 .. b0 + nb)[k0 .. k0 + nk) into x_s[nk][kRows] as fp32, zero rows
// past nb
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* x_s,
                                        int K, int k0, int nk, int b0,
                                        int nb) {
  for (int i = threadIdx.x; i < kRows * nk; i += kThreads) {
    const int b = i / nk, kk = i % nk;
    x_s[kk * kRows + b] =
        b < nb ? to_float(x[(size_t)(b0 + b) * K + k0 + kk]) : 0.f;
  }
}

constexpr int red_floats(int lanes) {
  return kThreads / 32 * kRows * lanes * kCols;
}

// ---------------------------------------------------------------------------
// bf16 products on the tensor cores
// ---------------------------------------------------------------------------
//
// With bf16 rows that start on 16 bytes, the u and x-W blocks run their
// products on mma.sync m16n8k16: the matrix tile is the A operand (16
// columns x 16 rows of a step, transposed by ldmatrix) and x the B operand
// (k = 16 of the slice, n = the row group's 8 rows), so 16 x 16 elements
// take one instruction a warp where the CUDA cores need 64 FMAs a thread.
// The 8 warps split the slice's 16-row steps; each keeps its own cp.async
// ring of steps, so it syncs with no other warp until the end.  x lands in
// shared memory by 16-byte cp.async in one round trip, zero past the slice
// and past the row group.  A u block walks (adapter, step) pairs; at the
// end of an adapter it keeps the sums of the rows on that adapter and
// starts again from zero, so a row only ever sees its own adapter.

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMmaTile = 64;  // columns of an mma block
// elements of a row of x in shared memory: the slice rounded up to a step,
// plus 8 so that the 8 rows' B fragments fall on distinct banks
__host__ __device__ constexpr int x_pitch(int rows) {
  return (rows + 15) / 16 * 16 + 8;
}
// a warp's ring: kMmaStages steps of 16 rows x 64 columns (128 pieces of
// 16 bytes); the block's rings, in bf16 elements
constexpr int kMmaStages = 4;
constexpr int kStepPieces = 16 * kMmaTile / 8;
constexpr int kMmaRing = kThreads / 32 * kMmaStages * kStepPieces * 8;

// x[b0 + b][k0, k0 + nk) into the rows of x_s (pitch elements apart) by
// cp.async, zero past nk and for rows past nb (the caller commits)
__device__ __forceinline__ void stage_x_async(const __nv_bfloat16* x,
                                              __nv_bfloat16* x_s, int pitch,
                                              int K, int k0, int nk, int b0,
                                              int nb) {
  const int pieces = pitch / 8;
  for (int i = threadIdx.x; i < kRows * pieces; i += kThreads) {
    const int b = i / pieces, kk = i % pieces * 8;
    const int bytes = b < nb ? min(max(nk - kk, 0), 8) * 2 : 0;
    cp_async16(x_s + b * pitch + kk,
               bytes ? x + (size_t)(b0 + b) * K + k0 + kk : x, bytes);
  }
}

// One block's 64 columns [c0, c0 + 64) of x . M over a slice of nk rows: M
// at mat (its slice's first row, column 0; rows ld apart; adapter g's
// matrix at mat + adapter[g] * astride, or one matrix for every row with
// all_rows).  Warp w takes the slice's 16-row steps w, w + 8, ...: it
// copies a step's 16 rows x 64 columns (16 full 128-byte lines, 4 pieces a
// lane) into its ring and runs 4 mma (one a 16-column group).  A piece
// (row, chunk) sits at slot row * 8 + (chunk ^ row % 8), so the 8 rows an
// ldmatrix matrix reads fall on distinct banks.  Writes the block's (rows
// < nb, columns < ncols) sums to out[(b0 + b) * ld_out + c0 + c].
__device__ __forceinline__ void mma_slice(
    const __nv_bfloat16* __restrict__ mat, size_t astride, size_t ld,
    int ncols, int c0, const __nv_bfloat16* x_s, int pitch, int nk,
    const AdapterGroups* groups, int n_groups, bool all_rows,
    __nv_bfloat16* ring, float* __restrict__ out, size_t ld_out, int b0,
    int nb) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nsteps = (nk + 15) / 16;
  const int cnt = nsteps > warp ? (nsteps - warp + kWarps - 1) / kWarps : 0;
  const int total = cnt * n_groups;
  __nv_bfloat16* wring = ring + warp * kMmaStages * kStepPieces * 8;
  int ig = 0, ii = 0;
  auto issue = [&](int i) {
    if (i < total) {
      const int step = warp + kWarps * ii;
      const size_t a = all_rows ? 0 : (size_t)groups->adapter[ig];
      __nv_bfloat16* slot = wring + (i % kMmaStages) * kStepPieces * 8;
#pragma unroll
      for (int q = 0; q < kStepPieces / 32; ++q) {
        const int row = lane / 8 + 4 * q, chunk = lane % 8;
        const int kk = step * 16 + row, col = c0 + chunk * 8;
        const bool ok = col < ncols && kk < nk;
        cp_async16(slot + (row * 8 + (chunk ^ (row & 7))) * 8,
                   ok ? mat + a * astride + (size_t)kk * ld + col : mat,
                   ok ? 16 : 0);
      }
      if (++ii == cnt) ii = 0, ++ig;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) issue(i);
  // ldmatrix: lanes 8m..8m+7 address matrix m of a 16-column group: rows
  // (m & 2 ? 8-15 : 0-7) of the step, chunk 2 * group + (m & 1)
  const int m = lane / 8;
  const int lrow = (m & 2) * 4 + lane % 8;
  const __nv_bfloat16* xr = x_s + (lane / 4) * pitch + 2 * (lane % 4);
  float acc[4][4], fin[4][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = fin[g][e] = 0.f;
  int cg = 0, ci = 0;
  for (int i = 0; i < total; ++i) {
    issue(i + kMmaStages - 1);
    cp_async_wait<kMmaStages - 1>();
    __syncwarp();  // every lane's pieces of step i have landed
    const __nv_bfloat16* slot = wring + (i % kMmaStages) * kStepPieces * 8;
    const __nv_bfloat16* xs = xr + (warp + kWarps * ci) * 16;
    const unsigned b0 = *reinterpret_cast<const unsigned*>(xs);
    const unsigned b1 = *reinterpret_cast<const unsigned*>(xs + 8);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      unsigned a[4];
      const int chunk = 2 * g + (m & 1);
      ldmatrix_x4_trans(a, slot + (lrow * 8 + (chunk ^ (lrow & 7))) * 8);
      mma_bf16(acc[g], a, b0, b1);
    }
    __syncwarp();  // step i's slot is read before any lane refills it
    if (++ci == cnt) {
      // this adapter's rows keep their sums: row 2 (lane % 4) + e % 2
      const unsigned mask = all_rows ? ~0u : groups->mask[cg];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mask >> (2 * (lane % 4) + (e & 1)) & 1u) fin[g][e] = acc[g][e];
          acc[g][e] = 0.f;
        }
      ci = 0, ++cg;
    }
  }
  // the warps' sums meet in shared memory (over the rings)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [warp][64 columns][kRows]
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = g * 16 + lane / 4 + (e >> 1) * 8;
      red[(warp * kMmaTile + col) * kRows + 2 * (lane % 4) + (e & 1)] =
          fin[g][e];
    }
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * kMmaTile; o += kThreads) {
    const int b = o / kMmaTile, c = o % kMmaTile;
    if (b >= nb || c0 + c >= ncols) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kMmaTile + c) * kRows + b];
    out[(size_t)(b0 + b) * ld_out + c0 + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// the blocks of launches 1 and 2
// ---------------------------------------------------------------------------

// bytes of the ring region every block of launches 1 and 2 holds after its
// staging region: the largest ring (fp32 rows, or the tensor-core steps)
// and every reduction fit in it
constexpr int kRingBytes = kStages * kThreads * kCols * 4;
static_assert(kMmaRing * 2 <= kRingBytes, "tensor-core rings");
static_assert(red_floats(kRankLanes) * 4 <= kRingBytes, "rank reduction");

// x staging bytes of a slice of ``rows`` rows
template <typename T, bool kMma>
__host__ __device__ constexpr int x_stage_bytes(int rows) {
  return kMma ? kRows * x_pitch(rows) * 2 : rows * kRows * 4;
}

// Blocks of 64 columns [c0, c0 + 64) of x . M over K rows [k0, k0 + nk):
// the x-W blocks (one matrix, every row) and the u blocks (adapter g's
// matrix at mat + adapter[g] * astride for the rows of mask[g]).
template <typename T, bool kMma>
__device__ __forceinline__ void x_block(const T* __restrict__ x,
                                        const T* __restrict__ mat,
                                        size_t astride, size_t ld, int ncols,
                                        int c0, int K, int k0, int nk,
                                        const AdapterGroups* groups,
                                        int n_groups, bool vec, float* out,
                                        unsigned char* stage,
                                        unsigned char* region, int b0,
                                        int nb) {
  if constexpr (kMma) {
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(stage);
    const int pitch = x_pitch(nk);
    stage_x_async(x, x_s, pitch, K, k0, nk, b0, nb);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mma_slice(mat + (size_t)k0 * ld, astride, ld, ncols, c0, x_s, pitch, nk,
              groups, n_groups, groups == nullptr,
              reinterpret_cast<__nv_bfloat16*>(region), out, ld, b0, nb);
  } else {
    float* x_s = reinterpret_cast<float*>(stage);
    stage_x(x, x_s, K, k0, nk, b0, nb);
    __syncthreads();
    float acc[kRows][kCols];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[b][e] = 0.f;
    const int c = c0 + threadIdx.x % kBaseLanes * kCols;
    const T* m = mat + (size_t)k0 * ld + c;
    const int k_lane = threadIdx.x / kBaseLanes;
    const int valid = ncols - c;
    uint4* ring = reinterpret_cast<uint4*>(region);
    if (groups == nullptr)
      stream<T, true>(m, 0, ld, x_s, nk, k_lane, kThreads / kBaseLanes,
                      valid, nullptr, 1, vec, ring, acc);
    else
      stream<T, false>(m, astride, ld, x_s, nk, k_lane,
                       kThreads / kBaseLanes, valid, groups, n_groups, vec,
                       ring, acc);
    reduce_store<kBaseLanes>(acc, reinterpret_cast<float*>(region), out, ld,
                             c0, ncols, b0, nb);
  }
}

// Launch 1: u block (K slice su of ku rows, rank columns [rt * 64, + 64))
// writes u_part[su][b][j].  Dynamic shared memory: x staging, then the ring
// region.
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads, 2) gather_u_kernel(
    const T* __restrict__ x, const T* __restrict__ left,
    const int* __restrict__ ids, float* __restrict__ u_part, int B, int K,
    int r, int A, int ku, int stage_bytes, bool vec_l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ AdapterGroups groups;
  // the output launch may start now: its x-W blocks do not read u
  asm volatile("griddepcontrol.launch_dependents;");
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0);
  const int r_tiles = (r + kMmaTile - 1) / kMmaTile;
  const int rt = blockIdx.x % r_tiles, su = blockIdx.x / r_tiles;
  const int k0 = su * ku, nk = min(ku, K - k0);
  find_groups(ids, b0, nb, A, &groups);
  __syncthreads();
  x_block<T, kMma>(x, left, (size_t)K * r, r, r, rt * kMmaTile, K, k0, nk,
                   &groups, groups.n, vec_l, u_part + (size_t)su * B * r,
                   smem_raw, smem_raw + stage_bytes, b0, nb);
}

// Launch 2, rank block (r slice sr of rs rows, output columns [tile * 256,
// + 256)): sums u's K-slice partials for its rows and slice, then streams
// right[a]'s tile once for each distinct adapter a of its rows (fp32 FMAs
// on the CUDA cores: right stays the fp32 it is stored in), into plane
// k_splits + sr.
__device__ __forceinline__ void rank_block(
    const float* __restrict__ u_part, const float* __restrict__ right,
    const int* __restrict__ ids, float* __restrict__ part, int B, int N,
    int r, int A, int u_splits, int rs, int k_splits, int sr, int tile,
    bool vec_r, AdapterGroups* groups, float* u_s, unsigned char* region,
    int b0, int nb) {
  constexpr int kTile = kRankLanes * kCols;
  const int j0 = sr * rs, nj = min(rs, r - j0);
  find_groups(ids, b0, nb, A, groups);
  // the u launch is done and its partials visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // u[b][j0 + jj]: the K slices' partials summed in order
  for (int i = threadIdx.x; i < kRows * nj; i += kThreads) {
    const int b = i / nj, jj = i % nj;
    float s = 0.f;
    if (b < nb) {
      const float* up = u_part + (size_t)(b0 + b) * r + j0 + jj;
#pragma unroll 4
      for (int su = 0; su < u_splits; ++su) s += up[(size_t)su * B * r];
    }
    u_s[jj * kRows + b] = s;
  }
  __syncthreads();
  float acc[kRows][kCols];
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[b][e] = 0.f;
  const int n = tile * kTile + threadIdx.x % kRankLanes * kCols;
  stream<float, false, true>(right + (size_t)j0 * N + n, (size_t)r * N, N,
                             u_s,
                       nj, threadIdx.x / kRankLanes, kThreads / kRankLanes,
                       N - n, groups, groups->n, vec_r,
                       reinterpret_cast<uint4*>(region), acc);
  reduce_store<kRankLanes>(acc, reinterpret_cast<float*>(region),
                           part + (size_t)(k_splits + sr) * B * N, N,
                           tile * kTile, N, b0, nb);
}

// Launch 2: x-W blocks (K split s of ks rows, output columns [tile * 64,
// + 64); blockIdx.x < n_w), then rank blocks, which stream W and right
// together.  It is a programmatic dependent launch: the x-W blocks may run
// while the u launch still runs, the rank blocks wait for it.  Dynamic
// shared memory: the staging region (x, or u of a rank slice), then the
// ring region.
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads, 2) gather_out_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ right, const float* __restrict__ u_part,
    const int* __restrict__ ids, float* __restrict__ part, int B, int K,
    int N, int r, int A, int ks, int rs, int u_splits, int n_w,
    int stage_bytes, bool vec_w, bool vec_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ AdapterGroups groups;
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0);
  unsigned char* region = smem_raw + stage_bytes;
  if ((int)blockIdx.x >= n_w) {
    const int blk = blockIdx.x - n_w;
    const int tiles = (N + kRankLanes * kCols - 1) / (kRankLanes * kCols);
    rank_block(u_part, right, ids, part, B, N, r, A, u_splits, rs,
               (K + ks - 1) / ks, blk / tiles, blk % tiles, vec_r, &groups,
               reinterpret_cast<float*>(smem_raw), region, b0, nb);
    return;
  }
  const int blk = blockIdx.x;
  const int tiles = (N + kMmaTile - 1) / kMmaTile;
  const int tile = blk % tiles, s = blk / tiles;
  const int k0 = s * ks, nk = min(ks, K - k0);
  x_block<T, kMma>(x, w, 0, N, N, tile * kMmaTile, K, k0, nk, nullptr, 1,
                   vec_w, part + (size_t)s * B * N, smem_raw, region, b0,
                   nb);
}

// Launch 3: y = sum over the planes, in order, in the compute dtype
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_finish_kernel(
    const float* __restrict__ part, T* __restrict__ y, int planes,
    size_t bn) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= bn) return;
  float s = 0.f;
  for (int p = 0; p < planes; ++p) s += part[(size_t)p * bn + i];
  y[i] = from_float<T>(s);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// Opt in to ``bytes`` of dynamic shared memory on every launch: the blocks
// also hold static shared memory, so even a 48 KB dynamic size needs it
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, bool kMma>
cudaError_t launch_engine(const void* x, const void* w, const void* left,
                          const void* right, const void* ids, float* u_part,
                          float* part, void* y, int B, int K, int N, int r,
                          int A, int ks, int ku, int rs, bool vec_w,
                          bool vec_l, bool vec_r, cudaStream_t stream) {
  const int groups = (B + kRows - 1) / kRows;
  const int k_splits = (K + ks - 1) / ks;
  const int u_splits = r > 0 ? (K + ku - 1) / ku : 0;
  const int r_splits = r > 0 ? (r + rs - 1) / rs : 0;
  const int n_rank = r_splits * ((N + kRankLanes * kCols - 1) /
                                 (kRankLanes * kCols));
  cudaError_t err;
  if (r > 0) {
    const int stage = x_stage_bytes<T, kMma>(ku);
    const size_t smem = (size_t)stage + kRingBytes;
    err = set_smem(gather_u_kernel<T, kMma>, smem);
    if (err != cudaSuccess) return err;
    const int n_u = u_splits * ((r + kMmaTile - 1) / kMmaTile);
    gather_u_kernel<T, kMma><<<dim3(n_u, groups), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(left),
        static_cast<const int*>(ids), u_part, B, K, r, A, ku, stage, vec_l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int stage = max(x_stage_bytes<T, kMma>(ks), rs * kRows * 4);
  const size_t smem = (size_t)stage + kRingBytes;
  err = set_smem(gather_out_kernel<T, kMma>, smem);
  if (err != cudaSuccess) return err;
  const int n_w = k_splits * ((N + kMmaTile - 1) / kMmaTile);
  // a programmatic dependent launch: it may begin once every u block has
  // started (griddepcontrol.launch_dependents); rank blocks then wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_w + n_rank, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = r > 0 ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gather_out_kernel<T, kMma>,
                           static_cast<const T*>(x), static_cast<const T*>(w),
                           static_cast<const float*>(right),
                           static_cast<const float*>(u_part),
                           static_cast<const int*>(ids), part, B, K, N, r, A,
                           ks, rs, u_splits, n_w, stage, vec_w, vec_r);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t bn = (size_t)B * N;
  gather_finish_kernel<T>
      <<<(unsigned)((bn + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          part, static_cast<T*>(y), k_splits + r_splits, bn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* left,
                   const void* right, const void* ids, float* u_part,
                   float* part, void* y, int B, int K, int N, int r, int A,
                   int ks, int ku, int rs, cudaStream_t stream) {
  const bool vec_w = N % kCols == 0 && aligned16(w);
  const bool vec_l = r % kCols == 0 && aligned16(left);
  const bool vec_r = N % kCols == 0 && aligned16(right);
  // the tensor cores take bf16 where x, W and left rows and the K slices
  // start on 16 bytes
  const bool mma = sizeof(T) == 2 && vec_w && (r == 0 || vec_l) &&
                   K % kCols == 0 && ks % kCols == 0 && ku % kCols == 0 &&
                   aligned16(x);
  if constexpr (sizeof(T) == 2) {
    if (mma)
      return launch_engine<T, true>(x, w, left, right, ids, u_part, part, y,
                                    B, K, N, r, A, ks, ku, rs, vec_w, vec_l,
                                    vec_r, stream);
  }
  return launch_engine<T, false>(x, w, left, right, ids, u_part, part, y, B,
                                 K, N, r, A, ks, ku, rs, vec_w, vec_l, vec_r,
                                 stream);
}

}  // namespace repro_torch

// ks, ku, rs: rows per W split, per u block's K slice and per rank slice
// (ops.gather_delta_plan).  Scratch the caller allocates: u_part
// ceil(K / ku) * B * r floats, part (ceil(K / ks) + ceil(r / rs)) * B * N
// floats.
extern "C" int gather_delta_matmul_launch(
    int dtype, const void* x, const void* w, const void* left,
    const void* right, const void* ids, void* u_part, void* part, void* y,
    int B, int K, int N, int r, int A, int ks, int ku, int rs,
    void* stream) {
  if (B == 0 || N == 0) return 0;
  if (K <= 0 || r < 0 || A <= 0 || ks <= 0 || ku <= 0 ||
      (r > 0 && rs <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* up = static_cast<float*>(u_part);
  float* pp = static_cast<float*>(part);
  if (dtype == REPRO_DTYPE_F32)
    return (int)repro_torch::launch<float>(x, w, left, right, ids, up, pp, y,
                                           B, K, N, r, A, ks, ku, rs, s);
  if (dtype == REPRO_DTYPE_BF16)
    return (int)repro_torch::launch<__nv_bfloat16>(
        x, w, left, right, ids, up, pp, y, B, K, N, r, A, ks, ku, rs, s);
  return (int)cudaErrorInvalidValue;
}
