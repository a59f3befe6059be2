// Block-diagonal input rotation, the OFT family's hot spot:
//   y[m, g*b:(g+1)*b] = x[m, g*b:(g+1)*b] . R_g        (transpose: . R_g^T)
//
// Replaces the TPU kernel src/repro/kernels/blockdiag_rotate.py,
// blockdiag_rotate_pallas.
//
//   x (M, d) fp32 or bf16, row-major; rots (d/b, b, b) fp32 or x's type;
//   y (M, d) in x's type; fp32 accumulation.  Any M and any block size b
//   that divides d.
//
// What bounds it on the H100: bytes.  At M = 2048, d = 3072, b = 32 in bf16
// it must move 25.2 MB (x in, y out: 7.5 us at 3.35 TB/s) for 2 M d b =
// 0.40 GFLOP, 0.4 us at the bf16 tensor-core peak but 6.0 us in fp32 on
// the CUDA cores: the products must leave the CUDA cores for the time to
// approach the bytes.
//
// Columns (both engines): a block owns up to 128 output columns, either
// 128 / b whole groups (b <= 128) or one 128-column slice of one group
// (b > 128; the last slice of a group may be narrower).  Above 128 the
// depth (the group's b rows of x and of R_g) is walked in chunks of 64, so
// any b runs in bounded shared memory.  block_columns() below and
// ops.blockdiag_block_columns() compute the same split.
//
// Two engines, chosen by the wrapper (ops._blockdiag_engine) and passed as a
// code that the entry point refuses where the shapes do not meet it:
//
// "mma" (bf16 x and rotations, b a multiple of 16, 16-byte aligned arrays):
//   128 threads, four warps of 16 rows, a 64-row tile at a time.  A block
//   walks tiles_per_block row tiles (planned by ops.blockdiag_plan); x
//   tiles (and, above b = 128, R_g's depth chunks) arrive by 16-byte
//   cp.async in a three-stage shared-memory ring, two items ahead of the
//   one being multiplied.  At b <= 128 the block's R_g are loaded once and
//   stay resident.  Operands come through ldmatrix from rows padded by 16
//   bytes (the eight rows of each 8 x 8 matrix on distinct banks); the
//   transposed launch reads R_g^T in place (ldmatrix without .trans), so
//   dx needs no copy.  Products are mma.sync m16n8k16 bf16 with fp32
//   accumulators; at b = 16, 32 and 64 (mma_groups) the block's groups are
//   unrolled, every group's fragments of a depth step loaded before their
//   mmas, so the short chains of a tile overlap (its compute is the tail
//   after the last x tile lands); other b take one group's up to 128
//   columns at a time.  The epilogue
//   rounds to bf16 into shared memory (over the warp's own rows of the x
//   tile it has consumed, or a separate stage above b = 128) and writes
//   each row back as 16-byte coalesced stores.
// "simt" (fp32 x or rotations, or b not a multiple of 16): a 256-thread
//   block owns 64 rows; it widens x and R_g (read transposed when
//   ``transpose``) to fp32 in shared memory, all of the groups' depth at
//   once up to b = 128 (the first design), 64 rows of depth at a time
//   above; each thread owns one output column and 32 of the 64 rows, 32
//   fp32 sums in registers, exact fp32 products on the CUDA cores.
//
// Blocks are independent; nothing carries between them.
#include <stdint.h>

#include "common.cuh"
#include "ptx.cuh"

namespace repro_torch {

constexpr int kBdCols = 128;   // output columns a block, at most
constexpr int kBdDepth = 64;   // depth chunk above b = kBdCols
constexpr int kBdRows = 64;    // rows of a tile

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// groups a block's columns cover (b <= 128), else 1
__host__ __device__ inline int groups_per_block(int b) {
  return b <= kBdCols ? kBdCols / b : 1;
}
// column slices of one group (b > 128), else 1
__host__ __device__ inline int slices_per_group(int b) {
  return b <= kBdCols ? 1 : cdiv(b, kBdCols);
}
__host__ __device__ inline int column_blocks(int d, int b) {
  const int nb = d / b;
  return b <= kBdCols ? cdiv(nb, groups_per_block(b))
                      : nb * slices_per_group(b);
}

// Column block cb: groups [g0, g0 + ng), each contributing output columns
// [c0, c0 + sw) of its own b (ng = 1 and sw <= 128 above b = 128)
struct Columns {
  int g0, ng, c0, sw;
};
__host__ __device__ inline Columns block_columns(int cb, int b, int nb) {
  if (b <= kBdCols) {
    const int gpb = groups_per_block(b), g0 = cb * gpb;
    return {g0, nb - g0 < gpb ? nb - g0 : gpb, 0, b};
  }
  const int sl = slices_per_group(b), c0 = (cb % sl) * kBdCols;
  return {cb / sl, 1, c0, b - c0 < kBdCols ? b - c0 : kBdCols};
}

// ---------------------------------------------------------------------------
// "simt": fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBdThreads = 256;
constexpr int kBdRowGroups = kBdThreads / kBdCols;        // 2
constexpr int kBdRowsPerThread = kBdRows / kBdRowGroups;  // 32

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

// b <= 128: whole groups, all their depth at once (gpb groups a block)
template <typename T, typename TR, bool kQuad>
__global__ void __launch_bounds__(kBdThreads)
    blockdiag_simt_kernel(const T* __restrict__ x,
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

// b > 128: one 128-column slice of one group; its depth (x's and R_g's b
// rows) staged 64 at a time, [kBdDepth][kBdCols] of R_g and
// [kBdRows][kBdDepth] of x
template <typename T, typename TR>
__global__ void __launch_bounds__(kBdThreads, 2)
    blockdiag_simt_chunked_kernel(const T* __restrict__ x,
                                  const TR* __restrict__ rots,
                                  T* __restrict__ y, int M, int d, int b,
                                  int transpose) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  float* xs = rs + kBdDepth * kBdCols;
  const Columns cols = block_columns(blockIdx.y, b, d / b);
  const int c0 = cols.c0, sw = cols.sw;
  const TR* rg_src = rots + (long)cols.g0 * b * b;
  const T* xg = x + (long)cols.g0 * b;
  const int row0 = blockIdx.x * kBdRows;
  const int cl = threadIdx.x % kBdCols, rg = threadIdx.x / kBdCols;
  float acc[kBdRowsPerThread];
#pragma unroll
  for (int i = 0; i < kBdRowsPerThread; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < b; k0 += kBdDepth) {
    const int kc = min(kBdDepth, b - k0);
    __syncthreads();  // the previous chunk fully consumed
    for (int i = threadIdx.x; i < kc * sw; i += kBdThreads) {
      const int kk = i / sw, cc = i - kk * sw;
      rs[kk * kBdCols + cc] = to_float(
          transpose ? rg_src[(long)(c0 + cc) * b + k0 + kk]
                    : rg_src[(long)(k0 + kk) * b + c0 + cc]);
    }
    for (int i = threadIdx.x; i < kBdRows * kc; i += kBdThreads) {
      const int r = i / kc, kk = i - r * kc;
      xs[r * kBdDepth + kk] =
          row0 + r < M ? to_float(xg[(long)(row0 + r) * d + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (cl < sw) {
      for (int k = 0; k < kc; ++k) {
        const float r0 = rs[k * kBdCols + cl];
#pragma unroll
        for (int i = 0; i < kBdRowsPerThread; ++i)
          acc[i] = fmaf(xs[(rg + i * kBdRowGroups) * kBdDepth + k], r0,
                        acc[i]);
      }
    }
  }
  if (cl >= sw) return;
  const long col = (long)cols.g0 * b + c0 + cl;
#pragma unroll
  for (int i = 0; i < kBdRowsPerThread; ++i) {
    const int m = row0 + rg + i * kBdRowGroups;
    if (m < M) y[(long)m * d + col] = from_float<T>(acc[i]);
  }
}

template <typename T, typename TR>
cudaError_t launch_simt(const void* x, const void* rots, void* y, int M,
                        int d, int b, int transpose, cudaStream_t stream) {
  const dim3 grid(cdiv(M, kBdRows), column_blocks(d, b));
  const T* xt = static_cast<const T*>(x);
  const TR* rt = static_cast<const TR*>(rots);
  T* yt = static_cast<T*>(y);
  if (b > kBdCols) {
    const size_t smem =
        (size_t)(kBdDepth * kBdCols + kBdRows * kBdDepth) * sizeof(float);
    cudaError_t err = allow_smem(blockdiag_simt_chunked_kernel<T, TR>, smem);
    if (err != cudaSuccess) return err;
    blockdiag_simt_chunked_kernel<T, TR><<<grid, kBdThreads, smem, stream>>>(
        xt, rt, yt, M, d, b, transpose);
    return cudaGetLastError();
  }
  const int gpb = groups_per_block(b);
  const size_t smem =
      (size_t)(round4(gpb * b * b) + kBdRows * gpb * b) * sizeof(float);
  void (*kernel)(const T*, const TR*, T*, int, int, int, int, int) =
      blockdiag_simt_kernel<T, TR, false>;
  if (b % 4 == 0) kernel = blockdiag_simt_kernel<T, TR, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBdThreads, smem, stream>>>(xt, rt, yt, M, d, b, gpb,
                                             transpose);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // four warps of 16 rows
constexpr int kMmaRows = kMmaThreads / 2;  // rows of a tile
constexpr int kMmaStages = 3;     // ring depth of the x (and R chunk) stages
constexpr int kPad = 8;           // bf16 elements: 16 bytes a row

// Shared-memory layout of the mma engine, in bf16 elements.  Resident
// (b <= 128): the block's R_g [gpb * b][b + pad], then the stages, each an
// x tile [64][gpb * b + pad] (the epilogue writes y over the warp's own
// rows of it).  Chunked (b > 128): stages of an x chunk [64][64 + pad] and
// an R_g rectangle (forward [64 depth][128 + pad], transposed
// [128][64 + pad]), then a y stage [64][128 + pad].
struct MmaLayout {
  bool chunked;
  int pr;       // row pitch of R_g (resident) or of the forward rectangle
  int px;       // row pitch of an x tile
  int r_elems;  // resident R region, or one stage's rectangle
  int stage;    // one stage: x tile (+ rectangle when chunked)
  int total;

  __host__ __device__ explicit MmaLayout(int b) {
    chunked = b > kBdCols;
    if (!chunked) {
      const int gw = groups_per_block(b) * b;
      pr = b + kPad;
      px = gw + kPad;
      r_elems = gw * pr;
      stage = kMmaRows * px;
      total = r_elems + kMmaStages * stage;
    } else {
      pr = kBdCols + kPad;
      px = kBdDepth + kPad;
      const int fwd = kBdDepth * pr, bwd = kBdCols * (kBdDepth + kPad);
      r_elems = fwd > bwd ? fwd : bwd;
      stage = kMmaRows * px + r_elems;
      total = kMmaStages * stage + kMmaRows * (kBdCols + kPad);
    }
  }
};

// cp.async a rows x cols (cols a multiple of 8) rectangle of a row-major
// array with row stride ld into shared memory with row pitch pitch; rows
// at or past ``valid`` are zero-filled
__device__ __forceinline__ void copy_rect(bf16* dst, int pitch,
                                          const bf16* src, long ld, int rows,
                                          int cols, int valid,
                                          const bf16* any) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += kMmaThreads) {
    const int r = i / cpr, ch = i - r * cpr;
    const bool ok = r < valid;
    ptx::cp_async(dst + r * pitch + ch * 8,
                  ok ? src + (long)r * ld + ch * 8 : any, ok ? 16 : 0);
  }
}

// One x tile through every resident R_g of the block at b = kB (16, 32 or
// 64): the groups' loops unrolled, each depth step's fragments of all
// groups loaded before their mmas, so the groups' chains overlap.  Writes
// the bf16 result over the warp's own rows of the tile.
template <int kB>
__device__ __forceinline__ void mma_groups(bf16* xs, int px,
                                           const bf16* r_res, int pr, int ng,
                                           int transpose, int warp,
                                           int lane) {
  constexpr int kG = kBdCols / kB, kP = kB / 16;
  float acc[kG][2 * kP][4];
#pragma unroll
  for (int j = 0; j < kG; ++j)
#pragma unroll
    for (int n = 0; n < 2 * kP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
  const bf16* xa = xs + (warp * 16 + (lane & 15)) * px + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kB; kk += 16) {
    unsigned a[kG][4], bq[kG][kP][4];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j < ng) {
        ptx::ldmatrix_x4(a[j], xa + j * kB + kk);
        const bf16* rect = r_res + j * kB * pr;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          if (transpose)  // B(k, n) = R_g[n][k]
            ptx::ldmatrix_x4(bq[j][p], rect + (p * 16 + (lane & 7) +
                                               (lane >> 4) * 8) * pr +
                                           kk + ((lane >> 3) & 1) * 8);
          else            // B(k, n) = R_g[k][n]
            ptx::ldmatrix_x4_trans(bq[j][p], rect + (kk + (lane & 15)) * pr +
                                                 p * 16 + (lane >> 4) * 8);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j < ng) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          ptx::mma_bf16(acc[j][2 * p], a[j], bq[j][p][0], bq[j][p][1]);
          ptx::mma_bf16(acc[j][2 * p + 1], a[j], bq[j][p][2], bq[j][p][3]);
        }
      }
    }
  }
  __syncwarp();  // every lane's ldmatrix of these rows is done
  const int row = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (j < ng) {
#pragma unroll
      for (int n = 0; n < 2 * kP; ++n) {
        const int col = j * kB + n * 8 + 2 * (lane & 3);
        *reinterpret_cast<unsigned*>(xs + row * px + col) =
            pack_bf16(acc[j][n][0], acc[j][n][1]);
        *reinterpret_cast<unsigned*>(xs + (row + 8) * px + col) =
            pack_bf16(acc[j][n][2], acc[j][n][3]);
      }
    }
  }
}

// kB: 16, 32 or 64 for those block sizes (mma_groups), 0 for any other
template <int kB>
__global__ void __launch_bounds__(kMmaThreads)
    blockdiag_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ rots, bf16* __restrict__ y,
                         int M, int d, int b_arg, int transpose, int tpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int b = kB ? kB : b_arg;
  const MmaLayout L(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Columns cols = block_columns(blockIdx.x, b, d / b);
  const int g0 = cols.g0, ng = cols.ng, c0 = cols.c0, sw = cols.sw;
  const int t0 = blockIdx.y * tpb;
  const int nt = min(tpb, cdiv(M, kMmaRows) - t0);
  const int chunks = L.chunked ? cdiv(b, kBdDepth) : 1;
  const int items = nt * chunks;
  const long bb = (long)b * b;
  bf16* r_res = sm;                                    // resident R_g
  bf16* stages = L.chunked ? sm : sm + L.r_elems;
  bf16* y_stage = sm + kMmaStages * L.stage;           // chunked only
  // the forward rectangle's pitch, or the transposed one's
  const int prc = transpose ? kBdDepth + kPad : L.pr;

  auto issue = [&](int item) {
    bf16* xs = stages + (item % kMmaStages) * L.stage;
    const int t = t0 + item / chunks, ch = item % chunks;
    const int row0 = t * kMmaRows;
    if (!L.chunked) {
      copy_rect(xs, L.px, x + (long)row0 * d + (long)g0 * b, d, kMmaRows,
                ng * b, M - row0, x);
      return;
    }
    const int k0 = ch * kBdDepth, kc = min(kBdDepth, b - k0);
    copy_rect(xs, L.px, x + (long)row0 * d + (long)g0 * b + k0, d, kMmaRows,
              kc, M - row0, x);
    const bf16* rg = rots + g0 * bb;
    bf16* rect = xs + kMmaRows * L.px;
    if (transpose)  // R_g[c0 + n][k0 + k], [n][k]
      copy_rect(rect, prc, rg + (long)c0 * b + k0, b, sw, kc, sw, x);
    else            // R_g[k0 + k][c0 + n], [k][n]
      copy_rect(rect, prc, rg + (long)k0 * b + c0, b, kc, sw, kc, x);
  };

  if (!L.chunked)  // the block's R_g, once, with the first item's group
    for (int jj = 0; jj < ng; ++jj)
      copy_rect(r_res + jj * b * L.pr, L.pr, rots + (g0 + jj) * bb, b, b, b,
                b, x);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < items) issue(s);
    ptx::cp_async_commit();
  }

  float acc[16][4];
  const int npairs = sw / 16;  // 16-column pairs of n8 tiles, at most 8
  for (int item = 0; item < items; ++item) {
    ptx::cp_async_wait<kMmaStages - 2>();  // item's group has landed
    __syncthreads();  // for every thread; and item - 1's slot is free
    if (item + kMmaStages - 1 < items) issue(item + kMmaStages - 1);
    ptx::cp_async_commit();

    bf16* xs = stages + (item % kMmaStages) * L.stage;
    const int t = t0 + item / chunks, ch = item % chunks;
    const bool first = ch == 0, last = ch == chunks - 1;
    const int kd = L.chunked ? min(kBdDepth, b - ch * kBdDepth) : b;
    if constexpr (kB != 0)
      mma_groups<kB>(xs, L.px, r_res, L.pr, ng, transpose, warp, lane);
    for (int j = 0; kB == 0 && j < ng; ++j) {
      if (first) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
      const bf16* rect = L.chunked ? xs + kMmaRows * L.px
                                   : r_res + j * b * L.pr;
      const int pr = L.chunked ? prc : L.pr;
      const int xcol = L.chunked ? 0 : j * b;
      const bf16* xa = xs + (warp * 16 + (lane & 15)) * L.px + xcol +
                       (lane >> 4) * 8;
      for (int kk = 0; kk < kd; kk += 16) {
        unsigned a[4];
        ptx::ldmatrix_x4(a, xa + kk);
        unsigned bq[8][4];  // every B fragment of the step, then the mmas
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (p < npairs) {
            if (transpose)  // B(k, n) = rect[n][k]
              ptx::ldmatrix_x4(bq[p], rect + (p * 16 + (lane & 7) +
                                              (lane >> 4) * 8) * pr +
                                          kk + ((lane >> 3) & 1) * 8);
            else            // B(k, n) = rect[k][n]
              ptx::ldmatrix_x4_trans(bq[p], rect + (kk + (lane & 15)) * pr +
                                                p * 16 + (lane >> 4) * 8);
          }
        }
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (p < npairs) {
            ptx::mma_bf16(acc[2 * p], a, bq[p][0], bq[p][1]);
            ptx::mma_bf16(acc[2 * p + 1], a, bq[p][2], bq[p][3]);
          }
        }
      }
      if (last) {  // round to bf16 into the warp's own rows
        bf16* dst = L.chunked ? y_stage : xs;
        const int pitch = L.chunked ? kBdCols + kPad : L.px;
        __syncwarp();  // every lane's ldmatrix of these rows is done
        const int row = warp * 16 + (lane >> 2);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (p < npairs) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = xcol + (2 * p + h) * 8 + 2 * (lane & 3);
              *reinterpret_cast<unsigned*>(dst + row * pitch + col) =
                  pack_bf16(acc[2 * p + h][0], acc[2 * p + h][1]);
              *reinterpret_cast<unsigned*>(dst + (row + 8) * pitch + col) =
                  pack_bf16(acc[2 * p + h][2], acc[2 * p + h][3]);
            }
          }
        }
      }
    }
    if (last) {  // the warp's 16 rows back to y, 16 bytes a lane
      __syncwarp();
      const bf16* src = L.chunked ? y_stage : xs;
      const int pitch = L.chunked ? kBdCols + kPad : L.px;
      const int width = L.chunked ? sw : ng * b;
      const long gcol = (long)g0 * b + c0;
      const int cpr = width / 8;
      for (int e = lane; e < 16 * cpr; e += 32) {
        const int r = e / cpr, cch = e - r * cpr;
        const int m = t * kMmaRows + warp * 16 + r;
        if (m < M)
          *reinterpret_cast<uint4*>(y + (long)m * d + gcol + cch * 8) =
              *reinterpret_cast<const uint4*>(src + (warp * 16 + r) * pitch +
                                              cch * 8);
      }
    }
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block
}

cudaError_t launch_mma(const void* x, const void* rots, void* y, int M,
                       int d, int b, int transpose, int tpb,
                       cudaStream_t stream) {
  const MmaLayout L(b);
  const size_t smem = (size_t)L.total * sizeof(bf16);
  void (*kernel)(const bf16*, const bf16*, bf16*, int, int, int, int, int) =
      b == 16   ? blockdiag_mma_kernel<16>
      : b == 32 ? blockdiag_mma_kernel<32>
      : b == 64 ? blockdiag_mma_kernel<64>
                : blockdiag_mma_kernel<0>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(column_blocks(d, b), cdiv(cdiv(M, kMmaRows), tpb));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(rots),
      static_cast<bf16*>(y), M, d, b, transpose, tpb);
  return cudaGetLastError();
}

}  // namespace repro_torch

// dtype: x and y; rdtype: rots (fp32, or x's dtype).  engine: 0 "simt"
// (any dtypes, any b dividing d), 1 "mma" (bf16 x and rots, b a multiple of
// 16, every array 16-byte aligned, tiles_per_block >= 1); anything else is
// refused.
extern "C" int blockdiag_rotate_launch(int dtype, int rdtype, int engine,
                                       int transpose, const void* x,
                                       const void* rots, void* y, int M,
                                       int d, int b, int tiles_per_block,
                                       void* stream) {
  using namespace repro_torch;
  if (M == 0 || d == 0) return 0;
  if (M < 0 || d < 0 || b < 1 || d % b) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 1) {
    const size_t ptrs = reinterpret_cast<size_t>(x) |
                        reinterpret_cast<size_t>(rots) |
                        reinterpret_cast<size_t>(y);
    if (dtype != REPRO_DTYPE_BF16 || rdtype != REPRO_DTYPE_BF16 || b % 16 ||
        ptrs % 16 || tiles_per_block < 1)
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, rots, y, M, d, b, transpose, tiles_per_block,
                           s);
  }
  if (engine != 0) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_DTYPE_F32 && rdtype == REPRO_DTYPE_F32)
    return (int)launch_simt<float, float>(x, rots, y, M, d, b, transpose, s);
  if (dtype == REPRO_DTYPE_BF16 && rdtype == REPRO_DTYPE_F32)
    return (int)launch_simt<bf16, float>(x, rots, y, M, d, b, transpose, s);
  if (dtype == REPRO_DTYPE_BF16 && rdtype == REPRO_DTYPE_BF16)
    return (int)launch_simt<bf16, bf16>(x, rots, y, M, d, b, transpose, s);
  return (int)cudaErrorInvalidValue;
}
