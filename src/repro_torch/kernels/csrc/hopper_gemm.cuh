// Hopper GEMM engine of psoft_matmul.cu: TMA loads into an mbarrier ring,
// warpgroup MMAs (wgmma) with fp32 accumulators in registers.
//
//   C (M x N) = [A1 | A2] (M x (D1 + D2)) . [B1 ; B2] ((D1 + D2) x N)
//
// in bf16 with fp32 accumulation; C is bf16 or fp32.  A1 and A2 are
// row-major (K-major) bf16 arrays; B1 and B2 are bf16 arrays read either
// K-major (stored as N x D, the depth contiguous: a transposed operand read
// in place) or MN-major (stored as D x N).  The depth is walked in steps of
// 64: ceil(D1 / 64) steps over A1 and B1, then ceil(D2 / 64) over A2 and B2
// (the extended depth of the PSOFT linear: [x | v] . [W' ; P_out]).  TMA
// fills every element outside an array with zeros, so a seam or a depth
// that 64 does not divide stays exact; ragged M and N are masked at the
// store.  TMA's rules: 16-byte-aligned bases and row pitches (every row
// length a multiple of 8 elements); the caller checks them.
//
// Grouped products: every operand is a stack of G arrays (one per expert of
// an MoE layer), described to TMA as a 3-D tensor with the group as its
// outer dimension and boxes 1 deep there, and the grid's y axis is the
// group.  TMA clips a box at the edge of its own group's array (zero fill
// past the last row or column), so a tile that overhangs an expert's M = C
// rows (C = 240 at deepseek-moe-16b is not a multiple of 64) reads zeros,
// never the next expert's rows, and its store is masked at the group's M.
// The single product is the G = 1 case of the same maps.
//
// Block: NC consumer warpgroups (BM = 64 * NC rows, one m64nBNk16 wgmma
// row band each) and one producer warp.  One thread of the producer warp
// issues the TMA loads of each stage (A: one 64-wide box of BM rows; B: one
// 64 x BN box K-major, or BN / 64 boxes of 64 x 64 MN-major, all with the
// 128-byte swizzle) into a ring of STAGES stages; a "full" mbarrier per
// stage counts the bytes in (complete_tx), an "empty" one the consumer
// warps' releases.  Consumers keep one wgmma group in flight: a stage is
// released when the group after it has been issued and its own has
// retired.  The epilogue stages each warpgroup's tile in shared memory and
// writes it with 16-byte stores.  One output tile per block (no persistent
// grid); the tile order is chosen by the caller so that the blocks in
// flight share the larger operand through L2.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace hopper {

constexpr int kBK = 64;             // depth of a stage: one 128-byte row
constexpr int kStageRowBytes = 128;  // bf16 row of one stage, swizzled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity ``parity`` has completed; a wait that
// outlasts any real one (a fault in the pipeline) traps, so a deadlock
// becomes a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 3-D TMA load of the box at (c0 inner, c1 outer, group g) into shared
// memory, counted on ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(g)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 1024-byte
// swizzle atoms start 1024-aligned: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(const void* smem,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving other instructions on the accumulators
// into a wgmma's pipeline stage (which would serialize the wgmmas)
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32, in registers) += A (64 x 16) . B (16 x 64), both bf16
// in shared memory (D = A . B where scale_d is 0); kTransB: B is MN-major
// (else K-major)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// D (64 x 128, fp32, in registers) += A (64 x 16) . B (16 x 128), both bf16
// in shared memory (D = A . B where scale_d is 0); kTransB: B is MN-major
// (else K-major)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// one m64nBNk16 wgmma, BN = 64 or 128
template <int BN, int kTransB>
__device__ __forceinline__ void wgmma(float* d, uint64_t desc_a,
                                      uint64_t desc_b, int scale_d) {
  static_assert(BN == 64 || BN == 128, "the engine uses n64 and n128");
  if constexpr (BN == 64)
    wgmma_m64n64<kTransB>(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n128<kTransB>(d, desc_a, desc_b, scale_d);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared-memory plan of one block: STAGES x (A tile, B tile), then one
// epilogue tile per consumer warpgroup, then the barriers.  Every tile
// starts 1024-aligned (the swizzle atom).
template <int NC, int BN, int STAGES, typename TOut>
struct Plan {
  static constexpr int kBM = 64 * NC;
  static constexpr int kThreads = NC * 128 + 32;
  static constexpr int kABytes = kBM * kStageRowBytes;
  static constexpr int kBBytes = BN * kStageRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPitch = BN * (int)sizeof(TOut) + 16;
  static constexpr int kEpiOffset = STAGES * kStageBytes;
  static constexpr int kBarOffset = kEpiOffset + NC * 64 * kPitch;
  static constexpr int kBytes = kBarOffset + 2 * STAGES * 8 + 1024;
};

// One BM x BN tile of C per block, of group blockIdx.y (C of group g starts
// g M N elements on).  Tiles are numbered M-fastest (the blocks in flight
// share B's columns) or N-fastest (they share A's rows).
template <int NC, int BN, bool kBKMajor, int STAGES, typename TOut>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a1,
                const __grid_constant__ CUtensorMap tm_b1,
                const __grid_constant__ CUtensorMap tm_a2,
                const __grid_constant__ CUtensorMap tm_b2, int steps1,
                int steps2, TOut* __restrict__ c, int M, int N,
                int m_fastest) {
  using P = Plan<NC, BN, STAGES, TOut>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + STAGES;

  const int m_tiles = (M + P::kBM - 1) / P::kBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  c += (long)g * M * N;
  const int mt = m_fastest ? tile % m_tiles : tile / n_tiles;
  const int nt = m_fastest ? tile / m_tiles : tile % n_tiles;
  const int m0 = mt * P::kBM, n0 = nt * BN;
  const int nsteps = steps1 + steps2;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one release per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      for (int ks = 0; ks < nsteps; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty[s], ((ks / STAGES) - 1) & 1);
        unsigned char* a_s = smem + s * P::kStageBytes;
        unsigned char* b_s = a_s + P::kABytes;
        const bool seg1 = ks < steps1;
        const int k0 = (seg1 ? ks : ks - steps1) * kBK;
        const CUtensorMap* ma = seg1 ? &tm_a1 : &tm_a2;
        const CUtensorMap* mb = seg1 ? &tm_b1 : &tm_b2;
        mbar_expect_tx(&full[s], P::kStageBytes);
        tma_load_3d(a_s, ma, &full[s], k0, m0, g);
        if constexpr (kBKMajor) {
          tma_load_3d(b_s, mb, &full[s], k0, n0, g);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b_s + j * 64 * kStageRowBytes, mb, &full[s],
                        n0 + 64 * j, k0, g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];  // the first step overwrites it (scale_d = 0)
  for (int ks = 0; ks < nsteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const unsigned char* a_s =
        smem + s * P::kStageBytes + wg * 64 * kStageRowBytes;
    const unsigned char* b_s = smem + s * P::kStageBytes + P::kABytes;
    fence_operands<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // K-major: the next 16 of depth are 32 bytes on within each swizzled
      // row, 8-row atoms 1024 bytes apart.  MN-major: 16 rows on (2048
      // bytes), 8-row atoms 1024 bytes apart, 64-column chunks 8 KB apart.
      const uint64_t da = make_desc(a_s + kk * 32, 16, 1024);
      const uint64_t db =
          kBKMajor ? make_desc(b_s + kk * 32, 16, 1024)
                   : make_desc(b_s + kk * 16 * kStageRowBytes,
                               64 * kStageRowBytes, 1024);
      wgmma<BN, kBKMajor ? 0 : 1>(acc, da, db, ks > 0 || kk > 0);
    }
    wgmma_commit();
    fence_operands<BN / 2>(acc);
    wgmma_wait<1>();  // the previous step's group has retired
    if (ks > 0 && threadIdx.x % 32 == 0)
      mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_operands<BN / 2>(acc);

  // epilogue: the accumulator fragment (row 16 w + lane / 4 (+ 8), column
  // 8 j + 2 (lane % 4) (+ 1)) into this warpgroup's staging tile, then
  // 16-byte row chunks to C
  const int tid = threadIdx.x % 128;
  const int wl = tid / 32, lane = tid % 32;
  unsigned char* epi = smem + P::kEpiOffset + wg * 64 * P::kPitch;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = wl * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = (i / 4) * 8 + (lane % 4) * 2;
    store_pair(reinterpret_cast<TOut*>(epi + row * P::kPitch) + col, acc[i],
               acc[i + 1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
  constexpr int kElems = 16 / (int)sizeof(TOut);
  constexpr int kChunks = BN / kElems;
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks, ch = i % kChunks;
    const int grow = m0 + wg * 64 + row, gcol = n0 + ch * kElems;
    if (grow < M && gcol < N)
      *reinterpret_cast<uint4*>(c + (long)grow * N + gcol) =
          *reinterpret_cast<const uint4*>(epi + row * P::kPitch + ch * 16);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A stack of ``groups`` dense row-major bf16 arrays of ``outer`` rows of
// ``inner`` elements each, one after another.
struct Operand {
  const void* ptr;
  long inner, outer;
  long groups;
};

// TMA map of ``op`` in boxes of box_inner x box_outer x 1 group, 128-byte
// swizzle, zeros outside each group's array
inline bool encode(CUtensorMap* map, const Operand& op, uint32_t box_inner,
                   uint32_t box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)op.inner, (cuuint64_t)op.outer,
                              (cuuint64_t)op.groups};
  const cuuint64_t strides[2] = {(cuuint64_t)op.inner * 2,
                                 (cuuint64_t)op.inner * op.outer * 2};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(op.ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C (M x N) = [A1 | A2] . [B1 ; B2]: A1 (M x d1) and A2 (M x d2) row-major;
// B K-major (stored N x d) or MN-major (stored d x N).  d2 = 0 leaves out
// the second segment (a2, b2 unused).  Every operand holds ``groups``
// arrays (its ``groups`` field must say so) and C groups x M x N.
template <int NC, int BN, bool kBKMajor, int STAGES, typename TOut>
cudaError_t launch_gemm(const Operand& a1, const Operand& b1,
                        const Operand& a2, const Operand& b2, int d1, int d2,
                        TOut* c, int M, int N, bool m_fastest,
                        cudaStream_t stream, int groups = 1) {
  using P = Plan<NC, BN, STAGES, TOut>;
  // the encoder is a driver call: it needs the device's context current on
  // this thread (autograd runs backwards on threads of its own, where only
  // runtime calls have bound it so far)
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, a1.ptr);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const Operand* ops[4] = {&a1, &b1, d2 > 0 ? &a2 : &a1,
                           d2 > 0 ? &b2 : &b1};
  for (int i = 0; i < 4; ++i) {
    const bool is_a = i % 2 == 0;
    const bool ok =
        is_a ? encode(&maps[i], *ops[i], kBK, P::kBM)
             : (kBKMajor ? encode(&maps[i], *ops[i], kBK, BN)
                         : encode(&maps[i], *ops[i], 64, kBK));
    if (!ok || ops[i]->groups != groups) return cudaErrorInvalidValue;
  }
  auto kernel = gemm_kernel<NC, BN, kBKMajor, STAGES, TOut>;
  err = allow_smem(kernel, P::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + P::kBM - 1) / P::kBM) * ((N + BN - 1) / BN);
  kernel<<<dim3(tiles, groups), P::kThreads, P::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (d1 + kBK - 1) / kBK,
      d2 > 0 ? (d2 + kBK - 1) / kBK : 0, c, M, N, m_fastest ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace repro_torch
