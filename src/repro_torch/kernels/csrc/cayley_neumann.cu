// Cayley-Neumann rotation of a layer stack:
//   R = (I - Q) sum_{k<=K} (-Q)^k   by K Horner steps  S <- I - Q S.
//
// Replaces the TPU kernel src/repro/kernels/cayley_kernel.py,
// cayley_neumann_pallas.
//
//   q (L, r, r) fp32, dense (skew-symmetric in use).  Writes the partial
//   sums S_1 .. S_K as series (K, L, r, r) fp32 (the autograd function's
//   backward runs the reverse Horner recursion over them; S_0 = I is not
//   stored) and R (L, r, r) fp32.  K = 0 gives R = I - Q.
//
// Two engines, chosen by the wrapper from r (ops._cayley_engine) and passed
// as a code the entry point refuses where the shape does not meet it:
//
// "smem" (r <= 128): the TPU kernel's own design, which fits a Hopper SM at
//   these sizes: one launch for the whole stack, each block holding Q and
//   S of its matrices in shared memory (2 r^2 fp32 each, rows padded to a
//   multiple of 4 plus 4: 135 KB at r = 128) across all K steps; a step
//   computes the next S in registers and writes it over S after a
//   barrier.  Several matrices share a block where they are small
//   (ops.cayley_smem_plan: 4 at r = 32, 64 at r = 8), so the 256 threads
//   each own one 4 x 4 output tile: rows ti + rp/4 * i, columns 4 tj ..
//   4 tj + 3, from 16-byte shared-memory reads, exact fp32 FMAs.  Each S_k
//   and R leaves by coalesced stores while the next step computes.  What
//   bounds it: bytes at the OFT and BOFT stacks (Q in, K + 1 matrices out:
//   77 MB for OFT's 2688 blocks of 32, 11.4 flops a byte at r = 32, below
//   the fp32 ridge of 20).
// "tc" (larger r; PSOFT's r = 352): one launch per Horner step on the
//   tensor cores in 3xTF32: each fp32 operand splits into a tf32 high part
//   (its top 10 mantissa bits) and the rest, and each product is lo.hi +
//   hi.lo + hi.hi by mma.sync m16n8k8 with fp32 accumulators (~1e-6
//   relative; plain TF32 misses the fp32 limit at PSOFT's scale).  A block
//   owns a 352 x 88 tile (4 blocks a matrix, 112 for a 28-layer stack:
//   352 = 4 x 88, no padding): 11 warps of 32 rows x 88 columns, 32-deep
//   steps through a three-stage cp.async ring, rows padded so every
//   fragment read is conflict-free.  The first launch forms S_1 = I - Q as
//   Q enters its registers and writes S_1 from the Q columns its stages
//   hold; the Horner epilogue (I - Q S, or S_K - Q S_K for R) stages the
//   product in shared memory and leaves by 16-byte stores.  Each launch
//   after the first is a programmatic dependent launch: its blocks start
//   while the previous step finishes, load their Q tiles, and only then
//   wait (griddepcontrol.wait) for the S they multiply.  What bounds it:
//   operations, 12.2 GFLOP a stack, 3 x that on the tf32 tensor cores
//   (0.074 ms at 494.7 TFLOP/s) against 0.18 ms of exact fp32 FMAs;
//   mma.sync reaches a fraction of the tensor cores' wgmma rate, and each
//   block streams all of Q for its 88 columns.
#include "common.cuh"
#include "ptx.cuh"

namespace repro_torch {

constexpr int kMaxGridZ = 65535;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// "smem": the whole series of a few matrices in shared memory
// ---------------------------------------------------------------------------

constexpr int kCsThreads = 256;
constexpr int kCsMaxR = 128;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100

__host__ __device__ inline int cs_rp(int r) { return (r + 3) & ~3; }
__host__ __device__ inline int cs_pitch(int r) { return cs_rp(r) + 4; }
// floats a matrix takes (Q, then S), rounded so that neighbouring
// matrices start 8 banks apart
__host__ __device__ inline int cs_matrix_floats(int r) {
  return ((2 * cs_rp(r) * cs_pitch(r) + 31) & ~31) + 8;
}

// out[m0 ...] = S of the block's np matrices (coalesced)
__device__ __forceinline__ void cs_store(const float* cs,
                                         float* __restrict__ out, int np,
                                         int r, bool vec) {
  const int rp = cs_rp(r), pitch = cs_pitch(r), ms = cs_matrix_floats(r);
  const int mat = r * r;
  const int off = rp * pitch;
  if (vec) {  // r % 4 == 0: four consecutive elements share a row
    for (int e = threadIdx.x * 4; e < np * mat; e += kCsThreads * 4) {
      const int p = e / mat, rem = e - p * mat, i = rem / r, j = rem - i * r;
      *reinterpret_cast<float4*>(out + e) = *reinterpret_cast<const float4*>(
          cs + p * ms + off + i * pitch + j);
    }
  } else {
    for (int e = threadIdx.x; e < np * mat; e += kCsThreads) {
      const int p = e / mat, rem = e - p * mat, i = rem / r, j = rem - i * r;
      out[e] = cs[p * ms + off + i * pitch + j];
    }
  }
}

// S <- I - Q S (eye), or S - Q S: every thread computes its (at most
// MAXT) tiles in registers, all threads pass a barrier (no one reads S any
// more), then each writes its own tiles back; padding stays 0
template <int MAXT>
__device__ __forceinline__ void cs_step(float* cs, int np, int r, bool eye) {
  const int rp = cs_rp(r), pitch = cs_pitch(r), ms = cs_matrix_floats(r);
  const int tpr = rp / 4, tiles = tpr * tpr;
  float out[MAXT][4][4];
#pragma unroll
  for (int w = 0; w < MAXT; ++w) {
    const int idx = threadIdx.x + w * kCsThreads;
    if (idx >= np * tiles) break;
    const int p = idx / tiles, rem = idx - p * tiles;
    const int ti = rem / tpr, tj = rem - ti * tpr;
    const float* qm = cs + p * ms;
    const float* s = qm + rp * pitch;
    float acc[4][4] = {};
    for (int k = 0; k < rp; k += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qm + (ti + tpr * i) * pitch +
                                                 k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 sv =
            *reinterpret_cast<const float4*>(s + (k + kk) * pitch + 4 * tj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qk = kk == 0 ? qv[i].x
                         : kk == 1 ? qv[i].y
                         : kk == 2 ? qv[i].z : qv[i].w;
          acc[i][0] = fmaf(qk, sv.x, acc[i][0]);
          acc[i][1] = fmaf(qk, sv.y, acc[i][1]);
          acc[i][2] = fmaf(qk, sv.z, acc[i][2]);
          acc[i][3] = fmaf(qk, sv.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ti + tpr * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * tj + c;
        const float base = eye ? (row == col ? 1.f : 0.f)
                               : s[row * pitch + col];
        out[w][i][c] = row < r && col < r ? base - acc[i][c] : 0.f;
      }
    }
  }
  __syncthreads();  // every read of S is done
#pragma unroll
  for (int w = 0; w < MAXT; ++w) {
    const int idx = threadIdx.x + w * kCsThreads;
    if (idx >= np * tiles) break;
    const int p = idx / tiles, rem = idx - p * tiles;
    const int ti = rem / tpr, tj = rem - ti * tpr;
    float* s = cs + p * ms + rp * pitch;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s + (ti + tpr * i) * pitch + 4 * tj) =
          make_float4(out[w][i][0], out[w][i][1], out[w][i][2],
                      out[w][i][3]);
  }
}

// block: matrices [m0, m0 + per_block) of the stack; MAXT: 4 x 4 tiles a
// thread owns at most (1 up to r = 64, 4 at r = 128)
template <int MAXT>
__global__ void __launch_bounds__(kCsThreads)
    cayley_smem_kernel(const float* __restrict__ q, float* __restrict__ series,
                       float* __restrict__ rot, int L, int r, int terms,
                       int per_block, bool vec) {
  extern __shared__ __align__(16) float cs[];
  const int rp = cs_rp(r), pitch = cs_pitch(r), ms = cs_matrix_floats(r);
  const long m0 = (long)blockIdx.x * per_block;
  const int np = (int)(L - m0 < per_block ? L - m0 : per_block);
  const int mat = r * r;
  const long n = (long)L * mat;
  for (int i = threadIdx.x; i < np * ms; i += kCsThreads) cs[i] = 0.f;
  __syncthreads();
  // Q, then S_1 = I - Q
  const float* qb = q + m0 * mat;
  for (int e = threadIdx.x; e < np * mat; e += kCsThreads) {
    const int p = e / mat, rem = e - p * mat, i = rem / r, j = rem - i * r;
    const float v = qb[e];
    float* base = cs + p * ms + i * pitch + j;
    base[0] = v;
    base[rp * pitch] = (i == j ? 1.f : 0.f) - v;
  }
  __syncthreads();
  cs_store(cs, (terms > 0 ? series : rot) + m0 * mat, np, r, vec);
  for (int k = 2; k <= terms + 1; ++k) {
    cs_step<MAXT>(cs, np, r, k <= terms);  // its barrier orders the store
    __syncthreads();
    cs_store(cs, (k <= terms ? series + (long)(k - 1) * n : rot) + m0 * mat,
             np, r, vec);
  }
}

cudaError_t launch_smem(const float* q, float* series, float* rot, int L,
                        int r, int terms, int per_block,
                        cudaStream_t stream) {
  const size_t smem = (size_t)per_block * cs_matrix_floats(r) * sizeof(float);
  const int tiles = (cs_rp(r) / 4) * (cs_rp(r) / 4) * per_block;
  if (r > kCsMaxR || per_block < 1 || smem > kSmemMax ||
      tiles > 4 * kCsThreads)
    return cudaErrorInvalidValue;
  void (*kernel)(const float*, float*, float*, int, int, int, int, bool) =
      tiles <= kCsThreads       ? cayley_smem_kernel<1>
      : tiles <= 2 * kCsThreads ? cayley_smem_kernel<2>
                                : cayley_smem_kernel<4>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec = r % 4 == 0 &&
                   ((reinterpret_cast<size_t>(series) |
                     reinterpret_cast<size_t>(rot)) & 15) == 0;
  kernel<<<cdiv(L, per_block), kCsThreads, smem, stream>>>(
      q, series, rot, L, r, terms, per_block, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "tc": one 3xTF32 tensor-core product per Horner step
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 11;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcWM = 32;                  // rows a warp: two m16 tiles
constexpr int kTcBM = kTcWarps * kTcWM;    // 352 rows a block
constexpr int kTcBN = 88, kTcBK = 32;
constexpr int kTcStages = 3;
constexpr int kTcPA = kTcBK + 4;   // A rows: 8 rows x 4 lanes on 32 banks
constexpr int kTcPB = kTcBN + 16;  // B rows: 104 = 8 mod 32, conflict-free
constexpr int kTcStage = kTcBM * kTcPA + kTcBK * kTcPB;  // floats
constexpr int kTcNT = kTcBN / 8;   // n8 tiles of a warp
constexpr int kTcPC = kTcBN + 4;   // row pitch of the staged product
static_assert(kTcBM * kTcPC <= kTcStages * kTcStage,
              "the staged product must fit in the ring");

// R = I - Q (K = 0 only)
__global__ void eye_minus_kernel(const float* __restrict__ q,
                                 float* __restrict__ out, long n, int r) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long rc = i % ((long)r * r);
    out[i] = (rc / r == rc % r ? 1.f : 0.f) - q[i];
  }
}

// x = hi + lo: hi keeps x's top 10 mantissa bits (the tf32 the tensor core
// reads), lo = x - hi exactly in fp32; the tensor core reads only lo's top
// 10 bits in turn, so hi.hi + hi.lo + lo.hi is within ~2^-20 of x.y.  Bit
// masks, not cvt.rna: the conversion unit's rate held the products back.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// out = (eye ? I : S) - Q S for matrix blockIdx.z, tile (blockIdx.y,
// blockIdx.x).  kFirst: S is S_1 = I - Q, formed from Q as it enters the
// registers, and the block also writes its tile of S_1 to s1_out from the
// Q columns its A stages hold.  VEC:
// floats a copy moves (4 where r % 4 == 0 and the arrays are 16-byte
// aligned, else 1).
template <int VEC, bool kFirst>
__global__ void __launch_bounds__(kTcThreads, 1)
    cayley_tc_kernel(const float* __restrict__ q, const float* __restrict__ s,
                     float* __restrict__ out, float* __restrict__ s1_out,
                     int r, int eye) {
  extern __shared__ __align__(16) float ts[];
  ptx::launch_dependents();  // the next step may start its own Q loads
  const long mat = (long)r * r;
  q += blockIdx.z * mat;
  s = kFirst ? q : s + blockIdx.z * mat;
  out += blockIdx.z * mat;
  if (kFirst) s1_out += blockIdx.z * mat;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = cdiv(r, kTcBK);

  auto issue_a = [&](int kt) {  // Q[m0 + i][k0 + k]
    float* as = ts + (kt % kTcStages) * kTcStage;
    const int k0 = kt * kTcBK;
    constexpr int kPer = kTcBK / VEC;
    for (int i = tid; i < kTcBM * kPer; i += kTcThreads) {
      const int row = i / kPer, c = (i - row * kPer) * VEC;
      const bool ok = m0 + row < r && k0 + c < r;
      ptx::cp_async<4 * VEC>(as + row * kTcPA + c,
                             ok ? q + (long)(m0 + row) * r + k0 + c : q,
                             ok ? 4 * VEC : 0);
    }
  };
  auto issue_b = [&](int kt) {  // S[k0 + k][n0 + n]
    float* bs = ts + (kt % kTcStages) * kTcStage + kTcBM * kTcPA;
    const int k0 = kt * kTcBK;
    constexpr int kPer = kTcBN / VEC;
    for (int i = tid; i < kTcBK * kPer; i += kTcThreads) {
      const int row = i / kPer, c = (i - row * kPer) * VEC;
      const bool ok = k0 + row < r && n0 + c < r;
      ptx::cp_async<4 * VEC>(bs + row * kTcPB + c,
                             ok ? s + (long)(k0 + row) * r + n0 + c : s,
                             ok ? 4 * VEC : 0);
    }
  };

  // Q does not depend on the previous step: load it before waiting
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st)
    if (st < nk) issue_a(st);
  ptx::wait_prerequisite();
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nk) issue_b(st);
    ptx::cp_async_commit();
  }

  float acc[2][kTcNT][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    ptx::cp_async_wait<kTcStages - 2>();
    __syncthreads();
    if (kt + kTcStages - 1 < nk) {
      issue_a(kt + kTcStages - 1);
      issue_b(kt + kTcStages - 1);
    }
    ptx::cp_async_commit();
    const float* as = ts + (kt % kTcStages) * kTcStage;
    const float* bs = as + kTcBM * kTcPA;
    if (kFirst) {  // this stage's columns of Q that fall in the block's
                   // tile give S_1 = I - Q there
      const int k0 = kt * kTcBK;
      const int c_lo = max(n0, k0), c_hi = min(min(n0 + kTcBN, r), k0 + kTcBK);
      for (int i = tid; c_lo < c_hi && i < kTcBM * kTcBK; i += kTcThreads) {
        const int row = i / kTcBK, col = k0 + i % kTcBK;
        if (m0 + row < r && col >= c_lo && col < c_hi)
          s1_out[(long)(m0 + row) * r + col] =
              (m0 + row == col ? 1.f : 0.f) - as[row * kTcPA + col - k0];
      }
    }
#pragma unroll 1  // unrolled, the four k8 steps spill
    for (int ks = 0; ks < kTcBK; ks += 8) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = as + (warp * kTcWM + mt * 16 + g) * kTcPA + ks + t;
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8 * kTcPA], ah[mt][1], al[mt][1]);
        split_tf32(ap[4], ah[mt][2], al[mt][2]);
        split_tf32(ap[8 * kTcPA + 4], ah[mt][3], al[mt][3]);
      }
      const int k = kt * kTcBK + ks + t;  // B rows k and k + 4
#pragma unroll
      for (int nt = 0; nt < kTcNT; ++nt) {
        const float* bp = bs + (ks + t) * kTcPB + nt * 8 + g;
        float b0 = bp[0], b1 = bp[4 * kTcPB];
        if (kFirst) {  // S_1 = I - Q; zero-filled edges stay 0
          const int n = n0 + nt * 8 + g;
          b0 = (k == n && k < r ? 1.f : 0.f) - b0;
          b1 = (k + 4 == n && k + 4 < r ? 1.f : 0.f) - b1;
        }
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ptx::mma_tf32(acc[mt][nt], al[mt], bh0, bh1);
          ptx::mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
          ptx::mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
        }
      }
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it stages the product

  // each warp puts its 32 x 88 product in shared memory (over the ring),
  // then writes its rows out as coalesced 16-byte stores, reading the
  // Horner base (I, or S_K for R) the same way
  float* cw = ts + warp * kTcWM * kTcPC;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTcNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cw + (mt * 16 + g + 8 * h) * kTcPC +
                                   nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncwarp();
  const int row0 = m0 + warp * kTcWM;
  constexpr int kChunks = kTcBN / VEC;  // per row
  for (int i = lane; i < kTcWM * kChunks; i += 32) {
    const int lr = i / kChunks, c = (i - lr * kChunks) * VEC;
    const int row = row0 + lr, col = n0 + c;
    if (row >= r || col >= r) continue;
    const long at = (long)row * r + col;
    float base[VEC], prod[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      prod[e] = cw[lr * kTcPC + c + e];
      base[e] = row == col + e ? 1.f : 0.f;  // the eye steps' base
    }
    if (!eye) {  // R = S_K - Q S_K: the base is S_K (S_1 = I - Q first)
      const float* src = kFirst ? q : s;
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + at);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) base[e] = kFirst ? base[e] - w[e] : w[e];
      } else {
        base[0] = kFirst ? base[0] - src[at] : src[at];
      }
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(out + at) =
          make_float4(base[0] - prod[0], base[1] - prod[1],
                      base[2] - prod[2], base[3] - prod[3]);
    } else {
      out[at] = base[0] - prod[0];
    }
  }
}

cudaError_t launch_tc(const float* q, float* series, float* rot, int L,
                      int r, int terms, cudaStream_t stream) {
  const long mat = (long)r * r;
  const long n = (long)L * mat;
  if (terms == 0) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    eye_minus_kernel<<<blocks, 256, 0, stream>>>(q, rot, n, r);
    return cudaGetLastError();
  }
  const bool vec = r % 4 == 0 &&
                   ((reinterpret_cast<size_t>(q) |
                     reinterpret_cast<size_t>(series) |
                     reinterpret_cast<size_t>(rot)) & 15) == 0;
  using Kernel = void (*)(const float*, const float*, float*, float*, int,
                          int);
  const Kernel first = vec ? cayley_tc_kernel<4, true>
                           : cayley_tc_kernel<1, true>;
  const Kernel step = vec ? cayley_tc_kernel<4, false>
                          : cayley_tc_kernel<1, false>;
  const size_t smem = (size_t)kTcStages * kTcStage * sizeof(float);
  cudaError_t err = allow_smem(first, smem);
  if (err == cudaSuccess) err = allow_smem(step, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  // the grid's z axis holds at most kMaxGridZ matrices: larger stacks go
  // in slices of the stack
  for (int l0 = 0; l0 < L; l0 += kMaxGridZ) {
    const int lc = L - l0 < kMaxGridZ ? L - l0 : kMaxGridZ;
    const long off = (long)l0 * mat;
    for (int k = 2; k <= terms + 1; ++k) {
      const float* prev = series + (long)(k - 2) * n + off;  // S_{k-1}
      float* dst = k <= terms ? series + (long)(k - 1) * n + off : rot + off;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cdiv(r, kTcBN), cdiv(r, kTcBM), lc);
      cfg.blockDim = dim3(kTcThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = stream;
      // the first product (it reads Q written before this call) waits for
      // the stream as any launch does; each later one is a programmatic
      // dependent launch of the step before it
      cfg.attrs = attr;
      cfg.numAttrs = k == 2 ? 0 : 1;
      err = cudaLaunchKernelEx(&cfg, k == 2 ? first : step, q + off, prev,
                               dst, series + off, r, k <= terms ? 1 : 0);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}

}  // namespace repro_torch

// engine: 0 "smem" (r <= 128, per_block matrices a block, within a block's
// shared memory), 1 "tc" (any r); anything else is refused
extern "C" int cayley_neumann_launch(int engine, const void* q, void* series,
                                     void* rot, int L, int r, int terms,
                                     int per_block, void* stream) {
  using namespace repro_torch;
  if (L == 0 || r == 0) return 0;
  if (L < 0 || r < 0 || terms < 0) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* sf = static_cast<float*>(series);
  float* rf = static_cast<float*>(rot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 0)
    return (int)launch_smem(qf, sf, rf, L, r, terms, per_block, s);
  if (engine == 1) return (int)launch_tc(qf, sf, rf, L, r, terms, s);
  return (int)cudaErrorInvalidValue;
}
