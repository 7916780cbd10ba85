// Tiled bf16 GEMM with f32 accumulation and a per-element epilogue, shared
// by the block kernels (attn_block.cu, mlp_block.cu, attn_train.cu,
// mlp_train.cu) and held alone through gemm.cu. Its body (gemm_body) is
// generic over an operand trait: OpBf16 here, OpS8 (int8 codes, exact int32
// accumulators dequantized at the epilogue) in gemm_s8.cuh.
//
//   C[m, n] = sum_k A(m, k) * B(k, n)
//
// the bf16 products of the TPU kernels (dot_general with
// preferred_element_type=f32 in audiossl_tpu/ops/pallas_mlp.py and
// pallas_attn.py). Each operand is stored row-major in one of two layouts,
// chosen at compile time:
//   A_K = true   A(m, k) at A[m * K + k]   (K contiguous: activations x)
//   A_K = false  A(m, k) at A[k * M + m]   (M contiguous: the X^T of X^T dY)
//   B_K = true   B(k, n) at B[n * K + k]   (K contiguous: torch's Linear
//                                           [out, in] weight in x W^T)
//   B_K = false  B(k, n) at B[k * N + n]   (N contiguous: the W of dy W, the
//                                           dY of X^T dY)
// so the forward products (A_K, B_K), the input-gradient products dy W
// (A_K, !B_K) and the weight-gradient products X^T dY over all M rows
// (!A_K, !B_K) all read their operands as stored, with no transposed copy.
//
// What bounds it on the H100: the block kernels' products (M = 48,000 rows
// at the ATST-Frame base step, C = 768, hidden 3072) do ~300 operations per
// byte they must move, at or above the bf16 ridge point, so the tensor-core
// rate bounds them; epilogues that read and write bf16 rows beside the
// product (GELU and its gradient) come close to the memory bound as well.
//
// Design, for Hopper (sm_90a):
//  - A block owns a BM x BN = 128 x 128 output tile: two consumer
//    warpgroups of 64 rows each run wgmma.mma_async m64n128k16 (bf16 in,
//    f32 accumulators in registers), both operands read from shared memory
//    through hand-built descriptors with the 128-byte swizzle. A K-major
//    operand is one TMA box of 64 k (128 bytes) x 128 rows; an MN-major
//    operand (A_K or B_K false) is two boxes of 64 m or n (128 bytes) x 64
//    k and enters wgmma through its transpose bit, so no layout is copied.
//  - One producer warp issues the TMA loads into a ring of STAGES stages of
//    one 128-byte swizzle row of K (BK = 64 bf16), with a full and an empty
//    mbarrier per stage. The producer is a warp, not a warpgroup, so 288
//    threads of 168 registers at most fit the SM's register file without
//    setmaxnreg. One persistent block an SM (the ring and the staging tiles
//    take ~198 KB of shared memory); its two consumer warpgroups take
//    turns, so one's epilogue runs while the other's products do.
//  - TMA zero-fills reads past the tensor, so ragged M, N and K need no
//    masked arithmetic; TMA needs a 16-byte aligned base and a row pitch
//    (the contiguous extent) that is a multiple of 16 bytes (8 bf16).
//  - The epilogue runs from the accumulator registers: each element goes
//    through the functor epi(m, n, acc) (rows and columns past M and N
//    skipped); an epilogue with kColSum also adds the column sums of the
//    values it returns into colsum[n] (the bias gradient of a product's
//    output), summed in a register by the thread that walks the column and
//    added with one atomicAdd per column per tile.
//  - Blocks walk the tiles with n fastest, so that a wave shares the rows
//    of A it reads. The weight-gradient products have K = M rows (48,000)
//    and a small output, so they split K into ranges that add their partial
//    tiles with f32 atomics (EpiAtomicAdd into a zeroed output).
// Only the order of the f32 sums differs from the TPU kernels.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace gemm {

constexpr int BM = 128, BN = 128;
constexpr int ROW_BYTES = 128;  // a stage's K extent: one 128-byte swizzle
// row, 64 bf16 or 128 int8 codes, read by wgmma as 4 slices of 32 bytes
constexpr int BK_BF16 = ROW_BYTES / 2;
constexpr int K_SLICES = ROW_BYTES / 32;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups, each on its own tiles
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the stages (1024-byte aligned for the swizzle), the mbarriers (full and
// empty per stage, order per consumer warpgroup), each warpgroup's staging
// tile and the row scales of its staged rows (int8 products)
constexpr int CP = BN + 8;  // f32 row pitch of a staging tile: float2
// stores from the accumulator layout meet no bank conflict
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES +
                           (2 * STAGES + CONSUMERS) * 8 +
                           CONSUMERS * 64 * (CP + 1) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
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

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

// waits until the barrier's phase of this parity has completed (the waiter
// is never more than one phase ahead); a wait past 4 s traps (an error at
// the next synchronize) rather than holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}

// TMA: the box at (c0 inner, c1 outer) of the map into dst, completing on
// bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major: SBO steps 8 rows (1024
// bytes), LBO is unused. MN-major: LBO steps the 64-wide chunks of m or n,
// SBO 8 rows of k (1024 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// d += A B for one m64n128k16 step; TA / TB: the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// keeps the compiler from moving reads of the accumulators (f32 or s32)
// across the asynchronous wgmma that writes them
template <class Acc>
__device__ __forceinline__ void fence_regs(Acc (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (std::is_same<Acc, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// The operand trait of the bf16 products: bf16 in, f32 accumulators handed
// to the epilogue as they are (no scales), every layout.
struct OpBf16 {
  using T = bf16;
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr bool kScaled = false;
  struct Scales {};
  template <int TA, int TB>
  __device__ static void mma(float (&d)[64], uint64_t da, uint64_t db) {
    wgmma_m64n128k16<TA, TB>(d, da, db);
  }
};

// Persistent blocks: block b takes tiles b, b + gridDim.x, ... of the
// output, numbered with n fastest, then m, then the K split; its consumer
// warpgroups take turns, warpgroup w the block's tiles w, w + 2, ... The
// producer loads the tiles' K steps in that order into one ring, so one
// warpgroup's products run while the other's epilogue does, and the ring's
// stage and phase run on across tiles. A warpgroup starts a tile's products
// once the other has waited for the last K step of the tile before (the
// order barriers), so no waiter runs two phases ahead of a barrier.
//
// The body of every kernel of the template: Op is the operand trait (its
// element type T, accumulator type Acc and wgmma; with kScaled, the row
// and column scales that dequantize an accumulator into the f32 value the
// epilogue takes).
template <class Op, bool A_K, bool B_K, class Epi>
__device__ __forceinline__ void gemm_body(const CUtensorMap& tma_a,
                                          const CUtensorMap& tma_b, int M,
                                          int N, int K, int k_split,
                                          int tiles_n, int tiles, int total,
                                          Epi epi, typename Op::Scales sc) {
  constexpr int BK = ROW_BYTES / sizeof(typename Op::T);
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  unsigned char* smem =
      gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // order[w]: warpgroup w may start
  // each consumer warpgroup's staging tile for the epilogue, 64 x CP f32,
  // and the row scales of its 64 rows
  float* stage_c = reinterpret_cast<float*>(order + CONSUMERS);
  float* stage_r = stage_c + CONSUMERS * 64 * CP;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int w = 0; w < CONSUMERS; ++w) mbar_init(&order[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile -> its corner and K steps
  auto at = [&](int tile, int& m0, int& n0, int& k_lo, int& nk) {
    const int t = tile % tiles;
    m0 = t / tiles_n * BM;
    n0 = t % tiles_n * BN;
    k_lo = tile / tiles * k_split;
    nk = (min(K, k_lo + k_split) - k_lo + BK - 1) / BK;
  };

  if (tid >= CONSUMERS * 128) {  // the producer warp: one thread loads
    if (tid == CONSUMERS * 128) {
      int it = 0;  // K steps loaded so far
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        int m0, n0, k_lo, nk;
        at(tile, m0, n0, k_lo, nk);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES, k0 = k_lo + kt * BK;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* as = smem + s * STAGE_BYTES;
          unsigned char* bs = as + A_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          if (A_K) {
            tma_load(as, &tma_a, &full[s], k0, m0);
          } else {
            tma_load(as, &tma_a, &full[s], m0, k0);
            tma_load(as + A_BYTES / 2, &tma_a, &full[s], m0 + 64, k0);
          }
          if (B_K) {
            tma_load(bs, &tma_b, &full[s], k0, n0);
          } else {
            tma_load(bs, &tma_b, &full[s], n0, k0);
            tma_load(bs + B_BYTES / 2, &tma_b, &full[s], n0 + 64, k0);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: the block's tiles wg, wg + 2, ..., rows m0 ..
  // m0 + 63 in d[0] and m0 + 64 .. m0 + 127 in d[1]
  const int wg = tid / 128, lane = tid % 32;
  int it = 0;  // K steps of the block's tiles before this one
  for (int i = 0, tile = blockIdx.x; tile < total; ++i, tile += gridDim.x) {
    int m0, n0, k_lo, nk;
    at(tile, m0, n0, k_lo, nk);
    if (i % CONSUMERS != wg) {  // the other warpgroup's tile
      it += nk;
      continue;
    }
    if (i > 0) mbar_wait(&order[wg], (i / CONSUMERS - 1 + wg) & 1);
    typename Op::Acc d[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 64; ++r) d[h][r] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE_BYTES), b = a + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < K_SLICES; ++j) {
        // K-major: a slice is 32 bytes along the swizzled row; MN-major
        // (bf16 only): 16 rows of k, 2048 bytes
        const uint64_t db = B_K ? sw128_desc(b + j * 32, 16, 1024)
                                : sw128_desc(b + j * 2048, B_BYTES / 2, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t da =
              A_K ? sw128_desc(a + h * 64 * ROW_BYTES + j * 32, 16, 1024)
                  : sw128_desc(a + h * (A_BYTES / 2) + j * 2048,
                               A_BYTES / 2, 1024);
          Op::template mma<A_K ? 0 : 1, B_K ? 0 : 1>(d[h], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free it
      if (kt > 0 && tid % 128 == 0)
        mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    if (tid % 128 == 0) mbar_arrive(&order[(wg + 1) % CONSUMERS]);
    wgmma_wait<0>();
    fence_regs(d[0]);
    fence_regs(d[1]);
    if (tid % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // The epilogue, one half of the tile (64 rows) at a time: the
    // accumulators, converted to f32 in registers, go to the warpgroup's
    // staging tile (accumulator layout of m64nNk16 / k32: warp w holds rows
    // 16 w + lane / 4 (+ 8), d[h][4 j + 2 e + c] is column 8 j + 2 (lane %
    // 4) + c of row 16 w + lane / 4 + 8 e), then thread c of the warpgroup
    // walks column c row by row, so that the epilogue's loads and stores
    // are coalesced; its column sum stays in a register. With kScaled the
    // walk dequantizes each value, f32(acc) * ra[m] * sb[n] in that order,
    // from its column's scale in a register and the rows' scales staged
    // beside the tile (dequantizing in the accumulator layout instead held
    // 32 column scales live beside the 128 accumulators, and spilled).
    const int c = tid % 128, row = c / 32 * 16 + lane / 4;
    float* st = stage_c + wg * 64 * CP;
    float* st_r = stage_r + wg * 64;
    const int n = n0 + c;
    float cs = 0.0f;
    if constexpr (Op::kScaled)
      if (n < N) cs = Op::col_scale(sc, n);
    float csum = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the staging tile's last readers are done
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              &st[(row + 8 * e) * CP + 8 * j + 2 * (lane % 4)]) =
              make_float2(static_cast<float>(d[h][4 * j + 2 * e]),
                          static_cast<float>(d[h][4 * j + 2 * e + 1]));
      if constexpr (Op::kScaled)
        if (c < 64 && m0 + 64 * h + c < M)
          st_r[c] = Op::row_scale(sc, m0 + 64 * h + c);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int rows = min(64, M - (m0 + 64 * h));
      if (n < N) {
        // 32 rows in flight: with one warp of the warpgroup on each
        // scheduler, only the unrolled rows' independent loads and
        // arithmetic hide each other's latency (the GELU epilogues ran
        // faster at 32 than at 4, 8, 16 or 64)
#pragma unroll 32
        for (int r = 0; r < rows; ++r) {
          float acc = st[r * CP + c];
          if constexpr (Op::kScaled) acc = acc * st_r[r] * cs;
          const float v = epi(m0 + 64 * h + r, n, acc);
          if constexpr (Epi::kColSum) csum += v;
        }
      }
    }
    if constexpr (Epi::kColSum)
      if (n < N) atomicAdd(&epi.colsum[n], csum);
  }
}

template <bool A_K, bool B_K, class Epi>
static __global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, int M, int N,
                     int K, int k_split, int tiles_n, int tiles, int total,
                     Epi epi, OpBf16::Scales sc) {
  gemm_body<OpBf16, A_K, B_K>(tma_a, tma_b, M, N, K, k_split, tiles_n, tiles,
                              total, epi, sc);
}

// Each epilogue returns the value that kColSum epilogues sum per column.
// Their inputs are read-only for the product's launch and are read through
// __ldg, so that the compiler may issue one element's loads ahead of the
// stores of the elements before it (the epilogue walks a column of rows).

// out = bf16(acc + bias[n])
struct EpiBias {
  static constexpr bool kColSum = false;
  bf16* out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = __float2bfloat16(acc + __ldg(&bias[n]));
    return 0.0f;
  }
};

// out = bf16(gelu(acc + bias[n])), exact-form GELU through the A&S erf
struct EpiBiasGelu {
  static constexpr bool kColSum = false;
  bf16* out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    float u = acc + __ldg(&bias[n]);
    out[(size_t)m * N + n] =
        __float2bfloat16(0.5f * u * (1.0f + erf_as(u * 0.7071067811865476f)));
    return 0.0f;
  }
};

// out = bf16(x + dp[sample] * (acc + bias[n])): the residual add with the
// per-sample drop-path keep multiplier; rows of one sample are consecutive.
struct EpiBiasResidual {
  static constexpr bool kColSum = false;
  bf16* out;
  const bf16* x;
  const float* bias;
  const float* dp;
  int N;
  int rows_per_sample;
  __device__ float operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float y = acc + __ldg(&bias[n]);
    out[i] = __float2bfloat16(__bfloat162float(__ldg(&x[i])) +
                              y * __ldg(&dp[m / rows_per_sample]));
    return 0.0f;
  }
};

// out = acc, f32
struct EpiStoreF32 {
  static constexpr bool kColSum = false;
  float* out;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = acc;
    return 0.0f;
  }
};

// out += acc (f32 atomics): the partial tile of one K split
struct EpiAtomicAdd {
  static constexpr bool kColSum = false;
  float* out;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    atomicAdd(&out[(size_t)m * N + n], acc);
    return 0.0f;
  }
};

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a row-major [outer, inner] matrix of Op's elements, read in
// boxes of 128 bytes of inner (swizzled) x box_outer, zero-filled past its
// edges.
template <class Op>
static inline bool tensor_map(CUtensorMap* map, const typename Op::T* p,
                              int inner, int outer, int box_outer) {
  using T = typename Op::T;
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t pitch[1] = {(cuuint64_t)inner * sizeof(T)};
  cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / sizeof(T)),
                       (cuuint32_t)box_outer};
  cuuint32_t step[2] = {1, 1};
  return enc(map, Op::kMapType, 2, const_cast<T*>(p), dims, pitch, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device (an H100's 132 if it cannot be read)
static inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      sms <= 0)
    return 132;
  return sms;
}

// The launch of a kernel of the template (gemm_bf16_kernel, gemm_s8_kernel)
// over the tiles of an M x N output, K split `splits` ways. Refuses, before
// any launch, what TMA cannot read: M, N or K < 1, a base that is not
// 16-byte aligned, a row pitch that is not a multiple of 16 bytes.
template <class Op, bool A_K, bool B_K, class Kernel, class Epi>
static inline cudaError_t gemm_launch(Kernel kernel,
                                      const typename Op::T* A,
                                      const typename Op::T* B, int M, int N,
                                      int K, Epi epi, typename Op::Scales sc,
                                      cudaStream_t s, int splits) {
  constexpr int BK = ROW_BYTES / sizeof(typename Op::T);
  constexpr int PITCH = 16 / sizeof(typename Op::T);
  const int a_in = A_K ? K : M, b_in = B_K ? K : N;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || a_in % PITCH ||
      b_in % PITCH || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(B) % 16)
    return cudaErrorInvalidValue;
  // each split covers a whole number of BK steps
  const int k_split = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (K + k_split - 1) / k_split;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * tiles_n;
  if (tiles * splits > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!tensor_map<Op>(&ta, A, a_in, A_K ? M : K, A_K ? BM : BK) ||
      !tensor_map<Op>(&tb, B, b_in, B_K ? N : K, B_K ? BN : BK))
    return cudaErrorInvalidValue;
  static unsigned configured = 0;  // a bit per device: attributes set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev >= 32 || !(configured >> dev & 1)) {
    if ((e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             SMEM_BYTES)) ||
        (e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)))
      return e;
    if (dev < 32) configured |= 1u << dev;
  }
  const int total = (int)(tiles * splits);
  kernel<<<std::min(total, sm_count()), THREADS, SMEM_BYTES, s>>>(
      ta, tb, M, N, K, k_split, tiles_n, (int)tiles, total, epi, sc);
  return cudaGetLastError();
}

template <bool A_K, bool B_K, class Epi>
static inline cudaError_t gemm_bf16(const bf16* A, const bf16* B, int M,
                                    int N, int K, Epi epi, cudaStream_t s,
                                    int splits = 1) {
  return gemm_launch<OpBf16, A_K, B_K>(gemm_bf16_kernel<A_K, B_K, Epi>, A, B,
                                       M, N, K, epi, OpBf16::Scales{}, s,
                                       splits);
}

// x W^T with torch's [out, in] weight: the forward products
template <class Epi>
static inline cudaError_t gemm_bf16_tn(const bf16* A, const bf16* W, int M,
                                       int N, int K, Epi epi,
                                       cudaStream_t s) {
  return gemm_bf16<true, true>(A, W, M, N, K, epi, s);
}

// The K splits of a weight-gradient product of `tiles` output tiles over
// `rows` rows: at least two waves of blocks on the card, the count within
// [s, 2 s) that leaves the last wave fullest, each split 8 or more K steps.
static inline int weight_grad_splits(int rows, int tiles) {
  const int wave = CONSUMERS * sm_count();  // tiles in flight
  const int lo = (2 * wave + tiles - 1) / tiles;
  int best = lo;
  double best_fill = 0.0;
  for (int sp = lo; sp < 2 * lo; ++sp) {
    const long long blocks = (long long)tiles * sp;
    const double fill =
        (double)blocks / ((blocks + wave - 1) / wave * (double)wave);
    if (fill > best_fill + 1e-9) best = sp, best_fill = fill;
  }
  return std::max(1, std::min(best, rows / (8 * BK_BF16)));
}

// dW[n, k] = sum_m dY[m, n] X[m, k] over all M rows into a zeroed f32
// [N, K] output (torch's [out, in] layout), K split by weight_grad_splits.
static inline cudaError_t gemm_bf16_weight_grad(const bf16* dY, const bf16* X,
                                                int rows, int N, int K,
                                                float* dW, cudaStream_t s) {
  const int tiles = ((N + BM - 1) / BM) * ((K + BN - 1) / BN);
  return gemm_bf16<false, false>(dY, X, N, K, rows, EpiAtomicAdd{dW, K}, s,
                                 weight_grad_splits(rows, tiles));
}

}  // namespace gemm
