// Tiled int8 GEMM with an exact int32 accumulator and per-row x per-column
// dequantization, shared by the int8 block kernels (K2q attn_block.cu, K3q
// mlp_block.cu, K4q attn_train.cu, K5q mlp_train.cu).
//
//   acc[m, n] = sum_k A[m, k] * B[n, k]          (int8 x int8 -> int32)
//   epi(m, n, float(acc) * ra[m] * sb[n])
//
// the TPU kernels' _q8_dot (audiossl_tpu/ops/pallas_block.py:96): A holds
// the int8 codes of an activation with one scale per row (ra), B those of a
// weight with one scale per column of the output (sb), and the epilogues of
// gemm_bf16.cuh (EpiBias, EpiBiasResidual, EpiStoreF32, ...) take the
// dequantized value as they take the bf16 product's f32 sum. Both operands
// are stored K-major (K contiguous): A [M, K], B [N, K], torch's [out, in]
// weight for the forward products x W^T; the grad-to-input products dy W of
// the int8dx backward take the codes of W^T, [in, out], from their caller.
// The int32 sum is exact in any order while K * 127^2 < 2^31 (the block
// kernels' K is at most 3,072), so the value each epilogue takes equals the
// TPU kernels' bit for bit.
//
// What bounds it on the H100: K5q's products (M = 48,000 rows, C = 768,
// hidden 3072) do ~600 int8 operations per byte of their codes and ~150 per
// byte of an f32 output, so the tensor-core rate (1,979 TOP/s dense) bounds
// the products and the epilogue's stores come close to the memory bound.
//
// Design: the body of gemm_bf16.cuh (gemm_body) with the operand trait
// OpS8: wgmma.mma_async m64n128k32 .s32.s8.s8, both operands K-major from
// 128-byte-swizzled shared memory (int8 wgmma reads no MN-major operand). A
// stage has the bf16 template's byte geometry -- 128 codes of K (one
// 128-byte swizzle row) x 128 rows of each operand, loaded by TMA as uint8
// boxes -- so its descriptors and 32-byte slice advance (k32 of int8 is k16
// of bf16) are the same, and a stage holds twice the MACs. TMA zero-fills
// past the tensor and a zero code adds nothing, so ragged M, N and K need
// no masks. The epilogue converts the s32 accumulators to f32 in registers
// and stages them as the bf16 products' sums are; the thread that walks a
// column dequantizes each value, f32(acc) * ra[m] * sb[n] in that order,
// before its functor takes it.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "gemm_bf16.cuh"

namespace gemm {

// d += A B for one m64n128k32 int8 step, both operands K-major
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The operand trait of the int8 products: int8 codes in (TMA moves their
// bits as uint8), s32 accumulators, K-major operands only, each
// accumulator dequantized as f32(acc) * ra[m] * sb[n] (gemm_body reads the
// scales of rows and columns within M and N only).
struct OpS8 {
  using T = int8_t;
  using Acc = int;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr bool kScaled = true;
  struct Scales {
    const float* ra;  // [M]
    const float* sb;  // [N]
  };
  template <int TA, int TB>
  __device__ static void mma(int (&d)[64], uint64_t da, uint64_t db) {
    static_assert(TA == 0 && TB == 0, "int8 wgmma reads K-major operands");
    wgmma_m64n128k32_s8(d, da, db);
  }
  __device__ static float row_scale(const Scales& sc, int m) {
    return __ldg(&sc.ra[m]);
  }
  __device__ static float col_scale(const Scales& sc, int n) {
    return __ldg(&sc.sb[n]);
  }
};

template <class Epi>
static __global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, int M, int N,
                   int K, int k_split, int tiles_n, int tiles, int total,
                   Epi epi, OpS8::Scales sc) {
  gemm_body<OpS8, true, true>(tma_a, tma_b, M, N, K, k_split, tiles_n, tiles,
                              total, epi, sc);
}

// A [M, K] and B [N, K] int8 codes, ra [M] and sb [N] f32 scales. Refuses,
// before any launch, M, N or K < 1, K not a multiple of 16 (the TMA row
// pitch is 16 bytes) and a code base that is not 16-byte aligned.
template <class Epi>
static inline cudaError_t gemm_s8(const void* A, const void* B,
                                  const float* ra, const float* sb, int M,
                                  int N, int K, Epi epi, cudaStream_t s) {
  return gemm_launch<OpS8, true, true>(
      gemm_s8_kernel<Epi>, static_cast<const int8_t*>(A),
      static_cast<const int8_t*>(B), M, N, K, epi, OpS8::Scales{ra, sb}, s,
      1);
}

// out = acc + bias[n], f32 (the fc1 pre-activation the GELU quantization
// reduces over)
struct EpiBiasF32 {
  static constexpr bool kColSum = false;
  float* out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = acc + bias[n];
    return 0.0f;
  }
};

}  // namespace gemm
