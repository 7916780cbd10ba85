// Tiled int8 GEMM with an exact int32 accumulator and per-row x per-column
// dequantization, shared by the int8 block kernels (K2q attn_block.cu, K3q
// mlp_block.cu, K4q attn_train.cu, K5q mlp_train.cu).
//
//   acc[m, n] = sum_k A[m, k] * B(k, n)          (int8 x int8 -> int32)
//   epi(m, n, float(acc) * ra[m] * sb[n])
//
// the TPU kernels' _q8_dot (audiossl_tpu/ops/pallas_block.py:96): A holds
// the int8 codes of an activation with one scale per row (ra), B those of a
// weight with one scale per output channel (sb), and the epilogues of
// gemm_bf16.cuh (EpiBias, EpiBiasResidual, EpiStoreF32, ...) take the
// dequantized value as they take the bf16 product's f32 sum. A is always
// stored with K contiguous (A[m * K + k]); the weight in one of two layouts:
//   B_K = true   B(k, n) at B[n * K + k]   (torch's [out, in] weight: the
//                                           forward products x W^T)
//   B_K = false  B(k, n) at B[k * N + n]   (the same layout read as W: the
//                                           grad-to-input products dy W of
//                                           the int8dx backward)
//
// Design (first, simple version; gemm_bf16.cuh's before wgmma): a 64x64
// output tile per block of 4 warps, each warp a 32x32 quarter as 2x2 WMMA
// 16x16x16 int8 tiles (int32 accumulators) on the tensor cores; 64-deep K
// steps (64 bytes) double-buffered in shared memory with cp.async. The
// tiles are stored as slabs 16 bytes wide along their contiguous dimension,
// [slab][row][16], so that every WMMA fragment starts 256-bit aligned with
// a row pitch of 16 bytes, and the 16-byte chunks that consecutive threads
// copy land on consecutive rows of one slab. Loads are 16 int8 at a time,
// so K (and N where it is contiguous) must be a multiple of 16; ragged
// edges are zero-filled, and a zero code adds nothing to the sum. wgmma and
// TMA (the int8 tensor-core rate, twice bf16's) are later work.
#pragma once

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "gemm_bf16.cuh"

namespace gemm {

// the tile of the int8 kernel (its own: gemm_bf16.cuh's tile is wgmma's)
constexpr int S8_BM = 64, S8_BN = 64, S8_THREADS = 128;
constexpr int S8_LDC = S8_BN + 4;  // int32 row pitch of the accumulators
constexpr int S8_BK = 64;  // int8 codes per K step

template <bool B_K, class Epi>
static __global__ void __launch_bounds__(S8_THREADS)
    gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   const float* __restrict__ ra, const float* __restrict__ sb,
                   int M, int N, int K, Epi epi) {
  using namespace nvcuda;
  constexpr int SL = S8_BK / 16;  // slabs of a K step
  // B_K: [slab of k][n][16]; otherwise [slab of n][k][16]
  constexpr int BS0 = B_K ? SL : S8_BN / 16, BS1 = B_K ? S8_BN : S8_BK;
  __shared__ __align__(128) int8_t As[2][SL][S8_BM][16];
  __shared__ __align__(128) int8_t Bs[2][BS0][BS1][16];
  __shared__ __align__(128) int Cs[S8_BM][S8_LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * S8_BM, n0 = blockIdx.y * S8_BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  // one stage: 256 chunks of 16 bytes for each operand, 2 per thread
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * S8_THREADS;
      {  // A: slab c / S8_BM, row c % S8_BM
        int sl = c / S8_BM, r = c % S8_BM, gm = m0 + r, gk = k0 + sl * 16;
        bool ok = gm < M && gk < K;
        cp_async16(&As[stage][sl][r][0], ok ? A + (size_t)gm * K + gk : A, ok);
      }
      if constexpr (B_K) {  // slab c / S8_BN of k, row n = c % S8_BN
        int sl = c / S8_BN, r = c % S8_BN, gn = n0 + r, gk = k0 + sl * 16;
        bool ok = gn < N && gk < K;
        cp_async16(&Bs[stage][sl][r][0], ok ? B + (size_t)gn * K + gk : B, ok);
      } else {  // slab c / S8_BK of n, row k = c % S8_BK
        int sl = c / S8_BK, r = c % S8_BK, gk = k0 + r, gn = n0 + sl * 16;
        bool ok = gn < N && gk < K;
        cp_async16(&Bs[stage][sl][r][0], ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
    cp_async_commit();
  };

  const int nk = (K + S8_BK - 1) / S8_BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * S8_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < SL; ++kk) {
      using BLay = typename std::conditional<B_K, wmma::col_major,
                                             wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, BLay> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[s][kk][wm + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (B_K)
          wmma::load_matrix_sync(b[j], &Bs[s][kk][wn + j * 16][0], 16);
        else
          wmma::load_matrix_sync(b[j], &Bs[s][(wn >> 4) + j][kk * 16][0], 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j],
                              S8_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < S8_BM * S8_BN; e += S8_THREADS) {
    int r = e / S8_BN, c = e % S8_BN;
    int gm = m0 + r, gn = n0 + c;
    bool in = gm < M && gn < N;
    // the dequantization of _q8_dot: f32(acc) * r[m], then * s[n]
    float v = in ? epi(gm, gn, static_cast<float>(Cs[r][c]) * ra[gm] * sb[gn])
                 : 0.0f;
    if constexpr (Epi::kColSum) Cs[r][c] = __float_as_int(v);
  }
  if constexpr (Epi::kColSum) {
    __syncthreads();
    if (tid < S8_BN && n0 + tid < N) {
      float s = 0.0f;
      for (int r = 0; r < S8_BM; ++r) s += __int_as_float(Cs[r][tid]);
      atomicAdd(&epi.colsum[n0 + tid], s);
    }
  }
}

template <bool B_K, class Epi>
static inline cudaError_t gemm_s8(const void* A, const void* B,
                                  const float* ra, const float* sb, int M,
                                  int N, int K, Epi epi, cudaStream_t s) {
  if (K % 16 || (!B_K && N % 16) || M <= 0 || N <= 0 || K <= 0 ||
      (N + S8_BN - 1) / S8_BN > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((M + S8_BM - 1) / S8_BM, (N + S8_BN - 1) / S8_BN);
  gemm_s8_kernel<B_K, Epi><<<grid, S8_THREADS, 0, s>>>(
      static_cast<const int8_t*>(A), static_cast<const int8_t*>(B), ra, sb, M,
      N, K, epi);
  return cudaGetLastError();
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
