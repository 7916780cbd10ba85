// Tiled bf16 GEMM with f32 accumulation and a per-element epilogue, shared
// by the block kernels (attn_block.cu, mlp_block.cu, attn_train.cu,
// mlp_train.cu).
//
//   C[m, n] = sum_k A(m, k) * B(k, n)
//
// Each operand is stored row-major in one of two layouts, chosen at compile
// time:
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
// Design (first, simple version): 64x64 output tile per block of 4 warps,
// each warp a 32x32 quarter as 2x2 WMMA 16x16x16 bf16 tiles on the tensor
// cores; 32-deep K steps double-buffered in shared memory with cp.async, so
// the next tile loads while the current one multiplies. Loads are 16-byte
// chunks along the contiguous dimension, so that dimension's extent must be
// a multiple of 8 (K a multiple of 32 when K is contiguous); the other edges
// are masked per row (zero-filled loads, guarded stores). The weight-
// gradient products have K = M rows (48,000 at the training step) and a
// small output, so they split K over grid.z and add their partial tiles with
// f32 atomics (EpiAtomicAdd into a zeroed output). The accumulator tile goes
// through shared memory so the epilogue sees (m, n, value) in coalesced
// order; an epilogue with kColSum also adds the column sums of the values it
// returns into colsum[n] (the bias gradient of a product's output). wgmma,
// TMA and persistent tiling are later work.
#pragma once

#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDC = BN + 4;  // f32 row pitch of the accumulator tile

template <bool A_K, bool B_K, class Epi>
static __global__ void __launch_bounds__(THREADS)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     int M, int N, int K, int k_split, Epi epi) {
  using namespace nvcuda;
  // tile pitches: 8 bf16 (16 bytes) of padding per row
  constexpr int AR = A_K ? BM : BK, AC = A_K ? BK + 8 : BM + 8;
  constexpr int BR = B_K ? BN : BK, BC = B_K ? BK + 8 : BN + 8;
  __shared__ __align__(128) bf16 As[2][AR][AC];
  __shared__ __align__(128) bf16 Bs[2][BR][BC];
  __shared__ __align__(128) float Cs[BM][LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  // row tiles on grid.x (up to 2^31 - 1 of them), column tiles on grid.y,
  // K splits on grid.z
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * k_split;
  const int k_hi = min(K, k_lo + k_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // one stage: 256 chunks of 16 bytes for each operand, 2 per thread
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      if constexpr (A_K) {  // rows m, chunks along k
        int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        int gm = m0 + r, gk = k0 + kc;
        bool ok = gm < M && gk < k_hi;
        cp_async16(&As[stage][r][kc], ok ? A + (size_t)gm * K + gk : A, ok);
      } else {  // rows k, chunks along m
        int r = c / (BM / 8), mc = (c % (BM / 8)) * 8;
        int gk = k0 + r, gm = m0 + mc;
        bool ok = gm < M && gk < k_hi;
        cp_async16(&As[stage][r][mc], ok ? A + (size_t)gk * M + gm : A, ok);
      }
      if constexpr (B_K) {  // rows n, chunks along k
        int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        int gn = n0 + r, gk = k0 + kc;
        bool ok = gn < N && gk < k_hi;
        cp_async16(&Bs[stage][r][kc], ok ? B + (size_t)gn * K + gk : B, ok);
      } else {  // rows k, chunks along n
        int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        int gk = k0 + r, gn = n0 + nc;
        bool ok = gn < N && gk < k_hi;
        cp_async16(&Bs[stage][r][nc], ok ? B + (size_t)gk * N + gn : B, ok);
      }
    }
    cp_async_commit();
  };

  const int nk = (k_hi - k_lo + BK - 1) / BK;
  if (nk > 0) load(0, k_lo);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, k_lo + (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      using ALay = typename std::conditional<A_K, wmma::row_major,
                                             wmma::col_major>::type;
      using BLay = typename std::conditional<B_K, wmma::col_major,
                                             wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALay> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (A_K)
          wmma::load_matrix_sync(a[i], &As[s][wm + i * 16][kk], AC);
        else
          wmma::load_matrix_sync(a[i], &As[s][kk][wm + i * 16], AC);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (B_K)
          wmma::load_matrix_sync(b[j], &Bs[s][wn + j * 16][kk], BC);
        else
          wmma::load_matrix_sync(b[j], &Bs[s][kk][wn + j * 16], BC);
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
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    int r = e / BN, c = e % BN;
    int gm = m0 + r, gn = n0 + c;
    bool in = gm < M && gn < N;
    float v = in ? epi(gm, gn, Cs[r][c]) : 0.0f;
    if constexpr (Epi::kColSum) Cs[r][c] = v;
  }
  if constexpr (Epi::kColSum) {
    __syncthreads();
    if (tid < BN && n0 + tid < N) {
      float s = 0.0f;
      for (int r = 0; r < BM; ++r) s += Cs[r][tid];
      atomicAdd(&epi.colsum[n0 + tid], s);
    }
  }
}

// Each epilogue returns the value that kColSum epilogues sum per column.

// out = bf16(acc + bias[n])
struct EpiBias {
  static constexpr bool kColSum = false;
  bf16* out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = __float2bfloat16(acc + bias[n]);
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
    float u = acc + bias[n];
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
    float y = acc + bias[n];
    out[i] = __float2bfloat16(__bfloat162float(x[i]) +
                              y * dp[m / rows_per_sample]);
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

template <bool A_K, bool B_K, class Epi>
static inline cudaError_t gemm_bf16(const bf16* A, const bf16* B, int M,
                                    int N, int K, Epi epi, cudaStream_t s,
                                    int splits = 1) {
  if ((A_K && K % BK) || (!A_K && M % 8) || (B_K && K % BK) ||
      (!B_K && N % 8) || M <= 0 || N <= 0 || K <= 0 || splits < 1 ||
      (N + BN - 1) / BN > 65535 || splits > 65535)
    return cudaErrorInvalidValue;
  // each split covers a whole number of BK steps
  int k_split = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (K + k_split - 1) / k_split;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  gemm_bf16_kernel<A_K, B_K, Epi><<<grid, THREADS, 0, s>>>(A, B, M, N, K,
                                                           k_split, epi);
  return cudaGetLastError();
}

// x W^T with torch's [out, in] weight: the forward products
template <class Epi>
static inline cudaError_t gemm_bf16_tn(const bf16* A, const bf16* W, int M,
                                       int N, int K, Epi epi,
                                       cudaStream_t s) {
  return gemm_bf16<true, true>(A, W, M, N, K, epi, s);
}

// dW[n, k] = sum_m dY[m, n] X[m, k] over all M rows into a zeroed f32
// [N, K] output (torch's [out, in] layout), K split so that the grid holds
// about four blocks per SM.
static inline cudaError_t gemm_bf16_weight_grad(const bf16* dY, const bf16* X,
                                                int rows, int N, int K,
                                                float* dW, cudaStream_t s) {
  int tiles = ((N + BM - 1) / BM) * ((K + BN - 1) / BN);
  int splits = std::max(1, std::min((4 * 132 + tiles - 1) / tiles,
                                    rows / (8 * BK)));
  return gemm_bf16<false, false>(dY, X, N, K, rows,
                                 EpiAtomicAdd{dW, K}, s, splits);
}

}  // namespace gemm
