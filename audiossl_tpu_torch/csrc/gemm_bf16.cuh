// Tiled bf16 GEMM with f32 accumulation and a per-element epilogue, shared
// by the attention (attn_block.cu) and MLP (mlp_block.cu) block kernels.
//
//   C[m, n] = sum_k A[m, k] * W[n, k]      A [M, K] bf16 row-major,
//                                          W [N, K] bf16 (torch's Linear
//                                          [out, in] layout, as stored)
//
// then epi(m, n, C[m, n]) writes the output. Both operands are K-contiguous,
// so a W tile loads straight into a column-major WMMA B fragment.
//
// Design (first, simple version): 64x64 output tile per block of 4 warps,
// each warp a 32x32 quarter as 2x2 WMMA 16x16x16 bf16 tiles on the tensor
// cores; 32-deep K steps double-buffered in shared memory with cp.async, so
// the next tile loads while the current one multiplies. M and N edges are
// masked (zero-filled loads, guarded stores); K must be a multiple of 32.
// The accumulator tile goes through shared memory so the epilogue sees
// (m, n, value) in coalesced order. wgmma, TMA and persistent tiling are
// later work.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDS = BK + 8;  // bf16 row pitch in shared memory (80 bytes)
constexpr int LDC = BN + 4;  // f32 row pitch of the accumulator tile

template <class Epi>
static __global__ void __launch_bounds__(THREADS)
    gemm_bf16_tn_kernel(const bf16* __restrict__ A,
                        const bf16* __restrict__ W, int M, int N, int K,
                        Epi epi) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][BM][LDS];
  __shared__ __align__(128) bf16 Ws[2][BN][LDS];
  __shared__ __align__(128) float Cs[BM][LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  // row tiles on grid.x (up to 2^31 - 1 of them), column tiles on grid.y
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // one stage: BM x BK of A and BN x BK of W, 16-byte chunks (8 bf16)
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
      int c = tid + i * THREADS;
      int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      int gm = m0 + r, gn = n0 + r;
      cp_async16(&As[stage][r][kc],
                 A + (size_t)(gm < M ? gm : 0) * K + k0 + kc, gm < M);
      cp_async16(&Ws[stage][r][kc],
                 W + (size_t)(gn < N ? gn : 0) * K + k0 + kc, gn < N);
    }
    cp_async_commit();
  };

  const int nk = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[s][wm + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[s][wn + j * 16][kk], LDS);
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
    if (gm < M && gn < N) epi(gm, gn, Cs[r][c]);
  }
}

// out = bf16(acc + bias[n])
struct EpiBias {
  bf16* out;
  const float* bias;
  int N;
  __device__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * N + n] = __float2bfloat16(acc + bias[n]);
  }
};

// out = bf16(gelu(acc + bias[n])), exact-form GELU through the A&S erf
struct EpiBiasGelu {
  bf16* out;
  const float* bias;
  int N;
  __device__ void operator()(int m, int n, float acc) const {
    float u = acc + bias[n];
    out[(size_t)m * N + n] =
        __float2bfloat16(0.5f * u * (1.0f + erf_as(u * 0.7071067811865476f)));
  }
};

// out = bf16(x + dp[sample] * (acc + bias[n])): the residual add with the
// per-sample drop-path keep multiplier; rows of one sample are consecutive.
struct EpiBiasResidual {
  bf16* out;
  const bf16* x;
  const float* bias;
  const float* dp;
  int N;
  int rows_per_sample;
  __device__ void operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float y = acc + bias[n];
    out[i] = __float2bfloat16(__bfloat162float(x[i]) +
                              y * dp[m / rows_per_sample]);
  }
};

template <class Epi>
static inline cudaError_t gemm_bf16_tn(const bf16* A, const bf16* W, int M,
                                       int N, int K, Epi epi,
                                       cudaStream_t s) {
  if (K % BK) return cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_bf16_tn_kernel<Epi><<<grid, THREADS, 0, s>>>(A, W, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace gemm
