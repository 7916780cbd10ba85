// Device helpers shared by the training block kernels (attn_train.cu,
// mlp_train.cu): the drop-path scaling of the incoming gradient with its
// column sums, column sums of a bf16 matrix, and the LayerNorm backward.
//
// Column sums (bias gradients, dLN) reduce over all M = B*N rows of one
// step. The TPU kernels accumulate them over their sequential batch grid;
// here blocks of rows run in parallel, each sums its rows in registers, and
// the per-block sums meet in a zeroed f32 output by atomicAdd (only the
// order of the f32 additions differs).
#pragma once

#include "common.cuh"

namespace train {

constexpr int COL_THREADS = 256;  // one column per thread
constexpr int COL_ROWS = 64;      // rows summed per block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// dyb = bf16(dy * dp[row / rows_per_sample]) and colsum[c] += sum over rows
// of the scaled value, rounded to bf16 first when round_sum (the attention
// half's dbproj sums the bf16 operand, the MLP half's db2 the f32 one).
static __global__ void __launch_bounds__(COL_THREADS)
    scale_dy_kernel(const bf16* __restrict__ dy, const float* __restrict__ dp,
                    int rows_per_sample, int M, int C,
                    bf16* __restrict__ dyb, float* __restrict__ colsum,
                    bool round_sum) {
  const int c = blockIdx.x * COL_THREADS + threadIdx.x;
  const int m0 = blockIdx.y * COL_ROWS;
  if (c >= C) return;
  float s = 0.0f;
  const int m1 = min(M, m0 + COL_ROWS);
  for (int m = m0; m < m1; ++m) {
    size_t i = (size_t)m * C + c;
    float v = __bfloat162float(dy[i]) * dp[m / rows_per_sample];
    bf16 vb = __float2bfloat16(v);
    dyb[i] = vb;
    s += round_sum ? __bfloat162float(vb) : v;
  }
  atomicAdd(&colsum[c], s);
}

static inline cudaError_t scale_dy(const bf16* dy, const float* dp,
                                   int rows_per_sample, int M, int C,
                                   bf16* dyb, float* colsum, bool round_sum,
                                   cudaStream_t s) {
  dim3 grid((C + COL_THREADS - 1) / COL_THREADS,
            (M + COL_ROWS - 1) / COL_ROWS);
  scale_dy_kernel<<<grid, COL_THREADS, 0, s>>>(dy, dp, rows_per_sample, M, C,
                                               dyb, colsum, round_sum);
  return cudaGetLastError();
}

// colsum[c] += sum over rows of x[m, c] (bf16 read, f32 sum)
static __global__ void __launch_bounds__(COL_THREADS)
    colsum_bf16_kernel(const bf16* __restrict__ x, int M, int C,
                       float* __restrict__ colsum) {
  const int c = blockIdx.x * COL_THREADS + threadIdx.x;
  const int m0 = blockIdx.y * COL_ROWS;
  if (c >= C) return;
  float s = 0.0f;
  const int m1 = min(M, m0 + COL_ROWS);
  for (int m = m0; m < m1; ++m) s += __bfloat162float(x[(size_t)m * C + c]);
  atomicAdd(&colsum[c], s);
}

static inline cudaError_t colsum_bf16(const bf16* x, int M, int C,
                                      float* colsum, cudaStream_t s) {
  dim3 grid((C + COL_THREADS - 1) / COL_THREADS,
            (M + COL_ROWS - 1) / COL_ROWS);
  colsum_bf16_kernel<<<grid, COL_THREADS, 0, s>>>(x, M, C, colsum);
  return cudaGetLastError();
}

// Sums of two values over the block, returned to every thread. sh holds one
// float2 per warp.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* sh) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction has read sh
  if (lane == 0) sh[w] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.0f, 0.0f);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    r.x += sh[i].x;
    r.y += sh[i].y;
  }
  return r;
}

constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = 32;  // rows per block

// LayerNorm backward of the residual half x -> x + dp * f(LN(x)) with f32
// statistics recomputed from x (the TPU kernels' single pass):
//   xhat = (x - mu) * rstd, dls += sum dh * xhat, dlb += sum dh,
//   dxh = dh * ls, dx = bf16(dy + rstd * (dxh - mean(dxh)
//                                         - xhat * mean(dxh * xhat)))
// where dy is the gradient arriving at the block output (the residual path)
// and dh the gradient at the LN output. The block's threads span a row
// (CPT columns each) and walk LN_ROWS rows, keeping their columns' dls/dlb
// in registers until one atomicAdd at the end.
template <int CPT>
static __global__ void __launch_bounds__(LN_THREADS)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dh,
                  const bf16* __restrict__ dy, const float* __restrict__ ls,
                  bf16* __restrict__ dx, float* __restrict__ dls,
                  float* __restrict__ dlb, int M, int C, float eps) {
  __shared__ float2 sh[LN_THREADS / 32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * LN_ROWS, m1 = min(M, m0 + LN_ROWS);
  float acc_s[CPT], acc_b[CPT], lsv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int c = tid + i * LN_THREADS;
    acc_s[i] = acc_b[i] = 0.0f;
    lsv[i] = c < C ? ls[c] : 0.0f;
  }
  const float inv_c = 1.0f / C;
  for (int m = m0; m < m1; ++m) {
    const size_t row = (size_t)m * C;
    float xv[CPT], g[CPT];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * LN_THREADS;
      xv[i] = c < C ? __bfloat162float(x[row + c]) : 0.0f;
      g[i] = c < C ? dh[row + c] : 0.0f;
      s += xv[i];
    }
    const float mu = block_sum2(s, 0.0f, sh).x * inv_c;
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * LN_THREADS;
      xv[i] = c < C ? xv[i] - mu : 0.0f;
      v += xv[i] * xv[i];
    }
    const float rstd = rsqrtf(block_sum2(v, 0.0f, sh).x * inv_c + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float xhat = xv[i] * rstd;  // 0 past C
      acc_s[i] += g[i] * xhat;
      acc_b[i] += g[i];
      float dxh = g[i] * lsv[i];
      s1 += dxh;
      s2 += dxh * xhat;
      xv[i] = xhat;
      g[i] = dxh;
    }
    const float2 mm = block_sum2(s1, s2, sh);
    const float mean1 = mm.x * inv_c, mean2 = mm.y * inv_c;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * LN_THREADS;
      if (c < C)
        dx[row + c] = __float2bfloat16(
            __bfloat162float(dy[row + c]) +
            rstd * (g[i] - mean1 - xv[i] * mean2));
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int c = tid + i * LN_THREADS;
    if (c < C) {
      atomicAdd(&dls[c], acc_s[i]);
      atomicAdd(&dlb[c], acc_b[i]);
    }
  }
}

static inline cudaError_t ln_bwd(const bf16* x, const float* dh,
                                 const bf16* dy, const float* ls, bf16* dx,
                                 float* dls, float* dlb, int M, int C,
                                 float eps, cudaStream_t s) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  if (C <= 4 * LN_THREADS)
    ln_bwd_kernel<4><<<blocks, LN_THREADS, 0, s>>>(x, dh, dy, ls, dx, dls,
                                                   dlb, M, C, eps);
  else if (C <= 8 * LN_THREADS)
    ln_bwd_kernel<8><<<blocks, LN_THREADS, 0, s>>>(x, dh, dy, ls, dx, dls,
                                                   dlb, M, C, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace train
