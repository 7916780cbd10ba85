// Per-row symmetric int8 quantization of activations, shared by the int8
// block kernels (K2q attn_block.cu, K3q mlp_block.cu, K4q attn_train.cu, K5q
// mlp_train.cu): the TPU kernels' _q8_act (audiossl_tpu/ops/pallas_block.py
// :79), which the Pallas kernels run inside their launch on a block held in
// VMEM. Per row of f32 values v:
//   m = max(|v|) (or a precomputed bound), m = max(m, 1e-30)
//   r = m * (1/127)  (the row's scale),  q = clamp(rint(v * (127/m)), +-127)
// rounding half to even, as jnp.round does. One warp per row, which it
// walks once per pass (two passes, four for the LayerNorm one; L1/L2 serve
// the repeats) and writes its codes once: these kernels are bound by
// bytes.
//
//  ln_q8:     the f32 output of a row LayerNorm of bf16 x (K2q-K5q quantize
//             the unrounded LN output, never a bf16 copy)
//  rows_q8:   T rows (f32 or bf16), optionally times a per-sample multiplier
//             (the int8dx backward's dy * dp)
//  gelu_q8:   GELU of f32 pre-activation rows u, quantized with the bound
//             max(gelu(max_j u[j]), 0.17) in place of the absmax: GELU is
//             monotone above its minimum of about -0.17, so the signed row
//             max of u bounds |gelu(u)| (pallas_block.py:231-237)
#pragma once

#include <cstdint>

#include "common.cuh"

namespace q8 {

constexpr int THREADS = 256;  // 8 rows (warps) per block
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t code(float v, float rinv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v * rinv), -127.0f), 127.0f));
}

static inline unsigned row_blocks(int M) {
  return (unsigned)((M + THREADS / 32 - 1) / (THREADS / 32));
}

// The erf-form GELU of K3 and K3q: 0.5 u (1 + erf(u / sqrt 2))
struct GeluErf {
  __device__ float operator()(float u) const {
    return 0.5f * u * (1.0f + erf_as(u * kInvSqrt2));
  }
};

static __global__ void __launch_bounds__(THREADS)
    ln_q8_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, int8_t* __restrict__ q,
                 float* __restrict__ r, int M, int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  float amax = 0.0f;
  for (int c = lane; c < C; c += 32)
    amax = fmaxf(amax, fabsf((__bfloat162float(xr[c]) - mu) * rstd * w[c] +
                             b[c]));
  const float m = fmaxf(warp_max(amax), 1e-30f);
  const float rinv = 127.0f / m;
  int8_t* qr = q + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    qr[c] = code((__bfloat162float(xr[c]) - mu) * rstd * w[c] + b[c], rinv);
  if (lane == 0) r[row] = m * (1.0f / 127.0f);
}

static inline cudaError_t ln_q8(const bf16* x, const float* w, const float* b,
                                void* q, float* r, int M, int C, float eps,
                                cudaStream_t s) {
  ln_q8_kernel<<<row_blocks(M), THREADS, 0, s>>>(
      x, w, b, static_cast<int8_t*>(q), r, M, C, eps);
  return cudaGetLastError();
}

template <typename T>
static __global__ void __launch_bounds__(THREADS)
    rows_q8_kernel(const T* __restrict__ x, const float* __restrict__ dp,
                   int rows_per_sample, int M, int K, int8_t* __restrict__ q,
                   float* __restrict__ r) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  const float mul = dp != nullptr ? dp[row / rows_per_sample] : 1.0f;
  float amax = 0.0f;
  for (int c = lane; c < K; c += 32)
    amax = fmaxf(amax, fabsf(elem<T>::to_f(xr[c]) * mul));
  const float m = fmaxf(warp_max(amax), 1e-30f);
  const float rinv = 127.0f / m;
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane; c < K; c += 32)
    qr[c] = code(elem<T>::to_f(xr[c]) * mul, rinv);
  if (lane == 0) r[row] = m * (1.0f / 127.0f);
}

// codes of x [M, K] (times dp[row / rows_per_sample] where dp is given)
template <typename T>
static inline cudaError_t rows_q8(const T* x, const float* dp,
                                  int rows_per_sample, int M, int K, void* q,
                                  float* r, cudaStream_t s) {
  rows_q8_kernel<T><<<row_blocks(M), THREADS, 0, s>>>(
      x, dp, rows_per_sample, M, K, static_cast<int8_t*>(q), r);
  return cudaGetLastError();
}

template <class Gelu>
static __global__ void __launch_bounds__(THREADS)
    gelu_q8_kernel(const float* __restrict__ u, int M, int K,
                   int8_t* __restrict__ q, float* __restrict__ r, Gelu gelu) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* ur = u + (size_t)row * K;
  float umax = -3.402823466e38f;
  for (int c = lane; c < K; c += 32) umax = fmaxf(umax, ur[c]);
  umax = warp_max(umax);
  const float gmax = 0.5f * umax * (1.0f + erf_as(umax * kInvSqrt2));
  const float m = fmaxf(fmaxf(gmax, 0.17f), 1e-30f);
  const float rinv = 127.0f / m;
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane; c < K; c += 32) qr[c] = code(gelu(ur[c]), rinv);
  if (lane == 0) r[row] = m * (1.0f / 127.0f);
}

template <class Gelu>
static inline cudaError_t gelu_q8(const float* u, int M, int K, void* q,
                                  float* r, Gelu gelu, cudaStream_t s) {
  gelu_q8_kernel<Gelu><<<row_blocks(M), THREADS, 0, s>>>(
      u, M, K, static_cast<int8_t*>(q), r, gelu);
  return cudaGetLastError();
}

}  // namespace q8
