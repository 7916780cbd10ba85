// Device helpers shared by the block kernels (attn_block.cu, mlp_block.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// 16-byte global -> shared copy that bypasses registers (sm_80+). With
// pred false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element types of the kernels templated on their storage type (bf16 or
// f32): 16-byte chunks of PER16 elements, conversion to and from f32 (f32
// sums, rounding to the element type where the TPU kernels round), and pair
// loads and stores.
template <typename T>
struct elem;

template <>
struct elem<bf16> {
  static constexpr int PER16 = 8;
  static __device__ __forceinline__ float to_f(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ float2 ld2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct elem<float> {
  static constexpr int PER16 = 4;
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// v rounded to T and back (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return elem<T>::to_f(elem<T>::from_f(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1.0f / x, bit-equal to the IEEE division for every x in [1, 2^126] and
// for +inf (checked over every such float on the card: gemm.cu
// rcp_check_launch), without the division's slow-path call: that call
// keeps the compiler from issuing one element's loads ahead of the last
// element's arithmetic in the GEMM epilogues, whose GELU products then
// wait on every load in turn. The approximate reciprocal and two Newton
// steps on FMAs.
__device__ __forceinline__ float rcp_ge1(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  r = __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
  r = __fmaf_rn(r, __fmaf_rn(-x, r, 1.0f), r);
  return isinf(x) ? 0.0f : r;
}

// erf by Abramowitz & Stegun 7.1.26, the polynomial the TPU kernel and the
// JAX module path use (|err| < 1.5e-7), with an exact reciprocal (the
// argument 1 + 0.3275911 |x| of a finite f32 x is at most 7.9e37 < 2^126).
__device__ __forceinline__ float erf_as(float x) {
  float a = fabsf(x);
  float t = rcp_ge1(1.0f + 0.3275911f * a);
  float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
               t * (-1.453152027f + t * 1.061405429f))));
  float r = 1.0f - poly * expf(-a * a);
  return x < 0.0f ? -r : (x > 0.0f ? r : 0.0f);
}

// Row LayerNorm of a bf16 [M, C] matrix: f32 mean and variance (two passes
// over the row, as the TPU kernel's _ln), output rounded to bf16 -- the
// operand the following product reads. One warp per row.
static __global__ void layer_norm_bf16_kernel(const bf16* __restrict__ x,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b,
                                              bf16* __restrict__ out, int M,
                                              int C, float eps) {
  int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  float mu = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  float rstd = rsqrtf(warp_sum(v) / C + eps);
  bf16* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = __float2bfloat16((__bfloat162float(xr[c]) - mu) * rstd * w[c] +
                               b[c]);
}

static inline cudaError_t layer_norm_bf16(const bf16* x, const float* w,
                                          const float* b, bf16* out, int M,
                                          int C, float eps, cudaStream_t s) {
  const int rows_per_block = 8;  // 8 warps of 256 threads
  layer_norm_bf16_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                           s>>>(x, w, b, out, M, C, eps);
  return cudaGetLastError();
}
