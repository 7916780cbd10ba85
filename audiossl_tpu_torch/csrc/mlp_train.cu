// Kernel K5: the trainable MLP residual half of a pre-LN transformer block,
// y = x + dp * fc2(gelu(fc1(LN2(x)))), forward and backward, for the student
// encoder of the pretraining step.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_mlp.py:255
// fused_mlp_block (forward _fwd :277 / _fwd_kernel :98, call :313; backward
// _bwd :350 / _bwd_impl :147, call :376), a custom_vjp whose kernels keep
// fc1/fc2 resident in VMEM, save the fc1 pre-activation u, rebuild GELU and
// its derivative in the backward from one shared exp(-u^2/2), and
// accumulate dW1/dW2/db/dLN in VMEM across a sequential batch grid.
//
// What bounds it on the H100: at the training step (M = 48,000 rows,
// C = 768, hidden 3072) the forward is 453 GFLOP and the backward 906 GFLOP
// of bf16 products against a 295 MB bf16 u -- bound by the tensor-core
// rate. The weights (9.4 MB bf16) cannot stay resident in a 227 KB SM, and
// the sequential-grid accumulation becomes one product over all M rows.
//
// Design (first, simple version), every launch on the caller's stream:
// forward, as K3 (mlp_block.cu) plus the saved pre-activation:
//  (a) h = bf16(LN2(x))                                        (common.cuh)
//  (b) u = h W1^T + b1 (f32); saves bf16(u) and a = bf16(gelu(u)) with the
//      A&S erf from exp(-u^2/2) and an exact reciprocal      (gemm_bf16.cuh)
//  (c) y = bf16(x + dp * (a W2^T + b2))
// backward, with the rounding points of _bwd_impl:
//  (1) dyb = bf16(dy * dp), db2 = sum of the f32 dy * dp  (train_common.cuh)
//  (2) a = bf16(u * Phi(u)) rebuilt from the saved bf16 u
//  (3) dW2 = dyb^T a (split-K, f32 atomics)
//  (4) da = dyb W2; du = da * gelu'(u), gelu'(u) = Phi(u) + u phi(u) from the
//      same exp(-u^2/2); stores bf16(du), db1 = sum of the f32 du (epilogue)
//  (5) h recomputed as in (a); dW1 = du^T h; dh = du W1 (f32)
//  (6) LN2 backward from recomputed f32 statistics: dx, dls, dlb
// The products run on wgmma with TMA loads (gemm_bf16.cuh); keeping du on
// chip (the TPU kernel never writes it to memory) is later work.
//
// Kernel K5q, the int8 variants (student_quant, pallas_mlp.py:255 with
// quant), weights as int8 codes quantized by the caller once per call.
// mlp_train_fwd_q8_launch follows _fwd_kernel_q8 (:120, via :313): fc1 from
// the codes of the f32 LN2 output; u = deq(.) + b1 kept in f32 and saved in
// bf16; a = gelu(u) in f32 quantized per row with the bound
// max(gelu(max_j u), 0.17) (quant_q8.cuh gelu_q8); fc2 from those codes.
// mlp_train_bwd_q8dx_launch follows _bwd_kernel_q8dx (:225, via :376): (1)-(6)
// above with da and dh in int8 against the codes of the dequantized weights
// quantized again per input channel, passed as the codes of W^T ([in, out],
// K-major for int8 wgmma): da from the codes of the f32 dy * dp, dh from
// those of the unrounded f32 du (so du is stored in f32 as well as in bf16
// for dW1). The weight-gradient products
// stay bf16.
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"
#include "quant_q8.cuh"
#include "train_common.cuh"

namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Phi(u) = 0.5 (1 + erf(u / sqrt 2)) and exp(-u^2/2) for GELU and its
// derivative: A&S 7.1.26 given the shared exponential, exact reciprocal
// (pallas_mlp.py _erf_from_exp; common.cuh rcp_ge1).
__device__ __forceinline__ float half_cdf(float u, float ex2) {
  float x = u * kInvSqrt2;
  float a = fabsf(x);
  float t = rcp_ge1(1.0f + 0.3275911f * a);
  float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
               t * (-1.453152027f + t * 1.061405429f))));
  float erf = 1.0f - poly * ex2;
  erf = x < 0.0f ? -erf : (x > 0.0f ? erf : 0.0f);
  return 0.5f * (1.0f + erf);
}

// (b): u = acc + b1; saves bf16(u) and bf16(gelu(u))
struct EpiBiasGeluSave {
  static constexpr bool kColSum = false;
  bf16* u_out;
  bf16* a_out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float u = acc + __ldg(&bias[n]);
    u_out[i] = __float2bfloat16(u);
    a_out[i] = __float2bfloat16(u * half_cdf(u, expf(-u * u * 0.5f)));
    return 0.0f;
  }
};

// (4): du = da * gelu'(u) from the saved bf16 u; stores bf16(du) and sums
// the f32 du per column into db1
struct EpiGeluGrad {
  static constexpr bool kColSum = true;
  float* colsum;
  const bf16* u;
  bf16* du_out;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float uf = __bfloat162float(__ldg(&u[i]));
    float ex2 = expf(-uf * uf * 0.5f);
    float du = acc * (half_cdf(uf, ex2) + uf * kInvSqrt2Pi * ex2);
    du_out[i] = __float2bfloat16(du);
    return du;
  }
};

// (2): a = bf16(u * Phi(u)) elementwise, 8 values (16 bytes) a thread at a
// time; u and a are 16-byte aligned
__device__ __forceinline__ bf16 gelu_bf16(bf16 u) {
  float uf = __bfloat162float(u);
  return __float2bfloat16(uf * half_cdf(uf, expf(-uf * uf * 0.5f)));
}

__global__ void gelu_from_u_kernel(const bf16* __restrict__ u,
                                   bf16* __restrict__ a, size_t n) {
  const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = tid; i < n / 8; i += stride) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(u) + i);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = gelu_bf16(e[j]);
    reinterpret_cast<uint4*>(a)[i] = v;
  }
  for (size_t i = n / 8 * 8 + tid; i < n; i += stride) a[i] = gelu_bf16(u[i]);
}

// K5q (b): u = acc + b1 in f32 and saved in bf16
struct EpiBiasSaveF32 {
  static constexpr bool kColSum = false;
  float* uf_out;
  bf16* u_out;
  const float* bias;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float u = acc + bias[n];
    uf_out[i] = u;
    u_out[i] = __float2bfloat16(u);
    return 0.0f;
  }
};

// K5q's GELU, as (b) of K5: u Phi(u) from exp(-u^2/2)
struct GeluFromExp {
  __device__ float operator()(float u) const {
    return u * half_cdf(u, expf(-u * u * 0.5f));
  }
};

// K5q backward (4): EpiGeluGrad that also keeps the f32 du, whose codes
// feed dh
struct EpiGeluGradF32 {
  static constexpr bool kColSum = true;
  float* colsum;
  const bf16* u;
  bf16* du_out;
  float* duf_out;
  int N;
  __device__ float operator()(int m, int n, float acc) const {
    size_t i = (size_t)m * N + n;
    float du = EpiGeluGrad{colsum, u, du_out, N}(m, n, acc);
    duf_out[i] = du;
    return du;
  }
};

}  // namespace

extern "C" int mlp_train_fwd_launch(int device, const void* x,
                                    const float* dp, const float* ln_w,
                                    const float* ln_b, const void* w1,
                                    const float* b1, const void* w2,
                                    const float* b2, void* out, void* h,
                                    void* u, void* a, int B, int N, int C,
                                    int Hd, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(h);
  bf16* ab = static_cast<bf16*>(a);
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_tn(
           hb, static_cast<const bf16*>(w1), M, Hd, C,
           EpiBiasGeluSave{static_cast<bf16*>(u), ab, b1, Hd}, s)))
    return e;
  return gemm::gemm_bf16_tn(
      ab, static_cast<const bf16*>(w2), M, C, Hd,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b2, dp, C, N}, s);
}

// Gradients dw1 [Hd, C], db1 [Hd], dw2 [C, Hd], db2, dls, dlb [C] are f32
// and overwritten. Scratch: h, dyb [M, C] bf16; a, du [M, Hd] bf16; dh
// [M, C] f32.
extern "C" int mlp_train_bwd_launch(
    int device, const void* x, const void* dy, const void* u, const float* dp,
    const float* ln_w, const float* ln_b, const void* w1, const void* w2,
    void* dx, float* dw1, float* db1, float* dw2, float* db2, float* dls,
    float* dlb, void* h, void* dyb, void* a, void* du, float* dh, int B,
    int N, int C, int Hd, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ub = static_cast<const bf16*>(u);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dybb = static_cast<bf16*>(dyb);
  bf16* ab = static_cast<bf16*>(a);
  bf16* dub = static_cast<bf16*>(du);
  const size_t c4 = sizeof(float) * C;
  if ((e = cudaMemsetAsync(dw1, 0, Hd * c4, s)) ||
      (e = cudaMemsetAsync(db1, 0, sizeof(float) * Hd, s)) ||
      (e = cudaMemsetAsync(dw2, 0, Hd * c4, s)) ||
      (e = cudaMemsetAsync(db2, 0, c4, s)) ||
      (e = cudaMemsetAsync(dls, 0, c4, s)) ||
      (e = cudaMemsetAsync(dlb, 0, c4, s)))
    return e;
  // (1), (2), (3)
  if ((e = train::scale_dy(static_cast<const bf16*>(dy), dp, N, M, C, dybb,
                           db2, false, s)))
    return e;
  const size_t nu = (size_t)M * Hd;
  gelu_from_u_kernel<<<(unsigned)std::min<size_t>((nu + 255) / 256, 65535),
                       256, 0, s>>>(ub, ab, nu);
  if ((e = cudaGetLastError())) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dybb, ab, M, C, Hd, dw2, s))) return e;
  // (4)
  if ((e = gemm::gemm_bf16<true, false>(
           dybb, static_cast<const bf16*>(w2), M, Hd, C,
           EpiGeluGrad{db1, ub, dub, Hd}, s)))
    return e;
  // (5)
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dub, hb, M, Hd, C, dw1, s))) return e;
  if ((e = gemm::gemm_bf16<true, false>(dub, static_cast<const bf16*>(w1), M,
                                        C, Hd, gemm::EpiStoreF32{dh, C}, s)))
    return e;
  // (6)
  return train::ln_bwd(xb, dh, static_cast<const bf16*>(dy), ln_w,
                       static_cast<bf16*>(dx), dls, dlb, M, C, eps, s);
}

extern "C" int mlp_train_fwd_q8_launch(
    int device, const void* x, const float* dp, const float* ln_w,
    const float* ln_b, const void* w1q, const float* s1, const float* b1,
    const void* w2q, const float* s2, const float* b2, void* out, void* hq,
    float* hr, void* u, float* uf, void* aq, float* ar, int B, int N, int C,
    int Hd, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  if ((e = q8::ln_q8(xb, ln_w, ln_b, hq, hr, M, C, eps, s))) return e;
  if ((e = gemm::gemm_s8(hq, w1q, hr, s1, M, Hd, C,
                         EpiBiasSaveF32{uf, static_cast<bf16*>(u), b1, Hd},
                         s)))
    return e;
  if ((e = q8::gelu_q8(uf, M, Hd, aq, ar, GeluFromExp{}, s))) return e;
  return gemm::gemm_s8(
      aq, w2q, ar, s2, M, C, Hd,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b2, dp, C, N}, s);
}

// As mlp_train_bwd_launch; wt1 [C, Hd] / wt2 [Hd, C] int8 codes of W1^T /
// W2^T ([in, out]: the product's K contiguous) with per-input-channel
// scales st1 [C] / st2 [Hd]. Extra scratch: duf [M, Hd] f32; aq int8
// [M, Hd] and ar f32 [M], the codes and row scales of dy * dp, then of du.
extern "C" int mlp_train_bwd_q8dx_launch(
    int device, const void* x, const void* dy, const void* u, const float* dp,
    const float* ln_w, const float* ln_b, const void* wt1, const float* st1,
    const void* wt2, const float* st2, void* dx, float* dw1, float* db1,
    float* dw2, float* db2, float* dls, float* dlb, void* h, void* dyb,
    void* a, void* du, float* duf, float* dh, void* aq, float* ar, int B,
    int N, int C, int Hd, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyin = static_cast<const bf16*>(dy);
  const bf16* ub = static_cast<const bf16*>(u);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dybb = static_cast<bf16*>(dyb);
  bf16* ab = static_cast<bf16*>(a);
  bf16* dub = static_cast<bf16*>(du);
  const size_t c4 = sizeof(float) * C;
  if ((e = cudaMemsetAsync(dw1, 0, Hd * c4, s)) ||
      (e = cudaMemsetAsync(db1, 0, sizeof(float) * Hd, s)) ||
      (e = cudaMemsetAsync(dw2, 0, Hd * c4, s)) ||
      (e = cudaMemsetAsync(db2, 0, c4, s)) ||
      (e = cudaMemsetAsync(dls, 0, c4, s)) ||
      (e = cudaMemsetAsync(dlb, 0, c4, s)))
    return e;
  // (1), (2), (3)
  if ((e = train::scale_dy(dyin, dp, N, M, C, dybb, db2, false, s))) return e;
  const size_t nu = (size_t)M * Hd;
  gelu_from_u_kernel<<<(unsigned)std::min<size_t>((nu + 255) / 256, 65535),
                       256, 0, s>>>(ub, ab, nu);
  if ((e = cudaGetLastError())) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dybb, ab, M, C, Hd, dw2, s))) return e;
  // (4): da = deq(q8(dy * dp) W2), du = da * gelu'(u) in f32 and bf16
  if ((e = q8::rows_q8(dyin, dp, N, M, C, aq, ar, s))) return e;
  if ((e = gemm::gemm_s8(aq, wt2, ar, st2, M, Hd, C,
                         EpiGeluGradF32{db1, ub, dub, duf, Hd}, s)))
    return e;
  // (5): dW1 from the bf16 du; dh = deq(q8(du) W1)
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dub, hb, M, Hd, C, dw1, s))) return e;
  if ((e = q8::rows_q8(static_cast<const float*>(duf), nullptr, 1, M, Hd, aq,
                       ar, s)))
    return e;
  if ((e = gemm::gemm_s8(aq, wt1, ar, st1, M, C, Hd,
                         gemm::EpiStoreF32{dh, C}, s)))
    return e;
  // (6)
  return train::ln_bwd(xb, dh, dyin, ln_w, static_cast<bf16*>(dx), dls, dlb,
                       M, C, eps, s);
}
