// Kernel K3: the MLP residual half of a pre-LN transformer block, for
// inference forwards (embedding extraction; later the EMA teacher).
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_block.py:360
// mlp_block_infer (_mlp_kernel :201, _mlp_core :193, _erf :59), which keeps
// fc1/fc2 resident in VMEM and runs LN2 -> fc1 -> exact GELU -> fc2 ->
// x + dp*y for one batch row per grid step with the [N, 4C] activation in
// VMEM.
//
// What bounds it on the H100: at ATST-Frame base (M = 8 x 250 tokens,
// C=768, hidden 3072) the two products are 18.9 GFLOP against 9.4 MB of
// bf16 weights and a 12 MB bf16 intermediate -- bound by the tensor-core
// rate. The weights cannot stay resident in a 227 KB SM.
//
// Design (first, simple version) -- three launches on the caller's stream:
//  (a) row LayerNorm, f32 statistics, bf16 output h            (common.cuh)
//  (b) u = bf16(gelu(h W1^T + b1)), GELU = 0.5 u (1 + erf(u/sqrt 2)) with
//      the A&S erf polynomial in f32 and an exact reciprocal  (gemm_bf16.cuh)
//  (c) out = bf16(x + dp * (u W2^T + b2))     the same GEMM template
// The TPU kernel rounds the GELU output to bf16 before fc2 as well, so the
// bf16 intermediate in device memory changes no number; keeping it on chip
// (fusing fc1 -> fc2 per row tile) is later work.
//
// Kernel K3q, mlp_block_q8_launch: K3 with fc1 and fc2 in int8 (the TPU
// kernel _mlp_kernel_q8, pallas_block.py:223, via :390), weight codes with
// per-output-channel scales from the caller. Four launches:
//  (a) LN2 in f32 -> int8 codes and row scales               (quant_q8.cuh)
//  (b) u = deq(hq W1^T) + b1, f32 [M, Hd]                     (gemm_s8.cuh)
//  (c) a = gelu(u) in f32, quantized per row with the bound
//      max(gelu(max_j u), 0.17) from the signed row max of u (quant_q8.cuh)
//  (d) out = bf16(x + dp * (deq(aq W2^T) + b2))
// The f32 u (not the TPU kernel's VMEM block) goes through device memory:
// 4 bytes per hidden element written and read twice, against 18.9 GFLOP of
// int8 products at ATST-Frame base; fusing (b)-(d) per row tile is later
// work.
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"
#include "quant_q8.cuh"

extern "C" int mlp_block_launch(int device, const void* x, const float* dp,
                                const float* ln_w, const float* ln_b,
                                const void* w1, const float* b1,
                                const void* w2, const float* b2, void* out,
                                void* h, void* u, int B, int N, int C, int Hd,
                                float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(h);
  bf16* ub = static_cast<bf16*>(u);
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_tn(hb, static_cast<const bf16*>(w1), M, Hd, C,
                              gemm::EpiBiasGelu{ub, b1, Hd}, s)))
    return e;
  return gemm::gemm_bf16_tn(
      ub, static_cast<const bf16*>(w2), M, C, Hd,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b2, dp, C, N}, s);
}

extern "C" int mlp_block_q8_launch(int device, const void* x, const float* dp,
                                   const float* ln_w, const float* ln_b,
                                   const void* w1q, const float* s1,
                                   const float* b1, const void* w2q,
                                   const float* s2, const float* b2, void* out,
                                   void* hq, float* hr, float* u, void* aq,
                                   float* ar, int B, int N, int C, int Hd,
                                   float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  if ((e = q8::ln_q8(xb, ln_w, ln_b, hq, hr, M, C, eps, s))) return e;
  if ((e = gemm::gemm_s8(hq, w1q, hr, s1, M, Hd, C,
                         gemm::EpiBiasF32{u, b1, Hd}, s)))
    return e;
  if ((e = q8::gelu_q8(u, M, Hd, aq, ar, q8::GeluErf{}, s))) return e;
  return gemm::gemm_s8(
      aq, w2q, ar, s2, M, C, Hd,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b2, dp, C, N}, s);
}
