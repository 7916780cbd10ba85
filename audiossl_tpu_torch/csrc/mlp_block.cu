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
#include "common.cuh"
#include "gemm_bf16.cuh"

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
