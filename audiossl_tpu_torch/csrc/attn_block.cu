// Kernel K2: the attention residual half of a pre-LN transformer block, for
// inference forwards (embedding extraction; later the EMA teacher).
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_block.py:282
// attn_block_infer (_attn_kernel :155, _attn_core :107), which keeps the
// block's weights resident in VMEM and runs LN1 -> qkv -> per-head exp-only
// softmax attention -> proj -> x + dp*y for one batch row per grid step.
//
// What bounds it on the H100: at ATST-Frame base (B=8 clips, N=250 tokens,
// C=768, 12 heads) the half is 9.4 GFLOP of weight products plus 1.5 GFLOP
// of attention against ~4.7 MB of bf16 weights and ~3 MB of activations per
// [M, C] pass -- far above the bf16 ridge point, so it is bound by the
// tensor-core rate, and by launch and occupancy overheads at this small M.
// A whole block's weights (4.7 MB) cannot stay resident in a 227 KB SM, so
// the TPU kernel's one-pass structure does not carry over.
//
// Design (first, simple version) -- four launches on the caller's stream:
//  (a) row LayerNorm, f32 statistics, bf16 output h            (common.cuh)
//  (b) qkv = bf16(h W_qkv^T + b_qkv)   wgmma + TMA GEMM      (gemm_bf16.cuh)
//  (c) per (clip, head, 64-query tile): s = q.k * scale over 64-key tiles,
//      e = bf16(exp(s)) -- no max subtraction, so partial sums over key
//      tiles simply add --, o = sum e v / (sum e valid_v + 1e-30), bf16,
//      on the tensor cores                                    (attn_exp.cuh)
//  (d) out = bf16(x + dp * (o W_proj^T + b_proj))  the same GEMM template
// with the TPU kernel's masking: invalid keys are zeroed in k (e = 1) and
// dropped from the sums by valid_v, which the wrapper sets to all ones for a
// sequence with no valid key (uniform attention); and its rounding points:
// qkv, e and o are bf16, the denominator sums the same rounded e.
// q/k/v never leave the [M, 3C] bf16 buffer; the score tile and e stay in
// registers. Keeping qkv and o on chip, wgmma and TMA are later work.
//
// Kernel K2q, attn_block_q8_launch: K2 with the qkv and proj products in
// int8 (the TPU kernel _attn_kernel_q8, pallas_block.py:179, via :326):
// int8 weight codes with per-output-channel scales (quantized by the caller,
// once per call, as the JAX package does at the XLA level) against per-row
// activation codes made on the card. Five launches:
//  (a) LN1 in f32 -> int8 codes hq and row scales hr, from the unrounded
//      f32 LN output                                          (quant_q8.cuh)
//  (b) qkv = bf16(deq(hq W_qkv^T) + b_qkv)   int8 wgmma GEMM   (gemm_s8.cuh)
//  (c) the same exp-only attention, with o left in f32 (unrounded)
//  (d) o -> int8 codes oq and row scales                      (quant_q8.cuh)
//  (e) out = bf16(x + dp * (deq(oq W_proj^T) + b_proj))
// deq(acc) = f32(acc) * r[row] * s[col]. At ATST-Frame base the int8
// products are the same 9.4 GFLOP at twice the bf16 tensor-core peak; the
// row quantizations add ~4 bytes moved per activation element.
#include "attn_exp.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"
#include "quant_q8.cuh"

extern "C" int attn_block_launch(int device, const void* x,
                                 const float* valid_k, const float* valid_v,
                                 const float* dp, const float* ln_w,
                                 const float* ln_b, const void* w_qkv,
                                 const float* b_qkv, const void* w_proj,
                                 const float* b_proj, void* out, void* h,
                                 void* qkv, void* o, int B, int N, int C,
                                 int H, float scale, float eps,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(h);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ob = static_cast<bf16*>(o);
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_tn(hb, static_cast<const bf16*>(w_qkv), M, 3 * C,
                              C, gemm::EpiBias{qkvb, b_qkv, 3 * C}, s)))
    return e;
  if ((e = attn::attn_exp(qkvb, valid_k, valid_v, ob, nullptr, B, N, C, H,
                          scale, s)))
    return e;
  return gemm::gemm_bf16_tn(
      ob, static_cast<const bf16*>(w_proj), M, C, C,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b_proj, dp, C, N},
      s);
}

extern "C" int attn_block_q8_launch(
    int device, const void* x, const float* valid_k, const float* valid_v,
    const float* dp, const float* ln_w, const float* ln_b, const void* wq_qkv,
    const float* s_qkv, const float* b_qkv, const void* wq_proj,
    const float* s_proj, const float* b_proj, void* out, void* hq, float* hr,
    void* qkv, float* o, void* oq, float* orow, int B, int N, int C, int H,
    float scale, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  if ((e = q8::ln_q8(xb, ln_w, ln_b, hq, hr, M, C, eps, s))) return e;
  if ((e = gemm::gemm_s8(hq, wq_qkv, hr, s_qkv, M, 3 * C, C,
                         gemm::EpiBias{qkvb, b_qkv, 3 * C}, s)))
    return e;
  if ((e = attn::attn_exp(qkvb, valid_k, valid_v, o, nullptr, B, N, C, H,
                          scale, s)))
    return e;
  if ((e = q8::rows_q8(o, nullptr, 1, M, C, oq, orow, s))) return e;
  return gemm::gemm_s8(
      oq, wq_proj, orow, s_proj, M, C, C,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b_proj, dp, C, N},
      s);
}
