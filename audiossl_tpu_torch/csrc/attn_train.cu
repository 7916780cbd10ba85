// Kernel K4: the trainable attention residual half of a pre-LN transformer
// block, y = x + dp * proj(MHA(qkv(LN1(x)))), forward and backward, for the
// student encoder of the pretraining step.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_attn.py:283
// fused_attn_block (forward _fwd :304 / _fwd_body :50, call :348; backward
// _bwd :396 / _bwd_impl :123, call :425), a custom_vjp whose kernels keep
// the block's weights resident in VMEM and walk the batch one sequence per
// grid step, accumulating the weight gradients in VMEM across that
// sequential grid.
//
// What bounds it on the H100: at the training step (2B = 192 sequences of
// N = 250 tokens, C = 768, 12 heads) the forward is 227 GFLOP of weight
// products and 37 GFLOP of attention, the backward twice the products plus
// ~130 GFLOP of attention -- tensor-core rate, far above the bf16 ridge
// point. The weights (4.7 MB bf16) cannot stay resident in a 227 KB
// SM, and blocks run in parallel in no order, so the sequential-grid
// accumulation of dW becomes one product over all M = B*N rows.
//
// Design (first, simple version), every launch on the caller's stream:
// forward, as K2 (attn_block.cu) plus the residuals the backward reads:
//  (a) h = bf16(LN1(x)), f32 statistics                       (common.cuh)
//  (b) qkv = bf16(h W_qkv^T + b_qkv), saved                 (gemm_bf16.cuh)
//  (c) exp-only attention -> o (bf16, saved) and the reciprocal
//      denominators r [M, H] (f32, saved)                    (attn_exp.cuh)
//  (d) y = bf16(x + dp * (o W_proj^T + b_proj))
// backward, with every bf16 rounding point of _bwd_impl:
//  (1) dyb = bf16(dy * dp), dbproj = sum dyb          (train_common.cuh)
//  (2) dW_proj = dyb^T o (split-K, f32 atomics); do = dyb W_proj (f32)
//  (3) per row and head: delta = sum bf16(do * o), dor = bf16(do * r),
//      nd = bf16(-delta * r)
//  (4) per (sequence, head, 64-query tile): e = bf16(exp(q kz^T * scale))
//      recomputed, dpd = dor vz^T + nd, t = bf16(e * dpd),
//      dq = bf16(t kz * scale)
//  (5) per (sequence, head, 64-key tile), walking all queries: the same
//      e and t, dk = bf16(t^T q * scale * valid), dv = bf16(e^T dor * valid)
//  (6) dbqkv = sum dqkv; h recomputed as in (a); dW_qkv = dqkv^T h;
//      dh = dqkv W_qkv (f32)
//  (7) LN1 backward from recomputed f32 statistics: dx, dls, dlb
// Steps (3)-(5) are the attention backward shared with K6 (attn_bwd.cuh),
// which replaces the products of _bwd_impl (:186-211). At this shape its
// two passes do ~130 GFLOP of [N, N] x D products, so the tensor cores
// bound it (0.13 ms at 989 TFLOP/s bf16): (4) and (5) run bf16 mma.sync
// m16n8k16 with f32 accumulation, the score, e and t tiles in registers,
// e and t rounded to bf16 where they become the next product's A operand.
// The forward's attention (c) runs on the same tensor-core parts
// (attn_exp.cuh: S, e and o in registers); wgmma, fusing (3) into (4) and
// the GEMMs' LN prologue are later work.
//
// Kernel K4q, the int8 variants (student_quant, pallas_attn.py:283 with
// quant): the weights come as int8 codes quantized by the caller once per
// call (torch ops, as the JAX package's XLA-level quantize_weight_q8).
// attn_train_fwd_q8_launch follows _fwd_kernel_q8 (:106, via :348): (a)-(d)
// above with the qkv product from the codes of the f32 LN1 output
// (quant_q8.cuh ln_q8) and the proj product from the codes of o after its
// bf16 store, both int8 wgmma GEMMs (gemm_s8.cuh) dequantized per row and
// channel. attn_train_bwd_q8dx_launch follows _bwd_kernel_q8dx (:252, via
// :425): (1)-(7) above with the two grad-to-input products in int8 against
// the codes of the dequantized weights quantized again per input channel,
// passed as the codes of W^T ([in, out], K-major for int8 wgmma): do from
// the codes of the f32 dy * dp, dh from those of the bf16 dqkv. The attention core and the bf16 weight-gradient
// products are unchanged.
#include "attn_bwd.cuh"
#include "attn_exp.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"
#include "quant_q8.cuh"
#include "train_common.cuh"

extern "C" int attn_train_fwd_launch(
    int device, const void* x, const float* valid_k, const float* valid_v,
    const float* dp, const float* ln_w, const float* ln_b, const void* w_qkv,
    const float* b_qkv, const void* w_proj, const float* b_proj, void* out,
    void* h, void* qkv, void* o, float* r, int B, int N, int C, int H,
    float scale, float eps, void* stream) {
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
  if ((e = attn::attn_exp(qkvb, valid_k, valid_v, ob, r, B, N, C, H, scale,
                          s)))
    return e;
  return gemm::gemm_bf16_tn(
      ob, static_cast<const bf16*>(w_proj), M, C, C,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b_proj, dp, C, N},
      s);
}

// Gradients dw_qkv [3C, C], db_qkv [3C], dw_proj [C, C], db_proj, dls, dlb
// [C] are f32 and overwritten. Scratch (all [M, *], row-major): h, dyb, dor,
// dqkv bf16 [.., C | C | C | 3C]; d_f32 [M, C] f32 (do, then dh); nd [M, H].
extern "C" int attn_train_bwd_launch(
    int device, const void* x, const void* dy, const void* qkv, const void* o,
    const float* r, const float* valid_k, const float* dp, const float* ln_w,
    const float* ln_b, const void* w_qkv, const void* w_proj, void* dx,
    float* dw_qkv, float* db_qkv, float* dw_proj, float* db_proj, float* dls,
    float* dlb, void* h, void* dyb, void* dor, void* dqkv, float* d_f32,
    float* nd, int B, int N, int C, int H, float scale, float eps,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* qkvb = static_cast<const bf16*>(qkv);
  const bf16* ob = static_cast<const bf16*>(o);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dybb = static_cast<bf16*>(dyb);
  bf16* dorb = static_cast<bf16*>(dor);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  const size_t c4 = sizeof(float) * C;
  if ((e = cudaMemsetAsync(dw_qkv, 0, 3 * C * c4, s)) ||
      (e = cudaMemsetAsync(db_qkv, 0, 3 * c4, s)) ||
      (e = cudaMemsetAsync(dw_proj, 0, C * c4, s)) ||
      (e = cudaMemsetAsync(db_proj, 0, c4, s)) ||
      (e = cudaMemsetAsync(dls, 0, c4, s)) ||
      (e = cudaMemsetAsync(dlb, 0, c4, s)))
    return e;
  // (1), (2)
  if ((e = train::scale_dy(static_cast<const bf16*>(dy), dp, N, M, C, dybb,
                           db_proj, true, s)))
    return e;
  if ((e = gemm::gemm_bf16_weight_grad(dybb, ob, M, C, C, dw_proj, s)))
    return e;
  if ((e = gemm::gemm_bf16<true, false>(dybb,
                                        static_cast<const bf16*>(w_proj), M,
                                        C, C, gemm::EpiStoreF32{d_f32, C}, s)))
    return e;
  // (3)-(5)
  if ((e = attn::attn_bwd<bf16, float>(d_f32, ob, r, qkvb, valid_k, dorb, nd,
                                       dqkvb, B, N, C, H, scale, s)))
    return e;
  // (6)
  if ((e = train::colsum_bf16(dqkvb, M, 3 * C, db_qkv, s))) return e;
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dqkvb, hb, M, 3 * C, C, dw_qkv, s)))
    return e;
  if ((e = gemm::gemm_bf16<true, false>(dqkvb,
                                        static_cast<const bf16*>(w_qkv), M,
                                        C, 3 * C,
                                        gemm::EpiStoreF32{d_f32, C}, s)))
    return e;
  // (7)
  return train::ln_bwd(xb, d_f32, static_cast<const bf16*>(dy), ln_w,
                       static_cast<bf16*>(dx), dls, dlb, M, C, eps, s);
}

extern "C" int attn_train_fwd_q8_launch(
    int device, const void* x, const float* valid_k, const float* valid_v,
    const float* dp, const float* ln_w, const float* ln_b, const void* wq_qkv,
    const float* s_qkv, const float* b_qkv, const void* wq_proj,
    const float* s_proj, const float* b_proj, void* out, void* hq, float* hr,
    void* qkv, void* o, float* r, void* oq, float* orow, int B, int N, int C,
    int H, float scale, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ob = static_cast<bf16*>(o);
  if ((e = q8::ln_q8(xb, ln_w, ln_b, hq, hr, M, C, eps, s))) return e;
  if ((e = gemm::gemm_s8(hq, wq_qkv, hr, s_qkv, M, 3 * C, C,
                         gemm::EpiBias{qkvb, b_qkv, 3 * C}, s)))
    return e;
  if ((e = attn::attn_exp(qkvb, valid_k, valid_v, ob, r, B, N, C, H, scale,
                          s)))
    return e;
  if ((e = q8::rows_q8(static_cast<const bf16*>(ob), nullptr, 1, M, C, oq,
                       orow, s)))
    return e;
  return gemm::gemm_s8(
      oq, wq_proj, orow, s_proj, M, C, C,
      gemm::EpiBiasResidual{static_cast<bf16*>(out), xb, b_proj, dp, C, N},
      s);
}

// As attn_train_bwd_launch; wt_qkv [C, 3C] / wt_proj [C, C] int8 codes of
// W_qkv^T / W_proj^T ([in, out]: the product's K contiguous) with
// per-input-channel scales st_qkv / st_proj [C]. Extra scratch: aq int8
// [M, 3C] and ar f32 [M], the codes and row scales of dy * dp, then of dqkv.
extern "C" int attn_train_bwd_q8dx_launch(
    int device, const void* x, const void* dy, const void* qkv, const void* o,
    const float* r, const float* valid_k, const float* dp, const float* ln_w,
    const float* ln_b, const void* wt_qkv, const float* st_qkv,
    const void* wt_proj, const float* st_proj, void* dx, float* dw_qkv,
    float* db_qkv, float* dw_proj, float* db_proj, float* dls, float* dlb,
    void* h, void* dyb, void* dor, void* dqkv, float* d_f32, float* nd,
    void* aq, float* ar, int B, int N, int C, int H, float scale, float eps,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyin = static_cast<const bf16*>(dy);
  const bf16* qkvb = static_cast<const bf16*>(qkv);
  const bf16* ob = static_cast<const bf16*>(o);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dybb = static_cast<bf16*>(dyb);
  bf16* dorb = static_cast<bf16*>(dor);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  const size_t c4 = sizeof(float) * C;
  if ((e = cudaMemsetAsync(dw_qkv, 0, 3 * C * c4, s)) ||
      (e = cudaMemsetAsync(db_qkv, 0, 3 * c4, s)) ||
      (e = cudaMemsetAsync(dw_proj, 0, C * c4, s)) ||
      (e = cudaMemsetAsync(db_proj, 0, c4, s)) ||
      (e = cudaMemsetAsync(dls, 0, c4, s)) ||
      (e = cudaMemsetAsync(dlb, 0, c4, s)))
    return e;
  // (1), (2): dW_proj from the bf16 dyb; do = deq(q8(dy * dp) W_proj)
  if ((e = train::scale_dy(dyin, dp, N, M, C, dybb, db_proj, true, s)))
    return e;
  if ((e = gemm::gemm_bf16_weight_grad(dybb, ob, M, C, C, dw_proj, s)))
    return e;
  if ((e = q8::rows_q8(dyin, dp, N, M, C, aq, ar, s))) return e;
  if ((e = gemm::gemm_s8(aq, wt_proj, ar, st_proj, M, C, C,
                         gemm::EpiStoreF32{d_f32, C}, s)))
    return e;
  // (3)-(5)
  if ((e = attn::attn_bwd<bf16, float>(d_f32, ob, r, qkvb, valid_k, dorb, nd,
                                       dqkvb, B, N, C, H, scale, s)))
    return e;
  // (6): dW_qkv from the bf16 dqkv; dh = deq(q8(dqkv) W_qkv)
  if ((e = train::colsum_bf16(dqkvb, M, 3 * C, db_qkv, s))) return e;
  if ((e = layer_norm_bf16(xb, ln_w, ln_b, hb, M, C, eps, s))) return e;
  if ((e = gemm::gemm_bf16_weight_grad(dqkvb, hb, M, 3 * C, C, dw_qkv, s)))
    return e;
  if ((e = q8::rows_q8(static_cast<const bf16*>(dqkvb), nullptr, 1, M, 3 * C,
                       aq, ar, s)))
    return e;
  if ((e = gemm::gemm_s8(aq, wt_qkv, ar, st_qkv, M, C, 3 * C,
                         gemm::EpiStoreF32{d_f32, C}, s)))
    return e;
  // (7)
  return train::ln_bwd(xb, d_f32, dyin, ln_w, static_cast<bf16*>(dx), dls,
                       dlb, M, C, eps, s);
}
