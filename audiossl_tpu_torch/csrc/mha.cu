// Kernel K6: the standalone multi-head attention of an f32 (or bf16)
// encoder's Attention module, out = softmax-free exp attention of the packed
// [B, N, 3C] qkv projection, forward and backward.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_mha.py:196 fused_mha, a
// custom_vjp (forward _fwd_kernel :78, call :212; backward _bwd_kernel :146
// / _bwd_head :102, call :261) that walks the batch one sequence per grid
// step and slices each head from the packed block in VMEM.
//
// The math is K4's attention core, so the kernels are the ones K2/K4 run,
// templated on the element type (attn_exp.cuh, attn_bwd.cuh):
//  forward   kz = k * valid, vv = [v * valid, valid], s = q kz^T * scale,
//            e = T(exp(s)) (no max subtraction), o = T((e v) / (e valid +
//            1e-30)); r = 1 / (e valid + 1e-30) [B, N, H] f32 is saved
//  backward  delta = sum T(do * o), dor = T(do * r), nd = T(-delta * r),
//            dpd = dor vz^T + nd, t = T(e * dpd), dq = T(t kz * scale),
//            dk = T(t^T q * scale * valid), dv = T(e^T dor * valid)
// Unlike K2/K4, a sequence with no valid key is not given uniform attention:
// its den is 0, so o = 0, and vz = 0 makes dpd = 0, so every gradient is 0
// (the TPU kernel's behaviour, pallas_mha.py:96-97).
//
// What bounds it on the H100: at the ATST-Clip small step (2B = 192
// sequences, N = 151 tokens, 6 heads of 64, f32) the forward is 6.7 GFLOP
// and the backward ~17 GFLOP of [N, N] products against ~45 MB of qkv
// (ATST-Frame base, [192, 250, 2304] with 12 heads: ~130 GFLOP in the
// backward's two passes), so the products bound it. The backward replaces
// pallas_mha.py:_bwd_head with the tensor-core core of attn_bwd.cuh: in bf16
// mma.sync m16n8k16 (989 TFLOP/s peak); in f32 3xTF32 on mma.sync m16n8k8,
// each operand split into two TF32 halves and each product summed from three
// TF32 passes (495 TFLOP/s peak, so 3 x ops / 495 bounds f32-accurate
// products), ~1e-6 relative, where one TF32 pass (~1e-3) would break the
// f32 contract. The forward (attn_exp.cuh) runs on the same warp-level
// parts: S = q kz^T, e rounded in registers, o += e vz, in bf16 mma.sync
// and in f32 3xTF32, and its e is the one the backward recomputes. The TPU
// kernel pads N to a multiple of 128 for lane alignment; here no padding is
// needed, since rows past N are zero-filled in the tile loads.
#include "attn_bwd.cuh"
#include "attn_exp.cuh"
#include "common.cuh"

// dtype: 0 = f32, 1 = bf16 (qkv, out and the gradients; r is f32)
extern "C" int mha_fwd_launch(int device, const void* qkv,
                              const float* valid, void* out, float* r,
                              int dtype, int B, int N, int C, int H,
                              float scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attn::attn_exp(static_cast<const float*>(qkv), valid, valid,
                          static_cast<float*>(out), r, B, N, C, H, scale, s);
  if (dtype == 1)
    return attn::attn_exp(static_cast<const bf16*>(qkv), valid, valid,
                          static_cast<bf16*>(out), r, B, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}

// dqkv [B, N, 3C] is overwritten; scratch dor [B, N, C] in the element type
// and nd [B, N, H] f32.
extern "C" int mha_bwd_launch(int device, const void* qkv, const float* valid,
                              const void* out, const float* r,
                              const void* d_out, void* dqkv, void* dor,
                              float* nd, int dtype, int B, int N, int C,
                              int H, float scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attn::attn_bwd<float, float>(
        static_cast<const float*>(d_out), static_cast<const float*>(out), r,
        static_cast<const float*>(qkv), valid, static_cast<float*>(dor), nd,
        static_cast<float*>(dqkv), B, N, C, H, scale, s);
  if (dtype == 1)
    return attn::attn_bwd<bf16, bf16>(
        static_cast<const bf16*>(d_out), static_cast<const bf16*>(out), r,
        static_cast<const bf16*>(qkv), valid, static_cast<bf16*>(dor), nd,
        static_cast<bf16*>(dqkv), B, N, C, H, scale, s);
  return cudaErrorInvalidValue;
}
