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
// ~130 GFLOP of attention -- tensor-core and SIMT rate, far above the bf16
// ridge point. The weights (4.7 MB bf16) cannot stay resident in a 227 KB
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
// Attention (4)/(5) runs on the SIMT f32 FMA units like K2's forward; the
// [N, N] score tiles live in shared memory only. wgmma attention, fusing
// (3) into (4) and keeping the bf16 operands on chip are later work.
#include "attn_exp.cuh"
#include "common.cuh"
#include "gemm_bf16.cuh"
#include "train_common.cuh"

namespace {

using train::bf16_round;

constexpr int TQ = 64;        // rows (queries or keys) per block
constexpr int TK = 32;        // columns per inner tile
constexpr int BTHREADS = 256;  // 4 threads per row

// (3): one warp per (row, head)
__global__ void attn_bwd_prep_kernel(const float* __restrict__ d_o,
                                     const bf16* __restrict__ o,
                                     const float* __restrict__ r,
                                     bf16* __restrict__ dor,
                                     float* __restrict__ nd, int M, int C,
                                     int H) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= M * H) return;
  const int m = w / H, h = w % H, D = C / H;
  const size_t off = (size_t)m * C + h * D;
  const float rr = r[(size_t)m * H + h];
  float delta = 0.0f;
  for (int c = lane; c < D; c += 32) {
    float g = d_o[off + c];
    delta += bf16_round(g * __bfloat162float(o[off + c]));
    dor[off + c] = __float2bfloat16(g * rr);
  }
  delta = warp_sum(delta);
  if (lane == 0) nd[(size_t)m * H + h] = bf16_round(-delta * rr);
}

// 16-byte row loads of one head's D columns; zero rows past N
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16 (*dst)[D + 8],
                                          const bf16* src, size_t pitch,
                                          int n0, int N, const float* scale) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += BTHREADS) {
    int row = c / CH, dc = (c % CH) * 8, n = n0 + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < N) v = *reinterpret_cast<const uint4*>(src + n * pitch + dc);
    if (scale != nullptr) {  // multiply by a per-row 0/1 validity
      float sc = n < N ? scale[n] : 0.0f;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * sc);
    }
    *reinterpret_cast<uint4*>(&dst[row][dc]) = v;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const bf16* a, const bf16* b) {
  float s = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + d));
    float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + d));
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

// (4): dq for 64 queries of one (sequence, head)
template <int D>
__global__ void __launch_bounds__(BTHREADS)
    attn_bwd_dq_kernel(const bf16* __restrict__ qkv,
                       const float* __restrict__ valid_k,
                       const bf16* __restrict__ dor,
                       const float* __restrict__ nd, bf16* __restrict__ dqkv,
                       int N, int C, int H, float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Qs[TQ][LD];
  __shared__ __align__(16) bf16 Ds[TQ][LD];
  __shared__ __align__(16) bf16 Ks[TK][LD];
  __shared__ __align__(16) bf16 Vs[TK][LD];
  __shared__ float Ts[TQ][TK + 1];
  __shared__ float NDs[TQ];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const size_t pitch = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * pitch;
  const float* vk = valid_k + (size_t)b * N;

  load_rows<D, TQ>(Qs, base + h * D, pitch, q0, N, nullptr);
  load_rows<D, TQ>(Ds, dor + (size_t)b * N * C + h * D, C, q0, N, nullptr);
  if (tid < TQ)
    NDs[tid] = q0 + tid < N ? nd[((size_t)b * N + q0 + tid) * H + h] : 0.0f;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // Qs/Ds written / previous tile consumed
    load_rows<D, TK>(Ks, base + C + h * D, pitch, k0, N, vk);      // kz
    load_rows<D, TK>(Vs, base + 2 * C + h * D, pitch, k0, N, vk);  // vz
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < TK / 4; ++jj) {
      int j = sub + 4 * jj;
      float e = bf16_round(expf(dot_row<D>(Qs[r], Ks[j]) * scale));
      float dpd = dot_row<D>(Ds[r], Vs[j]) + NDs[r];
      Ts[r][j] = bf16_round(e * dpd);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float t = Ts[r][j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &Ks[j][2 * sub + 8 * i]));
        acc[2 * i] = fmaf(t, k.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(t, k.y, acc[2 * i + 1]);
      }
    }
  }
  const int n = q0 + r;
  if (n >= N) return;
  bf16* row = dqkv + ((size_t)b * N + n) * pitch + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    *reinterpret_cast<__nv_bfloat162*>(&row[2 * sub + 8 * i]) =
        __floats2bfloat162_rn(acc[2 * i] * scale, acc[2 * i + 1] * scale);
}

// (5): dk, dv for 64 keys of one (sequence, head), over all queries
template <int D>
__global__ void __launch_bounds__(BTHREADS)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ valid_k,
                         const bf16* __restrict__ dor,
                         const float* __restrict__ nd,
                         bf16* __restrict__ dqkv, int N, int C, int H,
                         float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[TQ][LD];
  __shared__ __align__(16) bf16 Vs[TQ][LD];
  __shared__ __align__(16) bf16 Qs[TK][LD];
  __shared__ __align__(16) bf16 Ds[TK][LD];
  __shared__ float Es[TQ][TK + 1];
  __shared__ float Ts[TQ][TK + 1];
  __shared__ float NDs[TK];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const size_t pitch = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * pitch;
  const float* vk = valid_k + (size_t)b * N;

  load_rows<D, TQ>(Ks, base + C + h * D, pitch, k0, N, vk);      // kz
  load_rows<D, TQ>(Vs, base + 2 * C + h * D, pitch, k0, N, vk);  // vz

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += TK) {
    __syncthreads();  // Ks/Vs written / previous tile consumed
    load_rows<D, TK>(Qs, base + h * D, pitch, q0, N, nullptr);
    load_rows<D, TK>(Ds, dor + (size_t)b * N * C + h * D, C, q0, N, nullptr);
    if (tid < TK)
      NDs[tid] = q0 + tid < N ? nd[((size_t)b * N + q0 + tid) * H + h] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < TK / 4; ++jj) {
      int j = sub + 4 * jj;  // query within the tile
      float e = bf16_round(expf(dot_row<D>(Qs[j], Ks[r]) * scale));
      float dpd = dot_row<D>(Ds[j], Vs[r]) + NDs[j];
      Es[r][j] = e;
      Ts[r][j] = bf16_round(e * dpd);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float e = Es[r][j], t = Ts[r][j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &Qs[j][2 * sub + 8 * i]));
        float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &Ds[j][2 * sub + 8 * i]));
        dk[2 * i] = fmaf(t, q.x, dk[2 * i]);
        dk[2 * i + 1] = fmaf(t, q.y, dk[2 * i + 1]);
        dv[2 * i] = fmaf(e, g.x, dv[2 * i]);
        dv[2 * i + 1] = fmaf(e, g.y, dv[2 * i + 1]);
      }
    }
  }
  const int n = k0 + r;
  if (n >= N) return;
  const float v = vk[n];  // exact-softmax gradient: invalid keys get 0
  bf16* row = dqkv + ((size_t)b * N + n) * pitch + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(&row[C + 2 * sub + 8 * i]) =
        __floats2bfloat162_rn(dk[2 * i] * scale * v,
                              dk[2 * i + 1] * scale * v);
    *reinterpret_cast<__nv_bfloat162*>(&row[2 * C + 2 * sub + 8 * i]) =
        __floats2bfloat162_rn(dv[2 * i] * v, dv[2 * i + 1] * v);
  }
}

template <int D>
cudaError_t attn_bwd_core(const bf16* qkv, const float* valid_k,
                          const bf16* dor, const float* nd, bf16* dqkv,
                          int B, int N, int C, int H, float scale,
                          cudaStream_t s) {
  dim3 grid((N + TQ - 1) / TQ, H, B);
  attn_bwd_dq_kernel<D><<<grid, BTHREADS, 0, s>>>(qkv, valid_k, dor, nd,
                                                  dqkv, N, C, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  attn_bwd_dkdv_kernel<D><<<grid, BTHREADS, 0, s>>>(qkv, valid_k, dor, nd,
                                                    dqkv, N, C, H, scale);
  return cudaGetLastError();
}

}  // namespace

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
  // (3)
  const long long warps = (long long)M * H;
  attn_bwd_prep_kernel<<<(unsigned)((warps * 32 + 255) / 256), 256, 0, s>>>(
      d_f32, ob, r, dorb, nd, M, C, H);
  if ((e = cudaGetLastError())) return e;
  // (4), (5)
  switch (C / H) {
    case 32: e = attn_bwd_core<32>(qkvb, valid_k, dorb, nd, dqkvb, B, N, C, H, scale, s); break;
    case 64: e = attn_bwd_core<64>(qkvb, valid_k, dorb, nd, dqkvb, B, N, C, H, scale, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e) return e;
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
