// Exp-only softmax attention over the packed [M, 3C] qkv buffer, shared by
// the inference (attn_block.cu, K2) and training (attn_train.cu, K4)
// attention halves and the standalone MHA (mha.cu, K6). Templated on the
// element type T of qkv and o: bf16 (K2, K4, K6) or f32 (K6).
//
// Per (clip, head, 64-query tile): s = q.k * scale over 32-key tiles,
// e = T(exp(s)) -- no max subtraction, so partial sums over key tiles
// simply add --, o = sum e v / (sum e valid_v + 1e-30), T. The TPU
// kernels' masking: invalid keys are zeroed in k (e = 1) and dropped from
// the sums by valid_v. K2/K4's wrappers set valid_v to all ones for a
// sequence with no valid key (uniform attention); K6 passes valid_v =
// valid_k, so such a sequence gets den = 0 and o = 0. Rounding points: e and
// o are T, the denominator sums the same rounded e. With r != nullptr the
// reciprocal denominators 1 / (den + 1e-30) are written to r [M, H] (f32),
// the residual the backward reads. The output type TO is T, except for K2q
// (attn_block.cu), which quantizes the unrounded f32 o: bf16 qkv, f32 o.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace attn {

constexpr int QT = 64;         // queries per block
constexpr int KT = 32;         // keys per inner tile
constexpr int ATHREADS = 256;  // 4 threads per query row

template <typename T, int D, typename TO>
static __global__ void __launch_bounds__(ATHREADS)
    attn_exp_kernel(const T* __restrict__ qkv,
                    const float* __restrict__ valid_k,
                    const float* __restrict__ valid_v,
                    TO* __restrict__ o, float* __restrict__ r_out, int N,
                    int C, int H, float scale) {
  using E = elem<T>;
  constexpr int LD = D + E::PER16;  // row pitch (16-byte multiple)
  constexpr int CH = D / E::PER16;  // 16-byte chunks per row
  __shared__ __align__(16) T Qs[QT][LD];
  __shared__ __align__(16) T Ks[KT][LD];
  __shared__ __align__(16) T Vs[KT][LD];
  __shared__ float Es[QT][KT + 1];
  __shared__ float Vv[KT];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const size_t pitch = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * N * pitch;
  const float* vk = valid_k + (size_t)b * N;
  const float* vv = valid_v + (size_t)b * N;

  for (int c = tid; c < QT * CH; c += ATHREADS) {
    int row = c / CH, dc = (c % CH) * E::PER16, n = q0 + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < N)
      v = *reinterpret_cast<const uint4*>(base + n * pitch + h * D + dc);
    *reinterpret_cast<uint4*>(&Qs[row][dc]) = v;
  }

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.0f;
  float den = 0.0f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int c = tid; c < KT * CH; c += ATHREADS) {
      int j = c / CH, dc = (c % CH) * E::PER16, n = k0 + j;
      float mk = n < N ? vk[n] : 0.0f;
      float mv = n < N ? vv[n] : 0.0f;
      __align__(16) T kv[E::PER16];
      __align__(16) T vvv[E::PER16];
      if (n < N) {
        *reinterpret_cast<uint4*>(kv) =
            *reinterpret_cast<const uint4*>(base + n * pitch + C + h * D + dc);
        *reinterpret_cast<uint4*>(vvv) = *reinterpret_cast<const uint4*>(
            base + n * pitch + 2 * C + h * D + dc);
      }
#pragma unroll
      for (int e = 0; e < E::PER16; ++e) {  // kz = k * valid_k, v * valid_v
        float kf = n < N ? E::to_f(kv[e]) : 0.0f;
        float vf = n < N ? E::to_f(vvv[e]) : 0.0f;
        Ks[j][dc + e] = E::from_f(kf * mk);
        Vs[j][dc + e] = E::from_f(vf * mv);
      }
      if (dc == 0) Vv[j] = mv;
    }
    __syncthreads();

    // scores of row r against keys sub, sub+4, ..., sub+28
#pragma unroll
    for (int jj = 0; jj < KT / 4; ++jj) {
      int j = sub + 4 * jj;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 2) {
        float2 q = E::ld2(&Qs[r][d]);
        float2 k = E::ld2(&Ks[j][d]);
        s = fmaf(q.x, k.x, s);
        s = fmaf(q.y, k.y, s);
      }
      Es[r][j] = round_to<T>(expf(s * scale));
    }
    __syncthreads();

    // o[r, 2*sub + 8*i + {0,1}] += sum_j e[r, j] * v[j, .]
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float e = Es[r][j];
      den = fmaf(e, Vv[j], den);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 v = E::ld2(&Vs[j][2 * sub + 8 * i]);
        acc[2 * i] = fmaf(e, v.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(e, v.y, acc[2 * i + 1]);
      }
    }
  }

  const int n = q0 + r;
  if (n >= N) return;
  const float rden = 1.0f / (den + 1e-30f);
  if (r_out != nullptr && sub == 0) r_out[((size_t)b * N + n) * H + h] = rden;
  TO* orow = o + ((size_t)b * N + n) * C + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    elem<TO>::st2(&orow[2 * sub + 8 * i], acc[2 * i] * rden, acc[2 * i + 1] * rden);
}

template <typename T, int D, typename TO>
static cudaError_t attn_exp_d(const T* qkv, const float* valid_k,
                              const float* valid_v, TO* o, float* r, int B,
                              int N, int C, int H, float scale,
                              cudaStream_t s) {
  dim3 grid((N + QT - 1) / QT, H, B);
  attn_exp_kernel<T, D, TO><<<grid, ATHREADS, 0, s>>>(qkv, valid_k, valid_v, o, r,
                                                  N, C, H, scale);
  return cudaGetLastError();
}

// Dispatch on the head dimension C / H: 32, 64 or (bf16 only, the static
// shared-memory tiles of f32 would exceed 48 KB) 128.
template <typename T, typename TO>
static inline cudaError_t attn_exp(const T* qkv, const float* valid_k,
                                   const float* valid_v, TO* o, float* r,
                                   int B, int N, int C, int H, float scale,
                                   cudaStream_t s) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  switch (C / H) {
    case 32: return attn_exp_d<T, 32, TO>(qkv, valid_k, valid_v, o, r, B, N, C, H, scale, s);
    case 64: return attn_exp_d<T, 64, TO>(qkv, valid_k, valid_v, o, r, B, N, C, H, scale, s);
    case 128:
      if constexpr (sizeof(T) == 2)
        return attn_exp_d<T, 128, TO>(qkv, valid_k, valid_v, o, r, B, N, C, H, scale, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
