// Backward of the exp-only attention of attn_exp.cuh, shared by the
// trainable attention half (attn_train.cu, K4) and the standalone MHA
// (mha.cu, K6). Templated on the element type T of qkv, o, dor and dqkv
// (bf16 or f32) and on the type TD of the incoming gradient do (K4: the f32
// product dyb W_proj; K6: T). Every rounding point of the TPU kernels'
// backward (pallas_attn.py:_bwd_impl, pallas_mha.py:_bwd_head):
//  (3) per row and head: delta = sum T(do * o), dor = T(do * r),
//      nd = T(-delta * r)
//  (4) per (sequence, head, 64-query tile): e = T(exp(q kz^T * scale))
//      recomputed, dpd = dor vz^T + nd, t = T(e * dpd), dq = T(t kz * scale)
//  (5) per (sequence, head, 64-key tile), walking all queries: the same
//      e and t, dk = T(t^T q * scale * valid), dv = T(e^T dor * valid)
// where kz and vz are k and v with invalid keys zeroed. (4) and (5) run on
// the SIMT f32 FMA units; the [N, N] score tiles live in shared memory only,
// and no cross-block reduction is needed. The tiles take more than the 48 KB
// of static shared memory in f32, so they are dynamic.
#pragma once

#include "attn_exp.cuh"
#include "common.cuh"

namespace attn {

// (3): one warp per (row, head)
template <typename T, typename TD>
static __global__ void attn_bwd_prep_kernel(const TD* __restrict__ d_o,
                                            const T* __restrict__ o,
                                            const float* __restrict__ r,
                                            T* __restrict__ dor,
                                            float* __restrict__ nd, int M,
                                            int C, int H) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= M * H) return;
  const int m = w / H, h = w % H, D = C / H;
  const size_t off = (size_t)m * C + h * D;
  const float rr = r[(size_t)m * H + h];
  float delta = 0.0f;
  for (int c = lane; c < D; c += 32) {
    float g = elem<TD>::to_f(d_o[off + c]);
    delta += round_to<T>(g * elem<T>::to_f(o[off + c]));
    dor[off + c] = elem<T>::from_f(g * rr);
  }
  delta = warp_sum(delta);
  if (lane == 0) nd[(size_t)m * H + h] = round_to<T>(-delta * rr);
}

// 16-byte row loads of one head's D columns into a tile of pitch LD; zero
// rows past N; with scale, each row times its 0/1 validity
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(T (*dst)[LD], const T* src,
                                          size_t pitch, int n0, int N,
                                          const float* scale) {
  constexpr int PER = elem<T>::PER16;
  constexpr int CH = D / PER;
  for (int c = threadIdx.x; c < ROWS * CH; c += ATHREADS) {
    int row = c / CH, dc = (c % CH) * PER, n = n0 + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < N) v = *reinterpret_cast<const uint4*>(src + n * pitch + dc);
    if (scale != nullptr) {
      float sc = n < N ? scale[n] : 0.0f;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        e[i] = elem<T>::from_f(elem<T>::to_f(e[i]) * sc);
    }
    *reinterpret_cast<uint4*>(&dst[row][dc]) = v;
  }
}

template <typename T, int D>
__device__ __forceinline__ float dot_row(const T* a, const T* b) {
  float s = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; d += 2) {
    float2 x = elem<T>::ld2(a + d);
    float2 y = elem<T>::ld2(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

// dynamic shared memory of (4) and (5): four element tiles of QT, QT, KT, KT
// rows, then f32 score tiles and nd
template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * QT + 2 * KT) * (D + elem<T>::PER16) * sizeof(T) +
         sizeof(float) * (QT * (KT + 1) + QT);
}

template <typename T, int D>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * QT + 2 * KT) * (D + elem<T>::PER16) * sizeof(T) +
         sizeof(float) * (2 * QT * (KT + 1) + KT);
}

// (4): dq for 64 queries of one (sequence, head)
template <typename T, int D>
static __global__ void __launch_bounds__(ATHREADS)
    attn_bwd_dq_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ valid_k,
                       const T* __restrict__ dor, const float* __restrict__ nd,
                       T* __restrict__ dqkv, int N, int C, int H,
                       float scale) {
  using E = elem<T>;
  constexpr int LD = D + E::PER16;
  extern __shared__ __align__(16) unsigned char attn_bwd_smem[];
  T (*Qs)[LD] = reinterpret_cast<T (*)[LD]>(attn_bwd_smem);
  T (*Ds)[LD] = Qs + QT;
  T (*Ks)[LD] = Ds + QT;
  T (*Vs)[LD] = Ks + KT;
  float (*Ts)[KT + 1] = reinterpret_cast<float (*)[KT + 1]>(Vs + KT);
  float* NDs = reinterpret_cast<float*>(Ts + QT);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const size_t pitch = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * N * pitch;
  const float* vk = valid_k + (size_t)b * N;

  load_rows<T, D, LD, QT>(Qs, base + h * D, pitch, q0, N, nullptr);
  load_rows<T, D, LD, QT>(Ds, dor + (size_t)b * N * C + h * D, C, q0, N,
                          nullptr);
  if (tid < QT)
    NDs[tid] = q0 + tid < N ? nd[((size_t)b * N + q0 + tid) * H + h] : 0.0f;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // Qs/Ds written / previous tile consumed
    load_rows<T, D, LD, KT>(Ks, base + C + h * D, pitch, k0, N, vk);  // kz
    load_rows<T, D, LD, KT>(Vs, base + 2 * C + h * D, pitch, k0, N,
                            vk);  // vz
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < KT / 4; ++jj) {
      int j = sub + 4 * jj;
      float e = round_to<T>(expf(dot_row<T, D>(Qs[r], Ks[j]) * scale));
      float dpd = dot_row<T, D>(Ds[r], Vs[j]) + NDs[r];
      Ts[r][j] = round_to<T>(e * dpd);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float t = Ts[r][j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 k = E::ld2(&Ks[j][2 * sub + 8 * i]);
        acc[2 * i] = fmaf(t, k.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(t, k.y, acc[2 * i + 1]);
      }
    }
  }
  const int n = q0 + r;
  if (n >= N) return;
  T* row = dqkv + ((size_t)b * N + n) * pitch + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    E::st2(&row[2 * sub + 8 * i], acc[2 * i] * scale, acc[2 * i + 1] * scale);
}

// (5): dk, dv for 64 keys of one (sequence, head), over all queries
template <typename T, int D>
static __global__ void __launch_bounds__(ATHREADS)
    attn_bwd_dkdv_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ valid_k,
                         const T* __restrict__ dor,
                         const float* __restrict__ nd, T* __restrict__ dqkv,
                         int N, int C, int H, float scale) {
  using E = elem<T>;
  constexpr int LD = D + E::PER16;
  extern __shared__ __align__(16) unsigned char attn_bwd_smem[];
  T (*Ks)[LD] = reinterpret_cast<T (*)[LD]>(attn_bwd_smem);
  T (*Vs)[LD] = Ks + QT;
  T (*Qs)[LD] = Vs + QT;
  T (*Ds)[LD] = Qs + KT;
  float (*Es)[KT + 1] = reinterpret_cast<float (*)[KT + 1]>(Ds + KT);
  float (*Ts)[KT + 1] = Es + QT;
  float* NDs = reinterpret_cast<float*>(Ts + QT);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * QT;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const size_t pitch = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * N * pitch;
  const float* vk = valid_k + (size_t)b * N;

  load_rows<T, D, LD, QT>(Ks, base + C + h * D, pitch, k0, N, vk);  // kz
  load_rows<T, D, LD, QT>(Vs, base + 2 * C + h * D, pitch, k0, N, vk);  // vz

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += KT) {
    __syncthreads();  // Ks/Vs written / previous tile consumed
    load_rows<T, D, LD, KT>(Qs, base + h * D, pitch, q0, N, nullptr);
    load_rows<T, D, LD, KT>(Ds, dor + (size_t)b * N * C + h * D, C, q0, N,
                            nullptr);
    if (tid < KT)
      NDs[tid] = q0 + tid < N ? nd[((size_t)b * N + q0 + tid) * H + h] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < KT / 4; ++jj) {
      int j = sub + 4 * jj;  // query within the tile
      float e = round_to<T>(expf(dot_row<T, D>(Qs[j], Ks[r]) * scale));
      float dpd = dot_row<T, D>(Ds[j], Vs[r]) + NDs[j];
      Es[r][j] = e;
      Ts[r][j] = round_to<T>(e * dpd);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float e = Es[r][j], t = Ts[r][j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 q = E::ld2(&Qs[j][2 * sub + 8 * i]);
        float2 g = E::ld2(&Ds[j][2 * sub + 8 * i]);
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
  T* row = dqkv + ((size_t)b * N + n) * pitch + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    E::st2(&row[C + 2 * sub + 8 * i], dk[2 * i] * scale * v,
           dk[2 * i + 1] * scale * v);
    E::st2(&row[2 * C + 2 * sub + 8 * i], dv[2 * i] * v, dv[2 * i + 1] * v);
  }
}

template <typename T, int D>
static cudaError_t attn_bwd_core(const T* qkv, const float* valid_k,
                                 const T* dor, const float* nd, T* dqkv,
                                 int B, int N, int C, int H, float scale,
                                 cudaStream_t s) {
  constexpr size_t dq_bytes = dq_smem<T, D>(), dkdv_bytes = dkdv_smem<T, D>();
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq_bytes)) ||
      (e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dkdv_bytes)))
    return e;
  dim3 grid((N + QT - 1) / QT, H, B);
  attn_bwd_dq_kernel<T, D><<<grid, ATHREADS, dq_bytes, s>>>(
      qkv, valid_k, dor, nd, dqkv, N, C, H, scale);
  if ((e = cudaGetLastError())) return e;
  attn_bwd_dkdv_kernel<T, D><<<grid, ATHREADS, dkdv_bytes, s>>>(
      qkv, valid_k, dor, nd, dqkv, N, C, H, scale);
  return cudaGetLastError();
}

// (3)-(5): dqkv [M, 3C] from qkv, o, r [M, H] and do [M, C]; scratch dor
// [M, C] (T) and nd [M, H] (f32). Head dims 32 and 64.
template <typename T, typename TD>
static cudaError_t attn_bwd(const TD* d_o, const T* o, const float* r,
                            const T* qkv, const float* valid_k, T* dor,
                            float* nd, T* dqkv, int B, int N, int C, int H,
                            float scale, cudaStream_t s) {
  if (H <= 0 || C % H) return cudaErrorInvalidValue;
  const int M = B * N;
  const long long threads = (long long)M * H * 32;
  attn_bwd_prep_kernel<T, TD><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 s>>>(d_o, o, r, dor, nd, M, C, H);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  switch (C / H) {
    case 32: return attn_bwd_core<T, 32>(qkv, valid_k, dor, nd, dqkv, B, N, C, H, scale, s);
    case 64: return attn_bwd_core<T, 64>(qkv, valid_k, dor, nd, dqkv, B, N, C, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
