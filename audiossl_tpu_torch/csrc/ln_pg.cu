// Kernel K8: the single-pass LayerNorm backward of LayerNormPG, for the
// norms of an f32 (or bf16) encoder's blocks and its final norm.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_ln.py:132 layer_norm's
// backward (_bwd_pallas :84, call :95; per row block _bwd_kernel :57 and
// _bwd_block :42): one streaming pass over (x, dy) that recomputes the f32
// statistics with the forward's fast variance, max(mean(x^2) - mu^2, 0),
// and gives
//   xhat = (x - mu) * rstd, dxh = dy * scale,
//   dx = T(rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))),
//   dscale = sum dy * xhat, dbias = sum dy   (f32, over all rows)
// The TPU kernel sums dscale/dbias across its sequential grid; here blocks
// of rows run in parallel, each keeps its columns' sums in registers and
// adds them once into the zeroed f32 outputs by atomicAdd (only the order
// of the f32 additions differs). Rows past R are never read, so nothing
// outside the rows reaches the sums (the TPU kernel's dead-row guard).
//
// What bounds it on the H100: 2 reads and 1 write of [R, C] (at the ATST-Clip
// small step, R = 192 * 151 rows of 384 f32: 134 MB, ~40 us at 3.35 TB/s)
// and two block reductions per row; one block of 128 threads spans a row
// (CPT columns each) and walks 64 rows.
#include "common.cuh"
#include "train_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 64;  // rows per block

template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
    ln_pg_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ scale, T* __restrict__ dx,
                     float* __restrict__ dscale, float* __restrict__ dbias,
                     int R, int C, float eps) {
  using E = elem<T>;
  __shared__ float2 sh[THREADS / 32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * ROWS, m1 = min(R, m0 + ROWS);
  float acc_s[CPT], acc_b[CPT], sc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int c = tid + i * THREADS;
    acc_s[i] = acc_b[i] = 0.0f;
    sc[i] = c < C ? scale[c] : 0.0f;
  }
  const float fc = (float)C;
  for (int m = m0; m < m1; ++m) {
    const size_t row = (size_t)m * C;
    float xv[CPT], g[CPT];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * THREADS;
      xv[i] = c < C ? E::to_f(x[row + c]) : 0.0f;
      g[i] = c < C ? E::to_f(dy[row + c]) : 0.0f;
      s1 += xv[i];
      s2 += xv[i] * xv[i];
    }
    const float2 st = train::block_sum2(s1, s2, sh);
    const float mu = st.x / fc;
    const float var = fmaxf(st.y / fc - mu * mu, 0.0f);
    const float rstd = rsqrtf(var + eps);
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * THREADS;
      float xhat = c < C ? (xv[i] - mu) * rstd : 0.0f;
      acc_s[i] += g[i] * xhat;
      acc_b[i] += g[i];
      float dxh = g[i] * sc[i];
      t1 += dxh;
      t2 += dxh * xhat;
      xv[i] = xhat;
      g[i] = dxh;
    }
    const float2 mm = train::block_sum2(t1, t2, sh);
    const float mean1 = mm.x / fc, mean2 = mm.y / fc;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      int c = tid + i * THREADS;
      if (c < C)
        dx[row + c] = E::from_f(rstd * (g[i] - mean1 - xv[i] * mean2));
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int c = tid + i * THREADS;
    if (c < C) {
      atomicAdd(&dscale[c], acc_s[i]);
      atomicAdd(&dbias[c], acc_b[i]);
    }
  }
}

template <typename T>
cudaError_t ln_pg_bwd(const void* x, const void* dy, const float* scale,
                      void* dx, float* dscale, float* dbias, int R, int C,
                      float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int blocks = (R + ROWS - 1) / ROWS;
#define LN_PG_LAUNCH(CPT)                                                 \
  ln_pg_bwd_kernel<T, CPT><<<blocks, THREADS, 0, s>>>(xt, gt, scale, dxt, \
                                                      dscale, dbias, R, C, eps)
  if (C <= 1 * THREADS) LN_PG_LAUNCH(1);
  else if (C <= 2 * THREADS) LN_PG_LAUNCH(2);
  else if (C <= 3 * THREADS) LN_PG_LAUNCH(3);
  else if (C <= 4 * THREADS) LN_PG_LAUNCH(4);
  else if (C <= 6 * THREADS) LN_PG_LAUNCH(6);
  else if (C <= 8 * THREADS) LN_PG_LAUNCH(8);
  else return cudaErrorInvalidValue;
#undef LN_PG_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [R, C] in the element type (dtype 0 = f32, 1 = bf16); scale [C]
// f32; dscale, dbias [C] f32, overwritten. C <= 1024.
extern "C" int ln_pg_bwd_launch(int device, const void* x, const void* dy,
                                const float* scale, void* dx, float* dscale,
                                float* dbias, int dtype, int R, int C,
                                float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((e = cudaMemsetAsync(dscale, 0, sizeof(float) * C, s)) ||
      (e = cudaMemsetAsync(dbias, 0, sizeof(float) * C, s)))
    return e;
  return dtype == 0 ? ln_pg_bwd<float>(x, dy, scale, dx, dscale, dbias, R, C,
                                       eps, s)
                    : ln_pg_bwd<bf16>(x, dy, scale, dx, dscale, dbias, R, C,
                                      eps, s);
}
