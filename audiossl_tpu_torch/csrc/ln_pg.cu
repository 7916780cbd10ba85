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
// The TPU kernel sums dscale/dbias across its sequential grid; here the
// blocks run in parallel, so each writes its partial sums and a second
// small launch adds them in a fixed order (the same sums on every run;
// only the order of the f32 additions differs from the TPU's). Rows past R
// are never read, so nothing outside the rows reaches the sums (the TPU
// kernel's dead-row guard).
//
// What bounds it on the H100: 2 reads and 1 write of [R, C] (at the
// ATST-Clip small step, R = 192 * 151 rows of 384 f32: 134 MB, ~40 us at
// 3.35 TB/s), with two row reductions between the reads and the write.
//
// Design: a warp per row (two half-warps, one row each, where a row is at
// most 48 loads of 16 bytes, as at bf16 C = 384), each lane holding NPL
// 16-byte vectors of the row (4 f32 or 8 bf16; single elements where C is
// not a multiple of that, so a row's start is not 16-byte aligned), with
// shuffle-only reductions and no block barrier per row. A warp issues its
// next row's loads before this row's reductions, so one row's loads are in
// flight while the previous one computes. The grid is a few blocks an SM,
// each warp walking rows; a lane keeps its columns' dscale and dbias sums
// in registers, and the block adds its row groups' sums in shared memory
// in a fixed order before writing its partial row.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CMAX = 1024;

// V elements of T moved by one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int LPR>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// the lane's vectors sub + j * LPR of row `row` (zeros past the row or R)
template <typename T, int V, int LPR, int NPL>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ dy, int row,
                                         int R, int C, int sub,
                                         Pack<T, V> (&xr)[NPL],
                                         Pack<T, V> (&gr)[NPL]) {
  const int nvec = C / V;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int vi = sub + j * LPR;
    if (row < R && vi < nvec) {
      const size_t off = (size_t)row * C + (size_t)vi * V;
      xr[j] = *reinterpret_cast<const Pack<T, V>*>(x + off);
      gr[j] = *reinterpret_cast<const Pack<T, V>*>(dy + off);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        xr[j].v[k] = gr[j].v[k] = elem<T>::from_f(0.0f);
    }
  }
}

// LPR lanes per row, NPL vectors of V elements per lane
template <typename T, int V, int LPR, int NPL>
__global__ void __launch_bounds__(THREADS)
    ln_pg_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ scale, T* __restrict__ dx,
                     float* __restrict__ partial, int R, int C, float eps) {
  using E = elem<T>;
  constexpr int RPW = 32 / LPR;  // rows a warp takes at a time
  constexpr int GROUPS = WARPS * RPW;
  constexpr int NE = NPL * V;  // elements a lane holds
  __shared__ float s_scale[CMAX];
  __shared__ float red[2][CMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR, group = warp * RPW + lane / LPR;
  const int nvec = C / V;
  for (int c = threadIdx.x; c < C; c += THREADS) s_scale[c] = scale[c];
  __syncthreads();

  float acc_s[NE], acc_b[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) acc_s[i] = acc_b[i] = 0.0f;
  const float fc = (float)C;
  const int stride = gridDim.x * WARPS * RPW;  // rows between a warp's turns
  int row = (blockIdx.x * WARPS + warp) * RPW + lane / LPR;
  Pack<T, V> xr[NPL], gr[NPL];
  load_row<T, V, LPR, NPL>(x, dy, row, R, C, sub, xr, gr);
  // every lane of a warp runs the same turns (the shuffles need them all);
  // a half-warp whose row lies past R computes on zeros and stores nothing
  for (int first = row - lane / LPR; first < R; first += stride) {
    float xv[NE], gv[NE];
#pragma unroll
    for (int j = 0; j < NPL; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xv[j * V + k] = E::to_f(xr[j].v[k]);
        gv[j * V + k] = E::to_f(gr[j].v[k]);
      }
    // the next row's loads, before this row's reductions
    const int next = row + stride;
    load_row<T, V, LPR, NPL>(x, dy, next, R, C, sub, xr, gr);

    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      s1 += xv[i];
      s2 += xv[i] * xv[i];
    }
    group_sum2<LPR>(s1, s2);
    const float mu = s1 / fc;
    const float var = fmaxf(s2 / fc - mu * mu, 0.0f);
    const float rstd = rsqrtf(var + eps);
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = j * V + k, vi = sub + j * LPR;
        // zero past the row, where x and dy were zero-filled
        const float xhat = vi < nvec ? (xv[i] - mu) * rstd : 0.0f;
        acc_s[i] += gv[i] * xhat;
        acc_b[i] += gv[i];
        const float dxh = gv[i] * (vi < nvec ? s_scale[vi * V + k] : 0.0f);
        t1 += dxh;
        t2 += dxh * xhat;
        xv[i] = xhat;
        gv[i] = dxh;
      }
    group_sum2<LPR>(t1, t2);
    const float mean1 = t1 / fc, mean2 = t2 / fc;
    if (row < R) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int vi = sub + j * LPR;
        if (vi < nvec) {
          Pack<T, V> o;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int i = j * V + k;
            o.v[k] = E::from_f(rstd * (gv[i] - mean1 - xv[i] * mean2));
          }
          *reinterpret_cast<Pack<T, V>*>(dx + (size_t)row * C +
                                         (size_t)vi * V) = o;
        }
      }
    }
    row = next;
  }

  // the block's column sums: its row groups in turn, then one partial row
  for (int g = 0; g < GROUPS; ++g) {
    if (group == g) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int vi = sub + j * LPR;
        if (vi < nvec) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int c = vi * V + k, i = j * V + k;
            red[0][c] = g ? red[0][c] + acc_s[i] : acc_s[i];
            red[1][c] = g ? red[1][c] + acc_b[i] : acc_b[i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    out[c] = red[0][c];
    out[C + c] = red[1][c];
  }
}

// out[c] = sum over g of partial[g][c], c < n (= 2C: dscale then dbias), in
// the order g = 0, 1, ...: 32 columns a block, 8 threads a column taking
// every eighth partial row, then their 8 sums in order
__global__ void __launch_bounds__(256)
    ln_pg_colsum_kernel(const float* __restrict__ partial, int G, int n,
                        float* __restrict__ out) {
  __shared__ float sh[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < n)
    for (int g = threadIdx.y; g < G; g += 8) s += partial[(size_t)g * n + c];
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = sh[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += sh[i][threadIdx.x];
    out[c] = t;
  }
}

template <typename T, int V, int LPR, int NPL>
void launch_rows(const void* x, const void* dy, const float* scale, void* dx,
                 float* partial, int blocks, int R, int C, float eps,
                 cudaStream_t s) {
  ln_pg_bwd_kernel<T, V, LPR, NPL><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale,
      static_cast<T*>(dx), partial, R, C, eps);
}

// The instantiation for width C: 16-byte vectors where C allows them,
// single elements otherwise; half-warps for rows of at most 48 vectors;
// the fewest vectors per lane that cover the row.
template <typename T>
cudaError_t ln_pg_bwd(const void* x, const void* dy, const float* scale,
                      void* dx, float* partial, int blocks, int R, int C,
                      float eps, cudaStream_t s) {
  constexpr int VE = elem<T>::PER16;
  const auto go = [&](auto fn) {
    fn(x, dy, scale, dx, partial, blocks, R, C, eps, s);
    return cudaSuccess;
  };
  if (C % VE == 0) {
    const int nvec = C / VE;
    if (nvec <= 16) return go(launch_rows<T, VE, 16, 1>);
    if (nvec <= 32) return go(launch_rows<T, VE, 16, 2>);
    if (nvec <= 48) return go(launch_rows<T, VE, 16, 3>);
    if (nvec <= 64) return go(launch_rows<T, VE, 32, 2>);
    if (nvec <= 96) return go(launch_rows<T, VE, 32, 3>);
    if (nvec <= 128) return go(launch_rows<T, VE, 32, 4>);
    if constexpr (VE == 4) {  // f32: up to 256 vectors at C = 1024
      if (nvec <= 192) return go(launch_rows<T, VE, 32, 6>);
      return go(launch_rows<T, VE, 32, 8>);
    }
    return cudaErrorInvalidValue;
  }
  if (C <= 64) return go(launch_rows<T, 1, 32, 2>);
  if (C <= 128) return go(launch_rows<T, 1, 32, 4>);
  if (C <= 256) return go(launch_rows<T, 1, 32, 8>);
  if (C <= 512) return go(launch_rows<T, 1, 32, 16>);
  return go(launch_rows<T, 1, 32, 32>);
}

}  // namespace

// x, dy, dx [R, C] in the element type (dtype 0 = f32, 1 = bf16); scale [C]
// f32; partial [blocks, 2, C] f32 scratch, one row per block of the grid;
// dsb [2, C] f32, overwritten with dscale and dbias. C <= 1024.
extern "C" int ln_pg_bwd_launch(int device, const void* x, const void* dy,
                                const float* scale, void* dx, float* partial,
                                float* dsb, int blocks, int dtype, int R,
                                int C, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || C > CMAX || blocks <= 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  e = dtype == 0
          ? ln_pg_bwd<float>(x, dy, scale, dx, partial, blocks, R, C, eps, s)
          : ln_pg_bwd<bf16>(x, dy, scale, dx, partial, blocks, R, C, eps, s);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ln_pg_colsum_kernel<<<(2 * C + 31) / 32, dim3(32, 8), 0, s>>>(
      partial, blocks, 2 * C, dsb);
  return cudaGetLastError();
}
