// Backward of the exp-only attention of attn_exp.cuh, shared by the
// trainable attention half (attn_train.cu, K4 and its int8dx variant K4q)
// and the standalone MHA (mha.cu, K6). Templated on the element type T of
// qkv, o, dor and dqkv (bf16 or f32) and on the type TD of the incoming
// gradient do (K4: the f32 product dyb W_proj; K6: T).
//
// Replaces the attention part of the TPU kernels' backward,
// audiossl_tpu/ops/pallas_attn.py:_bwd_impl (products :186-211) and
// pallas_mha.py:_bwd_head (:102-143), with every rounding point:
//  (3) per row and head: delta = sum T(do * o), dor = T(do * r),
//      nd = T(-delta * r)
//  (4) per (sequence, head, 64-query block), walking 64-key tiles:
//      e = T(exp(q kz^T * scale)) recomputed, dpd = dor vz^T + nd (nd added
//      inside the f32 sum: the accumulator starts from it, as JAX appends
//      it as a contraction column), t = T(e * dpd), dq = T(t kz * scale)
//  (5) per (sequence, head, 64-key block), walking 64-query tiles: the same
//      e^T and t^T, dk = T(t^T q * scale * valid), dv = T(e^T dor * valid)
// where kz and vz are k and v with invalid keys zeroed (valid_k is 0/1: the
// wrappers build it from a comparison). Rows past N load as zeros, never
// skipped: an all-zero q or dor row gives t = 0 and adds nothing, an
// all-zero kz or vz row adds nothing to dq. Two passes, each recomputing e
// and t (14 D instead of 10 D flops per pair), so that no block reduces
// across blocks: no atomics, no f32 scratch, bit-reproducible gradients.
//
// What bounds it on the H100: at [192, 250, 768], 12 heads, the two passes
// do ~130 GFLOP of [N, N] x D products against ~0.6 GB of operands, far
// above the ridge point: the tensor cores bound it, 0.13 ms in bf16 at 989
// TFLOP/s; f32-accurate products as three TF32 passes at 495 TFLOP/s,
// 0.8 ms.
//
// Design: (4) and (5) are one kernel template (KEYS false / true). A block
// of 4 warps owns 64 rows (16 per warp) of q and dor (4) or kz and vz (5),
// and walks tiles of 64 rows of the other two, loaded with cp.async into a
// two-stage ring (zero-filled past N and, for key tiles, for invalid keys).
// Each warp computes its 16 x 64 scores S (S^T in (5)) and dP (dP^T) on the
// tensor cores into registers, rounds e and t there, and uses those
// accumulator fragments directly as the A operands of dq += t kz (dv += e^T
// dor and dk += t^T q): the FlashAttention-2 backward layout.
//  bf16: mma.sync.m16n8k16 bf16 with f32 accumulation, operands from shared
//    memory by ldmatrix (ldmatrix.trans for the [k][n] tiles of the second
//    products). mma.sync, not wgmma: the accumulator fragment of one
//    m16n8k16 product is the A fragment of the next, so e and t are rounded
//    to bf16 exactly where the A operand must become bf16 and never leave
//    registers; wgmma would need warpgroup-wide 64-row products per warp
//    group and swizzled shared-memory B tiles (later work).
//  f32: 3xTF32 on mma.sync.m16n8k8: each operand x splits into hi =
//    tf32(x) (cvt.rna) and lo = tf32(x - hi), each product is hi hi + hi lo
//    + lo hi with f32 accumulation: ~1e-6 relative, within the f32 contract
//    (one TF32 pass, ~1e-3, would not be). The k order of the second
//    products is permuted within each 8-wide step (k = t <-> row 2t, k = t
//    + 4 <-> row 2t + 1), so that the f32 accumulator fragment is the A
//    fragment as it stands; the B loads follow the same order.
// These warp-level products and the tile loads (attn_mma.cuh) are the
// forward core's as well (attn_exp.cuh), so e is recomputed from the same
// products in the same order as the forward formed it.
// Dynamic shared memory per block: own tiles 2, ring 2 x 2, each 64 rows of
// pitch P, and 3 x 64 floats of nd: bf16 56,064 bytes (D = 64; P = 72) and
// 31,488 (D = 32; P = 40); f32 105,216 (D = 64; P = 68) and 56,064 (D = 32;
// P = 36). The pitches keep ldmatrix and the f32 fragment loads free of
// bank conflicts.
#pragma once

#include <cstdint>

#include "attn_mma.cuh"
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

template <typename T, int D>
constexpr size_t core_smem() {
  return 6 * (size_t)BT * mma_core<T, D>::P * sizeof(T) +
         3 * BT * sizeof(float);
}

// (4) with KEYS false: dq of 64 queries; (5) with KEYS true: dk, dv of 64
// keys. The block's own tiles are q, dor (4) or kz, vz (5); it walks tiles
// of kz, vz (4) or q, dor (5).
template <typename T, int D, bool KEYS>
static __global__ void __launch_bounds__(BTHREADS)
    attn_bwd_mma_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ valid_k,
                        const T* __restrict__ dor, const float* __restrict__ nd,
                        T* __restrict__ dqkv, int N, int C, int H,
                        float scale) {
  using MC = mma_core<T, D>;
  constexpr int P = MC::P, TILE = BT * P;
  extern __shared__ __align__(16) unsigned char attn_bwd_smem[];
  T* own = reinterpret_cast<T*>(attn_bwd_smem);  // [2][BT][P]
  T* ring = own + 2 * TILE;                      // [2 stages][2][BT][P]
  // nd of the own rows (4), then of each stage's rows (5)
  float* nds = reinterpret_cast<float*>(ring + 4 * TILE);

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t pitch = 3 * (size_t)C;
  const T* q = qkv + (size_t)b * N * pitch + h * D;
  const T* dr = dor + (size_t)b * N * C + h * D;
  const float* vk = valid_k + (size_t)b * N;
  const float* ndb = nd + (size_t)b * N * H + h;  // row n at ndb[n * H]
  const T* own0 = KEYS ? q + C : q;
  const T* own1 = KEYS ? q + 2 * C : dr;
  const T* walk0 = KEYS ? q : q + C;
  const T* walk1 = KEYS ? dr : q + 2 * C;
  const size_t po1 = KEYS ? pitch : C, pw1 = KEYS ? C : pitch;
  const float* vown = KEYS ? vk : nullptr;
  const float* vwalk = KEYS ? nullptr : vk;

  auto issue = [&](int tile) {
    const int n0 = tile * BT;
    T* st = ring + (tile & 1) * 2 * TILE;
    tile_async<T, D, P>(st, walk0, pitch, n0, N, vwalk);
    tile_async<T, D, P>(st + TILE, walk1, pw1, n0, N, vwalk);
    if (KEYS && threadIdx.x < BT) {
      const int n = n0 + threadIdx.x;
      nds[BT + (tile & 1) * BT + threadIdx.x] =
          n < N ? ndb[(size_t)n * H] : 0.0f;
    }
  };
  tile_async<T, D, P>(own, own0, pitch, r0, N, vown);
  tile_async<T, D, P>(own + TILE, own1, po1, r0, N, vown);
  if (!KEYS && threadIdx.x < BT) {
    const int n = r0 + threadIdx.x;
    nds[threadIdx.x] = n < N ? ndb[(size_t)n * H] : 0.0f;
  }
  issue(0);
  cp_async_commit();

  float acc0[D / 8][4], acc1[D / 8][4];  // dq | dk, dv
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[j][i] = acc1[j][i] = 0.0f;

  const T* sa0 = own + warp * 16 * P;
  const T* sa1 = sa0 + TILE;
  const int tiles = (N + BT - 1) / BT;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and the own tiles) landed
    const T* s0 = ring + (it & 1) * 2 * TILE;
    const T* s1 = s0 + TILE;
    const float* ns = nds + BT + (it & 1) * BT;
    float s[BT / 8][4], p[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      if (KEYS) {  // columns are queries
        p[j][0] = p[j][2] = ns[8 * j + 2 * t];
        p[j][1] = p[j][3] = ns[8 * j + 2 * t + 1];
      } else {  // rows are queries
        p[j][0] = p[j][1] = nds[warp * 16 + g];
        p[j][2] = p[j][3] = nds[warp * 16 + g + 8];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
    }
    MC::rows_rowsT(s, sa0, s0, lane);  // S = q kz^T (S^T = kz q^T)
    MC::rows_rowsT(p, sa1, s1, lane);  // dpd = dor vz^T + nd (transposed)
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = round_to<T>(expf(s[j][i] * scale));
        s[j][i] = e;
        p[j][i] = round_to<T>(e * p[j][i]);  // t
      }
    if (KEYS) {
      MC::frag_rows(acc1, s, s1, lane);  // dv += e^T dor
      MC::frag_rows(acc0, p, s0, lane);  // dk += t^T q
    } else {
      MC::frag_rows(acc0, p, s0, lane);  // dq += t kz
    }
    __syncthreads();  // stage it & 1 consumed before it is loaded again
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = r0 + warp * 16 + g + 8 * half;
    if (n >= N) continue;
    T* row = dqkv + ((size_t)b * N + n) * pitch + h * D + 2 * t;
    const float v = KEYS ? vk[n] : 1.0f;  // invalid keys get dk = dv = 0
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float* a = &acc0[j][2 * half];
      if (KEYS) {
        const float* c = &acc1[j][2 * half];
        elem<T>::st2(row + C + 8 * j, a[0] * scale * v, a[1] * scale * v);
        elem<T>::st2(row + 2 * C + 8 * j, c[0] * v, c[1] * v);
      } else {
        elem<T>::st2(row + 8 * j, a[0] * scale, a[1] * scale);
      }
    }
  }
}

template <typename T, int D>
static cudaError_t attn_bwd_core(const T* qkv, const float* valid_k,
                                 const T* dor, const float* nd, T* dqkv,
                                 int B, int N, int C, int H, float scale,
                                 cudaStream_t s) {
  constexpr size_t bytes = core_smem<T, D>();
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(attn_bwd_mma_kernel<T, D, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes)) ||
      (e = cudaFuncSetAttribute(attn_bwd_mma_kernel<T, D, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes)))
    return e;
  dim3 grid((N + BT - 1) / BT, H, B);
  attn_bwd_mma_kernel<T, D, false><<<grid, BTHREADS, bytes, s>>>(
      qkv, valid_k, dor, nd, dqkv, N, C, H, scale);
  if ((e = cudaGetLastError())) return e;
  attn_bwd_mma_kernel<T, D, true><<<grid, BTHREADS, bytes, s>>>(
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
