// Exp-only softmax attention over the packed [M, 3C] qkv buffer, shared by
// the inference (attn_block.cu, K2 and K2q) and training (attn_train.cu, K4
// and K4q) attention halves and the standalone MHA (mha.cu, K6). Templated
// on the element type T of qkv: bf16 (K2, K4, K6) or f32 (K6), and on the
// output type TO: T, or f32 for K2q, which quantizes the unrounded o.
//
// Replaces the attention of the TPU kernels: audiossl_tpu/ops/
// pallas_mha.py:_fwd_kernel (:78-99), pallas_block.py:_attn_core
// (:107-150) and pallas_attn.py:_fwd_body (:60-80). Per (sequence, head):
// s = q kz^T * scale accumulated in f32, e = T(exp(s)) -- no max
// subtraction, so partial sums over key tiles simply add --, o = TO(sum e vz
// * r) with r = 1 / (den + 1e-30) and den = sum e valid_v, the same rounded
// e summed in f32. kz is k zeroed by valid_k, vz is v zeroed by valid_v.
// K2/K4's wrappers set valid_v to all ones for a sequence with no valid key
// (uniform attention over its N keys); K6 passes valid_v = valid_k, so such
// a sequence gets den = 0 and o = 0. Keys past N load as zeros with
// valid_v = 0: e = 1 there, and they add nothing to o or den. With r !=
// nullptr, r [M, H] (f32) is written: the residual the backward reads.
//
// What bounds it on the H100: at [192, 250, 3 * 768], 12 heads, the two
// products are 37 GFLOP against 295 MB of bf16 qkv and o: 0.04 ms at the
// bf16 tensor-core peak, 0.09 ms of bytes, plus 144 M accurate expf, so the
// bytes bound it. In f32 the products run as three TF32 passes (0.22 ms at
// 495 TFLOP/s) against 590 MB (0.18 ms).
//
// Design: the layout of the backward core's dq pass (attn_bwd.cuh), with
// the same warp-level parts (attn_mma.cuh). A block of 4 warps owns 64
// queries, 16 per warp, and walks 64-key tiles of kz and vz, loaded by
// cp.async into a ring (FWD_STAGES): the kz tile zero-filled by valid_k, the
// vz tile by valid_v, both past N; the tile's 64 valid_v values are staged
// in shared memory beside it. Per tile and warp:
//  S = q kz^T through mma_core::rows_rowsT into accumulator fragments (the
//    backward recomputes e from the same products in the same order);
//  e = T(expf(S * scale)) in registers (accurate expf, as the backward);
//  den += e * valid_v, each lane over its columns (a quad's four lanes
//    hold one row; a __shfl_xor over 1 and 2 completes it at the end);
//  o += e vz through mma_core::frag_rows, whose A operand is the e
//    fragment as it stands: in bf16 packed to bf16 exactly where JAX rounds
//    e, in f32 split into TF32 halves.
//  bf16: mma.sync m16n8k16 with f32 accumulation, operands by ldmatrix.
//  f32: 3xTF32 on mma.sync m16n8k8 (hi hi + hi lo + lo hi, ~1e-6 relative;
//    one TF32 pass, ~1e-3, would break the f32 contract), with the
//    k-permutation of frag_rows<float> for e vz.
// Neither the score tile nor e ever touches shared memory: one
// __syncthreads pair per 64-key tile. mma.sync rather than wgmma for the
// reason the backward gives: the accumulator fragment of S is the A
// fragment of e vz.
// Dynamic shared memory per block (cudaFuncSetAttribute): the q tile and
// the ring's kz and vz tiles, each 64 rows of pitch P, and 64 floats of
// valid_v per stage: bf16 (two stages) 26,112 bytes (D = 32; P = 40),
// 46,592 (D = 64; P = 72) and 87,552 (D = 128; P = 136); f32 (one stage)
// 27,904 (D = 32; P = 36) and 52,480 (D = 64; P = 68).
#pragma once

#include <cstdint>

#include "attn_mma.cuh"
#include "common.cuh"

namespace attn {

// Stages of the key-tile ring: f32 one (three tiles, 52 KB at D = 64: four
// blocks per SM, where two stages' 87 KB allowed two and ran slower on the
// H100), bf16 two (registers hold it to four blocks per SM either way).
template <typename T>
constexpr int FWD_STAGES = sizeof(T) == 4 ? 1 : 2;

template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int S = FWD_STAGES<T>;
  return (1 + 2 * S) * (size_t)BT * mma_core<T, D>::P * sizeof(T) +
         S * BT * sizeof(float);
}

template <typename T, int D, typename TO>
static __global__ void __launch_bounds__(BTHREADS)
    attn_fwd_mma_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ valid_k,
                        const float* __restrict__ valid_v,
                        TO* __restrict__ o, float* __restrict__ r_out, int N,
                        int C, int H, float scale) {
  using MC = mma_core<T, D>;
  constexpr int P = MC::P, TILE = BT * P, S = FWD_STAGES<T>;
  extern __shared__ __align__(16) unsigned char attn_fwd_smem[];
  T* qs = reinterpret_cast<T*>(attn_fwd_smem);  // [BT][P]
  T* ring = qs + TILE;                          // [S stages][kz, vz][BT][P]
  float* vvs = reinterpret_cast<float*>(ring + 2 * S * TILE);  // [S][BT]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t pitch = 3 * (size_t)C;
  const T* q = qkv + (size_t)b * N * pitch + h * D;
  const float* vk = valid_k + (size_t)b * N;
  const float* vv = valid_v + (size_t)b * N;

  auto issue = [&](int tile) {
    const int n0 = tile * BT;
    T* st = ring + (tile % S) * 2 * TILE;
    tile_async<T, D, P>(st, q + C, pitch, n0, N, vk);
    tile_async<T, D, P>(st + TILE, q + 2 * C, pitch, n0, N, vv);
    if (threadIdx.x < BT) {
      const int n = n0 + threadIdx.x;
      vvs[(tile % S) * BT + threadIdx.x] = n < N ? vv[n] : 0.0f;
    }
  };
  const int tiles = (N + BT - 1) / BT;
  tile_async<T, D, P>(qs, q, pitch, q0, N, nullptr);
  for (int it = 0; it < S - 1 && it < tiles; ++it) issue(it);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  float den[2] = {0.0f, 0.0f};  // rows g and g + 8, this lane's columns

  const T* sq = qs + warp * 16 * P;
  for (int it = 0; it < tiles; ++it) {
    if (it + S - 1 < tiles) issue(it + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();  // tile it (and the q tile) landed
    const T* sk = ring + (it % S) * 2 * TILE;
    const float* vs = vvs + (it % S) * BT;
    float s[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
    MC::rows_rowsT(s, sq, sk, lane);  // S = q kz^T
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const float v0 = vs[8 * j + 2 * t], v1 = vs[8 * j + 2 * t + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = round_to<T>(expf(s[j][i] * scale));
      den[0] = fmaf(s[j][1], v1, fmaf(s[j][0], v0, den[0]));
      den[1] = fmaf(s[j][3], v1, fmaf(s[j][2], v0, den[1]));
    }
    MC::frag_rows(acc, s, sk + TILE, lane);  // o += e vz
    __syncthreads();  // stage it % S consumed before it is loaded again
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 1);
    den[half] += __shfl_xor_sync(0xffffffffu, den[half], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + warp * 16 + g + 8 * half;
    if (n >= N) continue;
    const float rden = 1.0f / (den[half] + 1e-30f);
    if (r_out != nullptr && t == 0) r_out[((size_t)b * N + n) * H + h] = rden;
    TO* row = o + ((size_t)b * N + n) * C + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      elem<TO>::st2(row + 8 * j, acc[j][2 * half] * rden,
                    acc[j][2 * half + 1] * rden);
  }
}

template <typename T, int D, typename TO>
static cudaError_t attn_exp_d(const T* qkv, const float* valid_k,
                              const float* valid_v, TO* o, float* r, int B,
                              int N, int C, int H, float scale,
                              cudaStream_t s) {
  constexpr size_t bytes = fwd_smem<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_mma_kernel<T, D, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e) return e;
  dim3 grid((N + BT - 1) / BT, H, B);
  attn_fwd_mma_kernel<T, D, TO><<<grid, BTHREADS, bytes, s>>>(
      qkv, valid_k, valid_v, o, r, N, C, H, scale);
  return cudaGetLastError();
}

// Dispatch on the head dimension C / H: 32, 64 or (bf16 only: K2's
// wrapper takes it, no f32 caller does) 128.
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
