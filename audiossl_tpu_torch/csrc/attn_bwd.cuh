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
// Dynamic shared memory per block: own tiles 2, ring 2 x 2, each 64 rows of
// pitch P, and 3 x 64 floats of nd: bf16 56,064 bytes (D = 64; P = 72) and
// 31,488 (D = 32; P = 40); f32 105,216 (D = 64; P = 68) and 56,064 (D = 32;
// P = 36). The pitches keep ldmatrix and the f32 fragment loads free of
// bank conflicts.
#pragma once

#include <cstdint>

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

constexpr int BT = 64;         // rows a block owns, and rows of a walked tile
constexpr int BTHREADS = 128;  // 4 warps of 16 rows

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// acc += A B, A 16 x 16 bf16 (4 registers), B 16 x 8 (2), f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B, A 16 x 8 tf32 (4 registers), B 8 x 8 (2), f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo, hi = tf32(x) rounded to nearest, lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// acc += A B in 3xTF32: lo hi + hi lo + hi hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Warp-level products of the core, one specialization per element type. A
// warp's accumulator fragments: lane (g = lane / 4, t = lane % 4) holds, of
// each 8-column tile j, rows g and g + 8 at columns 8 j + 2 t and + 1.
template <typename T, int D>
struct mma_core;

template <int D>
struct mma_core<bf16, D> {
  static constexpr int P = D + 8;  // pitch: 16-byte rows, 4-bank row shift
  // acc[BT / 8] += A B^T over D: A the 16 rows at sA, B the BT rows at sB
  static __device__ __forceinline__ void rows_rowsT(float (&acc)[BT / 8][4],
                                                    const bf16* sA,
                                                    const bf16* sB, int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sA + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < BT / 16; ++j) {
        uint32_t b[4];
        ldsm_x4(b, sB + (j * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  // acc[D / 8] += E B over BT: E [16, BT] the accumulator fragments of
  // rows_rowsT, already rounded to bf16; B the BT rows at sB
  static __device__ __forceinline__ void frag_rows(float (&acc)[D / 8][4],
                                                   const float (&e)[BT / 8][4],
                                                   const bf16* sB, int lane) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(e[2 * kk][0], e[2 * kk][1]),
                             pack_bf16(e[2 * kk][2], e[2 * kk][3]),
                             pack_bf16(e[2 * kk + 1][0], e[2 * kk + 1][1]),
                             pack_bf16(e[2 * kk + 1][2], e[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, sB + (kk * 16 + (lane & 15)) * P + j * 16 +
                             (lane >> 4) * 8);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
};

template <int D>
struct mma_core<float, D> {
  static constexpr int P = D + 4;  // pitch: 16-byte rows, 4-bank row shift
  static __device__ __forceinline__ void rows_rowsT(float (&acc)[BT / 8][4],
                                                    const float* sA,
                                                    const float* sB,
                                                    int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      const float* a = sA + g * P + kk * 8 + t;
      split_tf32(a[0], ah[0], al[0]);
      split_tf32(a[8 * P], ah[1], al[1]);
      split_tf32(a[4], ah[2], al[2]);
      split_tf32(a[8 * P + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float* b = sB + (j * 8 + g) * P + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[4], bh[1], bl[1]);
        mma_3xtf32(acc[j], ah, al, bh, bl);
      }
    }
  }
  // k = t of step kk is row 8 kk + 2 t of B, k = t + 4 row 8 kk + 2 t + 1:
  // the order in which the accumulator fragment holds E's columns
  static __device__ __forceinline__ void frag_rows(float (&acc)[D / 8][4],
                                                   const float (&e)[BT / 8][4],
                                                   const float* sB, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(e[kk][0], ah[0], al[0]);
      split_tf32(e[kk][2], ah[1], al[1]);
      split_tf32(e[kk][1], ah[2], al[2]);
      split_tf32(e[kk][3], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float* b = sB + (kk * 8 + 2 * t) * P + j * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[P], bh[1], bl[1]);
        mma_3xtf32(acc[j], ah, al, bh, bl);
      }
    }
  }
};

// cp.async of rows [n0, n0 + BT) of one head's D columns (row pitch in
// elements) into a tile of pitch P; rows past N and, with vk, invalid rows
// are zero-filled
template <typename T, int D, int P>
__device__ __forceinline__ void tile_async(T* dst, const T* src, size_t pitch,
                                           int n0, int N, const float* vk) {
  constexpr int PER = elem<T>::PER16;
  constexpr int CH = D / PER;
  for (int c = threadIdx.x; c < BT * CH; c += BTHREADS) {
    const int row = c / CH, dc = (c % CH) * PER, n = n0 + row;
    const bool live = n < N && (vk == nullptr || vk[n] != 0.0f);
    cp_async16(dst + row * P + dc, src + (size_t)(live ? n : 0) * pitch + dc,
               live);
  }
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
