// Warp-level tensor-core parts of the two attention cores, the forward
// (attn_exp.cuh) and the backward (attn_bwd.cuh): the fragment loads, the
// bf16 and 3xTF32 mma.sync products, the two products a core is built of
// (mma_core: S = A B^T into accumulator fragments, then those fragments as
// the A operand of the next product) and the cp.async tile loads with
// zero-fill. Both cores compute their scores through the same
// mma_core<T, D>::rows_rowsT, so the forward's e and the backward's
// recomputed e come from the same products in the same order.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace attn {

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

// Warp-level products of the cores, one specialization per element type. A
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

}  // namespace attn
