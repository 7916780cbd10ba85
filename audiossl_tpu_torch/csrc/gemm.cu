// The GEMM templates alone, for holding them against a reference at the
// block kernels' shapes (audiossl_tpu_torch/ops/gemm.py). No TPU kernel
// corresponds to them and no main path calls them.
//
// gemm_bf16_launch, the bf16 template of gemm_bf16.cuh:
// layout: 0  forward      C = A B^T, A [M, K], B [N, K]   (A_K, B_K)
//         1  dx           C = A B,   A [M, K], B [K, N]   (A_K, !B_K)
//         2  weight_grad  C = A^T B, A [K, M], B [K, N]   (!A_K, !B_K)
// epi:    0  EpiStoreF32 into f32 out [M, N]
//         1  EpiAtomicAdd into a zeroed f32 out [M, N] over `splits` K
//            splits; splits = 0 with the weight_grad layout takes the block
//            kernels' own choice (gemm_bf16_weight_grad)
//         2  EpiBias into bf16 out [M, N] with f32 bias [N]
//
// gemm_s8_launch, the int8 template of gemm_s8.cuh: C = deq(A B^T), A [M, K]
// and B [N, K] int8 codes, ra [M] and sb [N] f32 scales;
// epi:    0  EpiStoreF32 into f32 out [M, N]
//         1  EpiBias into bf16 out [M, N] with f32 bias [N]
//
// rcp_check_launch counts the floats x in [1, 2^126] and +inf where the
// epilogues' reciprocal (common.cuh rcp_ge1) differs from 1.0f / x.
#include <cstdint>

#include "common.cuh"
#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"

namespace {

__global__ void rcp_check_kernel(uint32_t lo, uint32_t hi,
                                 unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (uint64_t b = lo + blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       b <= hi; b += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(b));
    bad += __float_as_uint(1.0f / x) != __float_as_uint(rcp_ge1(x));
  }
  if (bad) atomicAdd(mismatches, bad);
}

template <class Epi>
cudaError_t run(int layout, const bf16* A, const bf16* B, int M, int N,
                int K, Epi epi, cudaStream_t s, int splits) {
  switch (layout) {
    case 0:
      return gemm::gemm_bf16<true, true>(A, B, M, N, K, epi, s, splits);
    case 1:
      return gemm::gemm_bf16<true, false>(A, B, M, N, K, epi, s, splits);
    case 2:
      return gemm::gemm_bf16<false, false>(A, B, M, N, K, epi, s, splits);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gemm_bf16_launch(int device, const void* a, const void* b,
                                void* out, const float* bias, int M, int N,
                                int K, int layout, int epi, int splits,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  switch (epi) {
    case 0:
      return run(layout, A, B, M, N, K,
                 gemm::EpiStoreF32{static_cast<float*>(out), N}, s, 1);
    case 1:
      if (layout == 2 && splits == 0)
        return gemm::gemm_bf16_weight_grad(A, B, K, M, N,
                                           static_cast<float*>(out), s);
      return run(layout, A, B, M, N, K,
                 gemm::EpiAtomicAdd{static_cast<float*>(out), N}, s, splits);
    case 2:
      return run(layout, A, B, M, N, K,
                 gemm::EpiBias{static_cast<bf16*>(out), bias, N}, s, 1);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int gemm_s8_launch(int device, const void* a, const void* b,
                              const float* ra, const float* sb, void* out,
                              const float* bias, int M, int N, int K, int epi,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case 0:
      return gemm::gemm_s8(a, b, ra, sb, M, N, K,
                           gemm::EpiStoreF32{static_cast<float*>(out), N}, s);
    case 1:
      return gemm::gemm_s8(a, b, ra, sb, M, N, K,
                           gemm::EpiBias{static_cast<bf16*>(out), bias, N}, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// mismatches: one zeroed u64 on the device
extern "C" int rcp_check_launch(int device, void* mismatches, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* out = static_cast<unsigned long long*>(mismatches);
  rcp_check_kernel<<<132 * 16, 256, 0, s>>>(0x3f800000u, 0x7e800000u, out);
  if ((e = cudaGetLastError())) return e;
  rcp_check_kernel<<<1, 32, 0, s>>>(0x7f800000u, 0x7f800000u, out);  // +inf
  return cudaGetLastError();
}
