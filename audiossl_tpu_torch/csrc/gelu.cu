// The erf-form GELU of the module route's MLP (models/transformer.py
// gelu_exact), forward and backward, for every f32 (and bf16 module-route)
// encoder: finetuning, probes, SED, distillation, the K6/K8 pretraining
// steps, dual, the MAE-AST comparison encoder.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the fc1 product's consumers. In eager PyTorch the same chain
// (the scale, sign, abs, reciprocal, the polynomial, exp, the products) is
// ~24 aten passes over the pre-activation u forward and ~11 backward, and
// autograd keeps three more tensors of u's size; these two kernels read u
// once and write y once, and the backward reads u and dy and writes du.
//
//   forward   y  = T(0.5 u (1 + erf(u / sqrt 2)))
//   backward  du = T(dy (0.5 (1 + erf(z)) + u exp(-z^2) / sqrt(2 pi))),
//             z = u / sqrt 2
// with the A&S 7.1.26 erf of common.cuh (erf_as: the polynomial K3's and
// K3q's GELU epilogues use, with an exact reciprocal), all arithmetic in
// f32 and the results rounded to u's type T (f32 or bf16), where the eager
// chain rounds. The backward is the exact derivative 2/sqrt(pi) exp(-z^2)
// of erf, as the eager chain's _ErfApprox gives it, not the polynomial's.
// IEEE expf (no fast-math flags). K5's half_cdf (mlp_train.cu) is not
// shared: it builds erf from exp(-u^2/2) of u, not exp(-z^2) of the
// rounded z = u / sqrt 2, so it differs from erf_as in the last bits and
// sharing it would change either K5's results or this chain's.
//
// What bounds it on the H100: bytes. Forward 8 B an element in f32 (4 in
// bf16), backward 12 B (6); at the finetuning step's fc1 pre-activation
// [19,328, 3,072] f32 (237 MB) that is 0.142 ms forward and 0.213 ms
// backward at 3.35 TB/s, against ~50 f32 instructions an element.
//
// Design: one read and one write per tensor. Each thread moves 16 bytes
// a load (4 f32 or 8 bf16) in a grid-stride loop over a grid of as many
// blocks as the card holds at once, and a scalar tail takes the last n mod
// 4 (or 8) elements. The wrapper (ops/gelu.py) hands contiguous, 16-byte
// aligned tensors and at most 2^30 elements a launch.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu_of(float u) {
  return (0.5f * u) * (1.0f + erf_as(u * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad_of(float u, float dy) {
  const float z = u * kInvSqrt2;
  return dy * (0.5f * (1.0f + erf_as(z)) + u * kInvSqrt2Pi * expf(-z * z));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gelu_erf_fwd_kernel(const T* __restrict__ u, T* __restrict__ y,
                        size_t n) {
  constexpr int V = elem<T>::PER16;
  const size_t tid = blockIdx.x * (size_t)THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t nv = n / V;
  for (size_t i = tid; i < nv; i += stride) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(u) + i);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      e[j] = elem<T>::from_f(gelu_of(elem<T>::to_f(e[j])));
    reinterpret_cast<uint4*>(y)[i] = v;
  }
  for (size_t i = nv * V + tid; i < n; i += stride)
    y[i] = elem<T>::from_f(gelu_of(elem<T>::to_f(u[i])));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gelu_erf_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dy,
                        T* __restrict__ du, size_t n) {
  constexpr int V = elem<T>::PER16;
  const size_t tid = blockIdx.x * (size_t)THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t nv = n / V;
  for (size_t i = tid; i < nv; i += stride) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(u) + i);
    const uint4 g = __ldg(reinterpret_cast<const uint4*>(dy) + i);
    T* e = reinterpret_cast<T*>(&v);
    const T* ge = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int j = 0; j < V; ++j)
      e[j] = elem<T>::from_f(
          gelu_grad_of(elem<T>::to_f(e[j]), elem<T>::to_f(ge[j])));
    reinterpret_cast<uint4*>(du)[i] = v;
  }
  for (size_t i = nv * V + tid; i < n; i += stride)
    du[i] = elem<T>::from_f(
        gelu_grad_of(elem<T>::to_f(u[i]), elem<T>::to_f(dy[i])));
}

// Blocks for n elements of T: one 16-byte vector a thread, at most as many
// blocks as the card keeps resident at once (the grid-stride loop takes
// the rest), so no second wave runs on a part of the SMs alone.
template <typename T, typename Kernel>
cudaError_t grid_blocks(Kernel kernel, int device, int n, int* blocks) {
  static int per_sm = 0;  // depends on the kernel and the architecture
  cudaError_t e;
  if (per_sm <= 0) {
    int k = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &k, kernel, THREADS, 0)) != cudaSuccess)
      return e;
    per_sm = k;
  }
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return e;
  const int vectors = n / elem<T>::PER16;
  const int need = std::max(1, (vectors + THREADS - 1) / THREADS);
  *blocks = std::min(need, std::max(1, sms * per_sm));
  return cudaSuccess;
}

template <typename T>
cudaError_t gelu_fwd(int device, const void* u, void* y, int n,
                     cudaStream_t s) {
  int blocks;
  cudaError_t e = grid_blocks<T>(gelu_erf_fwd_kernel<T>, device, n, &blocks);
  if (e != cudaSuccess) return e;
  gelu_erf_fwd_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<T*>(y), (size_t)n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gelu_bwd(int device, const void* u, const void* dy, void* du,
                     int n, cudaStream_t s) {
  int blocks;
  cudaError_t e = grid_blocks<T>(gelu_erf_bwd_kernel<T>, device, n, &blocks);
  if (e != cudaSuccess) return e;
  gelu_erf_bwd_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dy),
      static_cast<T*>(du), (size_t)n);
  return cudaGetLastError();
}

}  // namespace

// u [n] -> y [n], both of one type: dtype 0 f32, 1 bf16
extern "C" int gelu_fwd_launch(int device, const void* u, void* y, int n,
                               int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? gelu_fwd<float>(device, u, y, n, s)
                    : gelu_fwd<bf16>(device, u, y, n, s);
}

// u, dy [n] -> du [n], all of one type: dtype 0 f32, 1 bf16
extern "C" int gelu_bwd_launch(int device, const void* u, const void* dy,
                               void* du, int n, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? gelu_bwd<float>(device, u, dy, du, n, s)
                    : gelu_bwd<bf16>(device, u, dy, du, n, s);
}
