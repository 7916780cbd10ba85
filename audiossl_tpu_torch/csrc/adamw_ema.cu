// Kernel K7: the fused AdamW + EMA-teacher update of the pretraining step,
// in place, over every student leaf in one launch.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_opt.py:150
// fused_adamw_ema_pallas (_leaf_pallas :97, call :115, math leaf_update
// :61), which streams one leaf per pallas_call through VMEM row blocks with
// the outputs aliased to the inputs, and leaves leaves under 65,536
// elements to an inline XLA path. Per element, in f32:
//   mu' = b1 mu + (1 - b1) g
//   nu' = b2 nu + (1 - b2) g^2
//   u   = (mu' rc1) / (sqrt(nu' rc2) + eps) + wd_eff p
//   p'  = p - lr u
//   t'  = m t + (1 - m) p'            (leaves the teacher holds)
// with rc1, rc2 the bias corrections of the incremented step count and
// wd_eff = wd on leaves with >= 2 dimensions, else 0.
//
// What bounds it on the H100: ~8 flops per element against 28 bytes read
// and 16 written (p, g, mu, nu, t), so bandwidth alone: the ~92 M elements
// of ATST-Frame base's student (encoder, projector, predictor) move ~3.9 GB,
// ~1.2 ms at 3.35 TB/s.
//
// Design (first, simple version): one launch for all leaves. A device table
// gives each leaf's pointers, length and weight-decay flag, and the first
// chunk of CHUNK elements that belongs to it; every block finds its leaf by
// binary search over those chunk offsets and streams one chunk with
// coalesced scalar loads, reading each state element once and writing it
// once. Small leaves share the same launch, since the math is the same.
// Vector (16-byte) loads and a persistent grid are later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;  // elements per block

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  float* t;  // nullptr when the teacher does not hold the leaf
  long long n;
  long long chunk0;  // index of the leaf's first chunk
  float wd;          // 1 where weight decay applies, else 0
  float pad;
};

struct Scalars {
  float lr, wd, m, one_minus_m, rc1, rc2, b1, one_minus_b1, b2, one_minus_b2,
      eps;
};

__global__ void __launch_bounds__(THREADS)
    adamw_ema_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                     Scalars sc) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;  // last leaf with chunk0 <= chunk
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  const Leaf L = leaves[lo];
  const long long start = (chunk - L.chunk0) * CHUNK;
  const long long end = start + CHUNK < L.n ? start + CHUNK : L.n;
  const float wd_eff = __fmul_rn(sc.wd, L.wd);
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    // the plain version's operation order, each step rounded on its own
    // (no contraction into FMAs), so the two agree bit for bit
    float p = L.p[i], g = L.g[i];
    float mu = __fadd_rn(__fmul_rn(sc.b1, L.mu[i]), __fmul_rn(sc.one_minus_b1, g));
    float nu = __fadd_rn(__fmul_rn(sc.b2, L.nu[i]),
                         __fmul_rn(sc.one_minus_b2, __fmul_rn(g, g)));
    float u = __fadd_rn(
        __fdiv_rn(__fmul_rn(mu, sc.rc1),
                  __fadd_rn(__fsqrt_rn(__fmul_rn(nu, sc.rc2)), sc.eps)),
        __fmul_rn(wd_eff, p));
    float p2 = __fsub_rn(p, __fmul_rn(sc.lr, u));
    L.p[i] = p2;
    L.mu[i] = mu;
    L.nu[i] = nu;
    if (L.t != nullptr)
      L.t[i] = __fadd_rn(__fmul_rn(sc.m, L.t[i]), __fmul_rn(sc.one_minus_m, p2));
  }
}

}  // namespace

// table: n_leaves Leaf records in device memory (the wrapper packs them);
// n_chunks = total chunks, the grid size. The scalars arrive as the f32
// values the wrapper computed, (1 - b1), (1 - b2) and (1 - m) included, so
// the kernel rounds nothing the plain version does not.
extern "C" int adamw_ema_launch(int device, const void* table, int n_leaves,
                                long long n_chunks, float lr, float wd,
                                float m, float one_minus_m, float rc1,
                                float rc2, float b1, float one_minus_b1,
                                float b2, float one_minus_b2, float eps,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 2147483647LL)
    return cudaErrorInvalidValue;
  Scalars sc{lr, wd, m, one_minus_m, rc1, rc2, b1, one_minus_b1, b2,
             one_minus_b2, eps};
  adamw_ema_kernel<<<(unsigned)n_chunks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, sc);
  return cudaGetLastError();
}
