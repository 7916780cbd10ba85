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
// What bounds it on the H100: ~20 flops per element against 16 bytes read
// and 12 written (20 and 16 where the teacher holds the leaf), so bandwidth
// alone: the ~92 M elements of ATST-Frame base's student (encoder,
// projector, predictor) move ~3.3 GB, ~0.98 ms at 3.35 TB/s.
//
// Design: one launch for all leaves, a persistent grid (as many blocks as
// fit on the SMs) walking chunks of CHUNK elements. Each leaf starts on a
// chunk of its own, so a chunk finds its leaf with one load from the
// chunk -> leaf map; the leaf's record (pointers, length, first chunk,
// decay flag) and its gradient's pointer follow. Every thread loads VECS
// float4 of each stream (p, g, mu, nu and the teacher's t) before any
// arithmetic, so 16 * 5 * VECS bytes per thread are in flight while the
// previous chunk's stores drain; a leaf whose length is not a multiple of
// 4 finishes with scalar elements in its last chunk. The table is built
// once per set of leaves and kept on the device by the wrapper
// (ops/adamw_ema.py); only the gradients' pointers change per step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS = 2;                      // float4 per thread and stream
constexpr int CHUNK = THREADS * VECS * 4;    // elements per chunk

// one leaf's record: 48 bytes, six 8-byte words (ops/adamw_ema.py packs it)
struct Leaf {
  float* p;
  float* mu;
  float* nu;
  float* t;  // nullptr when the teacher does not hold the leaf
  long long n;
  int chunk0;  // index of the leaf's first chunk
  float wd;    // 1 where weight decay applies, else 0
};
static_assert(sizeof(Leaf) == 48, "Leaf is packed by ops/adamw_ema.py");

struct Scalars {
  float lr, wd, m, one_minus_m, rc1, rc2, b1, one_minus_b1, b2, one_minus_b2,
      eps;
};

// The plain version's operation order, each step rounded on its own (no
// contraction into FMAs), so the two agree bit for bit.
__device__ __forceinline__ void update(float& p, float g, float& mu,
                                       float& nu, const Scalars& sc,
                                       float wd_eff) {
  mu = __fadd_rn(__fmul_rn(sc.b1, mu), __fmul_rn(sc.one_minus_b1, g));
  nu = __fadd_rn(__fmul_rn(sc.b2, nu),
                 __fmul_rn(sc.one_minus_b2, __fmul_rn(g, g)));
  const float u = __fadd_rn(
      __fdiv_rn(__fmul_rn(mu, sc.rc1),
                __fadd_rn(__fsqrt_rn(__fmul_rn(nu, sc.rc2)), sc.eps)),
      __fmul_rn(wd_eff, p));
  p = __fsub_rn(p, __fmul_rn(sc.lr, u));
}

__device__ __forceinline__ float ema(float t, float p, const Scalars& sc) {
  return __fadd_rn(__fmul_rn(sc.m, t), __fmul_rn(sc.one_minus_m, p));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& mu,
                                        float4& nu, const Scalars& sc,
                                        float wd_eff) {
  update(p.x, g.x, mu.x, nu.x, sc, wd_eff);
  update(p.y, g.y, mu.y, nu.y, sc, wd_eff);
  update(p.z, g.z, mu.z, nu.z, sc, wd_eff);
  update(p.w, g.w, mu.w, nu.w, sc, wd_eff);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__global__ void __launch_bounds__(THREADS)
    adamw_ema_kernel(const Leaf* __restrict__ leaves,
                     const int* __restrict__ chunk_leaf,
                     const float* const* __restrict__ grads, int n_chunks,
                     Scalars sc) {
  // the next chunk's leaf is looked up a turn ahead
  int next = blockIdx.x < n_chunks ? chunk_leaf[blockIdx.x] : 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int li = next;
    if (c + gridDim.x < n_chunks) next = chunk_leaf[c + gridDim.x];
    const Leaf L = leaves[li];
    const float* __restrict__ g = grads[li];
    float* __restrict__ pp = L.p;
    float* __restrict__ mp = L.mu;
    float* __restrict__ np = L.nu;
    float* __restrict__ tp = L.t;
    const float wd_eff = __fmul_rn(sc.wd, L.wd);
    const long long start = (long long)(c - L.chunk0) * CHUNK;
    long long e[VECS];
    float4 P[VECS], G[VECS], M[VECS], N[VECS], T[VECS];
    // every full vector's loads first
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      e[k] = start + 4LL * (threadIdx.x + k * THREADS);
      if (e[k] + 4 <= L.n) {
        P[k] = ld4(pp + e[k]);
        G[k] = ld4(g + e[k]);
        M[k] = ld4(mp + e[k]);
        N[k] = ld4(np + e[k]);
        if (tp != nullptr) T[k] = ld4(tp + e[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (e[k] + 4 <= L.n) {
        update4(P[k], G[k], M[k], N[k], sc, wd_eff);
        st4(pp + e[k], P[k]);
        st4(mp + e[k], M[k]);
        st4(np + e[k], N[k]);
        if (tp != nullptr)
          st4(tp + e[k], make_float4(ema(T[k].x, P[k].x, sc),
                                     ema(T[k].y, P[k].y, sc),
                                     ema(T[k].z, P[k].z, sc),
                                     ema(T[k].w, P[k].w, sc)));
      } else {
        // the leaf's last 1-3 elements (its length is not a multiple of 4)
        for (long long i = e[k]; i < L.n; ++i) {
          float p = pp[i], mu = mp[i], nu = np[i];
          update(p, g[i], mu, nu, sc, wd_eff);
          pp[i] = p;
          mp[i] = mu;
          np[i] = nu;
          if (tp != nullptr) tp[i] = ema(tp[i], p, sc);
        }
      }
    }
  }
}

}  // namespace

// table: n_leaves Leaf records, then the chunk -> leaf map (n_chunks int32),
// in device memory; grads: the n_leaves gradient pointers, in device memory
// (the wrapper packs both). The scalars arrive as the f32 values the
// wrapper computed, (1 - b1), (1 - b2) and (1 - m) included, so the kernel
// rounds nothing the plain version does not.
extern "C" int adamw_ema_launch(int device, const void* table,
                                const void* grads, int n_leaves,
                                int n_chunks, float lr, float wd, float m,
                                float one_minus_m, float rc1, float rc2,
                                float b1, float one_minus_b1, float b2,
                                float one_minus_b2, float eps, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n_leaves <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  // the persistent grid: as many blocks as are resident at once
  static int grid[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (grid[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, adamw_ema_kernel, THREADS, 0)))
      return e;
    grid[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const Leaf* leaves = static_cast<const Leaf*>(table);
  Scalars sc{lr, wd, m, one_minus_m, rc1, rc2, b1, one_minus_b1, b2,
             one_minus_b2, eps};
  const int blocks = n_chunks < grid[device] ? n_chunks : grid[device];
  adamw_ema_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, reinterpret_cast<const int*>(leaves + n_leaves),
      static_cast<const float* const*>(grads), n_chunks, sc);
  return cudaGetLastError();
}
