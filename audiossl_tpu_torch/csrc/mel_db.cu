// Kernel K1: |STFT|^2 -> mel filterbank -> dB, the post-STFT half of the
// log-mel front end.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_mel.py:39 stft_to_mel_db
// (_mel_db_kernel :28), which per (clip, 256-frame tile) squares the
// real/imag STFT in VMEM, multiplies by the dense [n_mels, F] filterbank
// on the MXU and takes 10*log10(max(mel, amin)).
//
// What bounds it on the H100: the recipe's filterbank (HTK triangles, 513
// bins, 64 mels) holds 970 non-zeros of 32,832: each mel is one contiguous
// run of 4-39 bins and no bin feeds more than 2 mels. Done band-sparse, a
// frame needs ~5 kFLOP against the 4.1 KB of f32 STFT it reads and the
// 256 bytes of mel it writes: a pure streaming pass, bound by device-memory
// bandwidth (3.35 TB/s). The [B, F, T] power array never reaches device
// memory.
//
// Design. The wrapper (ops/mel_db.py) turns the filterbank into a band
// table once: each mel's band from its first to its last non-zero bin
// (zeros inside a band kept, so the table gives the filterbank back
// exactly), flattened into one list of (bin, weight) pairs, mel after mel,
// a flag on each band's last pair; the mels are cut into groups of about
// the same number of pairs, so that at 8 clips the grid (group, frame
// tile, clip) covers the 132 SMs several times. A block owns NF * TT
// frames of one clip and one group; a thread owns NF frames TT apart, so
// every warp reads 128 contiguous bytes of an STFT row at a time. A thread
// walks its group's pairs in turns of U: it issues the turn's 2 * U * NF
// loads (real and imaginary values of each frame) before any arithmetic
// (96 bytes a thread: ~96 KB in flight an SM at 8 blocks an SM),
// then adds fmaf(w, re^2 + im^2, acc) in pair order -- ascending bins
// within a mel -- into one register a frame, and writes a mel's dB
// (coalesced along T) where its band ends. Every index into the turn's
// registers is a compile-time constant. On finite inputs the band sum is
// the dense sum less terms that are +0 (weights and powers are >= 0). A
// bin shared by two mels is loaded twice, the second time from L1 or L2
// (a ring of powers in shared memory that read it once measured slower:
// its reads sat on the accumulation's chain). The table is read by uniform
// (warp-broadcast) loads. The row pitch (T = 1001: 4,004 bytes) starts no
// row on a 16-byte boundary, which rules out float4 loads and TMA; the
// loads are 4-byte and coalesced. Ragged T is masked per frame; nothing is
// padded. logf (1 ulp) keeps the dB at the plain version's, at 64 logs a
// frame against ~1,900 loads.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 128;  // threads a block
constexpr int NF = 2;    // frames a thread, TT apart
constexpr int U = 6;     // pairs a turn
constexpr int BIN_MASK = 0xffff;  // a pair's bin; the flags above it
constexpr int LAST = 1 << 16;     // the pair ends its mel's band
constexpr int EMPTY = 1 << 17;    // the mel has no band: no term, write amin
constexpr float LOG10_SCALE = 4.342944819032518f;  // 10 / ln(10)

// one turn: U pairs' words and weights, and their real and imaginary
// values at each of the thread's frames
struct Turn {
  int e[U];
  float w[U], x[U][NF], y[U][NF];
};

// issues every load of the turn of pairs [k0, k0 + U) (those below k1)
__device__ __forceinline__ void load(Turn& c, int k0, int k1,
                                     const int* __restrict__ pairs,
                                     const float* __restrict__ weights,
                                     const float* __restrict__ re,
                                     const float* __restrict__ im, int T,
                                     const bool (&in)[NF]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = k0 + u < k1;
    c.e[u] = ok ? __ldg(pairs + k0 + u) : 0;
    c.w[u] = ok ? __ldg(weights + k0 + u) : 0.0f;
    const size_t row = (size_t)(c.e[u] & BIN_MASK) * T;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      c.x[u][j] = ok && in[j] ? __ldg(re + row + j * TT) : 0.0f;
      c.y[u][j] = ok && in[j] ? __ldg(im + row + j * TT) : 0.0f;
    }
  }
}

// table: pair0 [n_groups + 1] (each group's first pair), mel0 [n_groups]
// (its first mel), pairs [n_pairs] (bin | flags), weights [n_pairs] (f32)
__global__ void __launch_bounds__(TT)
    mel_db_kernel(const float* __restrict__ stft, const int* __restrict__ table,
                  float* __restrict__ out, int F, int T, int n_mels,
                  int n_groups, int n_pairs, float amin) {
  const int g = blockIdx.x, b = blockIdx.z;
  const int t = blockIdx.y * TT * NF + threadIdx.x;
  if (t >= T) return;
  bool in[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) in[j] = t + j * TT < T;
  const int* pair0 = table;
  const int* mel0 = pair0 + n_groups + 1;
  const int* pairs = mel0 + n_groups;
  const float* weights = reinterpret_cast<const float*>(pairs + n_pairs);
  const float* re = stft + (size_t)b * 2 * F * T + t;
  const float* im = re + (size_t)F * T;
  float* o = out + ((size_t)b * n_mels + __ldg(mel0 + g)) * T + t;
  const int k1 = __ldg(pair0 + g + 1);
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = 0.0f;
  int k0 = __ldg(pair0 + g);
  Turn cur;
  for (; k0 < k1; k0 += U) {
    load(cur, k0, k1, pairs, weights, re, im, T, in);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= k1) break;
      if (!(cur.e[u] & EMPTY)) {
#pragma unroll
        for (int j = 0; j < NF; ++j)  // the power rounded as the plain one's
          acc[j] = fmaf(cur.w[u],
                        __fadd_rn(__fmul_rn(cur.x[u][j], cur.x[u][j]),
                                  __fmul_rn(cur.y[u][j], cur.y[u][j])),
                        acc[j]);
      }
      if (cur.e[u] & LAST) {
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          if (in[j]) o[j * TT] = LOG10_SCALE * logf(fmaxf(acc[j], amin));
          acc[j] = 0.0f;
        }
        o += T;
      }
    }
  }
}

}  // namespace

extern "C" int mel_db_launch(int device, const float* stft, const int* table,
                             float* out, int B, int F, int T, int n_mels,
                             int n_groups, int n_pairs, float amin,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  dim3 grid(n_groups, (T + NF * TT - 1) / (NF * TT), B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  mel_db_kernel<<<grid, TT, 0, static_cast<cudaStream_t>(stream)>>>(
      stft, table, out, F, T, n_mels, n_groups, n_pairs, amin);
  return cudaGetLastError();
}

extern "C" const char* audiossl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
