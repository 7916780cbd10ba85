// Kernel K1: |STFT|^2 -> mel filterbank -> dB, the post-STFT half of the
// log-mel front end.
//
// Replaces the TPU kernel audiossl_tpu/ops/pallas_mel.py:39 stft_to_mel_db
// (_mel_db_kernel :28), which per (clip, 256-frame tile) squares the
// interleaved real/imag STFT in VMEM, multiplies by the [n_mels, F]
// filterbank on the MXU and takes 10*log10(max(mel, amin)).
//
// What bounds it on the H100: per 10 s clip it reads the f32 STFT
// [2*513, 1001] (4.1 MB) and writes the mel [64, 1001] (0.26 MB) for 66
// MFLOP -- about 16 FLOP per byte, near the f32 (non tensor core) ridge
// point, so device-memory bandwidth and f32 FMA rate bound it together.
// The design reads the STFT exactly once and never writes the [B, F, T]
// power array, which is the traffic the TPU kernel was written to avoid.
//
// Design (first, simple version): f32 throughout. One block of 256 threads
// per (64-frame tile, 64-mel tile, clip); the frequency axis runs in chunks
// of 32: each chunk's power (re^2 + im^2) and filterbank slice are staged
// in shared memory (2 x 8 KB; the whole 64 x 513 filterbank, 131 KB, would
// need dynamic shared memory), then each thread accumulates a 4 x 4
// (mel x frame) patch. The ragged frame edge (T = 1001) and the last
// frequency chunk (513 = 16*32 + 1) are masked in the kernel; nothing is
// padded.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 64;  // frames per block
constexpr int MT = 64;  // mels per block
constexpr int FC = 32;  // frequencies per shared-memory chunk
constexpr float LOG10_SCALE = 4.342944819032518f;  // 10 / ln(10)

__global__ void __launch_bounds__(256)
    mel_db_kernel(const float* __restrict__ stft, const float* __restrict__ fb,
                  float* __restrict__ out, int F, int T, int n_mels,
                  float amin) {
  __shared__ float P[FC][TT];
  __shared__ float Fb[FC][MT];
  const int b = blockIdx.z, m0 = blockIdx.y * MT, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* re = stft + (size_t)b * 2 * F * T;
  const float* im = re + (size_t)F * T;

  float acc[4][4] = {};
  for (int f0 = 0; f0 < F; f0 += FC) {
    for (int e = tid; e < FC * TT; e += 256) {
      int f = e / TT, t = e % TT, gf = f0 + f, gt = t0 + t;
      float p = 0.0f;
      if (gf < F && gt < T) {
        float x = re[(size_t)gf * T + gt], y = im[(size_t)gf * T + gt];
        p = x * x + y * y;
      }
      P[f][t] = p;
    }
    for (int e = tid; e < FC * MT; e += 256) {
      int f = e / MT, m = e % MT, gf = f0 + f, gm = m0 + m;
      Fb[f][m] = (gf < F && gm < n_mels) ? fb[(size_t)gf * n_mels + gm] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int f = 0; f < FC; ++f) {
      float pv[4], fv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = P[f][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) fv[i] = Fb[f][ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(fv[i], pv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= n_mels) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int t = t0 + tx + 16 * j;
      if (t < T)
        out[((size_t)b * n_mels + m) * T + t] =
            LOG10_SCALE * logf(fmaxf(acc[i][j], amin));
    }
  }
}

}  // namespace

extern "C" int mel_db_launch(int device, const float* stft, const float* fb,
                             float* out, int B, int F, int T, int n_mels,
                             float amin, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  dim3 grid((T + TT - 1) / TT, (n_mels + MT - 1) / MT, B);
  mel_db_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      stft, fb, out, F, T, n_mels, amin);
  return cudaGetLastError();
}

extern "C" const char* audiossl_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
