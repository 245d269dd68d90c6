// Fused Whisper log-mel: frame -> window-folded DFT -> power -> Slaney mel
// projection -> log10(max(., 1e-10)), one launch for a whole 30 s chunk.
//
// Replaces tpu_audio/ops/pallas/fused_mel.py:fused_log_mel.
//
// Bound on the H100: float32 arithmetic. A 30 s chunk is 3001 frames x
// (400 x 402 DFT + 201 x 128 mel) x 2 = 1.1 GFLOP against 1.9 MB of audio
// in and 1.5 MB out. The reference asks for HIGHEST precision and the
// 1e-10-floored log10 magnifies relative error, so all products are f32
// FMAs on the CUDA cores, not TF32 tensor-core products.
//
// Design: one block per tile of kFrames frames. The block copies the audio
// span its frames cover into shared memory once (frames overlap, hop 160
// of 400), so framing costs no gather in device memory. Each thread owns
// one frequency bin for all kFrames frames: it streams the bin's two basis
// columns (coalesced across threads) and keeps 2 x kFrames accumulators in
// registers. The power spectrum stays in shared memory for the mel
// projection; only the log-mel leaves the block.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kFrames = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_log_mel_kernel(const float* __restrict__ audio, int n_audio,
                     const float* __restrict__ basis,  // (n_fft, 2K)
                     const float* __restrict__ fb,     // (K, n_mels)
                     float* __restrict__ out,          // (num_frames, n_mels)
                     int num_frames, int n_fft, int hop, int n_mels) {
  extern __shared__ float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int span = (kFrames - 1) * hop + n_fft;
  float* wav = smem;            // span samples
  float* power = smem + span;   // kFrames x n_bins
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, num_frames - f0);
  const long start = static_cast<long>(f0) * hop;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long s = start + i;
    wav[i] = s < n_audio ? audio[s] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      const float c = basis[n * 2 * n_bins + k];
      const float s = basis[n * 2 * n_bins + n_bins + k];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float x = wav[f * hop + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nf * n_mels; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const float* p = power + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], fb[k * n_mels + m], acc);
    out[static_cast<long>(f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int tpa_fused_log_mel(const float* audio, int n_audio, const float* basis,
                                 const float* fb, float* out, int num_frames, int n_fft,
                                 int hop, int n_mels, cudaStream_t stream) {
  const int smem = ((kFrames - 1) * hop + n_fft + kFrames * (n_fft / 2 + 1)) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = tpa::allow_smem(fused_log_mel_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_frames + kFrames - 1) / kFrames;
  fused_log_mel_kernel<<<blocks, kThreads, smem, stream>>>(audio, n_audio, basis, fb, out,
                                                          num_frames, n_fft, hop, n_mels);
  return static_cast<int>(cudaGetLastError());
}
