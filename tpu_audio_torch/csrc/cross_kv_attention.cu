// One-token cross-attention over int8 cross-K/V, one decoder layer.
//
// Replaces tpu_audio/ops/pallas/cross_kv_attention.py:cross_attention_decode.
//
// q (B, H, 64) f32; k8, v8 (L, B, T_pad, H*64) int8 with per-(batch,
// channel) f32 scales of layer `layer`. The K scale folds into q, so
// scores = sum_d (q_d * ks_d) * K8[t, d]; the V scale multiplies the output
// after the division by the softmax sum. Keys t >= t_valid (the padding
// of T up to T_pad) are never read.
//
// Bound on the H100: device-memory bytes. Per decode step and layer at
// large-v3-turbo batch 16 the kernel reads 2 x 16 x 1500 x 1280 = 61 MB of
// int8 K/V and does 2 FLOP per byte, far below the ~295 FLOP/byte ridge.
//
// Design: one block per (batch, head), 256 threads. A head's row is 64
// contiguous bytes; four threads read it as 16-byte vectors, so a warp
// reads eight whole rows per load. Scores live in shared memory (T_pad f32),
// the softmax is f32 over the block, and the PV pass reads V the same way,
// with partial sums per row group reduced through shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPart = 16;                       // int8 channels per thread (one int4)
constexpr int kRowThreads = HD / kPart;         // 4 threads per head row
constexpr int kRowGroups = kThreads / kRowThreads;  // 64 rows per pass

__global__ void __launch_bounds__(kThreads)
cross_attention_decode_kernel(const float* __restrict__ q,       // (B, H, HD)
                              const int8_t* __restrict__ k8,     // (L, B, T_pad, D)
                              const int8_t* __restrict__ v8,
                              const float* __restrict__ k_scale,  // (B, D)
                              const float* __restrict__ v_scale,  // (B, D)
                              float* __restrict__ out,            // (B, H, HD)
                              int layer, int batch, int t_pad, int H, int t_valid) {
  extern __shared__ float smem[];
  float* scores = smem;               // t_pad
  float* partial = smem + t_pad;      // kRowGroups x HD
  __shared__ float qs[HD];
  __shared__ float scratch[kWarps];

  const int D = H * HD;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const long base = ((static_cast<long>(layer) * batch + b) * t_pad) * D + h * HD;
  if (tid < HD) qs[tid] = q[(static_cast<long>(b) * H + h) * HD + tid] *
                          k_scale[static_cast<long>(b) * D + h * HD + tid];
  __syncthreads();

  const int part = tid % kRowThreads, row = tid / kRowThreads;
  float qreg[kPart];
#pragma unroll
  for (int j = 0; j < kPart; ++j) qreg[j] = qs[part * kPart + j];

  // every thread runs the same trip count so the shuffles see a full warp
  float local_max = -INFINITY;
  for (int t0 = 0; t0 < t_valid; t0 += kRowGroups) {
    const int t = t0 + row;
    const bool valid = t < t_valid;
    int4 raw = make_int4(0, 0, 0, 0);
    if (valid)
      raw = *reinterpret_cast<const int4*>(k8 + base + static_cast<long>(t) * D +
                                           part * kPart);
    const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPart; ++j) s = fmaf(qreg[j], static_cast<float>(kv[j]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (valid) {
      if (part == 0) scores[t] = s;
      local_max = fmaxf(local_max, s);
    }
  }
  const float m = tpa::block_max<kWarps>(local_max, scratch);

  float local_sum = 0.f;
  for (int t = tid; t < t_valid; t += kThreads) {
    const float e = expf(scores[t] - m);
    scores[t] = e;
    local_sum += e;
  }
  const float denom = tpa::block_sum<kWarps>(local_sum, scratch);  // syncs the block

  float acc[kPart];
#pragma unroll
  for (int j = 0; j < kPart; ++j) acc[j] = 0.f;
  for (int t = row; t < t_valid; t += kRowGroups) {
    const int4 raw = *reinterpret_cast<const int4*>(v8 + base + static_cast<long>(t) * D +
                                                    part * kPart);
    const int8_t* vv = reinterpret_cast<const int8_t*>(&raw);
    const float p = scores[t];
#pragma unroll
    for (int j = 0; j < kPart; ++j) acc[j] = fmaf(p, static_cast<float>(vv[j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kPart; ++j) partial[row * HD + part * kPart + j] = acc[j];
  __syncthreads();

  if (tid < HD) {
    float s = 0.f;
    for (int g = 0; g < kRowGroups; ++g) s += partial[g * HD + tid];
    const long o = static_cast<long>(b) * D + h * HD + tid;
    out[(static_cast<long>(b) * H + h) * HD + tid] = s / denom * v_scale[o];
  }
}

}  // namespace

extern "C" int tpa_cross_attention_decode(const float* q, const int8_t* k8, const int8_t* v8,
                                          const float* k_scale, const float* v_scale,
                                          float* out, int layer, int batch, int t_pad, int H,
                                          int t_valid, cudaStream_t stream) {
  const int smem = (t_pad + kRowGroups * HD) * static_cast<int>(sizeof(float));
  cudaError_t err = tpa::allow_smem(cross_attention_decode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_attention_decode_kernel<<<batch * H, kThreads, smem, stream>>>(
      q, k8, v8, k_scale, v_scale, out, layer, batch, t_pad, H, t_valid);
  return static_cast<int>(cudaGetLastError());
}
