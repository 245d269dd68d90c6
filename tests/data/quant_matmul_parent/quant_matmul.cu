// Group-affine q4/q8 dequant-matmul at <= 32 rows: y = x . (q * s + b)^T in
// f32, q unpacked from 32-bit words low bits first, s and b per group of 64
// columns (the MLX checkpoint format).
//
// Replaces tpu_audio/ops/pallas/quant_matmul.py:quant_matmul.
//
// Bound on the H100: device-memory bytes. Each weight is used once per
// activation row (<= 8 rows a pass), far below the ~295 op/byte ridge: the
// Qwen3-0.6B tied lm head streams 151936 x 1024 nibbles plus two f32 per
// group, 97.2 MB per call. The unpack is the work that competes with the
// stream, so it avoids the int-to-float converter: a code q ORed into the
// mantissa of 2^23 reads as 2^23 + q, and one exact subtraction gives q.
//
// Design: a block stages its kRows activation rows in shared memory,
// transposed so that lane v of a warp reads the columns of its own 16-byte
// weight vector v without bank conflicts, and the sum of x over each
// vector's columns. Each warp owns kOut output channels; its lanes stream
// the channel's packed row as 16-byte vectors (cache-streaming loads, the
// weights are read once), kOut loads in flight together. A vector holds 32
// (q4) or 16 (q8) columns of one group, so a lane folds its partial dot in
// as s * sum(x q) + b * sum(x): the affine never needs a dequantised
// weight. The host runs rows in passes of at most 8, so the shared tile
// stays small enough for several blocks per SM at any width.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kGroup = 64;
constexpr int kMaxRowsPerPass = 8;

// BITS 4 or 8; kRows activation rows (B <= kRows), kOut channels a warp.
template <int BITS, int kRows, int kOut>
__global__ void __launch_bounds__(kThreads)
quant_gemv_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  float* __restrict__ out, int B, int I, int O) {
  constexpr int per = 32 / BITS;       // codes per word
  constexpr int cpv = 4 * per;         // columns per 16-byte vector
  constexpr int vpg = kGroup / cpv;    // vectors per group
  constexpr uint32_t mask = (1u << BITS) - 1u;
  extern __shared__ float smem[];
  const int nv = I / cpv;              // vectors per row
  const int nvp = nv + 1;              // padded: the staging writes miss bank conflicts too
  float* xs = smem;                     // [kRows][cpv][nvp]: xs[b][j][v] = x[b][v*cpv + j]
  float* xsum = xs + kRows * cpv * nvp; // [kRows][nv]
  for (int e = threadIdx.x; e < kRows * I; e += kThreads) {
    const int b = e / I, i = e % I;
    xs[(b * cpv + i % cpv) * nvp + i / cpv] = b < B ? x[static_cast<long>(b) * I + i] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * nv; e += kThreads) {
    const int b = e / nv, v = e % nv;
    float s = 0.f;
    for (int j = 0; j < cpv; ++j) s += xs[(b * cpv + j) * nvp + v];
    xsum[e] = s;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kOut;
  if (o0 >= O) return;
  const int groups = I / kGroup;
  const int4* rows[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {  // channels past O re-read channel o0 and are dropped
    const long o = o0 + r < O ? o0 + r : o0;
    rows[r] = reinterpret_cast<const int4*>(w + o * (I / per));
  }

  float acc[kOut][kRows];
#pragma unroll
  for (int r = 0; r < kOut; ++r)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[r][b] = 0.f;

  for (int v = lane; v < nv; v += 32) {
    int4 raw[kOut];
#pragma unroll
    for (int r = 0; r < kOut; ++r) raw[r] = __ldcs(rows[r] + v);
    float dot[kOut][kRows];
#pragma unroll
    for (int r = 0; r < kOut; ++r)
#pragma unroll
      for (int b = 0; b < kRows; ++b) dot[r][b] = 0.f;
#pragma unroll
    for (int j = 0; j < cpv; ++j) {
      float xv[kRows];
#pragma unroll
      for (int b = 0; b < kRows; ++b) xv[b] = xs[(b * cpv + j) * nvp + v];
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        const int wj = j / per;
        const uint32_t word = static_cast<uint32_t>(wj == 0 ? raw[r].x : wj == 1 ? raw[r].y
                                                     : wj == 2 ? raw[r].z : raw[r].w);
        const uint32_t code = (word >> (BITS * (j % per))) & mask;
        const float q = __uint_as_float(code | 0x4B000000u) - 8388608.f;  // exact
#pragma unroll
        for (int b = 0; b < kRows; ++b) dot[r][b] = fmaf(xv[b], q, dot[r][b]);
      }
    }
    const int g = v / vpg;
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const long oi = static_cast<long>(o0 + r < O ? o0 + r : o0) * groups + g;
      const float s = __ldg(scales + oi), bias = __ldg(biases + oi);
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        acc[r][b] = fmaf(s, dot[r][b], fmaf(bias, xsum[b * nv + v], acc[r][b]));
    }
  }

#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = o0 + r;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float s = tpa::warp_sum(acc[r][b]);
      if (lane == 0 && b < B && o < O) out[static_cast<long>(b) * O + o] = s;
    }
  }
}

template <int BITS, int kRows, int kOut>
cudaError_t launch(const float* x, const uint32_t* w, const float* s, const float* b, float* out,
                   int B, int I, int O, cudaStream_t stream) {
  constexpr int cpv = 128 / BITS;
  const int smem = kRows * (I + cpv + I / cpv) * static_cast<int>(sizeof(float));
  auto kernel = quant_gemv_kernel<BITS, kRows, kOut>;
  cudaError_t err = tpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int per_block = kWarps * kOut;
  kernel<<<(O + per_block - 1) / per_block, kThreads, smem, stream>>>(x, w, s, b, out, B, I, O);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_rows(const float* x, const uint32_t* w, const float* s, const float* b,
                        float* out, int B, int I, int O, cudaStream_t stream) {
  if (B <= 1) return launch<BITS, 1, 4>(x, w, s, b, out, B, I, O, stream);
  if (B <= 2) return launch<BITS, 2, 4>(x, w, s, b, out, B, I, O, stream);
  if (B <= 4) return launch<BITS, 4, 2>(x, w, s, b, out, B, I, O, stream);
  return launch<BITS, 8, 2>(x, w, s, b, out, B, I, O, stream);
}

}  // namespace

// x (B, I) f32; w (O, I * bits / 32) packed words; scales, biases (O, I / 64)
// f32; out (B, O) f32. bits 4 or 8, 1 <= B <= 32, I % 64 == 0. Rows run in
// passes of at most 8.
extern "C" int tpa_quant_matmul(const float* x, const uint32_t* w, const float* scales,
                                const float* biases, float* out, int B, int I, int O, int bits,
                                cudaStream_t stream) {
  if (B < 1 || B > 32 || I % kGroup || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(w) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  for (int b0 = 0; b0 < B; b0 += kMaxRowsPerPass) {
    const int rows = B - b0 < kMaxRowsPerPass ? B - b0 : kMaxRowsPerPass;
    const float* xb = x + static_cast<long>(b0) * I;
    float* ob = out + static_cast<long>(b0) * O;
    const cudaError_t err = bits == 4 ? launch_rows<4>(xb, w, scales, biases, ob, rows, I, O, stream)
                                      : launch_rows<8>(xb, w, scales, biases, ob, rows, I, O, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
