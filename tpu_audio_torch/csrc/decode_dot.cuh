// Conversions to f32 for the decode kernels (fused_whisper_step.cu,
// cross_kv_attention.cu), which read int8 weights and keys at a few
// operations a byte. An int8 -> f32 conversion instruction (I2F) issues
// at 16 a cycle on an SM, an eighth of the f32 FMA rate, and would bound
// those kernels: here a byte becomes a float by a byte permute into the
// mantissa of 2^23 and one subtraction, exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpa {
namespace dec {

// The four int8 values of w as floats, exactly: (w_k ^ 0x80) is w_k + 128
// as an unsigned byte; placed in the low mantissa byte of 2^23 it gives the
// float 2^23 + w_k + 128, from which 2^23 + 128 is subtracted.
__device__ __forceinline__ void s8x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) - 8388736.f;
}

// The two bf16 values of w (the first in the low half) as floats.
__device__ __forceinline__ void bf16x2(uint32_t w, float (&f)[2]) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// n consecutive elements of type T at p (16-byte aligned for n * sizeof(T)
// >= 16, else aligned to their size) as floats; n is 8 or 16.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[N]);

template <>
__device__ __forceinline__ void load_f32<int8_t, 8>(const int8_t* p, float (&f)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  float a[4], b[4];
  s8x4(w.x, a);
  s8x4(w.y, b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = a[k];
    f[4 + k] = b[k];
  }
}

template <>
__device__ __forceinline__ void load_f32<int8_t, 16>(const int8_t* p, float (&f)[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a[4];
    s8x4(ws[i], a);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = a[k];
  }
}

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                            float (&f)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a[2];
    bf16x2(ws[i], a);
    f[2 * i] = a[0];
    f[2 * i + 1] = a[1];
  }
}

template <>
__device__ __forceinline__ void load_f32<float, 8>(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

}  // namespace dec
}  // namespace tpa
