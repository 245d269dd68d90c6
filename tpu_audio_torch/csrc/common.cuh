// Helpers shared by the kernels of tpu_audio_torch: warp and block
// reductions, float conversion, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpa {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(signed char v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds one
// float per warp. Called by all threads of the block.
template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < kWarps ? scratch[lane] : 0.f);
}

template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_max(lane < kWarps ? scratch[lane] : -INFINITY);
}

// Blocks may use more than 48 KB of shared memory only after this opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace tpa
