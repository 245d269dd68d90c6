// Device functions of the whole-stack decode kernel (fused_step.cu):
// weight-streaming products over all warps of a cooperative grid, and
// two-pass attention over a head's cache rows split across blocks.
// Every function is called by a whole block of kThreads threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace tpa {
namespace step {

constexpr int kThreads = 256, kWarps = kThreads / 32;

template <typename T>
__host__ __device__ constexpr int per_vec() {  // elements per 16-byte vector
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ float dot_vec(const int4& raw, const float* a) {
  const T* e = reinterpret_cast<const T*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < per_vec<T>(); ++j) s = fmaf(to_float(e[j]), a[j], s);
  return s;
}

// R output channels over all warps of the grid: epi(o, row(o) . a), where
// row(o) points at a weight row of I elements and `a` is in shared memory.
// The lanes stream the row as 16-byte cache-streaming loads.
template <typename W, typename Row, typename Epi>
__device__ void gemv(int R, int I, const float* a, Row row, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int nv = I / per_vec<W>();
  for (int o = blockIdx.x * kWarps + (threadIdx.x >> 5); o < R; o += gridDim.x * kWarps) {
    const int4* wr = reinterpret_cast<const int4*>(row(o));
    float acc = 0.f;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) acc += dot_vec<W>(__ldcs(wr + v), a + v * per_vec<W>());
    acc = warp_sum(acc);
    if (lane == 0) epi(o, acc);
  }
}

// Pass 1 of one block's share of one head's attention: the scores of rows
// [t0, t1) of kb (row stride `stride` elements, this head's HD channels)
// against q (shared) go to `scores` (shared, kept for pass 2), and part[0],
// part[1] get their max and sum of exp (-inf and 0 for an empty range).
template <typename T, int HD>
__device__ void attn_scores(const T* kb, long stride, int t0, int t1, const float* q,
                            float* scores, float* part, float* scratch) {
  constexpr int per = per_vec<T>();
  constexpr int lanes = HD / per;         // lanes per row
  constexpr int rows = kThreads / lanes;  // rows per pass
  const int tid = threadIdx.x, pi = tid % lanes, r = tid / lanes;
  float qreg[per];
#pragma unroll
  for (int j = 0; j < per; ++j) qreg[j] = q[pi * per + j];

  float mloc = -INFINITY;
  for (int base = t0; base < t1; base += rows) {  // same trip count for every lane
    const int t = base + r;
    int4 raw = make_int4(0, 0, 0, 0);
    if (t < t1) raw = __ldg(reinterpret_cast<const int4*>(kb + t * stride) + pi);
    const T* e = reinterpret_cast<const T*>(&raw);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < per; ++j) s = fmaf(qreg[j], to_float(e[j]), s);
#pragma unroll
    for (int off = lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (t < t1) {
      if (pi == 0) scores[t - t0] = s;
      mloc = fmaxf(mloc, s);
    }
  }
  const float m = block_max<kWarps>(mloc, scratch);  // syncs: scores visible
  float lsum = 0.f;
  for (int t = tid; t < t1 - t0; t += kThreads) lsum += expf(scores[t] - m);
  const float l = block_sum<kWarps>(lsum, scratch);
  if (tid == 0) {
    part[0] = m;
    part[1] = l;
  }
}

// A head's softmax max and sum over its `split` chunk partials (`stride`
// floats apart) and a fresh score sf of the current token (-inf if none).
// Called by a whole warp; every lane gets the result.
__device__ __forceinline__ float2 head_stats(const float* part, int split, int stride, float sf) {
  const int lane = threadIdx.x & 31;
  const float* pc = part + lane * stride;
  const bool live = lane < split && __ldcg(pc + 1) > 0.f;
  const float mc = live ? __ldcg(pc) : -INFINITY;
  const float m = fmaxf(warp_max(mc), sf);
  const float l = warp_sum(live ? __ldcg(pc + 1) * expf(mc - m) : 0.f) +
                  (sf > -INFINITY ? expf(sf - m) : 0.f);
  return make_float2(m, l);
}

// Pass 2: p = exp(s - m) / l over the scores of pass 1, rounded to bf16
// when `rb` (the reference rounds the probabilities to its compute dtype
// before the value product), and part[2..] = sum of p * v over the rows
// [t0, t1) of vb. `red` holds kThreads * per_vec<T>() floats.
template <typename T, int HD>
__device__ void attn_values(const T* vb, long stride, int t0, int t1, float2 ml, bool rb,
                            float* scores, float* red, float* part) {
  constexpr int per = per_vec<T>();
  constexpr int lanes = HD / per;
  constexpr int rows = kThreads / lanes;
  const int tid = threadIdx.x, pi = tid % lanes, r = tid / lanes;
  for (int t = tid; t < t1 - t0; t += kThreads) {
    const float pr = expf(scores[t] - ml.x) / ml.y;
    scores[t] = rb ? round_bf16(pr) : pr;
  }
  __syncthreads();
  float acc[per];
#pragma unroll
  for (int j = 0; j < per; ++j) acc[j] = 0.f;
  for (int t = t0 + r; t < t1; t += rows) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(vb + t * stride) + pi);
    const T* e = reinterpret_cast<const T*>(&raw);
    const float pr = scores[t - t0];
#pragma unroll
    for (int j = 0; j < per; ++j) acc[j] = fmaf(pr, to_float(e[j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < per; ++j) red[r * HD + pi * per + j] = acc[j];
  __syncthreads();
  if (tid < HD) {
    float s = 0.f;
    for (int g = 0; g < rows; ++g) s += red[g * HD + tid];
    part[2 + tid] = s;
  }
  __syncthreads();
}

}  // namespace step
}  // namespace tpa
