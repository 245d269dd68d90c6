// The TMA + wgmma attention main loop of one (head, 128 query rows) block,
// shared by encoder_attention.cu (which stores O / l in bf16),
// fused_encoder.cu's attn_heads (which stores it in bf16, token-major) and
// fused_encoder_int8.cu's pair_codes (which codes O / l in int8 per head
// pair). The design and its bound are described in encoder_attention.cu.
//
// Per head: S = Q K^T in f32 times `scale`; keys >= t_valid masked with
// -1e30; an f32 softmax; the probabilities rounded to bf16 before P V,
// which sums in f32. The caller divides by the softmax sum.
//
// The input is a 4-D tensor map (64, inner, T, outer) read in (64, 1, 128,
// 1) boxes for q and (64, 1, 64, 1) boxes for k and v; head (hi, ho). Two
// warpgroups take 64 query rows each; thread 0 also issues the TMA loads:
// the Q tile once, then K/V tiles of 64 keys through a 4-stage ring, each
// stage refilled once both warpgroups have released it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace tpa {
namespace attn_wgmma {

namespace hp = tpa::hopper;

constexpr int BQ = 128, BKV = 64, HD = 64, kStages = 4;
constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = kConsumers * 128;      // thread 0 also issues the loads
constexpr int kQBytes = BQ * HD * 2;            // 16 KB
constexpr int kKVBytes = BKV * HD * 2;          // 8 KB: a K or V tile
// the Q tile, the ring and the barriers, from a 1024-aligned base
constexpr int kRingSmem = kQBytes + 2 * kStages * kKVBytes + (1 + 2 * kStages) * 8;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O (unnormalised) and the softmax sum l of this thread's rows: warpgroup
// wg = threadIdx.x / 128 takes query rows q0 + 64 wg .. + 63, and this
// thread rows r = q0 + 64 wg + 16 (tid / 32) + lane / 4 and r + 8 of them
// (the accumulator layout of hopper.cuh): o[i] is row r + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2; l[h] is row r + 8 h, summed over
// the row's four lanes. `smem` is 1024-aligned and holds kRingSmem bytes.
// Every thread of the block calls it; it ends with every load consumed.
//
// kExactMax false: the online softmax (one sweep over the keys; each key
// tile's probabilities are rounded to bf16 against the running row max and
// rescaled as the max grows). kExactMax true: a first sweep over the key
// tiles takes each row's exact max from S alone, so that the probabilities
// exp(s - max) are rounded to bf16 against the final max, as the plain
// version (and the TPU kernel, which holds all scores at once) rounds them;
// rounded against a running max and rescaled, a probability differs from
// that by up to a bf16 rounding.
template <bool kExactMax>
__device__ __forceinline__ void attend(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                       const CUtensorMap* map_v, unsigned char* smem, int hi,
                                       int ho, int q0, int t_valid, float scale,
                                       float (&o)[32], float (&l_out)[2]) {
  unsigned char* qs = smem;
  unsigned char* kv = smem + kQBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + 2 * kStages * kKVBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int n_tiles = (t_valid + BKV - 1) / BKV;
  const int n_steps = kExactMax ? 2 * n_tiles : n_tiles;  // ring steps: K tiles, then K/V tiles
  const int wg = threadIdx.x / 128;
  const bool producer = threadIdx.x == 0;
  // step g of the ring: K alone in the max sweep, K and V otherwise
  const auto issue = [&](int g) {
    const bool with_v = !kExactMax || g >= n_tiles;
    const int key0 = (kExactMax && g >= n_tiles ? g - n_tiles : g) * BKV, s = g % kStages;
    unsigned char* st = kv + s * 2 * kKVBytes;
    hp::mbar_arrive_expect_tx(&full[s], with_v ? 2 * kKVBytes : kKVBytes);
    hp::tma_load_4d(st, map_k, &full[s], 0, hi, key0, ho);
    if (with_v) hp::tma_load_4d(st + kKVBytes, map_v, &full[s], 0, hi, key0, ho);
  };
  if (producer) {
    hp::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (producer) {
    hp::mbar_arrive_expect_tx(qbar, kQBytes);
    hp::tma_load_4d(qs, map_q, qbar, 0, hi, q0, ho);
    for (int g = 0; g < kStages && g < n_steps; ++g) issue(g);
  }
  // release step g's stage; thread 0 refills the stage of step g - 1 once
  // both warpgroups are done with it
  const int lane = threadIdx.x & 31;
  const auto release = [&](int g) {
    if (lane == 0) hp::mbar_arrive(&empty[g % kStages]);
    if (producer && g >= 1 && g - 1 + kStages < n_steps) {
      hp::mbar_wait(&empty[(g - 1) % kStages], ((g - 1) / kStages) & 1);
      issue(g - 1 + kStages);
    }
  };
  // S = Q K^T of the step's key tile, times `scale`; keys at or past t_valid masked
  const uint64_t dq = hp::desc_sw128(qs + wg * 64 * 128);
  const auto scores = [&](int g, int j, float (&sc)[32], float mult) {
    const int s = g % kStages;
    hp::mbar_wait(&full[s], (g / kStages) & 1);
    const uint64_t dk = hp::desc_sw128(kv + s * 2 * kKVBytes);
    hp::fence_regs(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) hp::wgmma_m64n64k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    const bool partial = (j + 1) * BKV > t_valid;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] *= mult;
      if (partial) {
        const int key = j * BKV + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
        if (key >= t_valid) sc[i] = kMasked;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  hp::mbar_wait(qbar, 0);
  int g = 0;
  if constexpr (kExactMax) {  // the max sweep
    for (int j = 0; j < n_tiles; ++j, ++g) {
      float sc[32];
      scores(g, j, sc, scale);
#pragma unroll
      for (int i = 0; i < 32; ++i) m_run[(i / 2) % 2] = fmaxf(m_run[(i / 2) % 2], sc[i]);
      release(g);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[h] = fmaxf(m_run[h], __shfl_xor_sync(0xffffffffu, m_run[h], 1));
      m_run[h] = fmaxf(m_run[h], __shfl_xor_sync(0xffffffffu, m_run[h], 2));
    }
  }

  for (int j = 0; j < n_tiles; ++j, ++g) {
    float sc[32];
    uint32_t p[4][4];  // P in bf16 pairs: the A fragments of the 4 k-steps over 64 keys
    if constexpr (kExactMax) {  // e = exp(s - max), in log2 units after the subtraction
      scores(g, j, sc, scale);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i / 2) % 2;
        const float e0 = exp2_approx((sc[i] - m_run[h]) * kLog2e);
        const float e1 = exp2_approx((sc[i + 1] - m_run[h]) * kLog2e);
        l_run[h] += e0 + e1;
        p[i / 8][(i % 8) / 2] = hp::pack_bf16(e0, e1);
      }
    } else {  // scores in log2 units, the online softmax
      scores(g, j, sc, scale * kLog2e);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2_approx(m_run[h] - mx[h]);
        m_run[h] = mx[h];
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i / 2) % 2;
        const float e0 = exp2_approx(sc[i] - mx[h]), e1 = exp2_approx(sc[i + 1] - mx[h]);
        l_run[h] += e0 + e1;
        p[i / 8][(i % 8) / 2] = hp::pack_bf16(e0, e1);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
    }

    const uint64_t dv = hp::desc_sw128(kv + (g % kStages) * 2 * kKVBytes + kKVBytes);
    hp::fence_regs(o);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) hp::wgmma_m64n64k16_rs_tb(o, p[kk], dv + 128 * kk, 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    release(g);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_out[h] = l;
  }
}

// The tensor maps of head-major-compatible q, k, v: the 4-D description
// (64, inner, T, outer) of `encoder_attention.py:tma_view`, element strides
// of dimensions 1-3.
inline cudaError_t encode_qkv_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                                   const void* q, const void* k, const void* v, int n_heads,
                                   int T, int inner, long long stride_outer,
                                   long long stride_inner, int ld) {
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(inner), static_cast<uint64_t>(T),
                            static_cast<uint64_t>(n_heads / inner)};
  const uint64_t strides[3] = {static_cast<uint64_t>(stride_inner), static_cast<uint64_t>(ld),
                               static_cast<uint64_t>(stride_outer)};
  const uint32_t box[4] = {HD, 1, BKV, 1}, qbox[4] = {HD, 1, BQ, 1};
  cudaError_t err = hp::encode_map(mq, hp::kBf16, q, 4, dims, strides, qbox);
  if (err == cudaSuccess) err = hp::encode_map(mk, hp::kBf16, k, 4, dims, strides, box);
  if (err == cudaSuccess) err = hp::encode_map(mv, hp::kBf16, v, 4, dims, strides, box);
  return err;
}

}  // namespace attn_wgmma
}  // namespace tpa
