// One head's encoder self-attention for a block of 16 query rows, for the
// bf16 attention + o-projection kernel (fused_encoder.cu).
//
// `head` runs online-softmax attention over 64-key tiles with WMMA
// 16x16x16 bf16 fragments and f32 accumulators: S = Q K^T times `scale` in
// f32 (1 where the scale is folded into q and k upstream), keys >= t_valid
// masked with -1e30, f32 softmax statistics, the probabilities rounded to
// bf16 before P V, and the division by the softmax sum left to the caller
// (after P V, as the TPU kernels do). It leaves the unnormalised P V sum in
// `o` and the sums in `l`, with the block synchronised. A head's rows lie
// `ld` elements apart (HD for a head-major tensor, H * HD for (B, T, H, HD),
// 128 for two heads packed per row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace tpa {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int BQ = 16, BKV = 64, HD = 64, kThreads = 128, kWarps = 4;
constexpr int LDH = HD + 8;   // bf16 tiles (q, k, v, p)
constexpr int LDS = BKV + 4;  // f32 score tile
constexpr int LDO = HD + 4;   // f32 per-head output tile
constexpr float kMasked = -1e30f;

// Shared memory of one block's attention scratch; every part is a multiple
// of 32 bytes, so each stays aligned as WMMA needs.
constexpr int kTileBytes = BQ * LDH * 2        // q tile
                           + 2 * BKV * LDH * 2  // k, v tiles
                           + BQ * LDS * 4       // scores
                           + BQ * LDH * 2       // probabilities (bf16)
                           + BQ * LDO * 4       // running P V sum
                           + 2 * BQ * 4;        // running max and sum

struct Tile {
  bf16* q;   // BQ x LDH
  bf16* k;   // BKV x LDH
  bf16* v;   // BKV x LDH
  float* s;  // BQ x LDS
  bf16* p;   // BQ x LDH
  float* o;  // BQ x LDO
  float* m;  // BQ
  float* l;  // BQ
};

__device__ __forceinline__ Tile carve(unsigned char* base) {
  Tile t;
  t.q = reinterpret_cast<bf16*>(base);
  t.k = t.q + BQ * LDH;
  t.v = t.k + BKV * LDH;
  t.s = reinterpret_cast<float*>(t.v + BKV * LDH);
  t.p = reinterpret_cast<bf16*>(t.s + BQ * LDS);
  t.o = reinterpret_cast<float*>(t.p + BQ * LDH);
  t.m = t.o + BQ * LDO;
  t.l = t.m + BQ;
  return t;
}

// rows x HD bf16 from src (row stride ld, a multiple of 8) into dst (row
// stride LDH); rows past n_rows are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows,
                                          int n_rows, int ld = HD) {
  for (int i = threadIdx.x; i < rows * HD / 8; i += kThreads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long>(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// q, k, v point at one head's first row of T, rows `ld` apart; the block's
// query rows are [q0, q0 + BQ).
__device__ __forceinline__ void head(const Tile& t, const bf16* __restrict__ q,
                                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                                     int q0, int T, int t_valid, int ld = HD,
                                     float scale = 1.f) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  load_rows(t.q, q, q0, BQ, T, ld);
  for (int i = tid; i < BQ * HD; i += kThreads) t.o[(i / HD) * LDO + i % HD] = 0.f;
  if (tid < BQ) {
    t.m[tid] = kMasked;
    t.l[tid] = 0.f;
  }
  __syncthreads();

  for (int kv0 = 0; kv0 < t_valid; kv0 += BKV) {
    load_rows(t.k, k, kv0, BKV, T, ld);
    load_rows(t.v, v, kv0, BKV, T, ld);
    __syncthreads();

    {  // S = Q K^T; warp w owns key columns [16w, 16w + 16)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, t.q + kk, LDH);
        wmma::load_matrix_sync(bk, t.k + warp * 16 * LDH + kk, LDH);
        wmma::mma_sync(s, a, bk, s);
      }
      wmma::store_matrix_sync(t.s + warp * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    {  // online softmax: 8 threads per query row, 8 keys each
      const int r = tid >> 3, sub = tid & 7;
      float sv[8];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = sub * 8 + j;
        sv[j] = kv0 + c < t_valid ? t.s[r * LDS + c] * scale : kMasked;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_old = t.m[r];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = sv[j] <= kMasked ? 0.f : expf(sv[j] - m_new);
        psum += p;
        t.p[r * LDH + sub * 8 + j] = __float2bfloat16(p);
        t.o[r * LDO + sub * 8 + j] *= corr;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      __syncwarp();
      if (sub == 0) {
        t.m[r] = m_new;
        t.l[r] = t.l[r] * corr + psum;
      }
    }
    __syncthreads();

    {  // O += P V; warp w owns output channels [16w, 16w + 16)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, t.o + warp * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, t.p + kk, LDH);
        wmma::load_matrix_sync(bv, t.v + kk * LDH + warp * 16, LDH);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(t.o + warp * 16, o, LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

// y = acc row (f32), h = LayerNorm2(acc row) with f32 statistics (two
// passes), for the block's BQ rows of batch b; rows past T are skipped.
__device__ __forceinline__ void store_y_ln(const float* acc, int lda, const float* __restrict__ g2,
                                           const float* __restrict__ b2, bf16* __restrict__ y,
                                           bf16* __restrict__ hout, int b, int q0, int T, int D,
                                           float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += kWarps) {
    const int tq = q0 + r;
    if (tq >= T) continue;
    const float* row = acc + r * lda;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mu = tpa::warp_sum(s) / D;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mu;
      ss += d * d;
    }
    const float rstd = rsqrtf(tpa::warp_sum(ss) / D + eps);
    const long o = (static_cast<long>(b) * T + tq) * D;
    for (int c = lane; c < D; c += 32) {
      y[o + c] = __float2bfloat16(row[c]);
      hout[o + c] = __float2bfloat16((row[c] - mu) * rstd * g2[c] + b2[c]);
    }
  }
}

}  // namespace attn
}  // namespace tpa
