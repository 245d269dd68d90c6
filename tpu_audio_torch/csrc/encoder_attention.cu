// Bidirectional encoder self-attention, bf16 in and out, f32 softmax.
//
// Replaces tpu_audio/ops/pallas/encoder_attention.py:encoder_attention (its
// (B, T, H, D) and head-major (B*H, T, D) entries) and
// tpu_audio/ops/pallas/encoder_attention.py:encoder_attention_packed (two
// heads per 128-channel row, (B*H/2, T, 128)).
//
// One block per (head, 16-row query tile). The block reads its head in
// place through a base offset and a row stride, so all three layouts are
// read and written as they lie: no transpose, no padding of T. For head
// n of N, the head's first row is (n / inner) * stride_outer +
// (n % inner) * stride_inner and its rows are `ld` elements apart:
//   (B, T, H, 64)     inner H, stride_outer T*H*64, stride_inner 64, ld H*64
//   (B*H, T, 64)      inner 1, stride_outer T*64,               ld 64
//   (B*H/2, T, 128)   inner 2, stride_outer T*128, stride_inner 64, ld 128
// The attention itself is `attention_tile.cuh`'s `head` (online softmax over
// 64-key tiles, keys >= t_valid masked, the scale on the f32 scores, the
// probabilities rounded to bf16 before P V); the epilogue divides by the
// softmax sum after P V, as the TPU kernel does, and stores bf16.
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (B*H = 320 heads, T = 1500, hd = 64) a layer is 4*B*H*T^2*hd = 184 GFLOP
// against 246 MB of q, k, v and output: 0.186 ms of bf16 tensor-core time,
// 0.073 ms of bytes. The B*H*T^2 = 720 M exponentials at the SFU's 16 a
// clock per SM cost about as much again. Design: right and simple first;
// each block streams its head's whole K and V past one 16-row query tile
// (from L2 after the first of the head's 94 tiles), mma.sync WMMA tiles.
// wgmma, a TMA K/V ring and 64-row query tiles per warpgroup are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"

using bf16 = __nv_bfloat16;
namespace attn = tpa::attn;

namespace {

__global__ void __launch_bounds__(attn::kThreads)
encoder_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int T, int t_valid,
                         int inner, long long stride_outer, long long stride_inner, int ld,
                         float scale) {
  using namespace attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tile = carve(smem);
  const int n = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long off = (n / inner) * stride_outer + (n % inner) * stride_inner;
  head(tile, q + off, k + off, v + off, q0, T, t_valid, ld, scale);

  // one 16-byte vector of 8 channels per thread: BQ * HD / 8 == kThreads
  static_assert(BQ * HD / 8 == kThreads, "one vector per thread");
  const int r = threadIdx.x / (HD / 8), c = (threadIdx.x % (HD / 8)) * 8;
  if (q0 + r >= T) return;
  const float l = tile.l[r];
  __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16(tile.o[r * LDO + c + j] / l);
  *reinterpret_cast<uint4*>(out + off + static_cast<long long>(q0 + r) * ld + c) =
      *reinterpret_cast<const uint4*>(vals);
}

}  // namespace

extern "C" int tpa_encoder_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                     int n_heads, int T, int t_valid, int inner,
                                     long long stride_outer, long long stride_inner, int ld,
                                     float scale, cudaStream_t stream) {
  const dim3 grid((T + attn::BQ - 1) / attn::BQ, n_heads);
  encoder_attention_kernel<<<grid, attn::kThreads, attn::kTileBytes, stream>>>(
      q, k, v, out, T, t_valid, inner, stride_outer, stride_inner, ld, scale);
  return static_cast<int>(cudaGetLastError());
}
