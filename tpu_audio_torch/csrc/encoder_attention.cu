// Bidirectional encoder self-attention, bf16 in and out, f32 softmax.
//
// Replaces tpu_audio/ops/pallas/encoder_attention.py:encoder_attention (its
// (B, T, H, D) and head-major (B*H, T, D) entries) and
// tpu_audio/ops/pallas/encoder_attention.py:encoder_attention_packed (two
// heads per 128-channel row, (B*H/2, T, 128)).
//
// What it computes, per head: S = Q K^T in f32 times `scale`; keys >=
// t_valid masked with -1e30; an f32 online softmax; the probabilities rounded
// to bf16 before P V, which sums in f32; the division by the softmax sum
// after P V; bf16 out.
//
// One tensor-map recipe reads all three layouts in place, with no transpose
// and no padding of T: the input is the 4-D tensor (64, inner, T, outer) with
// element strides (1, stride_inner, ld, stride_outer), read in boxes of
// (64, 1, 128, 1), and head n of N is (n % inner, n / inner):
//   (B, T, H, 64)     inner H, stride_inner 64, ld H*64, stride_outer T*H*64
//   (B*H, T, 64)      inner 1,                   ld 64,  stride_outer T*64
//   (B*H/2, T, 128)   inner 2, stride_inner 64, ld 128, stride_outer T*128
// (`encoder_attention.py:tma_view` is the same description in Python.) TMA
// fills rows past T with zeros, so a tile never reads the next batch's rows.
//
// Design: a block per (head, 128 query rows), two blocks an SM. Two
// warpgroups take 64 query rows each; thread 0 also issues the TMA loads:
// the Q tile once, then K/V tiles of 64 keys through a 4-stage ring
// (128-byte swizzle, completion on mbarriers), each stage refilled once both
// warpgroups have released it. S = Q K^T is wgmma m64n64k16 (four k-steps
// over hd 64, Q and K from shared memory); the softmax stays in registers
// (row max over a quad by shuffles, exp2 with log2(e) folded into the
// scale, the last partial key tile masked in registers); P is rounded to
// bf16 in registers and is the register A operand of wgmma m64n64k16
// against V in its natural (keys x hd) layout, read transposed. O stays in
// registers to the end (the loop is attention_wgmma.cuh's `attend`, which
// fused_encoder.cu's attn_heads and fused_encoder_int8.cu's pair_codes
// share). A warpgroup waits for each
// product before it goes on; the four warpgroups of an SM overlap each
// other's softmax and products. 256 threads at 112 registers let two
// blocks share an SM (83 KB of shared memory each); a separate producer
// warp would make ptxas budget the block as 384 threads and cap it at 168
// registers, one block an SM.
// Key tiles wholly at or past t_valid are not read: their probabilities are
// exactly 0 (exp of -1e30 below the row max).
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (B*H = 320 heads, T = 1500, hd = 64) a layer is 4*B*H*T^2*hd = 184 GFLOP,
// 0.186 ms at 989 TFLOP/s, against 246 MB of q, k, v and output (0.073 ms).
// The B*H*T^2 = 720 M exponentials at the SFU's 16 a clock per SM are a
// second floor of ~0.17 ms. A block's K/V traffic from L2 is 384 KB for 128
// query rows (8x less than 16-row tiles). Overlapping one warpgroup's softmax
// with the other's wgmma (ping-pong) and a persistent grid are later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
namespace hp = tpa::hopper;
namespace aw = tpa::attn_wgmma;

namespace {

constexpr int kSmem = 1024 + aw::kRingSmem;

__global__ void __launch_bounds__(aw::kThreads, 2)
encoder_attention_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v, bf16* __restrict__ out,
                         int T, int t_valid, int inner, long long stride_outer,
                         long long stride_inner, int ld, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int n = blockIdx.y, q0 = blockIdx.x * aw::BQ;
  const int hi = n % inner, ho = n / inner;
  float o[32], l[2];
  aw::attend<false>(&map_q, &map_k, &map_v, hp::align_1024(smem_raw), hi, ho, q0, t_valid, scale,
                    o, l);

  // O / l, bf16, stored through the layout's base offset and row stride
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int tid = threadIdx.x % 128, lane = threadIdx.x & 31, wg = threadIdx.x / 128;
  const long long off = ho * stride_outer + hi * stride_inner;
  const int r = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r + 8 * h;
    if (t >= T) continue;
    bf16* row = out + off + static_cast<long long>(t) * ld;
#pragma unroll
    for (int jj = 0; jj < aw::HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(row + jj * 8 + (lane % 4) * 2) =
          hp::pack_bf16(o[4 * jj + 2 * h] * inv[h], o[4 * jj + 2 * h + 1] * inv[h]);
  }
}

}  // namespace

// dims and strides: the 4-D description (64, inner, T, outer) of
// `encoder_attention.py:tma_view`, element strides of dimensions 1-3.
extern "C" int tpa_encoder_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                     int n_heads, int T, int t_valid, int inner,
                                     long long stride_outer, long long stride_inner, int ld,
                                     float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = aw::encode_qkv_maps(&mq, &mk, &mv, q, k, v, n_heads, T, inner, stride_outer,
                                        stride_inner, ld);
  if (err == cudaSuccess) err = tpa::allow_smem(encoder_attention_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + aw::BQ - 1) / aw::BQ, n_heads);
  encoder_attention_kernel<<<grid, aw::kThreads, kSmem, stream>>>(
      mq, mk, mv, out, T, t_valid, inner, stride_outer, stride_inner, ld, scale);
  return static_cast<int>(cudaGetLastError());
}
