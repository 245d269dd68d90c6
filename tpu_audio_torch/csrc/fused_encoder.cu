// Fused Whisper encoder-block phase, bf16 in and out, f32 accumulation.
//
// Replaces tpu_audio/ops/pallas/fused_encoder.py:attn_oproj_ln (the first
// phase, ln_qkv_packed, is ln_qkv.cu).
//
//   attn_oproj_ln  per (batch, 16-row query tile): for each head, online-
//                  softmax attention over 64-key tiles (keys >= t_valid
//                  masked, f32 softmax, division after PV), then that head's
//                  slice of the o-projection accumulated in f32 into a
//                  (16, D) shared-memory accumulator that starts at x + bias;
//                  finally y = acc (bf16) and h = LayerNorm2(acc). The
//                  per-head attention is `attention_tile.cuh`.
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (B*T = 24000 rows, D = 1280, 20 heads) one block is 184 GFLOP of
// attention and 79 GFLOP of o-projection, against ~0.25 GB of activations:
// far above the H100's ~295 FLOP/byte ridge.
//
// Design: WMMA 16x16x16 bf16 fragments with f32 accumulators (mma.sync),
// written to be right first. attn_oproj_ln never writes the attention
// output to device memory: the TPU kernel keeps a (256 x 1280) f32
// accumulator in VMEM, which does not fit a block's 227 KB, so the query
// tile shrinks to 16 rows (an 80 KB accumulator) and the o-projection reads
// its weight fragments from L2 for every head. wgmma, TMA and a
// register-resident softmax are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;
namespace attn = tpa::attn;

namespace {

// ----------------------------------------------------------- attn_oproj_ln
inline int attn_smem_bytes(int d) {
  return attn::BQ * (d + 4) * 4 + attn::kTileBytes;  // o-projection accumulator + tile
}

__global__ void __launch_bounds__(attn::kThreads)
attn_oproj_ln_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,           // (B, H, T, HD)
                     const bf16* __restrict__ x,           // (B, T, D) residual
                     const bf16* __restrict__ wo,          // (D, D), out x in
                     const float* __restrict__ bo,         // (D)
                     const float* __restrict__ g2, const float* __restrict__ b2,  // (D)
                     bf16* __restrict__ y, bf16* __restrict__ hout,  // (B, T, D)
                     int T, int H, int t_valid, float eps) {
  using namespace attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * HD;
  const int lda = D + 4;
  float* acc = reinterpret_cast<float*>(smem);          // BQ x lda
  const Tile tile = carve(smem + BQ * lda * 4);

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    acc[r * lda + c] =
        t < T ? __bfloat162float(x[(static_cast<long>(b) * T + t) * D + c]) + bo[c] : 0.f;
  }

  for (int hh = 0; hh < H; ++hh) {
    const long off = (static_cast<long>(b) * H + hh) * T * HD;
    attn::head(tile, q + off, k + off, v + off, q0, T, t_valid);

    // this head's attention output (bf16) replaces the q tile
    for (int i = tid; i < BQ * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      tile.q[r * LDH + c] = __float2bfloat16(tile.o[r * LDO + c] / tile.l[r]);
    }
    __syncthreads();

    // acc[:, n] += O_h (BQ x HD) @ wo[n, hh*HD : hh*HD + HD]^T
    for (int n0 = warp * 16; n0 < D; n0 += kWarps * 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc + n0, lda, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a, tile.q + kk, LDH);
        wmma::load_matrix_sync(bw, wo + static_cast<long>(n0) * D + hh * HD + kk, D);
        wmma::mma_sync(c, a, bw, c);
      }
      wmma::store_matrix_sync(acc + n0, c, lda, wmma::mem_row_major);
    }
    __syncthreads();
  }

  store_y_ln(acc, lda, g2, b2, y, hout, b, q0, T, D, eps);
}

}  // namespace

extern "C" int tpa_attn_oproj_ln(const bf16* q, const bf16* k, const bf16* v, const bf16* x,
                                 const bf16* wo, const float* bo, const float* g2,
                                 const float* b2, bf16* y, bf16* h, int batch, int T, int H,
                                 int t_valid, float eps, cudaStream_t stream) {
  const int smem = attn_smem_bytes(H * tpa::attn::HD);
  cudaError_t err = tpa::allow_smem(attn_oproj_ln_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + tpa::attn::BQ - 1) / tpa::attn::BQ, batch);
  attn_oproj_ln_kernel<<<grid, tpa::attn::kThreads, smem, stream>>>(q, k, v, x, wo, bo, g2, b2, y, h,
                                                             T, H, t_valid, eps);
  return static_cast<int>(cudaGetLastError());
}
