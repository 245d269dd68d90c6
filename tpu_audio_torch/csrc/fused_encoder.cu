// Fused Whisper encoder-block phases, bf16 in and out, f32 accumulation.
//
// Replaces tpu_audio/ops/pallas/fused_encoder.py:ln_qkv_packed and
// tpu_audio/ops/pallas/fused_encoder.py:attn_oproj_ln.
//
//   ln_qkv         x (B,T,D) -> LayerNorm (f32 statistics) -> one GEMM against
//                  the packed [q*s | k*s | v] weight (3D, D) + bias, written
//                  head-major as q, k, v (B, H, T, hd). s = hd^-0.25.
//   attn_oproj_ln  per (batch, 16-row query tile): for each head, online-
//                  softmax attention over 64-key tiles (keys >= t_valid
//                  masked, f32 softmax, division after PV), then that head's
//                  slice of the o-projection accumulated in f32 into a
//                  (16, D) shared-memory accumulator that starts at x + bias;
//                  finally y = acc (bf16) and h = LayerNorm2(acc). The
//                  per-head attention is `attention_tile.cuh`, shared with
//                  the int8 kernel of fused_encoder_int8.cu.
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (B*T = 24000 rows, D = 1280, 20 heads) one block is 236 GFLOP of QKV GEMM,
// 184 GFLOP of attention and 79 GFLOP of o-projection, against ~0.25 GB of
// activations: far above the H100's ~295 FLOP/byte ridge.
//
// Design: both kernels use WMMA 16x16x16 bf16 fragments with f32
// accumulators (mma.sync), written to be right first. ln_qkv keeps its
// 64 normalized rows in shared memory for the whole N loop, so the
// LayerNorm runs once per row and only the weight streams. attn_oproj_ln
// never writes the attention output to device memory: the TPU kernel keeps
// a (256 x 1280) f32 accumulator in VMEM, which does not fit a block's
// 227 KB, so the query tile shrinks to 16 rows (an 80 KB accumulator) and
// the o-projection reads its weight fragments from L2 for every head.
// wgmma, TMA and a register-resident softmax are later work.
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

// ------------------------------------------------------------------ ln_qkv
namespace lq {
constexpr int BM = 64, BN = 128, BK = 64, kThreads = 256;
constexpr int LDB = BK + 8;   // bf16 weight tile row stride
constexpr int LDC = BN + 4;   // f32 output tile row stride
inline int smem_bytes(int d) {
  return BM * (d + 8) * 2 + BN * LDB * 2 + BM * LDC * 4;
}
}  // namespace lq

__global__ void __launch_bounds__(lq::kThreads, 1)
ln_qkv_kernel(const bf16* __restrict__ x,         // (M, D), M = B*T
              const float* __restrict__ ln_w,     // (D)
              const float* __restrict__ ln_b,     // (D)
              const bf16* __restrict__ w,         // (3D, D)
              const float* __restrict__ bias,     // (3D)
              bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v,
              int M, int T, int D, int H, float eps) {
  using namespace lq;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);                 // BM x lda
  bf16* Bs = As + BM * lda;                                  // BN x LDB
  float* Cs = reinterpret_cast<float*>(Bs + BN * LDB);       // BM x LDC
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // LayerNorm of the block's rows into As, statistics in f32 (two passes).
  for (int r = warp; r < BM; r += kThreads / 32) {
    bf16* dst = As + r * lda;
    const int m = m0 + r;
    if (m >= M) {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = x + static_cast<long>(m) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(src[c]);
    const float mu = tpa::warp_sum(s) / D;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(src[c]) - mu;
      ss += d * d;
    }
    const float rstd = rsqrtf(tpa::warp_sum(ss) / D + eps);
    for (int c = lane; c < D; c += 32)
      dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mu) * rstd * ln_w[c] + ln_b[c]);
  }
  __syncthreads();

  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 32 x 32 each
  const int hd = D / H;
  for (int n0 = 0; n0 < 3 * D; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int i = threadIdx.x; i < BN * BK / 8; i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const uint4*>(w + static_cast<long>(n0 + r) * D + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();

    // + bias, scatter to head-major q / k / v
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int m = m0 + r;
      if (m >= M) continue;
      const int n = n0 + c;
      const int which = n / D, nn = n - which * D;
      const int h = nn / hd, e = nn - h * hd;
      const int b = m / T, t = m - b * T;
      bf16* dst = which == 0 ? q : (which == 1 ? k : v);
      dst[((static_cast<long>(b) * H + h) * T + t) * hd + e] =
          __float2bfloat16(Cs[r * LDC + c] + bias[n]);
    }
    __syncthreads();
  }
}

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

extern "C" int tpa_ln_qkv(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w,
                          const float* bias, bf16* q, bf16* k, bf16* v, int batch, int T,
                          int D, int H, float eps, cudaStream_t stream) {
  const int smem = lq::smem_bytes(D);
  cudaError_t err = tpa::allow_smem(ln_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = batch * T;
  const int blocks = (M + lq::BM - 1) / lq::BM;
  ln_qkv_kernel<<<blocks, lq::kThreads, smem, stream>>>(x, ln_w, ln_b, w, bias, q, k, v, M, T,
                                                        D, H, eps);
  return static_cast<int>(cudaGetLastError());
}

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
