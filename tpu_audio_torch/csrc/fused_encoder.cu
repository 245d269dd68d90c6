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
//                  finally y = acc (bf16) and h = LayerNorm2(acc).
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

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

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
namespace ao {
constexpr int BQ = 16, BKV = 64, HD = 64, kThreads = 128, kWarps = 4;
constexpr int LDH = HD + 8;   // bf16 tiles (q, k, v, p)
constexpr int LDS = BKV + 4;  // f32 score tile
constexpr int LDO = HD + 4;   // f32 per-head output tile
constexpr float kMasked = -1e30f;
inline int smem_bytes(int d) {
  return BQ * (d + 4) * 4            // o-projection accumulator
         + BQ * LDH * 2              // q tile, then the head's attention output
         + 2 * BKV * LDH * 2         // k, v tiles
         + BQ * LDS * 4              // scores
         + BQ * LDH * 2              // probabilities (bf16)
         + BQ * LDO * 4              // running PV sum
         + 2 * BQ * 4;               // running max and sum
}
}  // namespace ao

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows,
                                          int n_rows) {
  // rows x HD bf16 from src (row stride HD) into dst (row stride LDH); rows past
  // n_rows are zero.
  using namespace ao;
  for (int i = threadIdx.x; i < rows * HD / 8; i += kThreads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long>(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(ao::kThreads)
attn_oproj_ln_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,           // (B, H, T, HD)
                     const bf16* __restrict__ x,           // (B, T, D) residual
                     const bf16* __restrict__ wo,          // (D, D), out x in
                     const float* __restrict__ bo,         // (D)
                     const float* __restrict__ g2, const float* __restrict__ b2,  // (D)
                     bf16* __restrict__ y, bf16* __restrict__ hout,  // (B, T, D)
                     int T, int H, int t_valid, float eps) {
  using namespace ao;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * HD;
  const int lda = D + 4;
  float* acc = reinterpret_cast<float*>(smem);          // BQ x lda
  bf16* Qs = reinterpret_cast<bf16*>(acc + BQ * lda);    // BQ x LDH
  bf16* Ks = Qs + BQ * LDH;                              // BKV x LDH
  bf16* Vs = Ks + BKV * LDH;                             // BKV x LDH
  float* Ss = reinterpret_cast<float*>(Vs + BKV * LDH);  // BQ x LDS
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);     // BQ x LDH
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDH);   // BQ x LDO
  float* row_m = Os + BQ * LDO;                          // BQ
  float* row_l = row_m + BQ;                             // BQ

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    acc[r * lda + c] =
        t < T ? __bfloat162float(x[(static_cast<long>(b) * T + t) * D + c]) + bo[c] : 0.f;
  }

  for (int hh = 0; hh < H; ++hh) {
    const long head = (static_cast<long>(b) * H + hh) * T * HD;
    load_rows(Qs, q + head, q0, BQ, T);
    for (int i = tid; i < BQ * HD; i += kThreads) Os[(i / HD) * LDO + i % HD] = 0.f;
    if (tid < BQ) {
      row_m[tid] = kMasked;
      row_l[tid] = 0.f;
    }
    __syncthreads();

    for (int kv0 = 0; kv0 < t_valid; kv0 += BKV) {
      load_rows(Ks, k + head, kv0, BKV, T);
      load_rows(Vs, v + head, kv0, BKV, T);
      __syncthreads();

      {  // S = Q K^T; warp w owns key columns [16w, 16w + 16)
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.f);
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(a, Qs + kk, LDH);
          wmma::load_matrix_sync(bk, Ks + warp * 16 * LDH + kk, LDH);
          wmma::mma_sync(s, a, bk, s);
        }
        wmma::store_matrix_sync(Ss + warp * 16, s, LDS, wmma::mem_row_major);
      }
      __syncthreads();

      {  // online softmax: 8 threads per query row, 8 keys each
        const int r = tid >> 3, sub = tid & 7;
        float sv[8];
        float mx = kMasked;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = sub * 8 + j;
          sv[j] = kv0 + c < t_valid ? Ss[r * LDS + c] : kMasked;
          mx = fmaxf(mx, sv[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);
        const float corr = expf(m_old - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = sv[j] <= kMasked ? 0.f : expf(sv[j] - m_new);
          psum += p;
          Ps[r * LDH + sub * 8 + j] = __float2bfloat16(p);
          Os[r * LDO + sub * 8 + j] *= corr;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        psum += __shfl_xor_sync(0xffffffffu, psum, 4);
        __syncwarp();
        if (sub == 0) {
          row_m[r] = m_new;
          row_l[r] = row_l[r] * corr + psum;
        }
      }
      __syncthreads();

      {  // O += P V; warp w owns output channels [16w, 16w + 16)
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, Os + warp * 16, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, Ps + kk, LDH);
          wmma::load_matrix_sync(bv, Vs + kk * LDH + warp * 16, LDH);
          wmma::mma_sync(o, a, bv, o);
        }
        wmma::store_matrix_sync(Os + warp * 16, o, LDO, wmma::mem_row_major);
      }
      __syncthreads();
    }

    // this head's attention output (bf16) replaces the q tile
    for (int i = tid; i < BQ * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      Qs[r * LDH + c] = __float2bfloat16(Os[r * LDO + c] / row_l[r]);
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
        wmma::load_matrix_sync(a, Qs + kk, LDH);
        wmma::load_matrix_sync(bw, wo + static_cast<long>(n0) * D + hh * HD + kk, D);
        wmma::mma_sync(c, a, bw, c);
      }
      wmma::store_matrix_sync(acc + n0, c, lda, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // y = acc; h = LayerNorm2(acc), statistics in f32 (two passes)
  for (int r = warp; r < BQ; r += kWarps) {
    const int t = q0 + r;
    if (t >= T) continue;
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
    const long o = (static_cast<long>(b) * T + t) * D;
    for (int c = lane; c < D; c += 32) {
      y[o + c] = __float2bfloat16(row[c]);
      hout[o + c] = __float2bfloat16((row[c] - mu) * rstd * g2[c] + b2[c]);
    }
  }
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
  const int smem = ao::smem_bytes(H * ao::HD);
  cudaError_t err = tpa::allow_smem(attn_oproj_ln_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + ao::BQ - 1) / ao::BQ, batch);
  attn_oproj_ln_kernel<<<grid, ao::kThreads, smem, stream>>>(q, k, v, x, wo, bo, g2, b2, y, h,
                                                             T, H, t_valid, eps);
  return static_cast<int>(cudaGetLastError());
}
