// The W8A8 Whisper encoder block: per-output-channel int8 weights,
// per-row int8 activations quantised inside the kernels, exact int32 sums
// on the tensor cores (mma.sync m16n8k32 s8), f32 epilogues. Four launches
// per block, in this order:
//
//   ln_qkv_int8         replaces tpu_audio/ops/pallas/fused_encoder.py:
//                       ln_qkv_packed_int8. x (B,T,D) bf16 -> LayerNorm1 (f32)
//                       -> row quantisation -> s8 GEMM against the packed
//                       (3D, D) int8 weight -> acc * sx * cs + bias, written
//                       head-major as bf16 q, k, v (B, H, T, 64); cs carries
//                       the per-channel weight scales, hd^-0.25 folded into
//                       the q and k columns.
//   attn_oproj_ln_int8  replaces fused_encoder.py:attn_oproj_ln_int8. Per
//                       (batch, 16-row query tile) and head pair: both heads'
//                       attention (attention_tile.cuh, as the bf16 kernel),
//                       normalised in f32 into a (16, 128) pair tile, that
//                       tile row-quantised (one scale per row per pair, never
//                       rounded to bf16 first), an s8 product with the pair's
//                       128 input channels of the o-weight, and
//                       acc * sa * cso added in f32 onto x + bo. Finally y and
//                       h = LayerNorm2(y).
//   fc1_gelu_int8       replaces fused_encoder.py:fc1_gelu_int8. h -> row
//                       quantisation -> s8 GEMM with the (FF, D) weight ->
//                       acc * sh * cs + bias -> erf GELU (erff) -> the row's
//                       requantisation over all FF values: int8 codes (B,T,FF)
//                       and one f32 scale per row.
//   fc2_residual_int8   replaces fused_encoder.py:fc2_residual_int8. s8 GEMM
//                       of those codes with the (D, FF) weight ->
//                       acc * sg * cs + bias + y.
//
// Row quantisation everywhere: s = max(max|row| / 127, 1e-10), codes
// clip(rint(row / s), -127, 127) (round half to even, as torch.round and
// jnp.round), as int8_matmul.cu.
//
// Bound on the H100 at large-v3-turbo batch 16 (M = B*T = 24000 rows,
// D = 1280, FF = 5120, 20 heads): tensor-core operations for all four.
// ln_qkv_int8 235.9 G int8 ops (0.119 ms at 1,979 TOP/s) against 251 MB
// (0.075 ms at 3.35 TB/s); attn_oproj_ln_int8 184.3 GFLOP of bf16
// attention (0.186 ms at 989 TFLOP/s) plus 78.6 G int8 ops of o-projection
// (0.040 ms) against 369 MB; fc1_gelu_int8 and fc2_residual_int8 314.6 G
// int8 ops each (0.159 ms) against 191 MB and 252 MB. About 21 ms for the
// 32 blocks of one batch of 16.
//
// Design, right first and simple: mma.sync s8 fragments taken from 128-deep
// k chunks that each lane reads with two 16-byte loads, k permuted alike in
// A and B (row strides of 16 mod 128 bytes keep the shared-memory loads free
// of bank conflicts); no TMA, no wgmma, no pipelining of the weight tiles.
// - ln_qkv_int8 normalises and quantises 64 rows once into 83 KB of shared
//   memory (half the bf16 kernel's tile) and streams 128 x 128 weight tiles
//   past them; 8 warps of 32 x 32 outputs.
// - attn_oproj_ln_int8 needs both heads of a pair finished before the
//   pair's row maximum exists, so it loops over pairs and keeps the f32 pair
//   tile and its codes in shared memory beside the (16, D) accumulator; the
//   o-weight's fragments come from L2.
// - fc1_gelu_int8 needs all FF post-GELU values of a row before its scale
//   exists: 16 rows of f32 (320 KB) do not fit a block, so a block takes 8
//   rows (160 KB of f32 beside their codes) and swaps the operands: weight
//   rows are the 16-row A operand straight from L2 and the 8 token rows the
//   B operand, so the tensor cores run full fragments. Each block reads the
//   whole weight from L2; a cluster that shares it is later work.
// - fc2_residual_int8 is a plain 64 x 128 tiled GEMM over K = FF.
// T need not be a multiple of anything: row tails are guarded, keys >=
// t_valid are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "common.cuh"

using bf16 = __nv_bfloat16;
namespace attn = tpa::attn;

namespace {

// ------------------------------------------------ s8 x s8 -> s32 fragments
// mma.sync m16n8k32: A 16 x 32 row-major, B 32 x 8 column-major (each of the
// 8 columns' 32 k values contiguous), C 16 x 8 int32. With g = lane / 4 and
// t = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k32"):
//   A registers: (row g, k 4t..4t+3), (row g+8, k 4t..), (row g, k 16+4t..),
//                (row g+8, k 16+4t..)
//   B registers: (column g, k 4t..4t+3), (column g, k 16+4t..)
//   C:           c0, c1 = (row g, columns 2t, 2t+1); c2, c3 = (row g+8, ...)
// No `volatile`: the product has no side effect, so the compiler may move
// loads across it.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A product over a 128-deep k chunk runs as four m16n8k32 steps with k
// permuted alike in A and B (a sum does not depend on the order of its
// terms): lane t = lane % 4 of a row holds the row's bytes [32t, 32t + 32),
// two 16-byte loads, and step s gives it bytes 32t + 4s.. as the fragment's
// k 4t.. and bytes 32t + 16 + 4s.. as its k 16 + 4t.. .
struct KChunk {
  int4 lo, hi;
};

// The chunk of the row at p (16-byte aligned, k0 already added).
__device__ __forceinline__ KChunk load_chunk(const int8_t* p) {
  const int4* v = reinterpret_cast<const int4*>(p + 32 * (threadIdx.x & 3));
  return {v[0], v[1]};
}

__device__ __forceinline__ int part(const int4& v, int s) {
  return s == 0 ? v.x : (s == 1 ? v.y : (s == 2 ? v.z : v.w));
}

// C (16 x 8) += A B over one chunk: a0 and a1 are A's rows g and g + 8, b is
// B's column g.
__device__ __forceinline__ void mma_chunk(int (&c)[4], const KChunk& a0, const KChunk& a1,
                                          const KChunk& b) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int fa[4] = {part(a0.lo, s), part(a1.lo, s), part(a0.hi, s), part(a1.hi, s)};
    const int fb[2] = {part(b.lo, s), part(b.hi, s)};
    mma_s8(c, fa, fb);
  }
}

__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax / 127.0f, 1e-10f); }

__device__ __forceinline__ signed char code(float v, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// A warp's 32 x 32 block of C += A B^T over one 128-deep chunk: A's 32 rows
// at a (stride lda), B's 32 columns at b (stride ldb).
__device__ __forceinline__ void warp_tile_32x32(int (&acc)[2][4][4], const int8_t* a, int lda,
                                                const int8_t* b, int ldb) {
  const int g = (threadIdx.x & 31) >> 2;
  KChunk ka[2][2], kb[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ka[i][0] = load_chunk(a + (i * 16 + g) * lda);
    ka[i][1] = load_chunk(a + (i * 16 + g + 8) * lda);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) kb[j] = load_chunk(b + (j * 8 + g) * ldb);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_chunk(acc[i][j], ka[i][0], ka[i][1], kb[j]);
}

// --------------------------------------------------------------- ln_qkv_int8
namespace lq8 {
constexpr int BM = 64, BN = 128, BK = 128, kThreads = 256;
constexpr int LDB = BK + 16;  // weight tile row stride (bytes)
inline int smem_bytes(int d) { return BM * (d + 16) + BN * LDB + BM * 4; }
}  // namespace lq8

__global__ void __launch_bounds__(lq8::kThreads)
ln_qkv_int8_kernel(const bf16* __restrict__ x,        // (M, D), M = B*T
                   const float* __restrict__ ln_w,    // (D)
                   const float* __restrict__ ln_b,    // (D)
                   const int8_t* __restrict__ w,      // (3D, D)
                   const float* __restrict__ cs,      // (3D)
                   const float* __restrict__ bias,    // (3D)
                   bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v,
                   int M, int T, int D, int H, float eps) {
  using namespace lq8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 16;
  int8_t* As = reinterpret_cast<int8_t*>(smem);             // BM x lda codes
  int8_t* Bs = As + BM * lda;                                // BN x LDB weight tile
  float* sx = reinterpret_cast<float*>(Bs + BN * LDB);       // BM row scales
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // LayerNorm (f32 statistics, two passes), then the row's codes and scale
  for (int r = warp; r < BM; r += kThreads / 32) {
    int8_t* dst = As + r * lda;
    const int m = m0 + r;
    if (m >= M) {
      for (int c = lane; c < D; c += 32) dst[c] = 0;
      if (lane == 0) sx[r] = 0.f;
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
    float amax = 0.f;
    for (int c = lane; c < D; c += 32)
      amax = fmaxf(amax, fabsf((__bfloat162float(src[c]) - mu) * rstd * ln_w[c] + ln_b[c]));
    const float scale = row_scale(tpa::warp_max(amax));
    for (int c = lane; c < D; c += 32)
      dst[c] = code((__bfloat162float(src[c]) - mu) * rstd * ln_w[c] + ln_b[c], scale);
    if (lane == 0) sx[r] = scale;
  }
  __syncthreads();

  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 outputs each
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int hd = D / H;
  for (int n0 = 0; n0 < 3 * D; n0 += BN) {
    int acc[2][4][4] = {};
    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int i = threadIdx.x; i < BN * BK / 16; i += kThreads) {
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        *reinterpret_cast<int4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const int4*>(w + static_cast<long>(n0 + r) * D + k0 + c);
      }
      __syncthreads();
      warp_tile_32x32(acc, As + wm * 32 * lda + k0, lda, Bs + wn * 32 * LDB, LDB);
      __syncthreads();
    }
    // acc * sx * cs + bias, scattered head-major to q / k / v
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + i * 16 + g + 8 * half;
        const int m = m0 + r;
        if (m >= M) continue;
        const float s = sx[r];
        const int b = m / T, t = m - b * T;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn * 32 + j * 8 + t2;
          const int which = n / D, nn = n - which * D;
          const int h = nn / hd, e = nn - h * hd;
          bf16* dst = which == 0 ? q : (which == 1 ? k : v);
          const float y0 = static_cast<float>(acc[i][j][2 * half]) * s * cs[n] + bias[n];
          const float y1 = static_cast<float>(acc[i][j][2 * half + 1]) * s * cs[n + 1] + bias[n + 1];
          *reinterpret_cast<__nv_bfloat162*>(dst + ((static_cast<long>(b) * H + h) * T + t) * hd + e) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
  }
}

// -------------------------------------------------------- attn_oproj_ln_int8
namespace ao8 {
constexpr int PAIR = 2 * attn::HD;  // 128 channels of a head pair
constexpr int LDP = PAIR + 4;       // f32 pair tile row stride
constexpr int LDQ = PAIR + 16;      // pair codes row stride (bytes)
inline int smem_bytes(int d) {
  return attn::BQ * (d + 4) * 4 + attn::kTileBytes + attn::BQ * LDP * 4 + attn::BQ * LDQ +
         attn::BQ * 4;
}
}  // namespace ao8

__global__ void __launch_bounds__(attn::kThreads)
attn_oproj_ln_int8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,          // (B, H, T, HD)
                          const bf16* __restrict__ x,          // (B, T, D) residual
                          const int8_t* __restrict__ wo,       // (D, D), out x in
                          const float* __restrict__ cso,       // (D) channel scales
                          const float* __restrict__ bo,        // (D)
                          const float* __restrict__ g2, const float* __restrict__ b2,  // (D)
                          bf16* __restrict__ y, bf16* __restrict__ hout,  // (B, T, D)
                          int T, int H, int t_valid, float eps) {
  using namespace attn;
  using ao8::LDP;
  using ao8::LDQ;
  using ao8::PAIR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * HD;
  const int lda = D + 4;
  float* acc = reinterpret_cast<float*>(smem);                                 // BQ x lda
  const Tile tile = carve(smem + BQ * lda * 4);
  float* pair = reinterpret_cast<float*>(smem + BQ * lda * 4 + kTileBytes);   // BQ x LDP
  int8_t* codes = reinterpret_cast<int8_t*>(pair + BQ * LDP);                 // BQ x LDQ
  float* sa = reinterpret_cast<float*>(codes + BQ * LDQ);                     // BQ

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int t = q0 + r;
    acc[r * lda + c] =
        t < T ? __bfloat162float(x[(static_cast<long>(b) * T + t) * D + c]) + bo[c] : 0.f;
  }

  for (int gp = 0; gp < H / 2; ++gp) {
    // both heads of the pair, normalised in f32
    for (int j = 0; j < 2; ++j) {
      const long off = (static_cast<long>(b) * H + 2 * gp + j) * T * HD;
      attn::head(tile, q + off, k + off, v + off, q0, T, t_valid);
      for (int i = tid; i < BQ * HD; i += kThreads) {
        const int r = i / HD, c = i % HD;
        pair[r * LDP + j * HD + c] = tile.o[r * LDO + c] / tile.l[r];
      }
      __syncthreads();
    }

    // one scale per row over the pair's 128 channels; each lane 4 channels
    for (int r = warp; r < BQ; r += kWarps) {
      const float4 val = *reinterpret_cast<const float4*>(pair + r * LDP + lane * 4);
      const float amax = fmaxf(fmaxf(fabsf(val.x), fabsf(val.y)), fmaxf(fabsf(val.z), fabsf(val.w)));
      const float s = row_scale(tpa::warp_max(amax));
      *reinterpret_cast<char4*>(codes + r * LDQ + lane * 4) =
          make_char4(code(val.x, s), code(val.y, s), code(val.z, s), code(val.w, s));
      if (lane == 0) sa[r] = s;
    }
    __syncthreads();

    // acc[:, n] += (codes @ wo[n, 128 gp : 128 gp + 128]^T) * sa * cso[n]
    // (one 128-deep chunk); warp w owns output columns [8w, 8w + 8) + 32 i
    static_assert(PAIR == 128, "the pair's product is one chunk");
    const KChunk a0 = load_chunk(codes + g * LDQ), a1 = load_chunk(codes + (g + 8) * LDQ);
    const float s0 = sa[g], s1 = sa[g + 8];
#pragma unroll 4
    for (int n0 = warp * 8; n0 < D; n0 += kWarps * 8) {
      const KChunk b = load_chunk(wo + static_cast<long>(n0 + g) * D + gp * PAIR);
      const float2 cs = *reinterpret_cast<const float2*>(cso + n0 + t2);
      int c[4] = {0, 0, 0, 0};
      mma_chunk(c, a0, a1, b);
      float* row0 = acc + g * lda + n0 + t2;
      float* row1 = row0 + 8 * lda;
      row0[0] += static_cast<float>(c[0]) * s0 * cs.x;
      row0[1] += static_cast<float>(c[1]) * s0 * cs.y;
      row1[0] += static_cast<float>(c[2]) * s1 * cs.x;
      row1[1] += static_cast<float>(c[3]) * s1 * cs.y;
    }
    __syncthreads();
  }

  store_y_ln(acc, lda, g2, b2, y, hout, b, q0, T, D, eps);
}

// ------------------------------------------------------------- fc1_gelu_int8
namespace f1 {
constexpr int BT = 8, kThreads = 256, kWarps = kThreads / 32;  // one warp per token row
inline int smem_bytes(int d, int ff) { return BT * (ff + 4) * 4 + BT * (d + 16) + BT * 4; }
}  // namespace f1

__global__ void __launch_bounds__(f1::kThreads)
fc1_gelu_int8_kernel(const bf16* __restrict__ h,       // (M, D)
                     const int8_t* __restrict__ w,     // (FF, D)
                     const float* __restrict__ cs,     // (FF)
                     const float* __restrict__ bias,   // (FF)
                     int8_t* __restrict__ out,         // (M, FF) codes
                     float* __restrict__ sg,           // (M) row scales
                     int M, int D, int FF) {
  using namespace f1;
  static_assert(kWarps == BT, "one warp per token row");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = FF + 4, ldh = D + 16;
  float* act = reinterpret_cast<float*>(smem);                        // BT x lda post-GELU
  int8_t* hs = reinterpret_cast<int8_t*>(act + BT * lda);             // BT x ldh codes of h
  float* sh = reinterpret_cast<float*>(hs + BT * ldh);                // BT
  const int m0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  {  // codes of h: warp r quantises token row r
    const int m = m0 + warp;
    int8_t* dst = hs + warp * ldh;
    if (m < M) {
      const bf16* src = h + static_cast<long>(m) * D;
      float amax = 0.f;
      for (int c = lane; c < D; c += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[c])));
      const float s = row_scale(tpa::warp_max(amax));
      for (int c = lane; c < D; c += 32) dst[c] = code(__bfloat162float(src[c]), s);
      if (lane == 0) sh[warp] = s;
    } else {
      for (int c = lane; c < D; c += 32) dst[c] = 0;
      if (lane == 0) sh[warp] = 0.f;
    }
  }
  __syncthreads();

  // act[t][f] = gelu(acc * sh[t] * cs[f] + bias[f]). The weight's 16-feature
  // rows are the A operand, read from L2; the block's 8 token rows are B.
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  for (int f0 = warp * 16; f0 < FF; f0 += kWarps * 16) {
    int c[4] = {0, 0, 0, 0};
    const int8_t* w0 = w + static_cast<long>(f0 + g) * D;
    const int8_t* w1 = w0 + 8L * D;
    const int8_t* hg = hs + g * ldh;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 128)
      mma_chunk(c, load_chunk(w0 + k0), load_chunk(w1 + k0), load_chunk(hg + k0));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = f0 + g + 8 * half;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t2 + u;
        const float z = static_cast<float>(c[2 * half + u]) * sh[t] * cs[f] + bias[f];
        act[t * lda + f] = z * 0.5f * (1.f + erff(z * 0.70710678118654752f));
      }
    }
  }
  __syncthreads();

  {  // the row's requantisation over all FF values: warp r takes token row r
    const int m = m0 + warp;
    if (m < M) {
      const float* row = act + warp * lda;
      float amax = 0.f;
      for (int c = lane * 4; c < FF; c += 128) {
        const float4 val = *reinterpret_cast<const float4*>(row + c);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(val.x), fabsf(val.y)),
                                 fmaxf(fabsf(val.z), fabsf(val.w))));
      }
      const float s = row_scale(tpa::warp_max(amax));
      int8_t* dst = out + static_cast<long>(m) * FF;
      for (int c = lane * 4; c < FF; c += 128) {
        const float4 val = *reinterpret_cast<const float4*>(row + c);
        *reinterpret_cast<char4*>(dst + c) =
            make_char4(code(val.x, s), code(val.y, s), code(val.z, s), code(val.w, s));
      }
      if (lane == 0) sg[m] = s;
    }
  }
}

// --------------------------------------------------------- fc2_residual_int8
namespace f2 {
constexpr int BM = 64, BN = 128, BK = 128, kThreads = 256;
constexpr int LDT = BK + 16;  // tile row stride (bytes)
}  // namespace f2

__global__ void __launch_bounds__(f2::kThreads)
fc2_residual_int8_kernel(const int8_t* __restrict__ gq,   // (M, FF) codes
                         const float* __restrict__ sg,    // (M)
                         const bf16* __restrict__ y,      // (M, D) residual
                         const int8_t* __restrict__ w,    // (D, FF)
                         const float* __restrict__ cs,    // (D)
                         const float* __restrict__ bias,  // (D)
                         bf16* __restrict__ out,          // (M, D)
                         int M, int D, int FF) {
  using namespace f2;
  __shared__ __align__(16) int8_t As[BM * LDT];
  __shared__ __align__(16) int8_t Bs[BN * LDT];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 outputs each
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < FF; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / 16; i += kThreads) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *reinterpret_cast<const int4*>(gq + static_cast<long>(m0 + r) * FF + k0 + c);
      *reinterpret_cast<int4*>(As + r * LDT + c) = val;
    }
    for (int i = threadIdx.x; i < BN * BK / 16; i += kThreads) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      *reinterpret_cast<int4*>(Bs + r * LDT + c) =
          *reinterpret_cast<const int4*>(w + static_cast<long>(n0 + r) * FF + k0 + c);
    }
    __syncthreads();
    warp_tile_32x32(acc, As + wm * 32 * LDT, LDT, Bs + wn * 32 * LDT, LDT);
    __syncthreads();
  }

  // acc * sg * cs + bias + y
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (m >= M) continue;
      const float s = sg[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t2;
        const long o = static_cast<long>(m) * D + n;
        const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(y + o);
        const float o0 = static_cast<float>(acc[i][j][2 * half]) * s * cs[n] + bias[n] +
                         __low2float(res);
        const float o1 = static_cast<float>(acc[i][j][2 * half + 1]) * s * cs[n + 1] +
                         bias[n + 1] + __high2float(res);
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(o0, o1);
      }
    }
}

}  // namespace

extern "C" int tpa_ln_qkv_int8(const bf16* x, const float* ln_w, const float* ln_b,
                               const int8_t* w, const float* cs, const float* bias, bf16* q,
                               bf16* k, bf16* v, int batch, int T, int D, int H, float eps,
                               cudaStream_t stream) {
  if (D % lq8::BK || H % 2 || D != H * attn::HD) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lq8::smem_bytes(D);
  cudaError_t err = tpa::allow_smem(ln_qkv_int8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = batch * T;
  ln_qkv_int8_kernel<<<(M + lq8::BM - 1) / lq8::BM, lq8::kThreads, smem, stream>>>(
      x, ln_w, ln_b, w, cs, bias, q, k, v, M, T, D, H, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpa_attn_oproj_ln_int8(const bf16* q, const bf16* k, const bf16* v,
                                      const bf16* x, const int8_t* wo, const float* cso,
                                      const float* bo, const float* g2, const float* b2, bf16* y,
                                      bf16* h, int batch, int T, int H, int t_valid, float eps,
                                      cudaStream_t stream) {
  if (H % 2 || t_valid < 1 || t_valid > T) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ao8::smem_bytes(H * attn::HD);
  cudaError_t err = tpa::allow_smem(attn_oproj_ln_int8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + attn::BQ - 1) / attn::BQ, batch);
  attn_oproj_ln_int8_kernel<<<grid, attn::kThreads, smem, stream>>>(q, k, v, x, wo, cso, bo, g2,
                                                                    b2, y, h, T, H, t_valid, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpa_fc1_gelu_int8(const bf16* h, const int8_t* w, const float* cs,
                                 const float* bias, int8_t* codes, float* sg, int M, int D,
                                 int FF, cudaStream_t stream) {
  if (D % 128 || FF % 128) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = f1::smem_bytes(D, FF);
  cudaError_t err = tpa::allow_smem(fc1_gelu_int8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fc1_gelu_int8_kernel<<<(M + f1::BT - 1) / f1::BT, f1::kThreads, smem, stream>>>(
      h, w, cs, bias, codes, sg, M, D, FF);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpa_fc2_residual_int8(const int8_t* g, const float* sg, const bf16* y,
                                     const int8_t* w, const float* cs, const float* bias,
                                     bf16* out, int M, int D, int FF, cudaStream_t stream) {
  if (D % f2::BN || FF % f2::BK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(D / f2::BN, (M + f2::BM - 1) / f2::BM);
  fc2_residual_int8_kernel<<<grid, f2::kThreads, 0, stream>>>(g, sg, y, w, cs, bias, out, M, D,
                                                              FF);
  return static_cast<int>(cudaGetLastError());
}
