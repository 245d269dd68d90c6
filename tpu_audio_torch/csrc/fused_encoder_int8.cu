// The W8A8 Whisper encoder block: per-output-channel int8 weights,
// per-row int8 activations quantised inside the kernels, exact int32 sums
// on the tensor cores, f32 epilogues. Four entry points per block, in this
// order:
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
//                       and one f32 scale per row. Two launches: quant_rows,
//                       then fc1_gemm.
//   fc2_residual_int8   replaces fused_encoder.py:fc2_residual_int8. s8 GEMM
//                       of those codes with the (D, FF) weight ->
//                       acc * sg * cs + bias + y.
//
// Row quantisation everywhere: s = max(max|row| / 127, 1e-10), codes
// clip(rint(row / s), -127, 127) (round half to even, as torch.round and
// jnp.round), as int8_matmul.cu; the division is true division. fc1 and fc2
// round each product and sum of their epilogues on its own (no FMA
// contraction), in the plain versions' order, so their outputs equal the
// plain versions' on the card bit for bit.
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
// ln_qkv_int8 and attn_oproj_ln_int8: mma.sync m16n8k32 s8 fragments taken
// from 128-deep k chunks that each lane reads with two 16-byte loads, k
// permuted alike in A and B (row strides of 16 mod 128 bytes keep the
// shared-memory loads free of bank conflicts); no TMA, no wgmma.
// - ln_qkv_int8 normalises and quantises 64 rows once into 83 KB of shared
//   memory (half the bf16 kernel's tile) and streams 128 x 128 weight tiles
//   past them; 8 warps of 32 x 32 outputs.
// - attn_oproj_ln_int8 needs both heads of a pair finished before the
//   pair's row maximum exists, so it loops over pairs and keeps the f32 pair
//   tile and its codes in shared memory beside the (16, D) accumulator; the
//   o-weight's fragments come from L2.
// fc1_gelu_int8 and fc2_residual_int8: TMA + s8 wgmma (hopper.cuh), A and B
// K-major 128-byte-swizzled tiles 128 bytes deep (four k32 steps a stage).
// - fc2_residual_int8 (fc2_gemm): the persistent GEMM of ln_qkv.cu's
//   qkv_gemm in s8: 128 x 256 tiles (940 at batch 16 over 132 SMs), a
//   producer warp keeping a 3-stage ring of TMA loads in flight across
//   tiles, two consumer warpgroups of m64n256k32 (128 s32 a thread); the
//   epilogue rounds to bf16 into shared memory and stores 16-byte chunks.
//   A 128 x 160 tile (1504 tiles, a fuller last round) measured slower.
// - fc1_gelu_int8: the row scale needs all FF post-GELU values of a row.
//   quant_rows (one warp a row) writes h's codes and scales into the
//   caller's scratch (61 MB read, 31 MB written); then fc1_gemm,
//   design (a) of the three exact ones: a thread-block cluster of
//   C = FF / 320 = 16 blocks (non-portable past 8) shares a 128-row tile,
//   each block 320 of its FF columns, so the tensor work is done once and
//   no f32 leaves the chip. Four consumer warpgroups of m64n160k32 hold the
//   128 x 320 values, 80 a thread in registers; each block stores its rows'
//   partial |max| into every block of the cluster (st.shared::cluster), one
//   cluster barrier, and every block quantises its columns by the full
//   row's scale. The card holds 7 such clusters (112 SMs); each walks row
//   tiles persistently. The weight is read from L2 once per row tile
//   (188 x 6.55 MB = 1.23 GB). Not kept: (b) two sweeps over FF, twice the
//   tensor work and the erff (a 0.318 ms floor); (c) an f32 scratch with an
//   atomic row max, 614 MB more traffic (a ~0.33 ms floor). The epilogue
//   (erff GELU, the exchange, the quotient, the codes) takes about half of
//   fc1's time (PERF.md) and does not overlap the tensor cores: the 80
//   values leave no registers for the next tile's accumulators.
// T need not be a multiple of anything: row tails are zero-filled by TMA or
// guarded and never stored, keys >= t_valid are masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
namespace attn = tpa::attn;
namespace hp = tpa::hopper;

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
// quant_rows: one warp a row, 16-byte loads; h's codes and scale into the
// caller's scratch.
constexpr int kQuantRows = 8;  // rows (warps) per quant_rows block

__global__ void __launch_bounds__(kQuantRows * 32)
quant_rows_kernel(const bf16* __restrict__ h, int8_t* __restrict__ hq, float* __restrict__ sh,
                  int M, int D) {
  const int row = blockIdx.x * kQuantRows + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* src = reinterpret_cast<const uint4*>(h + static_cast<long long>(row) * D);
  uint2* dst = reinterpret_cast<uint2*>(hq + static_cast<long long>(row) * D);
  const int nv = D / 8;
  float amax = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
  const float s = row_scale(tpa::warp_max(amax));
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    uint2 out;
    signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = code(__bfloat162float(e[j]), s);
    dst[c] = out;
  }
  if (lane == 0) sh[row] = s;
}

// (acc * s) * c + b, each product and sum rounded on its own (no FMA
// contraction), the plain version's order.
__device__ __forceinline__ float dequant(int acc, float s, float c, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), s), c), b);
}

__device__ __forceinline__ float gelu(float z) {
  return z * 0.5f * (1.f + erff(z * 0.70710678118654752f));
}

namespace f1 {
constexpr int BM = 128, BK = 128, kStages = 3;
constexpr int kConsumers = 4;               // 2 row halves x 2 column halves
constexpr int kThreads = kConsumers * 128;  // no producer warp: 128 registers a thread
constexpr int kMaxCluster = 16;
// NW columns a warpgroup (wgmma m64nNWk32), 2 NW a block, FF / (2 NW) blocks
// a cluster. Shared memory: two buffers of every rank's row maxima, the
// second column half's, the block's cs and bias, the barriers, then
// 1024-aligned the ring.
template <int NW>
struct Tile {
  static constexpr int BN = 2 * NW;
  static constexpr int kABytes = BM * BK;  // 16 KB
  static constexpr int kBBytes = BN * BK;  // 40 KB at NW = 160
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kHead = (2 * kMaxCluster + 1) * BM * 4 + 2 * BN * 4 + 2 * kStages * 8;
  static constexpr int kSmem = kHead + 1024 + kStages * kStageBytes;
};
}  // namespace f1

template <int NW>
__device__ __forceinline__ void wgmma_s8(int (&d)[NW / 2], uint64_t a, uint64_t b) {
  if constexpr (NW == 160) hp::wgmma_m64n160k32_s8(d, a, b, 1);
  else hp::wgmma_m64n128k32_s8(d, a, b, 1);
}

// RN(v / s), given r = RN(1 / s): q1 = q0 + (v - q0 s) r is within a small
// fraction of an ulp of v / s, and one more such step rounds correctly
// (Markstein's theorem: r within half an ulp of 1 / s, the quotient within
// one ulp, the remainder exact by FMA), so this is the IEEE quotient that
// `v / s` gives, without a reciprocal on the SFU for every value.
__device__ __forceinline__ float quotient(float v, float s, float r) {
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
  return __fmaf_rn(__fmaf_rn(-q1, s, v), r, q1);
}

// clip(rint(q), -127, 127) for |q| < 2^22 on the full-rate pipes: adding
// 1.5 * 2^23 rounds q to an integer (half to even) in the sum's low bits.
__device__ __forceinline__ int round_clip(float q) {
  const int n = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000;
  return min(max(n, -127), 127);
}

// Two codes in the low 16 bits, the first in the low byte.
__device__ __forceinline__ uint32_t pair_codes(float q0, float q1) {
  return (round_clip(q0) & 0xFF) | (round_clip(q1) & 0xFF) << 8;
}

// The four lanes t = lane % 4 of a row each hold a 16-bit pair of every one
// of four 8-byte chunks (pk[i]: chunk i, lane t's columns 2t, 2t + 1);
// returns chunk t whole: lane 0's pair first. Round one swaps chunk pairs
// with lane t ^ 2, round two single chunks with lane t ^ 1.
__device__ __forceinline__ uint2 gather_chunk(const uint32_t (&pk)[4], int lane) {
  const int t = lane & 3, e = t & 1;
  const uint32_t w01 = pk[0] | pk[1] << 16, w23 = pk[2] | pk[3] << 16;
  const uint32_t mine = t < 2 ? w01 : w23;  // this lane's pairs of chunks 2 (t / 2) + {0, 1}
  const uint32_t other = __shfl_xor_sync(0xffffffffu, t < 2 ? w23 : w01, 2);  // lane t ^ 2's
  // A, B: lanes t and t ^ 2 in chunk t; the partner t ^ 1 wants its own chunk
  const uint32_t a = e ? mine >> 16 : mine & 0xFFFF, b = e ? other >> 16 : other & 0xFFFF;
  const uint32_t send = e ? (mine & 0xFFFF) | other << 16 : mine >> 16 | (other & 0xFFFF0000u);
  const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);  // lanes t ^ 1, t ^ 3 in chunk t
  const uint32_t c = got & 0xFFFF, d = got >> 16;
  const uint32_t p = e ? c | a << 16 : a | c << 16;  // lanes 2 (t / 2) + {0, 1}
  const uint32_t r = e ? d | b << 16 : b | d << 16;  // lanes 2 (1 - t / 2) + {0, 1}
  return t < 2 ? make_uint2(p, r) : make_uint2(r, p);
}

// A cluster of C = FF / (2 NW) blocks takes a 128-row tile, block r (its
// rank) columns [2 NW r, 2 NW (r + 1)); the grid holds as many clusters as
// the card runs at once, and cluster j walks row tiles j, j + gridDim.y, ...
// (persistent: one cluster a row tile lost time to the waves' fill). Thread
// 0 streams the h codes' 128 x 128 tile and the weight's 2 NW x 128 tile of
// each k step through a 3-stage ring, refilling a stage once all four
// warpgroups have released it, and so runs on into the next row tile while
// this one's epilogue runs (a producer warp would cost the 80 accumulators
// their registers: ptxas sizes 544 threads as 640, 96 registers).
// Warpgroup w multiplies rows 64 (w / 2).. by columns NW (w % 2).. . The
// post-GELU values stay in the accumulators' registers while each block
// stores its rows' partial |max| into every block of the cluster: one
// cluster barrier a tile, then local reads, the buffers alternating between
// tiles. The codes go out from registers, 8 bytes a lane (a shuffle transpose).
template <int NW>
__global__ void __launch_bounds__(f1::kThreads, 1)
fc1_gemm_kernel(__grid_constant__ const CUtensorMap map_a,  // hq (M, D) int8
                __grid_constant__ const CUtensorMap map_b,  // w (FF, D) int8
                const float* __restrict__ sh,               // (M)
                const float* __restrict__ cs,               // (FF)
                const float* __restrict__ bias,             // (FF)
                int8_t* __restrict__ out,                   // (M, FF) codes
                float* __restrict__ sg,                     // (M)
                int M, int D, int FF) {
  using namespace f1;
  using T = Tile<NW>;
  extern __shared__ unsigned char smem_raw[];
  float* pall = reinterpret_cast<float*>(smem_raw);  // 2 x kMaxCluster x BM: [buffer][rank][row]
  float* phalf = pall + 2 * kMaxCluster * BM;         // BM: column half 1's row maxima
  float* cs_s = phalf + BM;                           // BN: the block's cs, then its bias
  float* bias_s = cs_s + T::BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + T::BN);
  uint64_t* empty = full + kStages;
  unsigned char* head_end = smem_raw + T::kHead;
  unsigned char* ring = head_end + ((1024 - (hp::smem_addr(head_end) & 1023)) & 1023);

  const uint32_t rank = hp::cluster_rank(), n_ranks = FF / T::BN;
  const int n0 = rank * T::BN;
  const int ksteps = D / BK, n_tiles = (M + BM - 1) / BM;
  const int n_steps = ksteps * ((n_tiles - static_cast<int>(blockIdx.y) +
                                 static_cast<int>(gridDim.y) - 1) / gridDim.y);
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    hp::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < T::BN; i += kThreads) {
    cs_s[i] = cs[n0 + i];
    bias_s[i] = bias[n0 + i];
  }
  hp::cluster_arrive();  // every block of the cluster runs before a peer stores into it
  hp::cluster_wait();

  // step g of this block: k step g % ksteps of its (g / ksteps)-th row tile
  const auto issue = [&](int g) {  // (thread 0)
    const int s = g % kStages, kk = (g % ksteps) * BK;
    const int m0 = (blockIdx.y + (g / ksteps) * gridDim.y) * BM;
    unsigned char* st = ring + s * T::kStageBytes;
    hp::mbar_arrive_expect_tx(&full[s], T::kStageBytes);
    hp::tma_load_2d(st, &map_a, &full[s], kk, m0);
    hp::tma_load_2d(st + T::kABytes, &map_b, &full[s], kk, n0);
    hp::tma_load_2d(st + T::kABytes + NW * BK, &map_b, &full[s], kk, n0 + NW);
  };
  // release step g's stage; thread 0 refills it with step g + kStages
  const auto release = [&](int g) {
    const int s = g % kStages;
    if (lane == 0) hp::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && g + kStages < n_steps) {
      hp::mbar_wait(&empty[s], (g / kStages) & 1);
      issue(g + kStages);
    }
  };
  if (threadIdx.x == 0)
    for (int g = 0; g < kStages && g < n_steps; ++g) issue(g);

  const int wr = wg / 2, wc = wg % 2;
  int g = 0;
  for (int tile = blockIdx.y, it = 0; tile < n_tiles; tile += gridDim.y, ++it) {
    int acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
    for (int kk = 0; kk < ksteps; ++kk, ++g) {
      const int s = g % kStages;
      hp::mbar_wait(&full[s], (g / kStages) & 1);
      const unsigned char* st = ring + s * T::kStageBytes;
      const uint64_t da = hp::desc_sw128(st + wr * 64 * BK);
      const uint64_t db = hp::desc_sw128(st + T::kABytes + wc * NW * BK);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) wgmma_s8<NW>(acc, da + 2 * j, db + 2 * j);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous step's products are done: release its stage
      hp::fence_regs(acc);
      if (kk > 0) release(g - 1);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    release(g - 1);  // thread 0 starts the next row tile's loads

    // gelu(acc * sh * cs + bias), kept in acc's registers as f32 bits; thread
    // (warp, lane) holds rows r0 and r0 + 8 of the tile, columns
    // c0 + 8 j + {0, 1} of the block's
    const int m0 = tile * BM;
    const int r0 = wr * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int c0 = wc * NW + 2 * (lane % 4);
    const float s_lo = m0 + r0 < M ? sh[m0 + r0] : 0.f;
    const float s_hi = m0 + r0 + 8 < M ? sh[m0 + r0 + 8] : 0.f;
    float amax_lo = 0.f, amax_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(cs_s + c0 + 8 * j);
      const float2 b = *reinterpret_cast<const float2*>(bias_s + c0 + 8 * j);
      const float v0 = gelu(dequant(acc[4 * j], s_lo, c.x, b.x));
      const float v1 = gelu(dequant(acc[4 * j + 1], s_lo, c.y, b.y));
      const float v2 = gelu(dequant(acc[4 * j + 2], s_hi, c.x, b.x));
      const float v3 = gelu(dequant(acc[4 * j + 3], s_hi, c.y, b.y));
      amax_lo = fmaxf(amax_lo, fmaxf(fabsf(v0), fabsf(v1)));
      amax_hi = fmaxf(amax_hi, fmaxf(fabsf(v2), fabsf(v3)));
      acc[4 * j] = __float_as_int(v0);
      acc[4 * j + 1] = __float_as_int(v1);
      acc[4 * j + 2] = __float_as_int(v2);
      acc[4 * j + 3] = __float_as_int(v3);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // the four lanes of a row
      amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, o));
      amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, o));
    }
    // the block's row maxima into every rank's buffer `it & 1`: column half
    // 1 hands its rows to half 0, whose four lanes of a row take every
    // fourth rank. A peer writes this buffer again two tiles on, after the
    // next tile's barrier, which this block passes only after these reads.
    float* buf = pall + (it & 1) * kMaxCluster * BM;
    if (wc == 1 && lane % 4 == 0) {
      phalf[r0] = amax_lo;
      phalf[r0 + 8] = amax_hi;
    }
    hp::named_barrier(2 + wr, 256);
    if (wc == 0) {
      const float p_lo = fmaxf(amax_lo, phalf[r0]), p_hi = fmaxf(amax_hi, phalf[r0 + 8]);
      for (uint32_t q = lane % 4; q < n_ranks; q += 4) {
        hp::st_peer(buf + rank * BM + r0, q, p_lo);
        hp::st_peer(buf + rank * BM + r0 + 8, q, p_hi);
      }
    }
    hp::cluster_arrive();
    hp::cluster_wait();

    // the row's |max| over all FF, the four lanes of a row taking every fourth rank
    for (uint32_t q = lane % 4; q < n_ranks; q += 4) {
      amax_lo = fmaxf(amax_lo, buf[q * BM + r0]);
      amax_hi = fmaxf(amax_hi, buf[q * BM + r0 + 8]);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, o));
      amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, o));
    }
    const float g_lo = row_scale(amax_lo), g_hi = row_scale(amax_hi);
    const float i_lo = __frcp_rn(g_lo), i_hi = __frcp_rn(g_hi);
    if (rank == 0 && wc == 0 && lane % 4 == 0) {
      if (m0 + r0 < M) sg[m0 + r0] = g_lo;
      if (m0 + r0 + 8 < M) sg[m0 + r0 + 8] = g_hi;
    }
    // codes: lane t of a row holds two codes of each 8-column chunk j; two
    // shuffles hand it all eight of chunk 4 q + t, one 8-byte store each
    int8_t* row_lo = out + static_cast<long long>(m0 + r0) * FF + n0 + wc * NW + 8 * (lane % 4);
    int8_t* row_hi = row_lo + 8LL * FF;
#pragma unroll
    for (int q = 0; q < NW / 32; ++q) {
      uint32_t pk_lo[4], pk_hi[4];  // chunk 4 q + i: this lane's two codes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        pk_lo[i] = pair_codes(quotient(__int_as_float(acc[4 * j]), g_lo, i_lo),
                              quotient(__int_as_float(acc[4 * j + 1]), g_lo, i_lo));
        pk_hi[i] = pair_codes(quotient(__int_as_float(acc[4 * j + 2]), g_hi, i_hi),
                              quotient(__int_as_float(acc[4 * j + 3]), g_hi, i_hi));
      }
      const uint2 w_lo = gather_chunk(pk_lo, lane), w_hi = gather_chunk(pk_hi, lane);
      if (m0 + r0 < M) *reinterpret_cast<uint2*>(row_lo + 32 * q) = w_lo;
      if (m0 + r0 + 8 < M) *reinterpret_cast<uint2*>(row_hi + 32 * q) = w_hi;
    }
  }
}

// --------------------------------------------------------- fc2_residual_int8
namespace f2 {
constexpr int BM = 128, BN = 256, BK = 128, kStages = 3;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kABytes = BM * BK;                 // 16 KB
constexpr int kBBytes = BN * BK;                 // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int LDC = BN + 8;                      // staged output row, bf16
constexpr int kSmem = 1024 + kStages * kStageBytes + BM * LDC * 2 + 2 * kStages * 8;
}  // namespace f2

// Persistent: block i takes output tiles i, i + gridDim.x, ..., the N tiles
// of one row block consecutive; the ring runs on into the next tile while
// this one is stored (the pattern of ln_qkv.cu's qkv_gemm).
__global__ void __launch_bounds__(f2::kThreads, 1)
fc2_gemm_kernel(__grid_constant__ const CUtensorMap map_a,  // codes (M, FF) int8
                __grid_constant__ const CUtensorMap map_b,  // w (D, FF) int8
                const float* __restrict__ sg,               // (M)
                const bf16* __restrict__ y,                 // (M, D) residual
                const float* __restrict__ cs,               // (D)
                const float* __restrict__ bias,             // (D)
                bf16* __restrict__ out,                     // (M, D)
                int M, int D, int FF) {
  using namespace f2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;                                        // kStages x (A | B)
  bf16* cst = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);  // BM x LDC
  uint64_t* full = reinterpret_cast<uint64_t*>(cst + BM * LDC);
  uint64_t* empty = full + kStages;

  const int n_tiles_n = (D + BN - 1) / BN;
  const int n_tiles = n_tiles_n * ((M + BM - 1) / BM);
  const int ksteps = FF / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp: one lane issues every load
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;  // k-steps issued, over all of this block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles_n) * BN, m0 = (tile / n_tiles_n) * BM;
        for (int kk = 0; kk < ksteps; ++kk, ++it) {
          const int s = it % kStages;
          if (it >= kStages) hp::mbar_wait(&empty[s], (it / kStages - 1) & 1);
          hp::mbar_arrive_expect_tx(&full[s], kStageBytes);
          hp::tma_load_2d(ring + s * kStageBytes, &map_a, &full[s], kk * BK, m0);
          hp::tma_load_2d(ring + s * kStageBytes + kABytes, &map_b, &full[s], kk * BK, n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg*64 .. wg*64 + 63 of each tile
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x & 31;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles_n) * BN, m0 = (tile / n_tiles_n) * BM;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kk = 0; kk < ksteps; ++kk, ++it) {
      const int s = it % kStages;
      hp::mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t da = hp::desc_sw128(ring + s * kStageBytes + wg * 64 * BK);
      const uint64_t db = hp::desc_sw128(ring + s * kStageBytes + kABytes);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) hp::wgmma_m64n256k32_s8(acc, da + 2 * j, db + 2 * j, 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous step's products are done: release its stage
      hp::fence_regs(acc);
      if (kk > 0 && lane == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (lane == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);

    // acc * sg * cs + bias + y, rounded once to bf16 into the staged tile
    const int m_lo = m0 + r0, m_hi = m_lo + 8;
    const float s_lo = m_lo < M ? sg[m_lo] : 0.f, s_hi = m_hi < M ? sg[m_hi] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2, n = n0 + c;
      float2 cc = make_float2(0.f, 0.f), bb = cc, y_lo = cc, y_hi = cc;
      if (n < D) {
        cc = *reinterpret_cast<const float2*>(cs + n);
        bb = *reinterpret_cast<const float2*>(bias + n);
        if (m_lo < M)
          y_lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(y + static_cast<long long>(m_lo) * D + n));
        if (m_hi < M)
          y_hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(y + static_cast<long long>(m_hi) * D + n));
      }
      *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
          hp::pack_bf16(__fadd_rn(dequant(acc[4 * j], s_lo, cc.x, bb.x), y_lo.x),
                        __fadd_rn(dequant(acc[4 * j + 1], s_lo, cc.y, bb.y), y_lo.y));
      *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
          hp::pack_bf16(__fadd_rn(dequant(acc[4 * j + 2], s_hi, cc.x, bb.x), y_hi.x),
                        __fadd_rn(dequant(acc[4 * j + 3], s_hi, cc.y, bb.y), y_hi.y));
    }
    hp::named_barrier(1 + wg, 128);
    // 16-byte stores of the warpgroup's 64 rows, neighbouring threads on
    // neighbouring chunks of a row
    constexpr int kChunks = BN / 8;
    for (int i = tid; i < 64 * kChunks; i += 128) {
      const int r = wg * 64 + i / kChunks, c = (i % kChunks) * 8;
      const int m = m0 + r, n = n0 + c;
      if (m < M && n < D)
        *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * D + n) =
            *reinterpret_cast<const uint4*>(cst + r * LDC + c);
    }
    hp::named_barrier(1 + wg, 128);  // the rows are read before the next tile writes them
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

namespace {

// fc1's split of FF: NW columns a warpgroup, FF / (2 NW) blocks a cluster,
// at most 16 (non-portable past 8); 0 where no split fits.
int fc1_nw(int FF) {
  constexpr int kNw[2] = {160, 128};
  for (const int nw : kNw)
    if (FF % (2 * nw) == 0 && FF / (2 * nw) <= f1::kMaxCluster) return nw;
  return 0;
}

// Launch fc1_gemm_kernel<NW> on hq, or, given `clusters`, report how many
// of its clusters the card holds at once instead.
template <int NW>
cudaError_t fc1_gemm(const int8_t* hq, const int8_t* w, const float* sh, const float* cs,
                     const float* bias, int8_t* codes, float* sg, int M, int D, int FF,
                     cudaStream_t stream, int* clusters) {
  using T = f1::Tile<NW>;
  const auto kernel = fc1_gemm_kernel<NW>;
  const unsigned n_ranks = FF / T::BN;
  cudaError_t err = tpa::allow_smem(kernel, T::kSmem);
  if (err == cudaSuccess && n_ranks > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ranks, (M + f1::BM - 1) / f1::BM);
  cfg.blockDim = dim3(f1::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess || clusters != nullptr) {
    if (clusters != nullptr) *clusters = active;
    return err;
  }
  if (active < 1) return cudaErrorLaunchOutOfResources;
  const int tiles = (M + f1::BM - 1) / f1::BM;
  cfg.gridDim.y = tiles < active ? tiles : active;

  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(FF)};
  const uint64_t strides[1] = {static_cast<uint64_t>(D)};
  const uint32_t box_a[2] = {f1::BK, f1::BM}, box_b[2] = {f1::BK, NW};
  err = hp::encode_map(&map_a, hp::kS8, hq, 2, dims_a, strides, box_a);
  if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kS8, w, 2, dims_b, strides, box_b);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, sh, cs, bias, codes, sg, M, D, FF);
}

}  // namespace

// Two launches: quant_rows (h -> hq, sh, the caller's scratch), then the
// cluster GEMM with its requantising epilogue.
extern "C" int tpa_fc1_gelu_int8(const bf16* h, const int8_t* w, const float* cs,
                                 const float* bias, int8_t* hq, float* sh, int8_t* codes,
                                 float* sg, int M, int D, int FF, cudaStream_t stream) {
  const int nw = fc1_nw(FF);
  if (D % f1::BK || nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  quant_rows_kernel<<<(M + kQuantRows - 1) / kQuantRows, kQuantRows * 32, 0, stream>>>(
      h, hq, sh, M, D);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = nw == 160 ? fc1_gemm<160>(hq, w, sh, cs, bias, codes, sg, M, D, FF, stream, nullptr)
                    : fc1_gemm<128>(hq, w, sh, cs, bias, codes, sg, M, D, FF, stream, nullptr);
  return static_cast<int>(err);
}

// How many of fc1's clusters (FF / (2 NW) blocks each) fit the card at once.
extern "C" int tpa_fc1_gelu_int8_clusters(int* clusters, int D, int FF, cudaStream_t stream) {
  const int nw = fc1_nw(FF);
  if (D % f1::BK || nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      nw == 160 ? fc1_gemm<160>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                f1::BM, D, FF, stream, clusters)
                : fc1_gemm<128>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                f1::BM, D, FF, stream, clusters);
  return static_cast<int>(err);
}

extern "C" int tpa_fc2_residual_int8(const int8_t* g, const float* sg, const bf16* y,
                                     const int8_t* w, const float* cs, const float* bias,
                                     bf16* out, int M, int D, int FF, cudaStream_t stream) {
  if (D % 128 || FF % f2::BK) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(FF), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(FF), static_cast<uint64_t>(D)};
  const uint64_t strides[1] = {static_cast<uint64_t>(FF)};
  const uint32_t box_a[2] = {f2::BK, f2::BM}, box_b[2] = {f2::BK, f2::BN};
  cudaError_t err = hp::encode_map(&map_a, hp::kS8, g, 2, dims_a, strides, box_a);
  if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kS8, w, 2, dims_b, strides, box_b);
  if (err == cudaSuccess) err = tpa::allow_smem(fc2_gemm_kernel, f2::kSmem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (D + f2::BN - 1) / f2::BN * ((M + f2::BM - 1) / f2::BM);
  fc2_gemm_kernel<<<tiles < sms ? tiles : sms, f2::kThreads, f2::kSmem, stream>>>(
      map_a, map_b, sg, y, cs, bias, out, M, D, FF);
  return static_cast<int>(cudaGetLastError());
}
