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
//                       the q and k columns. Two launches: ln_quant_rows,
//                       then s8_gemm<true>.
//   attn_oproj_ln_int8  replaces fused_encoder.py:attn_oproj_ln_int8. Both
//                       heads' attention of each head pair, normalised in
//                       f32 and row-quantised per pair (one scale per row per
//                       pair, never rounded to bf16 first); an s8 product of
//                       each pair's codes with the pair's 128 input channels
//                       of the o-weight, acc * sa * cso added in f32 onto
//                       x + bo; finally y and h = LayerNorm2(y). Two
//                       launches: pair_codes, then oproj_ln.
//   fc1_gelu_int8       replaces fused_encoder.py:fc1_gelu_int8. h -> row
//                       quantisation -> s8 GEMM with the (FF, D) weight ->
//                       acc * sh * cs + bias -> erf GELU (erff) -> the row's
//                       requantisation over all FF values: int8 codes (B,T,FF)
//                       and one f32 scale per row. Two launches: quant_rows,
//                       then fc1_gemm.
//   fc2_residual_int8   replaces fused_encoder.py:fc2_residual_int8. s8 GEMM
//                       of those codes with the (D, FF) weight ->
//                       acc * sg * cs + bias + y (s8_gemm<false>).
//
// Row quantisation everywhere: s = max(max|row| / 127, 1e-10), codes
// clip(rint(row / s), -127, 127) (round half to even, as torch.round and
// jnp.round), as int8_matmul.cu; the division is true division. The
// epilogues round each product and sum on its own (no FMA contraction), in
// the plain versions' order, so that fc1's, fc2's and oproj_ln's y equal
// the plain versions' on the card bit for bit, given the same codes.
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
// All four are TMA + wgmma kernels (hopper.cuh): A and B K-major
// 128-byte-swizzled tiles 128 bytes deep (four k32 steps a stage), s32 sums.
// - s8_gemm (fc2_residual_int8, and ln_qkv_int8's product): the persistent
//   GEMM of ln_qkv.cu's qkv_gemm in s8: 128 x 256 tiles (940 for fc2, 2820
//   for ln_qkv_int8 at batch 16, over 132 SMs), a producer warp keeping a
//   3-stage ring of TMA loads in flight across tiles, two consumer
//   warpgroups of m64n256k32 (128 s32 a thread); the epilogue rounds to bf16
//   into shared memory and stores 16-byte chunks: rows of (M, N) for fc2,
//   each head's 64 columns of a row into q, k or v for ln_qkv_int8 (a
//   128-row tile straddles batches at T = 1500, so each row finds its own
//   (b, t)). A 128 x 160 tile (1504 fc2 tiles, a fuller last round)
//   measured slower. ln_quant_rows (one warp a row) writes the LayerNormed
//   rows' codes and scales into the caller's scratch (61 MB read, 31 MB
//   written) first: the s8 product needs the codes as its A tiles.
// - attn_oproj_ln_int8: the TPU kernel keeps a (rows, D) f32 o-projection
//   accumulator across the pairs; 128 rows x 1280 f32 is 640 KB, more than
//   a block holds, and 16-row tiles waste the tensor cores and K/V reads 8x.
//   So it is split at the pair codes, two launches with a scratch between:
//   pair_codes is encoder_attention.cu's block (attention_wgmma.cuh's
//   `attend`: 128 query rows of one head, 4-stage K/V ring, wgmma for S
//   and P V, two blocks an SM) in clusters of two, heads 2g and 2g + 1 of
//   the same rows. The block first sweeps the key tiles for each row's
//   exact max (S alone), so that its bf16 probabilities round as the plain
//   version's (rounded against a running max, each probability may land
//   on the other side of a bf16 rounding, and the codes of a row with it).
//   Each block divides O by l (true division, as the plain
//   version), takes each row's |max| over its 64 channels, stores it into
//   the peer (st.shared::cluster, one cluster barrier), codes its 64
//   columns by the pair's scale and writes them with 16-byte stores into
//   columns 128 g + 64 j of the (M, D) codes; rank 0 writes the pair's
//   scale into (M, D / 128). oproj_ln is an s8 GEMM whose 128-byte k-stages
//   are exactly the pairs, each with its own row scale, so each stage's s32
//   sums (m64n128k32, starting from zero) are dequantised and added in f32
//   before the next: acc = x + bo, then acc += (sum * sa) * cso a pair, in
//   the plain version's order (|sum| < 2^22: converted exactly by adding
//   1.5 * 2^23). LayerNorm2 needs all D columns of a row, so a cluster of
//   ceil(D / 256) blocks (5 at D = 1280) shares a 128-row tile, each block
//   256 columns in two halves of 128 (128 f32 a thread), and the row
//   statistics go through every rank's shared memory in two rounds (the
//   sum, then the sum of squared deviations from the mean), each one
//   cluster barrier; y and h leave as bf16, no f32 leaves the chip. The
//   card holds 22 clusters of 5 (110 SMs); blocks of 128 columns in
//   clusters of 10 fit 7 (70 SMs) and took 1.7x as long. Thread 0 refills
//   the ring as the stages are released, running on into the next tile
//   during this one's epilogue.
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

#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "oproj_ln.cuh"

using bf16 = __nv_bfloat16;
namespace hp = tpa::hopper;
namespace aw = tpa::attn_wgmma;
namespace op = tpa::oproj;

namespace {

__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax / 127.0f, 1e-10f); }

__device__ __forceinline__ signed char code(float v, float s) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// ---------------------------------------------------------- the row passes
// quant_rows (fc1_gelu_int8): one warp a row, 16-byte loads; h's codes and
// scale into the caller's scratch.
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

// ln_quant_rows (ln_qkv_int8): LayerNorm1 in f32 (the mean, then the mean square of the
// deviations, as the TPU kernels' _ln_f32), the row's |max|, its codes and
// scale into the caller's scratch; one warp a row, 16-byte loads, the row
// re-read from L1 in each pass. Each product and sum of the normalisation
// is rounded on its own, in the plain version's order.
__global__ void __launch_bounds__(kQuantRows * 32)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int D, float eps) {
  const int row = blockIdx.x * kQuantRows + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
  uint2* dst = reinterpret_cast<uint2*>(xq + static_cast<long long>(row) * D);
  const int nv = D / 8;
  float s = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
  const float mu = tpa::warp_sum(s) / D;
  float ss = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - mu;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(tpa::warp_sum(ss) / D + eps);
  // the 8 normalised values of chunk c
  const auto norm = [&](int c, float (&v)[8]) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    const float4 w0 = reinterpret_cast<const float4*>(ln_w)[2 * c];
    const float4 w1 = reinterpret_cast<const float4*>(ln_w)[2 * c + 1];
    const float4 b0 = reinterpret_cast<const float4*>(ln_b)[2 * c];
    const float4 b1 = reinterpret_cast<const float4*>(ln_b)[2 * c + 1];
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(e[j]), mu), rstd), w[j]),
                       b[j]);
  };
  float amax = 0.f;
  for (int c = lane; c < nv; c += 32) {
    float v[8];
    norm(c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float scale = row_scale(tpa::warp_max(amax));
  for (int c = lane; c < nv; c += 32) {
    float v[8];
    norm(c, v);
    uint2 out;
    signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = code(v[j], scale);
    dst[c] = out;
  }
  if (lane == 0) sx[row] = scale;
}

// Two floats from shared memory, loaded where they are used: a volatile load
// is not hoisted out of a loop into registers that the loop needs.
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(hp::smem_addr(p)));
  return v;
}

// ------------------------------------------------------------- fc1_gelu_int8
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
__device__ __forceinline__ uint32_t two_codes(float q0, float q1) {
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
  unsigned char* ring = hp::align_1024(head_end);

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
        pk_lo[i] = two_codes(quotient(__int_as_float(acc[4 * j]), g_lo, i_lo),
                              quotient(__int_as_float(acc[4 * j + 1]), g_lo, i_lo));
        pk_hi[i] = two_codes(quotient(__int_as_float(acc[4 * j + 2]), g_hi, i_hi),
                              quotient(__int_as_float(acc[4 * j + 3]), g_hi, i_hi));
      }
      const uint2 w_lo = gather_chunk(pk_lo, lane), w_hi = gather_chunk(pk_hi, lane);
      if (m0 + r0 < M) *reinterpret_cast<uint2*>(row_lo + 32 * q) = w_lo;
      if (m0 + r0 + 8 < M) *reinterpret_cast<uint2*>(row_hi + 32 * q) = w_hi;
    }
  }
}

// ------------------------------------ s8_gemm: fc2_residual_int8, ln_qkv_int8
namespace s8g {
constexpr int BM = 128, BN = 256, BK = 128, kStages = 3;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kABytes = BM * BK;                 // 16 KB
constexpr int kBBytes = BN * BK;                 // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int LDC = BN + 8;                      // staged output row, bf16
// the ring, the staged tile, two buffers of the tile's cs and bias, the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + BM * LDC * 2 + 4 * BN * 4 + 2 * kStages * 8;
}  // namespace s8g

// out = codes (M, K) . w (N, K)^T * sa[row] * cs + bias, rounded once to
// bf16. kHeads false (fc2): + the residual res (M, N), rows of out (M, N).
// kHeads true (ln_qkv_int8): N = 3D, D = 64 H; out holds q, k and v, each
// (B, H, T, 64), one after the other, and each row's columns [64 h,
// 64 h + 64) of the q, k or v third go to row (b, h, t) of it.
// Persistent: block i takes output tiles i, i + gridDim.x, ..., the N tiles
// of one row block consecutive; the ring runs on into the next tile while
// this one is stored (the pattern of ln_qkv.cu's qkv_gemm).
template <bool kHeads>
__global__ void __launch_bounds__(s8g::kThreads, 1)
s8_gemm_kernel(__grid_constant__ const CUtensorMap map_a,  // codes (M, K) int8
               __grid_constant__ const CUtensorMap map_b,  // w (N, K) int8
               const float* __restrict__ sa,               // (M)
               const float* __restrict__ cs,               // (N)
               const float* __restrict__ bias,             // (N)
               const bf16* __restrict__ res,               // (M, N) residual (fc2)
               bf16* __restrict__ out, int M, int N, int K, int T, int H) {
  using namespace s8g;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hp::align_1024(smem_raw);                    // kStages x (A | B)
  bf16* cst = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);  // BM x LDC
  float* cb = reinterpret_cast<float*>(cst + BM * LDC);  // [tile parity][cs | bias][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(cb + 4 * BN);
  uint64_t* empty = full + kStages;

  const int n_tiles_n = (N + BN - 1) / BN;
  const int n_tiles = n_tiles_n * ((M + BM - 1) / BM);
  const int ksteps = K / BK;
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
  for (int tile = blockIdx.x, parity = 0; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    const int n0 = (tile % n_tiles_n) * BN, m0 = (tile / n_tiles_n) * BM;
    // the tile's cs and bias into shared memory (read by the epilogue from
    // there, so that the compiler does not hold them in registers beside
    // the accumulators); a warpgroup is at most one tile ahead of the other
    float* cs_s = cb + parity * 2 * BN;
    for (int i = threadIdx.x; i < BN; i += kConsumers * 128) {
      cs_s[i] = n0 + i < N ? cs[n0 + i] : 0.f;
      cs_s[BN + i] = n0 + i < N ? bias[n0 + i] : 0.f;
    }
    hp::named_barrier(3, kConsumers * 128);
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

    // acc * sa * cs + bias (+ res), rounded once to bf16 into the staged tile
    const int m_lo = m0 + r0, m_hi = m_lo + 8;
    const float s_lo = m_lo < M ? sa[m_lo] : 0.f, s_hi = m_hi < M ? sa[m_hi] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2, n = n0 + c;
      const float2 cc = lds_f2(cs_s + c), bb = lds_f2(cs_s + BN + c);
      float2 y_lo = make_float2(0.f, 0.f), y_hi = y_lo;
      if constexpr (!kHeads) {
        if (n < N && m_lo < M)
          y_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              res + static_cast<long long>(m_lo) * N + n));
        if (n < N && m_hi < M)
          y_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              res + static_cast<long long>(m_hi) * N + n));
      }
      float v[4] = {dequant(acc[4 * j], s_lo, cc.x, bb.x),
                    dequant(acc[4 * j + 1], s_lo, cc.y, bb.y),
                    dequant(acc[4 * j + 2], s_hi, cc.x, bb.x),
                    dequant(acc[4 * j + 3], s_hi, cc.y, bb.y)};
      if constexpr (!kHeads) {
        v[0] = __fadd_rn(v[0], y_lo.x);
        v[1] = __fadd_rn(v[1], y_lo.y);
        v[2] = __fadd_rn(v[2], y_hi.x);
        v[3] = __fadd_rn(v[3], y_hi.y);
      }
      *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) = hp::pack_bf16(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) = hp::pack_bf16(v[2], v[3]);
    }
    hp::named_barrier(1 + wg, 128);
    // 16-byte stores of the warpgroup's 64 rows: a thread keeps one 8-column
    // chunk and walks every fourth row, neighbouring threads on neighbouring
    // chunks of a row
    constexpr int kChunks = BN / 8, kStep = 128 / kChunks;
    const int c = (tid % kChunks) * 8, n = n0 + c, r_first = wg * 64 + tid / kChunks;
    if (n < N) {
      bf16* dst = out + n;  // row m at dst + m * N
      int b = 0, t = 0;     // kHeads: row m = b T + t at dst + (b H T + t) * 64
      if constexpr (kHeads) {  // head hh of the 3H, q's, k's or v's head hh - which H
        const int hh = n / 64, which = hh < H ? 0 : (hh < 2 * H ? 1 : 2);
        dst = out + static_cast<long long>(which) * M * H * 64 +
              static_cast<long long>(hh - which * H) * T * 64 + n % 64;
        b = (m0 + r_first) / T;
        t = m0 + r_first - b * T;
      }
      for (int r = r_first; r < wg * 64 + 64; r += kStep) {
        const int m = m0 + r;
        if (m >= M) break;
        const long long off = kHeads ? (static_cast<long long>(b) * H * T + t) * 64
                                     : static_cast<long long>(m) * N;
        *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(cst + r * LDC + c);
        if constexpr (kHeads) {
          for (t += kStep; t >= T; t -= T) ++b;
        }
      }
    }
    hp::named_barrier(1 + wg, 128);  // the rows are read before the next tile writes them
  }
}

// ------------------------------------------------------ attn_oproj_ln_int8
// pair_codes: one block per (head, 128 query rows), clusters of the two
// heads 2g and 2g + 1 (rank j) of one batch on the same rows.
namespace pc {
constexpr int LDS = 64 + 16;  // staged codes row (bytes), 16-byte aligned rows
constexpr int kStageOff = (aw::kRingSmem + 127) / 128 * 128;
constexpr int kSmem = 1024 + kStageOff + aw::BQ * LDS + aw::BQ * 4;
}  // namespace pc

// The int32 value v (|v| < 2^22) as a float, exactly, on the full-rate
// pipes: its bits added to those of 1.5 * 2^23, then 1.5 * 2^23 subtracted.
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f);
}

__global__ void __launch_bounds__(aw::kThreads, 2)
pair_codes_kernel(__grid_constant__ const CUtensorMap map_q,  // head-major (B*H, T, 64)
                  __grid_constant__ const CUtensorMap map_k,
                  __grid_constant__ const CUtensorMap map_v,
                  int8_t* __restrict__ codes,   // (B*T, D)
                  float* __restrict__ scales,   // (B*T, D / 128)
                  int T, int H, int t_valid) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + pc::kStageOff);      // BQ x LDS
  float* peer_max = reinterpret_cast<float*>(stage + aw::BQ * pc::LDS);  // BQ: the peer's row |max|
  const int n = blockIdx.y, q0 = blockIdx.x * aw::BQ;
  const uint32_t j = hp::cluster_rank();  // head 2g + j
  const int b = n / H, g = (n % H) / 2, n_g = H / 2, D = H * aw::HD;
  hp::cluster_arrive();  // this block runs: the peer may store into it after its wait

  float o[32], l[2];
  // scale 1: hd^-0.25 is folded into q and k; probabilities against the exact row max
  aw::attend<true>(&map_q, &map_k, &map_v, smem, 0, n, q0, t_valid, 1.f, o, l);

  // O / l by true division, as the plain version divides; each row's |max|
  // over this head's 64 channels
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = __fdiv_rn(o[i], l[(i / 2) % 2]);
    amax[(i / 2) % 2] = fmaxf(amax[(i / 2) % 2], fabsf(o[i]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
  }
  const int tid = threadIdx.x % 128, lane = threadIdx.x & 31, wg = threadIdx.x / 128;
  const int r = wg * 64 + (tid / 32) * 16 + lane / 4;  // this thread's rows r, r + 8 of the tile
  hp::cluster_wait();
  if (lane % 4 == 0) {
    hp::st_peer(peer_max + r, j ^ 1, amax[0]);
    hp::st_peer(peer_max + r + 8, j ^ 1, amax[1]);
  }
  hp::cluster_arrive();
  hp::cluster_wait();

  // the pair's scale, and this head's codes by it: two a lane in each
  // 8-column chunk, staged for 16-byte stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    const float s = row_scale(fmaxf(amax[h], peer_max[row])), inv = __frcp_rn(s);
#pragma unroll
    for (int jj = 0; jj < aw::HD / 8; ++jj)
      *reinterpret_cast<uint16_t*>(stage + row * pc::LDS + 8 * jj + 2 * (lane % 4)) =
          static_cast<uint16_t>(two_codes(quotient(o[4 * jj + 2 * h], s, inv),
                                          quotient(o[4 * jj + 2 * h + 1], s, inv)));
    const int t = q0 + row;
    if (j == 0 && lane % 4 == 0 && t < T) scales[(static_cast<long long>(b) * T + t) * n_g + g] = s;
  }
  hp::named_barrier(1 + wg, 128);
  for (int i = tid; i < 64 * 4; i += 128) {  // the warpgroup's 64 rows, four 16-byte chunks each
    const int row = wg * 64 + i / 4, c = (i % 4) * 16, t = q0 + row;
    if (t < T)
      *reinterpret_cast<uint4*>(codes + (static_cast<long long>(b) * T + t) * D + 128 * g +
                                64 * j + c) =
          *reinterpret_cast<const uint4*>(stage + row * pc::LDS + c);
  }
}

// oproj_ln: a cluster of ceil(D / 256) blocks (rank r: output columns
// [256 r, 256 r + 256), the last block 128 where D is an odd multiple of
// 128) takes a 128-row tile; the grid holds as many clusters as the card
// runs at once, and cluster i walks row tiles i, i + gridDim.y, ...
// (oproj_ln.cuh, shared with the bf16 o-projection).
namespace ol {
constexpr int BM = op::BM, BN = op::BN, BH = 128, BK = 128, kStages = 3;
constexpr int kConsumers = 2;               // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128;  // thread 0 also issues the loads
constexpr int kMaxCluster = op::kMaxCluster;
constexpr int kABytes = BM * BK;            // 16 KB: the codes of one pair
constexpr int kHBytes = BH * BK;            // 16 KB: wo's 128 columns of it, a half
constexpr int kStageBytes = kABytes + 2 * kHBytes;
constexpr int LDC = BH + 8;                 // staged output row (a half), bf16
constexpr int kMaxPairs = 16;
// from the 1024-aligned base: the ring, the staged half tile, two rounds of
// every rank's row partials, two buffers of the tile's pair scales, the
// block's cso, bo, g2 and b2, the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + BM * LDC * 2 + 2 * kMaxCluster * BM * 4 +
                      2 * kMaxPairs * BM * 4 + 4 * BN * 4 + 2 * kStages * 8;
}  // namespace ol

// Thread 0 streams each step's codes tile and the block's two weight halves
// through the ring (step g: pair g % ksteps of the block's (g / ksteps)-th
// row tile) and refills the stage of step g - 1 once both warpgroups have
// released it, so that the next tile's first stages load during this
// tile's epilogue (a producer warp would cap the block at 168 registers;
// the two halves' accumulators take 128 a thread). A warpgroup multiplies
// its 64 rows by each half in turn (m64n128k32 into one set of s32 sums)
// and adds that half's sums into its f32 accumulator.
__global__ void __launch_bounds__(ol::kThreads, 1)
oproj_ln_kernel(__grid_constant__ const CUtensorMap map_a,  // codes (M, D) int8
                __grid_constant__ const CUtensorMap map_b,  // wo (D, D) int8, out x in
                const float* __restrict__ sa,               // (M, D / 128) pair scales
                const bf16* __restrict__ x,                 // (M, D) residual
                const float* __restrict__ cso, const float* __restrict__ bo,
                const float* __restrict__ g2, const float* __restrict__ b2,  // (D)
                bf16* __restrict__ y, bf16* __restrict__ hout,               // (M, D)
                int M, int D, float eps) {
  using namespace ol;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hp::align_1024(smem_raw);                    // kStages x (A | B0 | B1)
  bf16* cst = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);  // BM x LDC
  float* psum = reinterpret_cast<float*>(cst + BM * LDC);  // [rank][row]: Σ y
  float* psq = psum + kMaxCluster * BM;                     // [rank][row]: Σ (y - mean)^2
  float* sa_s = psq + kMaxCluster * BM;                     // [tile parity][row][pair]
  float* cso_s = sa_s + 2 * kMaxPairs * BM;
  float* bo_s = cso_s + BN;
  float* g2_s = bo_s + BN;
  float* b2_s = g2_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(b2_s + BN);
  uint64_t* empty = full + kStages;

  const uint32_t rank = hp::cluster_rank(), n_ranks = (D + BN - 1) / BN;
  const int n0 = rank * BN, halves = D - n0 < BN ? 1 : 2;
  const int ksteps = D / BK;  // one head pair a k step
  const int n_tiles = (M + BM - 1) / BM;
  const int n_steps = ksteps * ((n_tiles - static_cast<int>(blockIdx.y) +
                                 static_cast<int>(gridDim.y) - 1) / static_cast<int>(gridDim.y));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    hp::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < BN; i += kThreads) {
    const bool in = n0 + i < D;
    cso_s[i] = in ? cso[n0 + i] : 0.f;
    bo_s[i] = in ? bo[n0 + i] : 0.f;
    g2_s[i] = in ? g2[n0 + i] : 0.f;
    b2_s[i] = in ? b2[n0 + i] : 0.f;
  }
  __syncthreads();
  hp::cluster_arrive();  // every block of the cluster runs before a peer stores into it
  hp::cluster_wait();

  const auto issue = [&](int step) {  // (thread 0)
    const int s = step % kStages, kk = step % ksteps;
    const int m0 =
        (static_cast<int>(blockIdx.y) + step / ksteps * static_cast<int>(gridDim.y)) * BM;
    unsigned char* st = ring + s * kStageBytes;
    hp::mbar_arrive_expect_tx(&full[s], kStageBytes);  // a half past D arrives as zeros
    hp::tma_load_2d(st, &map_a, &full[s], kk * BK, m0);
    hp::tma_load_2d(st + kABytes, &map_b, &full[s], kk * BK, n0);
    hp::tma_load_2d(st + kABytes + kHBytes, &map_b, &full[s], kk * BK, n0 + BH);
  };
  const auto release = [&](int step) {
    if (lane == 0) hp::mbar_arrive(&empty[step % kStages]);
    if (threadIdx.x == 0 && step >= 1 && step - 1 + kStages < n_steps) {
      hp::mbar_wait(&empty[(step - 1) % kStages], ((step - 1) / kStages) & 1);
      issue(step - 1 + kStages);
    }
  };
  if (threadIdx.x == 0)
    for (int step = 0; step < kStages && step < n_steps; ++step) issue(step);

  // this thread: rows r0 and r0 + 8 of each tile, columns
  // 128 h + c0 + 8 j + {0, 1} of the block's (the accumulator layout of
  // hopper.cuh; acc[h] the half h)
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
  float acc[2][BH / 2];

  // the row sums of lo and hi over all D columns through the cluster
  const auto exchange = [&](float* buf, float& lo, float& hi) {
    op::cluster_row_sums(buf, lo, hi, rank, n_ranks, r0);
  };
  // the staged half h of this warpgroup's 64 rows out to dst (M, D)
  const auto store_rows = [&](bf16* dst, int m0, int h) {
    op::store_staged_rows<BH>(cst, LDC, dst, m0, n0 + BH * h, M, D);
  };

  int step = 0;
  for (int tile = blockIdx.y, parity = 0; tile < n_tiles; tile += gridDim.y, parity ^= 1) {
    const int m0 = tile * BM, m_lo = m0 + r0, m_hi = m_lo + 8;
    // the tile's pair scales into shared memory (rows past M: 0); a
    // warpgroup is at most one tile ahead of the other
    float* sa_t = sa_s + parity * kMaxPairs * BM;
    for (int i = threadIdx.x; i < BM * ksteps; i += kThreads)
      sa_t[i] = m0 + i / ksteps < M ? sa[static_cast<long long>(m0) * ksteps + i] : 0.f;
    hp::named_barrier(3, kThreads);
    // acc = x + bo (rows past M and columns past D: bo, never stored)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jn = 0; jn < BH / 8; ++jn) {
        const int c = BH * h + c0 + 8 * jn;
        float2 x_lo = make_float2(0.f, 0.f), x_hi = x_lo;
        if (h < halves && m_lo < M)
          x_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              x + static_cast<long long>(m_lo) * D + n0 + c));
        if (h < halves && m_hi < M)
          x_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              x + static_cast<long long>(m_hi) * D + n0 + c));
        const float2 bb = *reinterpret_cast<const float2*>(bo_s + c);
        acc[h][4 * jn] = __fadd_rn(x_lo.x, bb.x);
        acc[h][4 * jn + 1] = __fadd_rn(x_lo.y, bb.y);
        acc[h][4 * jn + 2] = __fadd_rn(x_hi.x, bb.x);
        acc[h][4 * jn + 3] = __fadd_rn(x_hi.y, bb.y);
      }
    }
    for (int kk = 0; kk < ksteps; ++kk, ++step) {
      const int s = step % kStages;
      hp::mbar_wait(&full[s], (step / kStages) & 1);
      const float sa_lo = sa_t[r0 * ksteps + kk], sa_hi = sa_t[(r0 + 8) * ksteps + kk];
      const uint64_t da = hp::desc_sw128(ring + s * kStageBytes + wg * 64 * BK);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= halves) break;
        const uint64_t db = hp::desc_sw128(ring + s * kStageBytes + kABytes + h * kHBytes);
        int part[BH / 2];  // the half's s32 sums: the first wgmma ignores their values
        hp::fence_regs(part);
        hp::wgmma_fence();
#pragma unroll
        for (int k32 = 0; k32 < BK / 32; ++k32)  // the pair's sums start from zero
          hp::wgmma_m64n128k32_s8(part, da + 2 * k32, db + 2 * k32, k32 > 0 ? 1 : 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(part);
        // acc + (sum * sa) * cso, each product and sum rounded on its own
#pragma unroll
        for (int jn = 0; jn < BH / 8; ++jn) {
          const float2 cc = lds_f2(cso_s + BH * h + c0 + 8 * jn);
          acc[h][4 * jn] = __fadd_rn(
              acc[h][4 * jn], __fmul_rn(__fmul_rn(small_int_to_float(part[4 * jn]), sa_lo), cc.x));
          acc[h][4 * jn + 1] =
              __fadd_rn(acc[h][4 * jn + 1],
                        __fmul_rn(__fmul_rn(small_int_to_float(part[4 * jn + 1]), sa_lo), cc.y));
          acc[h][4 * jn + 2] =
              __fadd_rn(acc[h][4 * jn + 2],
                        __fmul_rn(__fmul_rn(small_int_to_float(part[4 * jn + 2]), sa_hi), cc.x));
          acc[h][4 * jn + 3] =
              __fadd_rn(acc[h][4 * jn + 3],
                        __fmul_rn(__fmul_rn(small_int_to_float(part[4 * jn + 3]), sa_hi), cc.y));
        }
      }
      release(step);
    }

    // LayerNorm2's statistics over all D columns: the mean, then the mean
    // square of the deviations from it (the TPU kernels' _ln_f32)
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= halves) break;
#pragma unroll
      for (int jn = 0; jn < BH / 8; ++jn) {
        s_lo += acc[h][4 * jn] + acc[h][4 * jn + 1];
        s_hi += acc[h][4 * jn + 2] + acc[h][4 * jn + 3];
      }
    }
    exchange(psum, s_lo, s_hi);
    const float mu_lo = s_lo / D, mu_hi = s_hi / D;
    float q_lo = 0.f, q_hi = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= halves) break;
#pragma unroll
      for (int jn = 0; jn < BH / 8; ++jn) {
        const float d0 = acc[h][4 * jn] - mu_lo, d1 = acc[h][4 * jn + 1] - mu_lo;
        const float d2 = acc[h][4 * jn + 2] - mu_hi, d3 = acc[h][4 * jn + 3] - mu_hi;
        q_lo += d0 * d0 + d1 * d1;
        q_hi += d2 * d2 + d3 * d3;
      }
    }
    exchange(psq, q_lo, q_hi);
    const float rstd_lo = rsqrtf(q_lo / D + eps), rstd_hi = rsqrtf(q_hi / D + eps);

    // y, then h = (y - mean) * rstd * g2 + b2 (the plain version's order),
    // each staged as bf16 a half at a time and stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= halves) break;
#pragma unroll
      for (int jn = 0; jn < BH / 8; ++jn) {
        const int c = c0 + 8 * jn;
        *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
            hp::pack_bf16(acc[h][4 * jn], acc[h][4 * jn + 1]);
        *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
            hp::pack_bf16(acc[h][4 * jn + 2], acc[h][4 * jn + 3]);
      }
      store_rows(y, m0, h);
#pragma unroll
      for (int jn = 0; jn < BH / 8; ++jn) {
        const int c = c0 + 8 * jn;
        const float2 gg = *reinterpret_cast<const float2*>(g2_s + BH * h + c);
        const float2 bb = *reinterpret_cast<const float2*>(b2_s + BH * h + c);
        *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
            hp::pack_bf16(op::ln_value(acc[h][4 * jn], mu_lo, rstd_lo, gg.x, bb.x),
                          op::ln_value(acc[h][4 * jn + 1], mu_lo, rstd_lo, gg.y, bb.y));
        *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
            hp::pack_bf16(op::ln_value(acc[h][4 * jn + 2], mu_hi, rstd_hi, gg.x, bb.x),
                          op::ln_value(acc[h][4 * jn + 3], mu_hi, rstd_hi, gg.y, bb.y));
      }
      store_rows(hout, m0, h);
    }
  }
}

}  // namespace

namespace {

// Launch s8_gemm_kernel<kHeads> on all SMs (or fewer blocks than tiles).
template <bool kHeads>
cudaError_t s8_gemm(const int8_t* a, const int8_t* w, const float* sa, const float* cs,
                    const float* bias, const bf16* res, bf16* out, int M, int N, int K, int T,
                    int H, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t box_a[2] = {s8g::BK, s8g::BM}, box_b[2] = {s8g::BK, s8g::BN};
  const auto kernel = s8_gemm_kernel<kHeads>;
  cudaError_t err = hp::encode_map(&map_a, hp::kS8, a, 2, dims_a, strides, box_a);
  if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kS8, w, 2, dims_b, strides, box_b);
  if (err == cudaSuccess) err = tpa::allow_smem(kernel, s8g::kSmem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (N + s8g::BN - 1) / s8g::BN * ((M + s8g::BM - 1) / s8g::BM);
  kernel<<<tiles < sms ? tiles : sms, s8g::kThreads, s8g::kSmem, stream>>>(
      map_a, map_b, sa, cs, bias, res, out, M, N, K, T, H);
  return cudaGetLastError();
}

using op::cluster_config;

cudaError_t pair_codes(const bf16* q, const bf16* k, const bf16* v, int8_t* codes, float* scales,
                       int batch, int T, int H, int t_valid, cudaStream_t stream) {
  const int n_heads = batch * H;
  CUtensorMap mq, mk, mv;  // the head-major layout as encoder_attention.py:tma_view's pre_bh
  cudaError_t err = aw::encode_qkv_maps(&mq, &mk, &mv, q, k, v, n_heads, T, 1,
                                        static_cast<long long>(T) * aw::HD, aw::HD, aw::HD);
  if (err == cudaSuccess) err = tpa::allow_smem(pair_codes_kernel, pc::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, dim3((T + aw::BQ - 1) / aw::BQ, n_heads), dim3(1, 2, 1),
                     aw::kThreads, pc::kSmem, stream);
  return cudaLaunchKernelEx(&cfg, pair_codes_kernel, mq, mk, mv, codes, scales, T, H, t_valid);
}

// Launch oproj_ln_kernel, or, given `clusters`, report how many of its
// clusters (ceil(D / 256) blocks each) the card holds at once instead.
cudaError_t oproj_ln(const int8_t* codes, const int8_t* wo, const float* scales, const bf16* x,
                     const float* cso, const float* bo, const float* g2, const float* b2, bf16* y,
                     bf16* h, int M, int D, float eps, cudaStream_t stream, int* clusters) {
  CUtensorMap map_a = {}, map_b = {};
  if (clusters == nullptr) {
    const uint64_t dims_a[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(M)};
    const uint64_t dims_b[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(D)};
    const uint64_t strides[1] = {static_cast<uint64_t>(D)};
    const uint32_t box[2] = {ol::BK, ol::BM};
    cudaError_t err = hp::encode_map(&map_a, hp::kS8, codes, 2, dims_a, strides, box);
    if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kS8, wo, 2, dims_b, strides, box);
    if (err != cudaSuccess) return err;
  }
  return op::launch_row_clusters(oproj_ln_kernel, ol::kThreads, ol::kSmem, M, D, stream,
                                 clusters, map_a, map_b, scales, x, cso, bo, g2, b2, y, h, M, D,
                                 eps);
}

}  // namespace

// ln_qkv_int8's two launches (the wrapper runs both; each alone serves the
// checks): ln_quant_rows (x -> xq, sx, the caller's scratch), then the s8
// GEMM with the head-major epilogue.
extern "C" int tpa_ln_quant_rows(const bf16* x, const float* ln_w, const float* ln_b, int8_t* xq,
                                 float* sx, int M, int D, float eps, cudaStream_t stream) {
  if (D % 8) return static_cast<int>(cudaErrorInvalidValue);
  ln_quant_rows_kernel<<<(M + kQuantRows - 1) / kQuantRows, kQuantRows * 32, 0, stream>>>(
      x, ln_w, ln_b, xq, sx, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// qkv: q, k and v (B, H, T, 64) one after the other.
extern "C" int tpa_qkv_gemm_int8(const int8_t* xq, const float* sx, const int8_t* w,
                                 const float* cs, const float* bias, bf16* qkv, int batch, int T,
                                 int D, int H, cudaStream_t stream) {
  if (D % s8g::BK || H % 2 || D != H * aw::HD) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      s8_gemm<true>(xq, w, sx, cs, bias, nullptr, qkv, batch * T, 3 * D, D, T, H, stream));
}

// attn_oproj_ln_int8's two launches: pair_codes (q, k, v -> codes, scales,
// the caller's scratch), then oproj_ln.
extern "C" int tpa_pair_codes(const bf16* q, const bf16* k, const bf16* v, int8_t* codes,
                              float* scales, int batch, int T, int H, int t_valid,
                              cudaStream_t stream) {
  if (!op::heads_fit(H) || t_valid < 1 || t_valid > T) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pair_codes(q, k, v, codes, scales, batch, T, H, t_valid, stream));
}

extern "C" int tpa_oproj_ln(const int8_t* codes, const float* scales, const bf16* x,
                            const int8_t* wo, const float* cso, const float* bo, const float* g2,
                            const float* b2, bf16* y, bf16* h, int M, int D, float eps,
                            cudaStream_t stream) {
  if (D % aw::HD || !op::heads_fit(D / aw::HD)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      oproj_ln(codes, wo, scales, x, cso, bo, g2, b2, y, h, M, D, eps, stream, nullptr));
}

// How many of oproj_ln's clusters (ceil(D / 256) blocks each) fit the card at once.
extern "C" int tpa_oproj_ln_clusters(int* clusters, int H, cudaStream_t stream) {
  if (!op::heads_fit(H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(oproj_ln(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, ol::BM, H * aw::HD, 0.f, stream,
                                   clusters));
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
  if (D % 128 || FF % s8g::BK) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      s8_gemm<false>(g, w, sg, cs, bias, y, out, M, D, FF, 0, 0, stream));
}
