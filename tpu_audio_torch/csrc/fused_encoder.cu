// Fused Whisper encoder-block phase, bf16 in and out, f32 accumulation.
//
// Replaces tpu_audio/ops/pallas/fused_encoder.py:attn_oproj_ln (the first
// phase, ln_qkv_packed, is ln_qkv.cu).
//
//   attn_oproj_ln  per head: attention over keys < t_valid (S = Q K^T in
//                  f32, f32 softmax, the probabilities rounded to bf16 before
//                  P V, which sums in f32, the division after it), the output
//                  rounded to bf16; y = x + bo + sum over the heads of
//                  O_h wo[:, h]^T, summed in f32; h = LayerNorm2(y); y and h
//                  bf16. Two launches: attn_heads, then oproj_ln_bf16.
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (M = B*T = 24000 rows, D = 1280, 20 heads) the attention is 184.3 GFLOP
// (0.186 ms at 989 TFLOP/s) and the o-projection 78.6 GFLOP (0.0795 ms),
// against ~0.25 GB of q, k, v, x, y and h (0.074 ms at 3.35 TB/s); the
// scratch adds 61 MB written and read.
//
// Design. The TPU kernel keeps a (rows, D) f32 accumulator in VMEM across
// the head pairs. 128 query rows of all 20 heads' attention output (320 KB
// in bf16) do not fit a block's 227 KB beside a ring, and 16-row tiles
// waste the tensor cores and read K/V from L2 eight times over. So the
// phase is split at the attention output, as fused_encoder_int8.cu's
// attn_oproj_ln_int8 is, with a (B*T, D) bf16 scratch that the caller
// allocates between the two launches:
// - attn_heads: encoder_attention.cu's block (attention_wgmma.cuh's
//   `attend`, the online softmax: 128 query rows of one head, a 4-stage TMA
//   ring of 64-key K/V tiles, wgmma for S and P V, two blocks an SM) reads
//   head-major q, k, v (encoder_attention.py:tma_view's pre_bh recipe),
//   divides O by l (true division, as the plain version) and stores it as
//   bf16, token-major, into columns 64 h of the scratch through a staged
//   tile with 16-byte stores. No exact-max sweep: no codes are made from
//   these probabilities, and the online softmax's rounding of them stays
//   within the rel 2e-2 the encoder attention is held to.
// - oproj_ln_bf16: a persistent TMA + bf16 wgmma GEMM of the scratch (M, D)
//   with wo (D, D, out x in), both K-major as they lie: one k step a head,
//   a 4-stage ring of the scratch's (128 x 64) head tile and wo's (256 x 64)
//   columns of that head, 128-byte swizzle. A cluster of ceil(D / 256)
//   blocks (5 at D = 1280) shares a 128-row tile, block r taking output
//   columns [256 r, 256 r + 256) (the last block 128 where D is an odd
//   multiple of 128: the weight rows past D arrive as zeros and are never
//   stored); two consumer warpgroups of 64 rows each issue m64n256k16
//   (128 f32 accumulators a thread), one product group kept in flight while
//   the previous stage is released. Thread 0 also refills the ring (a
//   producer warp would cap the block's registers), running on into the
//   next tile during this one's epilogue. The epilogue adds x + bo to the
//   f32 product (the plain version's order), takes LayerNorm2's row sums
//   through every block of the cluster in two rounds (oproj_ln.cuh, as the
//   int8 o-projection), and stages y and h as bf16, 64 columns at a time,
//   for 16-byte stores: no f32 leaves the chip. The row tiles cross batch
//   boundaries (T = 1500 is not a multiple of 128): the scratch is one
//   (M, D) matrix and rows past M come from TMA's zero fill, never stored.
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

// ------------------------------------------------------------- attn_heads
// One block per (head, 128 query rows): grid (ceil(T / 128), B * H).
namespace ah {
constexpr int LDS = aw::HD + 8;  // staged row, bf16: 144 bytes, 16-byte aligned rows
constexpr int kStageOff = (aw::kRingSmem + 127) / 128 * 128;
constexpr int kSmem = 1024 + kStageOff + aw::BQ * LDS * 2;
}  // namespace ah

__global__ void __launch_bounds__(aw::kThreads, 2)
attn_heads_kernel(__grid_constant__ const CUtensorMap map_q,  // head-major (B*H, T, 64)
                  __grid_constant__ const CUtensorMap map_k,
                  __grid_constant__ const CUtensorMap map_v,
                  bf16* __restrict__ out,  // (B*T, D), head h in columns [64 h, 64 h + 64)
                  int T, int H, int t_valid) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  bf16* stage = reinterpret_cast<bf16*>(smem + ah::kStageOff);  // BQ x LDS
  const int n = blockIdx.y, q0 = blockIdx.x * aw::BQ;
  const int b = n / H, head = n % H, D = H * aw::HD;
  float o[32], l[2];
  // scale 1: hd^-0.25 is folded into q and k
  aw::attend<false>(&map_q, &map_k, &map_v, smem, 0, n, q0, t_valid, 1.f, o, l);

  // O / l by true division, as the plain version divides, rounded to bf16
  // and staged: this thread's rows r and r + 8, two columns in each 8-column chunk
  const int tid = threadIdx.x % 128, lane = threadIdx.x & 31, wg = threadIdx.x / 128;
  const int r = wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int jj = 0; jj < aw::HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(stage + (r + 8 * h) * ah::LDS + 8 * jj + 2 * (lane % 4)) =
          hp::pack_bf16(__fdiv_rn(o[4 * jj + 2 * h], l[h]), __fdiv_rn(o[4 * jj + 2 * h + 1], l[h]));
  }
  hp::named_barrier(1 + wg, 128);
  // the warpgroup's 64 rows of 128 bytes, eight 16-byte chunks each
  for (int i = tid; i < 64 * 8; i += 128) {
    const int row = wg * 64 + i / 8, c = (i % 8) * 8, t = q0 + row;
    if (t < T)
      *reinterpret_cast<uint4*>(out + (static_cast<long long>(b) * T + t) * D + head * aw::HD + c) =
          *reinterpret_cast<const uint4*>(stage + row * ah::LDS + c);
  }
}

// ---------------------------------------------------------- oproj_ln_bf16
namespace ob {
constexpr int BM = op::BM, BN = op::BN, BK = 64, kStages = 4;
constexpr int kConsumers = 2;               // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128;  // thread 0 also issues the loads
constexpr int kABytes = BM * BK * 2;        // 16 KB: one head's 64 columns of the scratch
constexpr int kBBytes = BN * BK * 2;        // 32 KB: wo's 256 output rows, that head's channels
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int BQ = 64;                      // staged output columns (a quarter of BN)
constexpr int LDC = BQ + 8;                 // staged output row, bf16
// from the 1024-aligned base: the ring, the staged quarter tile, two rounds
// of every rank's row partials, the block's bo, g2 and b2, the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + BM * LDC * 2 + 2 * op::kMaxCluster * BM * 4 +
                      3 * BN * 4 + 2 * kStages * 8;
}  // namespace ob

// Thread 0 streams each step's scratch tile and the block's weight tile
// through the ring (step g: head g % ksteps of the block's (g / ksteps)-th
// row tile) and refills the stage of step g once both warpgroups have
// released it, kStages - 1 steps ahead of the products.
__global__ void __launch_bounds__(ob::kThreads, 1)
oproj_ln_bf16_kernel(__grid_constant__ const CUtensorMap map_a,  // attention (M, D) bf16
                     __grid_constant__ const CUtensorMap map_b,  // wo (D, D) bf16, out x in
                     const bf16* __restrict__ x,                 // (M, D) residual
                     const float* __restrict__ bo, const float* __restrict__ g2,
                     const float* __restrict__ b2,                    // (D)
                     bf16* __restrict__ y, bf16* __restrict__ hout,  // (M, D)
                     int M, int D, float eps) {
  using namespace ob;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hp::align_1024(smem_raw);                    // kStages x (A | B)
  bf16* cst = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);  // BM x LDC
  float* psum = reinterpret_cast<float*>(cst + BM * LDC);  // [rank][row]: Σ y
  float* psq = psum + op::kMaxCluster * BM;                 // [rank][row]: Σ (y - mean)^2
  float* bo_s = psq + op::kMaxCluster * BM;
  float* g2_s = bo_s + BN;
  float* b2_s = g2_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(b2_s + BN);
  uint64_t* empty = full + kStages;

  const uint32_t rank = hp::cluster_rank(), n_ranks = (D + BN - 1) / BN;
  const int n0 = rank * BN, n_chunks = D - n0 < BN ? BN / 16 : BN / 8;  // 8-column chunks
  const int ksteps = D / BK;  // one head a k step
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
    hp::mbar_arrive_expect_tx(&full[s], kStageBytes);  // weight rows past D arrive as zeros
    hp::tma_load_2d(st, &map_a, &full[s], kk * BK, m0);
    hp::tma_load_2d(st + kABytes, &map_b, &full[s], kk * BK, n0);
  };
  const auto release = [&](int step) {
    if (lane == 0) hp::mbar_arrive(&empty[step % kStages]);
    if (threadIdx.x == 0 && step + kStages < n_steps) {
      hp::mbar_wait(&empty[step % kStages], (step / kStages) & 1);
      issue(step + kStages);
    }
  };
  if (threadIdx.x == 0)
    for (int step = 0; step < kStages && step < n_steps; ++step) issue(step);

  // this thread: rows r0 and r0 + 8 of each tile; acc[4 j + e] is row
  // r0 + 8 (e / 2), column c0 + 8 j + e % 2 of the block's (the
  // accumulator layout of hopper.cuh)
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
  float acc[BN / 2];
  // the row sums of lo and hi over all D columns through the cluster
  const auto exchange = [&](float* buf, float& lo, float& hi) {
    op::cluster_row_sums(buf, lo, hi, rank, n_ranks, r0);
  };

  int step = 0;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int m0 = tile * BM, m_lo = m0 + r0, m_hi = m_lo + 8;
    for (int kk = 0; kk < ksteps; ++kk, ++step) {
      const int s = step % kStages;
      hp::mbar_wait(&full[s], (step / kStages) & 1);
      const uint64_t da = hp::desc_sw128(ring + s * kStageBytes + wg * 64 * BK * 2);
      const uint64_t db = hp::desc_sw128(ring + s * kStageBytes + kABytes);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16)  // the tile's first product ignores acc's values
        hp::wgmma_m64n256k16_ss(acc, da + 2 * k16, db + 2 * k16, kk > 0 || k16 > 0 ? 1 : 0);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous step's products are done: release its stage
      hp::fence_regs(acc);
      if (kk > 0) release(step - 1);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    release(step - 1);

    // y = (x + bo) + the product, in f32 (rows past M: never stored)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j >= n_chunks) break;
      const int c = c0 + 8 * j;
      float2 x_lo = make_float2(0.f, 0.f), x_hi = x_lo;
      if (m_lo < M)
        x_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<long long>(m_lo) * D + n0 + c));
      if (m_hi < M)
        x_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<long long>(m_hi) * D + n0 + c));
      const float2 bb = *reinterpret_cast<const float2*>(bo_s + c);
      acc[4 * j] = __fadd_rn(__fadd_rn(x_lo.x, bb.x), acc[4 * j]);
      acc[4 * j + 1] = __fadd_rn(__fadd_rn(x_lo.y, bb.y), acc[4 * j + 1]);
      acc[4 * j + 2] = __fadd_rn(__fadd_rn(x_hi.x, bb.x), acc[4 * j + 2]);
      acc[4 * j + 3] = __fadd_rn(__fadd_rn(x_hi.y, bb.y), acc[4 * j + 3]);
    }

    // LayerNorm2's statistics over all D columns: the mean, then the mean
    // square of the deviations from it
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j >= n_chunks) break;
      s_lo += acc[4 * j] + acc[4 * j + 1];
      s_hi += acc[4 * j + 2] + acc[4 * j + 3];
    }
    exchange(psum, s_lo, s_hi);
    const float mu_lo = s_lo / D, mu_hi = s_hi / D;
    float q_lo = 0.f, q_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j >= n_chunks) break;
      const float d0 = acc[4 * j] - mu_lo, d1 = acc[4 * j + 1] - mu_lo;
      const float d2 = acc[4 * j + 2] - mu_hi, d3 = acc[4 * j + 3] - mu_hi;
      q_lo += d0 * d0 + d1 * d1;
      q_hi += d2 * d2 + d3 * d3;
    }
    exchange(psq, q_lo, q_hi);
    const float rstd_lo = rsqrtf(q_lo / D + eps), rstd_hi = rsqrtf(q_hi / D + eps);

    // y, then h = (y - mean) * rstd * g2 + b2, each staged as bf16 a
    // quarter (64 columns) at a time and stored
#pragma unroll
    for (int qd = 0; qd < BN / BQ; ++qd) {
      if (qd * (BQ / 8) >= n_chunks) break;
#pragma unroll
      for (int jq = 0; jq < BQ / 8; ++jq) {
        const int j = qd * (BQ / 8) + jq, c = c0 + 8 * jq;
        *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
            hp::pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
            hp::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      op::store_staged_rows<BQ>(cst, LDC, y, m0, n0 + BQ * qd, M, D);
#pragma unroll
      for (int jq = 0; jq < BQ / 8; ++jq) {
        const int j = qd * (BQ / 8) + jq, c = c0 + 8 * jq, cb = BQ * qd + c;
        const float2 gg = *reinterpret_cast<const float2*>(g2_s + cb);
        const float2 bb = *reinterpret_cast<const float2*>(b2_s + cb);
        *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
            hp::pack_bf16(op::ln_value(acc[4 * j], mu_lo, rstd_lo, gg.x, bb.x),
                          op::ln_value(acc[4 * j + 1], mu_lo, rstd_lo, gg.y, bb.y));
        *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
            hp::pack_bf16(op::ln_value(acc[4 * j + 2], mu_hi, rstd_hi, gg.x, bb.x),
                          op::ln_value(acc[4 * j + 3], mu_hi, rstd_hi, gg.y, bb.y));
      }
      op::store_staged_rows<BQ>(cst, LDC, hout, m0, n0 + BQ * qd, M, D);
    }
  }
}

// Launch oproj_ln_bf16_kernel, or, given `clusters`, report how many of
// its clusters (ceil(D / 256) blocks each) the card holds at once instead.
cudaError_t oproj_ln_bf16(const bf16* attn, const bf16* x, const bf16* wo, const float* bo,
                          const float* g2, const float* b2, bf16* y, bf16* h, int M, int D,
                          float eps, cudaStream_t stream, int* clusters) {
  CUtensorMap map_a = {}, map_b = {};
  if (clusters == nullptr) {
    const uint64_t dims_a[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(M)};
    const uint64_t dims_b[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(D)};
    const uint64_t strides[1] = {static_cast<uint64_t>(D)};
    const uint32_t box_a[2] = {ob::BK, ob::BM}, box_b[2] = {ob::BK, ob::BN};
    cudaError_t err = hp::encode_map(&map_a, hp::kBf16, attn, 2, dims_a, strides, box_a);
    if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kBf16, wo, 2, dims_b, strides, box_b);
    if (err != cudaSuccess) return err;
  }
  return op::launch_row_clusters(oproj_ln_bf16_kernel, ob::kThreads, ob::kSmem, M, D, stream,
                                 clusters, map_a, map_b, x, bo, g2, b2, y, h, M, D, eps);
}

}  // namespace

// attn_oproj_ln's two launches (the wrapper runs both, with the scratch
// between them; each alone serves the checks): attn_heads (q, k, v -> the
// attention output (B*T, D) bf16, the caller's scratch), then oproj_ln_bf16.
extern "C" int tpa_attn_heads(const bf16* q, const bf16* k, const bf16* v, bf16* out, int batch,
                              int T, int H, int t_valid, cudaStream_t stream) {
  if (!op::heads_fit(H) || t_valid < 1 || t_valid > T)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_heads = batch * H;
  CUtensorMap mq, mk, mv;  // the head-major layout as encoder_attention.py:tma_view's pre_bh
  cudaError_t err = aw::encode_qkv_maps(&mq, &mk, &mv, q, k, v, n_heads, T, 1,
                                        static_cast<long long>(T) * aw::HD, aw::HD, aw::HD);
  if (err == cudaSuccess) err = tpa::allow_smem(attn_heads_kernel, ah::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + aw::BQ - 1) / aw::BQ, n_heads);
  attn_heads_kernel<<<grid, aw::kThreads, ah::kSmem, stream>>>(mq, mk, mv, out, T, H, t_valid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpa_oproj_ln_bf16(const bf16* attn, const bf16* x, const bf16* wo, const float* bo,
                                 const float* g2, const float* b2, bf16* y, bf16* h, int M, int D,
                                 float eps, cudaStream_t stream) {
  if (D % aw::HD || !op::heads_fit(D / aw::HD)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(oproj_ln_bf16(attn, x, wo, bo, g2, b2, y, h, M, D, eps, stream, nullptr));
}

// How many of oproj_ln_bf16's clusters (ceil(D / 256) blocks each) fit the card at once.
extern "C" int tpa_oproj_ln_bf16_clusters(int* clusters, int H, cudaStream_t stream) {
  if (!op::heads_fit(H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(oproj_ln_bf16(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, op::BM, H * aw::HD, 0.f, stream,
                                        clusters));
}
