// Whisper encoder block, first phase: LayerNorm, then the packed QKV
// projection written head-major. bf16 in and out, f32 statistics and
// accumulation.
//
// Replaces tpu_audio/ops/pallas/fused_encoder.py:ln_qkv_packed.
//
//   x (B, T, D) -> xn = LayerNorm(x) (f32 statistics, rounded to bf16 as the
//   TPU kernel rounds it before its product) -> xn @ [q*s | k*s | v]^T (the
//   packed (3D, D) weight, f32 accumulation) + the f32 bias -> bf16, each
//   head's hd columns written as rows of q, k or v (B, H, T, hd).
//
// Two launches behind one entry point:
//   ln_rows   one warp a row, 16-byte loads, two-pass f32 statistics; writes
//             xn (B*T, D) bf16 into the caller's scratch tensor.
//   qkv_gemm  128 x 256 output tiles, one block an SM walking its share of
//             them (persistent): one producer warp keeps a 3-stage ring of
//             TMA loads in flight (xn 128 x 64 and weight 256 x 64 tiles,
//             both K-major as they lie, 128-byte swizzle), running on into
//             the next tile while this one is stored; two consumer
//             warpgroups each take 64 rows with wgmma m64n256k16 (128 f32
//             accumulators a thread). The epilogue adds the bias, rounds to
//             bf16 into a padded shared-memory tile and writes each head's
//             slice of a row with 16-byte stores. A 128-row tile straddles
//             batches (T = 1500), so each row finds its (b, t) itself; rows
//             past B*T come from TMA's zero fill and are not stored, and
//             columns past 3D likewise.
//
// Bound on the H100: tensor-core arithmetic. At large-v3-turbo batch 16
// (B*T = 24000, D = 1280) the product is 2 * 24000 * 1280 * 3840 = 236 GFLOP,
// 0.239 ms at 989 TFLOP/s, against 0.06 ms of bytes; xn adds 61 MB written
// and read (~0.04 ms). Keeping the LayerNormed rows resident instead (the
// first design) caps a block at 64 rows (165 KB of shared memory); fusing
// the LayerNorm into the A operand (wgmma with A from registers) is later
// work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
namespace hp = tpa::hopper;

namespace {

namespace lq {
constexpr int BM = 128, BN = 256, BK = 64, kStages = 3;
constexpr int kConsumers = 2;                        // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;      // + one producer warp
constexpr int kABytes = BM * BK * 2;                 // 16 KB
constexpr int kBBytes = BN * BK * 2;                 // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int LDC = BN + 8;                          // staged output row, bf16
constexpr int kSmem = 1024                           // alignment slack
                      + kStages * kStageBytes + BM * LDC * 2 + 2 * kStages * 8;
constexpr int kLnRows = 8;                           // rows (warps) per ln_rows block
}  // namespace lq

__global__ void __launch_bounds__(lq::kLnRows * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, bf16* __restrict__ xn, int M, int D, float eps) {
  const int row = blockIdx.x * lq::kLnRows + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
  uint4* dst = reinterpret_cast<uint4*>(xn + static_cast<long long>(row) * D);
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
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = src[c];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    const float4 w0 = reinterpret_cast<const float4*>(ln_w)[2 * c];
    const float4 w1 = reinterpret_cast<const float4*>(ln_w)[2 * c + 1];
    const float4 b0 = reinterpret_cast<const float4*>(ln_b)[2 * c];
    const float4 b1 = reinterpret_cast<const float4*>(ln_b)[2 * c + 1];
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = hp::pack_bf16((__bfloat162float(e[2 * j]) - mu) * rstd * w[2 * j] + b[2 * j],
                           (__bfloat162float(e[2 * j + 1]) - mu) * rstd * w[2 * j + 1] +
                               b[2 * j + 1]);
    dst[c] = out;
  }
}

// + bias, bf16, head-major: one warpgroup's 64 rows of the (m0, n0) tile,
// staged through its rows of `cst`.
__device__ __forceinline__ void store_tile(const float (&acc)[128], bf16* cst,
                                           const float* __restrict__ bias, bf16* q, bf16* k,
                                           bf16* v, int m0, int n0, int wg, int M, int T, int D,
                                           int H) {
  using namespace lq;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x & 31;
  const int N3 = 3 * D;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane % 4) * 2;
    float2 bb = make_float2(0.f, 0.f);
    if (n0 + c < N3) bb = *reinterpret_cast<const float2*>(bias + n0 + c);
    *reinterpret_cast<uint32_t*>(cst + r0 * LDC + c) =
        hp::pack_bf16(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    *reinterpret_cast<uint32_t*>(cst + (r0 + 8) * LDC + c) =
        hp::pack_bf16(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
  hp::named_barrier(1 + wg, 128);

  // each head's slice of a row is contiguous in q, k or v: 16-byte stores.
  // A thread keeps one 8-column chunk and walks every 4th row.
  const int hd = D / H;
  const int c = (tid % (BN / 8)) * 8, n = n0 + c;
  if (n < N3) {
    const int which = n / D, nn = n - which * D, h = nn / hd, e = nn - h * hd;
    bf16* dst = which == 0 ? q : (which == 1 ? k : v);
    for (int r = wg * 64 + tid / (BN / 8); r < wg * 64 + 64; r += 128 / (BN / 8)) {
      const int m = m0 + r;
      if (m >= M) break;
      const int b = m / T, t = m - b * T;
      const bf16* src = cst + r * LDC + c;
      if (hd % 8 == 0) {
        *reinterpret_cast<uint4*>(dst + ((static_cast<long long>(b) * H + h) * T + t) * hd + e) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8; ++j) {
          const int wj = (n + j) / D, nj = n + j - wj * D, hj = nj / hd, ej = nj - hj * hd;
          bf16* dj = wj == 0 ? q : (wj == 1 ? k : v);
          dj[((static_cast<long long>(b) * H + hj) * T + t) * hd + ej] = src[j];
        }
      }
    }
  }
  hp::named_barrier(1 + wg, 128);  // the rows are read before the next tile writes them
}

// Persistent: block i takes output tiles i, i + gridDim.x, ..., the N tiles
// of one row block consecutive (so a row block's xn is read from device
// memory once, while the weight stays in L2). The ring runs on across tiles:
// the producer fills the next tile's stages while the consumers store this
// one.
__global__ void __launch_bounds__(lq::kThreads, 1)
qkv_gemm_kernel(__grid_constant__ const CUtensorMap map_a,   // xn (M, D)
                __grid_constant__ const CUtensorMap map_b,   // w (3D, D)
                const float* __restrict__ bias,              // (3D)
                bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v,
                int M, int T, int D, int H) {
  using namespace lq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  unsigned char* ring = smem;                                        // kStages x (A | B)
  bf16* cst = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);  // BM x LDC
  uint64_t* full = reinterpret_cast<uint64_t*>(cst + BM * LDC);
  uint64_t* empty = full + kStages;

  const int n_tiles_n = (3 * D + BN - 1) / BN;
  const int n_tiles = n_tiles_n * ((M + BM - 1) / BM);
  const int ksteps = D / BK;
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
  const int lane = threadIdx.x & 31;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles_n) * BN, m0 = (tile / n_tiles_n) * BM;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk, ++it) {
      const int s = it % kStages;
      hp::mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t da = hp::desc_sw128(ring + s * kStageBytes + wg * 64 * 128);
      const uint64_t db = hp::desc_sw128(ring + s * kStageBytes + kABytes);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) hp::wgmma_m64n256k16_ss(acc, da + 2 * j, db + 2 * j, 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous step's products are done: release its stage
      hp::fence_regs(acc);
      if (kk > 0 && lane == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (lane == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
    store_tile(acc, cst, bias, q, k, v, m0, n0, wg, M, T, D, H);
  }
}

}  // namespace

extern "C" int tpa_ln_qkv(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w,
                          const float* bias, bf16* xn, bf16* q, bf16* k, bf16* v, int batch,
                          int T, int D, int H, float eps, cudaStream_t stream) {
  const int M = batch * T;
  ln_rows_kernel<<<(M + lq::kLnRows - 1) / lq::kLnRows, lq::kLnRows * 32, 0, stream>>>(
      x, ln_w, ln_b, xn, M, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(3 * D)};
  const uint64_t strides[1] = {static_cast<uint64_t>(D)};
  const uint32_t box_a[2] = {lq::BK, lq::BM}, box_b[2] = {lq::BK, lq::BN};
  err = hp::encode_map(&map_a, hp::kBf16, xn, 2, dims_a, strides, box_a);
  if (err == cudaSuccess) err = hp::encode_map(&map_b, hp::kBf16, w, 2, dims_b, strides, box_b);
  if (err == cudaSuccess) err = tpa::allow_smem(qkv_gemm_kernel, lq::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (3 * D + lq::BN - 1) / lq::BN * ((M + lq::BM - 1) / lq::BM);
  qkv_gemm_kernel<<<tiles < sms ? tiles : sms, lq::kThreads, lq::kSmem, stream>>>(
      map_a, map_b, bias, q, k, v, M, T, D, H);
  return static_cast<int>(cudaGetLastError());
}
