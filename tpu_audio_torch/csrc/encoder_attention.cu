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
// registers to the end. A warpgroup waits for each product before it goes
// on; the four warpgroups of an SM overlap each other's softmax and
// products. 256 threads at 112 registers let two blocks share an SM (83 KB
// of shared memory each); a separate producer warp would make ptxas budget
// the block as 384 threads and cap it at 168 registers, one block an SM.
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

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;
namespace hp = tpa::hopper;

namespace {

namespace ea {
constexpr int BQ = 128, BKV = 64, HD = 64, kStages = 4;
constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = kConsumers * 128;      // thread 0 also issues the loads
constexpr int kQBytes = BQ * HD * 2;            // 16 KB
constexpr int kKVBytes = BKV * HD * 2;          // 8 KB: a K or V tile
constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 2 * kStages) * 8;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
}  // namespace ea

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(ea::kThreads, 2)
encoder_attention_kernel(__grid_constant__ const CUtensorMap map_q,
                         __grid_constant__ const CUtensorMap map_k,
                         __grid_constant__ const CUtensorMap map_v, bf16* __restrict__ out,
                         int T, int t_valid, int inner, long long stride_outer,
                         long long stride_inner, int ld, float scale_log2) {
  using namespace ea;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* kv = smem + kQBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + 2 * kStages * kKVBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int n = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hi = n % inner, ho = n / inner;
  const int n_tiles = (t_valid + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;
  const bool producer = threadIdx.x == 0;
  if (producer) {
    hp::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (producer) {
    hp::mbar_arrive_expect_tx(qbar, kQBytes);
    hp::tma_load_4d(qs, &map_q, qbar, 0, hi, q0, ho);
    for (int j = 0; j < kStages && j < n_tiles; ++j) {
      hp::mbar_arrive_expect_tx(&full[j], 2 * kKVBytes);
      hp::tma_load_4d(kv + j * 2 * kKVBytes, &map_k, &full[j], 0, hi, j * BKV, ho);
      hp::tma_load_4d(kv + j * 2 * kKVBytes + kKVBytes, &map_v, &full[j], 0, hi, j * BKV, ho);
    }
  }

  // warpgroup wg: query rows q0 + wg*64 .. + 63; this thread holds rows r
  // and r + 8 of them (the accumulator layout of hopper.cuh)
  const int tid = threadIdx.x % 128, lane = threadIdx.x & 31;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint64_t dq = hp::desc_sw128(qs + wg * 64 * 128);
  hp::mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    hp::mbar_wait(&full[s], (j / kStages) & 1);
    unsigned char* ks = kv + s * 2 * kKVBytes;
    const uint64_t dk = hp::desc_sw128(ks), dv = hp::desc_sw128(ks + kKVBytes);

    float sc[32];
    hp::fence_regs(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) hp::wgmma_m64n64k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);

    // scores in log2 units; keys at or past t_valid masked
    const bool partial = (j + 1) * BKV > t_valid;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] *= scale_log2;
      if (partial) {
        const int key = j * BKV + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
        if (key >= t_valid) sc[i] = kMasked;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
    uint32_t p[4][4];  // P in bf16 pairs: the A fragments of the 4 k-steps over 64 keys
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i / 2) % 2;
      const float e0 = exp2_approx(sc[i] - mx[h]), e1 = exp2_approx(sc[i + 1] - mx[h]);
      l_run[h] += e0 + e1;
      p[i / 8][(i % 8) / 2] = hp::pack_bf16(e0, e1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];

    hp::fence_regs(o);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) hp::wgmma_m64n64k16_rs_tb(o, p[kk], dv + 128 * kk, 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    if (lane == 0) hp::mbar_arrive(&empty[s]);
    // refill the stage of the previous tile once both warpgroups are done with it
    if (producer && j >= 1) {
      const int jj = j - 1, nj = jj + kStages, st = jj % kStages;
      if (nj < n_tiles) {
        hp::mbar_wait(&empty[st], (jj / kStages) & 1);
        hp::mbar_arrive_expect_tx(&full[st], 2 * kKVBytes);
        hp::tma_load_4d(kv + st * 2 * kKVBytes, &map_k, &full[st], 0, hi, nj * BKV, ho);
        hp::tma_load_4d(kv + st * 2 * kKVBytes + kKVBytes, &map_v, &full[st], 0, hi, nj * BKV,
                        ho);
      }
    }
  }

  // O / l, bf16, stored through the layout's base offset and row stride
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;
  }
  const long long off = ho * stride_outer + hi * stride_inner;
  const int r = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r + 8 * h;
    if (t >= T) continue;
    bf16* row = out + off + static_cast<long long>(t) * ld;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
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
  const uint64_t dims[4] = {ea::HD, static_cast<uint64_t>(inner), static_cast<uint64_t>(T),
                            static_cast<uint64_t>(n_heads / inner)};
  const uint64_t strides[3] = {static_cast<uint64_t>(stride_inner), static_cast<uint64_t>(ld),
                               static_cast<uint64_t>(stride_outer)};
  const uint32_t box[4] = {ea::HD, 1, ea::BKV, 1}, qbox[4] = {ea::HD, 1, ea::BQ, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err = hp::encode_map(&mq, hp::kBf16, q, 4, dims, strides, qbox);
  if (err == cudaSuccess) err = hp::encode_map(&mk, hp::kBf16, k, 4, dims, strides, box);
  if (err == cudaSuccess) err = hp::encode_map(&mv, hp::kBf16, v, 4, dims, strides, box);
  if (err == cudaSuccess) err = tpa::allow_smem(encoder_attention_kernel, ea::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + ea::BQ - 1) / ea::BQ, n_heads);
  encoder_attention_kernel<<<grid, ea::kThreads, ea::kSmem, stream>>>(
      mq, mk, mv, out, T, t_valid, inner, stride_outer, stride_inner, ld, scale * ea::kLog2e);
  return static_cast<int>(cudaGetLastError());
}
