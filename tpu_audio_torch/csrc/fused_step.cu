// The whole Llama / Qwen2 / Qwen3 decoder stack for one token at B=1, all
// layers, in one cooperative launch.
//
// Replaces tpu_audio/ops/pallas/fused_step.py:fused_decode_step.
//
// Bound on the H100: device-memory bytes. A step reads every layer's
// weights once: Qwen3-0.6B 880.8 MB in bf16 (440.4 MB int8), ~0.26 ms
// (0.13 ms) at 3.35 TB/s; Llama-3.2-3B 2.82 GB in int8, ~0.85 ms.
// (tools/fused_step_split.py splits the step's time on the card.)
//
// Design. One block an SM, co-resident (cudaLaunchCooperativeKernel): eight
// consumer warps and one producer warp.
//  - Weights. Block b owns channels [C b / G, C (b + 1) / G) of every
//    product (C its output channels, G the blocks), contiguous rows in
//    memory; of gate/up it owns the gate rows AND the up rows of the same
//    channels. The producer warp's lane 0 streams the block's rows of every
//    product of every layer, in the order the consumers use them, by bulk
//    copies (cp.async.bulk, completion on an mbarrier) into a ring of
//    `stages` slots of ~49 KB (16 rows of 3 KB), and waits only for a slot
//    to be freed: it never waits on a grid barrier, so the weights of the
//    next products are in flight while the consumers wait at one.
//  - A product: its input vector (the normed residual, the attention
//    output or the SwiGLU activation) is written to shared memory once as a
//    few exact terms (see make_terms), and the rows of each landed slot go
//    to the tensor cores as they are: mma.sync m16n8k32 s8 (int8 weights,
//    s32 sums) or m16n8k16 bf16 (f32 sums), the terms the columns of B, each
//    warp a share of the k-steps of every 16-row tile of the slot. No
//    weight is converted: an int8 -> f32 conversion issues at an eighth of
//    the FMA rate, and an FMA loop, one row a warp against f32 inputs in
//    shared memory, measured as the largest share of a step
//    (tools/fused_step_split.py splits both designs). A slot costs the
//    consumers ~1 us however few its rows, so its rows are as many as fit,
//    spread evenly over the product's slots. A thread a channel sums the warps' shares of its rows
//    and applies the scale (and bias, residual or SwiGLU), its scale and
//    residual row loaded before the product's first slot is waited on.
//    silu(gate) * up is the gate/up product's epilogue, so the down product
//    reads `hidden` values.
//  - Phases of a layer, each ended by a grid barrier among the consumer
//    warps (an arrival counter, thread 0 of each block; the producer is
//    not part of it): P1 RMSNorm ln1 -> qkv (+ scale, bias); P2 attention;
//    P3 o-projection + residual; P4 RMSNorm ln2 -> gate/up -> SwiGLU;
//    P5 down + residual. Five a layer, and after the last block 0 writes
//    the final RMSNorm. An RMSNorm reads the residual once into registers.
//  - Attention: query head h's keys [start, pos) are split over `split`
//    blocks. Each normalises (Qwen3 q/k RMS) and rotates its q head and its
//    KV head (h // (H / KVH)) itself; chunk 0 of the first query head of a
//    KV head writes the new k/v slot at `pos`. A chunk leaves (max, sum of
//    exp, P.V) in the workspace; the chunk that arrives last at its head's
//    counter (atomicAdd after a fence) merges the head's chunks and the
//    current token's own term, so every other block reads H hd merged
//    values. With f32 activations one pass a chunk is exact up to the order
//    of the sums; with bf16 ones each probability is rounded against the
//    head's max and sum, as the reference rounds it, so a chunk first
//    publishes its max and sum, waits at the head's counter for the others,
//    then forms its P.V.
//  - A wait that never ends (a fault) traps after ~4 s instead of hanging.
// The term making, a slot's product and the chunk's attention are functions
// of their own (__noinline__), to keep the kernel's registers unspilled.
// Weights are int8 with a per-channel f32 scale applied to the dot's output
// (W8A16: activations not quantised) or bf16 with scale 1. With bf16
// activations the normed input, the probabilities, the attention output and
// the SwiGLU activation are rounded to bf16 before their products, as the
// TPU kernel rounds to its compute dtype. Sums are f32 (s32 within a
// term's int8 product).
//
// Data written during the launch (the residual, qkv, partials, the merged
// attention output, the SwiGLU activation) is read with __ldcg, from L2,
// so that no SM's L1 can hand back a stale line.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "decode_dot.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;
namespace hp = tpa::hopper;

namespace {

constexpr int kWarps = 8;                        // consumer warps
constexpr int kThreads = kWarps * 32;            // consumer threads
constexpr int kBlockThreads = kThreads + 32;     // and the producer warp
constexpr int kBar = 1;                          // the consumers' named barrier
constexpr int kMaxSplit = 32;                    // key chunks a head (one lane each when merging)
constexpr int kSlotBytes = 49920;                // a ring slot: 16 rows of 3 KB, their pads
constexpr int kMaxStages = 8;
constexpr int kPiece = 16384;                    // a bulk copy, at most
constexpr int kRed = 2048;                       // floats of the P.V reduction
constexpr int kEarly = 4;                        // key and value rows a lane loads first
enum { P_QKV, P_O, P_GU, P_DOWN, kProducts };

struct Params {
  const void* x;
  int x_bf16;
  const long long* pos;
  const long long* start;
  const float* cos;      // (hd)
  const float* sin;
  const void* w[kProducts];   // qkv (L, QO, D), o (L, D, H hd), gate/up (L, 2 hidden, D), down
  const float* s[kProducts];  // (L, rows)
  const float* bqkv;     // (L, QO) or null
  const float* qknorm;   // (L, 2, hd) or null
  const float* ln1;      // (L, D)
  const float* ln2;
  const float* norm;     // (D)
  __nv_bfloat16* kc;     // (L, KVH, S, hd)
  __nv_bfloat16* vc;
  float* h;              // (D)
  float* work;
  float eps;
  int L, D, hidden, H, KVH, S;
  int split;             // key chunks a head
  int stages;            // slots of the weight ring
  int stage_bytes;       // bytes of a slot
  int kv_rows;           // the most keys of a chunk
  int per_slot[kProducts];  // the most channels a slot holds, by product
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void consumers_sync() { hp::named_barrier(kBar, kThreads); }

// A wait of the step that lasts this long is a fault (a slot or a count
// that never comes): it traps, and the launch fails, rather than hang. The
// SM's cycle counter is read only once a wait has failed.
constexpr long long kHangCycles = 8000000000ll;  // ~4 s

__device__ __forceinline__ void check_hang(long long& since) {
  const long long now = clock64();
  if (since == 0)
    since = now;
  else if (now - since > kHangCycles)
    __trap();
}

// Until *count reaches target (an acquire).
__device__ __forceinline__ void wait_count(const int* count, int target) {
  long long t0 = 0;
  while (ld_acquire(count) < target) check_hang(t0);
}

// Until the mbarrier's phase of this parity has completed.
__device__ __forceinline__ void wait_slot(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hp::smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    check_hang(t0);
  }
}

// Sum and max over the consumer threads; every one gets the result.
__device__ __forceinline__ float csum(float v, float* scratch) {
  v = tpa::warp_sum(v);
  consumers_sync();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  consumers_sync();
  return tpa::warp_sum((threadIdx.x & 31) < kWarps ? scratch[threadIdx.x & 31] : 0.f);
}

__device__ __forceinline__ float cmax(float v, float* scratch) {
  v = tpa::warp_max(v);
  consumers_sync();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  consumers_sync();
  return tpa::warp_max((threadIdx.x & 31) < kWarps ? scratch[threadIdx.x & 31] : -INFINITY);
}

// The grid barrier among the consumer warps of all blocks: arrival number
// `target` (G a barrier, counted from the launch) at the counter.
__device__ __forceinline__ void grid_barrier(int* count, int target) {
  consumers_sync();
  if (threadIdx.x == 0) {
    // a release at the device's scope: it orders every consumer's writes,
    // which the named barrier ordered before it
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
    wait_count(count, target);
  }
  consumers_sync();
}

// This block's channels [lo, lo + n) of C over G blocks.
__device__ __forceinline__ int share(int C, int b, int G, int& lo) {
  lo = static_cast<int>(static_cast<long>(C) * b / G);
  return static_cast<int>(static_cast<long>(C) * (b + 1) / G) - lo;
}

// ---- the products, on the tensor cores
//
// A product's input vector a goes to shared memory as a few terms the
// tensor cores take, so that mma.sync reads the weight rows as they landed,
// with no conversion of a weight:
//  - int8 weights: a = S (t0 + t1 / 128 + t2 / 128^2 + t3 / 128^3) + e, the
//    t int8, S the power of two with 32 S <= max|a| < 64 S; |e| <= 2^-22 S,
//    a sixteenth of the f32 ulp of the largest element;
//  - bf16 weights: a = t0 + t1 + t2, the t bf16 (hi, mid, lo), exactly; a
//    bf16 activation is t0 alone.
// Row . a is then the sum over t of wt_t (row . t_t) (wt_t = S 2^-7t, or
// 1): one mma.sync (m16n8k32 s8 with s32 sums, or m16n8k16 bf16 with f32
// sums) a 16-row tile and 32 bytes of k, the terms the B operand's columns.
// Rows and terms lie 32 bytes further apart than their length in shared
// memory, so that the 8-byte loads of a fragment meet no bank twice.
template <typename W>
struct Terms;
template <>
struct Terms<int8_t> {
  using T = int8_t;
  static constexpr int n = 4;
};
template <>
struct Terms<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int n = 3;
};

constexpr int kPad = 32;    // bytes between rows, and between terms
constexpr int kMaxIn = 32;  // input values a thread holds: I <= 8192
constexpr int kRows = 2 * kThreads;  // a product's rows a block holds, at most

// Row pitch in shared memory of I elements of T.
template <typename T>
__host__ __device__ constexpr int pitch_of(int I) {
  return I * static_cast<int>(sizeof(T)) + kPad;
}

__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename W>
using Acc = typename std::conditional<sizeof(W) == 1, int, float>::type;

// The n values of a vector (f32 x, read from L2, or the bf16 input xb),
// RMS-normalised with weight nw when nw is given, rounded to bf16 when rb,
// into the product's terms (shared, pitch pitch_of<T>(n)) and their weights
// wt. Each thread holds K float4 of them (n <= 4 K kThreads) in registers,
// the weight's beside them, loaded together. The consumers; syncs them at
// the end.
template <typename W, int K>
__device__ __noinline__ void make_terms_k(const float* x, const __nv_bfloat16* xb,
                                          const float* nw, int n, float eps, bool rb,
                                          unsigned char* terms, float* wt, float* scratch) {
  using T = typename Terms<W>::T;
  const int tp = pitch_of<T>(n), tid = threadIdx.x;
  float v[K][4], w[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = tid + k * kThreads;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[k][j] = 0.f, w[k][j] = 0.f;
    if (4 * i < n) {
      if (xb != nullptr) {
        float a[2], b[2];
        const uint2 u = reinterpret_cast<const uint2*>(xb)[i];
        tpa::dec::bf16x2(u.x, a);
        tpa::dec::bf16x2(u.y, b);
        v[k][0] = a[0], v[k][1] = a[1], v[k][2] = b[0], v[k][3] = b[1];
      } else {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(x) + i);
        v[k][0] = f.x, v[k][1] = f.y, v[k][2] = f.z, v[k][3] = f.w;
      }
      if (nw != nullptr) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(nw) + i);
        w[k][0] = f.x, w[k][1] = f.y, w[k][2] = f.z, w[k][3] = f.w;
      }
    }
  }
  if (nw != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) s = fmaf(v[k][j], v[k][j], s);
    const float r = rsqrtf(csum(s, scratch) / n + eps);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = v[k][j] * r * w[k][j];
  }
  if (rb) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = round_bf16(v[k][j]);
  }
  if constexpr (sizeof(T) == 1) {
    float mx = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fabsf(v[k][j]));
    int e;
    frexpf(cmax(mx, scratch), &e);  // max|a| < 2^e
    const float up = __int_as_float((127 + 6 - e) << 23);  // 2^(6 - e)
    // r + 1.5 2^23 rounds r (|r| <= 64) to the nearest integer, ties to
    // even as rintf, which is then the low byte of its bits
    constexpr float kRound = 12582912.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * kThreads;
      uint32_t q[4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r = v[k][j] * up;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float b = __fadd_rn(r, kRound);
          q[t] |= (__float_as_uint(b) & 0xFFu) << (8 * j);
          r = (r - __fsub_rn(b, kRound)) * 128.f;
        }
      }
      if (4 * i < n)
#pragma unroll
        for (int t = 0; t < 4; ++t) *reinterpret_cast<uint32_t*>(terms + t * tp + 4 * i) = q[t];
    }
    if (tid < 4) wt[tid] = __int_as_float((127 + e - 6 - 7 * tid) << 23);  // 2^(e - 6 - 7t)
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = tid + k * kThreads;
      uint32_t q[3][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r0 = v[k][2 * h], r1 = v[k][2 * h + 1];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
          q[t][h] = *reinterpret_cast<const uint32_t*>(&b);
          r0 -= __low2float(b);
          r1 -= __high2float(b);
        }
      }
      if (4 * i < n)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          *reinterpret_cast<uint2*>(terms + t * tp + 8 * i) = make_uint2(q[t][0], q[t][1]);
    }
    if (tid < 3) wt[tid] = 1.f;
  }
  consumers_sync();
}

template <typename W>
__device__ __forceinline__ void make_terms(const float* x, const __nv_bfloat16* xb,
                                           const float* nw, int n, float eps, bool rb,
                                           unsigned char* terms, float* wt, float* scratch) {
  const int k = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (k <= 1)
    make_terms_k<W, 1>(x, xb, nw, n, eps, rb, terms, wt, scratch);
  else if (k <= 2)
    make_terms_k<W, 2>(x, xb, nw, n, eps, rb, terms, wt, scratch);
  else if (k <= 3)
    make_terms_k<W, 3>(x, xb, nw, n, eps, rb, terms, wt, scratch);
  else if (k <= 4)
    make_terms_k<W, 4>(x, xb, nw, n, eps, rb, terms, wt, scratch);
  else
    make_terms_k<W, 8>(x, xb, nw, n, eps, rb, terms, wt, scratch);
}

// The rows of one slot, TT 16-row tiles of them, against the terms: each
// warp takes every kWarps-th 32 bytes of k, KU k-steps at once (TT KU = 4
// sums in flight), the terms' fragment loaded once a k-step for every tile.
// Row r of the slot (r < rows) goes to out[r + (r >= cnt) (n - cnt)]: the
// up rows of gate/up (U = 2) sit n further than the gate rows.
template <typename W, int TT>
__device__ __forceinline__ void tiles_mma(const unsigned char* st, int rows, int cnt, int n,
                                          int nkb, int pw, const unsigned char* tb, float w0,
                                          float w1, float* out) {
  constexpr int NT = Terms<W>::n, KU = 4 / TT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const unsigned char* pa[TT];
  const unsigned char* pb[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    pa[t] = st + min(16 * t + g, rows - 1) * pw + 8 * c;
    pb[t] = st + min(16 * t + g + 8, rows - 1) * pw + 8 * c;
  }
  Acc<W> acc[TT][KU][4] = {};
  auto step = [&](int u, int kk) {
    const int o = 32 * kk;
    const uint2 x = g < NT ? *reinterpret_cast<const uint2*>(tb + o) : make_uint2(0u, 0u);
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const uint2 wa = *reinterpret_cast<const uint2*>(pa[t] + o);
      const uint2 wb = *reinterpret_cast<const uint2*>(pb[t] + o);
      mma(acc[t][u], wa.x, wb.x, wa.y, wb.y, x.x, x.y);
    }
  };
  int kb = warp;
#pragma unroll 1
  for (; kb + (KU - 1) * kWarps < nkb; kb += KU * kWarps) {
#pragma unroll
    for (int u = 0; u < KU; ++u) step(u, kb + u * kWarps);
  }
#pragma unroll 1
  for (; kb < nkb; kb += kWarps) step(0, kb);
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    // row g of the tile: columns 2c, 2c + 1 (terms); row g + 8 likewise
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      va += static_cast<float>(acc[t][u][0]) * w0 + static_cast<float>(acc[t][u][1]) * w1;
      vb += static_cast<float>(acc[t][u][2]) * w0 + static_cast<float>(acc[t][u][3]) * w1;
    }
    va += __shfl_xor_sync(0xffffffffu, va, 1);
    va += __shfl_xor_sync(0xffffffffu, va, 2);
    vb += __shfl_xor_sync(0xffffffffu, vb, 1);
    vb += __shfl_xor_sync(0xffffffffu, vb, 2);
    const int ra = 16 * t + g, rb = ra + 8;
    if (c == 0 && ra < rows) out[ra + (ra >= cnt ? n - cnt : 0)] = va;
    if (c == 0 && rb < rows) out[rb + (rb >= cnt ? n - cnt : 0)] = vb;
  }
}

// One slot of a product, st (shared, rows pitch_of<W>(I) apart): the rows
// of its channels [c0, c0 + cnt) of the block's n, unit after unit (the
// gate rows, then the up rows; U cnt <= 64). Each warp writes its share of
// row (u, c) . a, against the terms of a (shared) and their weights wt, to
// part[warp][u n + c] (shared, kRows a warp). Waits for the slot to land,
// frees it when done.
template <typename W>
__device__ __noinline__ void slot_mma(const unsigned char* st, uint64_t* full, uint64_t* empty,
                                      uint32_t parity, int c0, int cnt, int n, int U, int I,
                                      const unsigned char* terms, const float* wt, float* part) {
  using T = typename Terms<W>::T;
  constexpr int NT = Terms<W>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const int rows = U * cnt, nkb = I * static_cast<int>(sizeof(W)) / 32;
  const int pw = pitch_of<W>(I);
  const unsigned char* tb = terms + g * pitch_of<T>(I) + 8 * c;  // term g (g < NT)
  const float w0 = 2 * c < NT ? wt[2 * c] : 0.f, w1 = 2 * c + 1 < NT ? wt[2 * c + 1] : 0.f;
  float* out = part + warp * kRows + c0;
  wait_slot(full, parity);
  if (rows <= 16)
    tiles_mma<W, 1>(st, rows, cnt, n, nkb, pw, tb, w0, w1, out);
  else if (rows <= 32)
    tiles_mma<W, 2>(st, rows, cnt, n, nkb, pw, tb, w0, w1, out);
  else
    tiles_mma<W, 4>(st, rows, cnt, n, nkb, pw, tb, w0, w1, out);
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

// The channels of a block's n in each slot of a product: as even as the
// slots allow, at most `fit` (the slot's room).
__device__ __forceinline__ int slot_channels(int n, int fit) {
  const int slots = (n + fit - 1) / fit;
  return slots > 0 ? (n + slots - 1) / slots : fit;
}

// The final RMSNorm of the residual x (global) with weight w into h.
// The consumers.
__device__ __noinline__ void final_norm(const float* x, const float* w, int D, float eps,
                                        float* h, float* scratch) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = __ldcg(x + i);
    s = fmaf(v, v, s);
  }
  const float r = rsqrtf(csum(s, scratch) / D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) h[i] = __ldcg(x + i) * r * w[i];
}

// Eight bf16 (16 bytes) as floats.
__device__ __forceinline__ void bf16x8(const uint4& w, float (&f)[8]) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a[2];
    tpa::dec::bf16x2(ws[i], a);
    f[2 * i] = a[0];
    f[2 * i + 1] = a[1];
  }
}

// The shared buffers of one head's chunk of attention.
struct AttnSmem {
  float* qh;       // HD: the rotated, scaled query head
  float* kh;       // HD: the rotated key head
  float* tmp;      // 2 HD
  float* scores;   // kv_rows
  float* red;      // kRed
  float* scratch;  // 32
  float* bc;       // 8: values broadcast to the consumers
};

// Where a chunk's partial goes, the head's partials, the head's arrival
// counters and the count at which every chunk of this layer has arrived.
struct Chunk {
  float* part;
  const float* head_part;
  int* stats;
  int* done;
  int target, split;
};

// One head's chunk of attention: keys [t0, t1) of kb/vb (the cache of its
// KV head, rows of HD), query q, key k, value v of the current token
// (global, raw: q/k-norm weights qn/kn or null, RoPE cos/sin, q scaled by
// HD^-1/2). Writes the current token's k, v into the cache slot `pos` when
// `slot`. Leaves (max, sum of exp, P.V) in c.part; the chunk that arrives
// last at c.done merges the head's partials with the fresh term into out
// (global, HD). rb: bf16 activations (see the file's comment).
template <int HD>
__device__ __noinline__ void chunk_attention(const float* q, const float* k, const float* v,
                                             const float* qn, const float* kn, const float* cos,
                                             const float* sin, float eps,
                                             __nv_bfloat16* kb, __nv_bfloat16* vb, int t0,
                                             int t1, int pos, bool slot, bool rb, Chunk c,
                                             float* out, AttnSmem sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kGroupWarps = HD / 32;
  // HD / 8 lanes a key or value row, 8 elements a lane; the first kEarly
  // rows of each lane's keys and values are loaded before anything waits,
  // so that their latency runs beside the query's
  constexpr int lanes = HD / 8, rows = kThreads / lanes;
  const int e = tid % lanes, rr = tid / lanes, n = t1 - t0;
  uint4 ke[kEarly], ve[kEarly];
#pragma unroll
  for (int j = 0; j < kEarly; ++j) {
    const int t = rr + j * rows;
    ke[j] = ve[j] = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) {
      ke[j] = __ldg(reinterpret_cast<const uint4*>(kb + static_cast<long>(t0 + t) * HD + e * 8));
      ve[j] = __ldg(reinterpret_cast<const uint4*>(vb + static_cast<long>(t0 + t) * HD + e * 8));
    }
  }
  // q to threads [0, HD), k to [HD, 2 HD): the optional RMS, then RoPE
  {
    const bool isq = tid < HD, isk = tid >= HD && tid < 2 * HD;
    const int d = tid % HD;
    const float x = isq ? __ldcg(q + d) : isk ? __ldcg(k + d) : 0.f;
    const float ss = tpa::warp_sum(x * x);
    if (lane == 0) sm.scratch[warp] = ss;
    consumers_sync();
    const float* nw = isq ? qn : kn;
    if (isq || isk) {
      float r = 1.f;
      if (nw != nullptr) {
        float t = 0.f;
        for (int w = 0; w < kGroupWarps; ++w) t += sm.scratch[(tid / HD) * kGroupWarps + w];
        r = rsqrtf(t / HD + eps);
      }
      sm.tmp[tid] = nw != nullptr ? x * r * nw[d] : x;
    }
    consumers_sync();
    if (isq || isk) {
      const int base = tid - d;
      const float rot = d < HD / 2 ? -sm.tmp[base + d + HD / 2] : sm.tmp[base + d - HD / 2];
      const float y = sm.tmp[tid] * cos[d] + rot * sin[d];
      if (isq)
        sm.qh[d] = y * rsqrtf(static_cast<float>(HD));
      else
        sm.kh[d] = y;
    }
    consumers_sync();
  }
  if (slot && tid < HD) {
    kb[static_cast<long>(pos) * HD + tid] = __float2bfloat16(sm.kh[tid]);
    vb[static_cast<long>(pos) * HD + tid] = __float2bfloat16(__ldcg(v + tid));
  }
  // scores
  float qreg[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qreg[j] = sm.qh[e * 8 + j];
  float mloc = -INFINITY;
  auto score = [&](int t, const uint4& raw) {  // the whole warp, the same t - rr
    float f[8], s = 0.f;
    bf16x8(raw, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(qreg[j], f[j], s);
#pragma unroll
    for (int off = lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (t < n) {
      if (e == 0) sm.scores[t] = s;
      mloc = fmaxf(mloc, s);
    }
  };
#pragma unroll
  for (int j = 0; j < kEarly; ++j) score(rr + j * rows, ke[j]);
  for (int base = kEarly * rows; base < n; base += rows) {  // the same trip count for every lane
    const int t = base + rr;
    score(t, t < n ? __ldg(reinterpret_cast<const uint4*>(kb + static_cast<long>(t0 + t) * HD +
                                                          e * 8))
                   : make_uint4(0u, 0u, 0u, 0u));
  }
  const float m = cmax(mloc, sm.scratch);  // syncs: scores visible
  float lsum = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float x = expf(sm.scores[t] - m);
    if (!rb) sm.scores[t] = x;
    lsum += x;
  }
  const float l = csum(lsum, sm.scratch);  // syncs
  // the fresh score, by warp 0
  if (warp == 0) {
    float sf = 0.f;
    for (int d = lane; d < HD; d += 32) sf = fmaf(sm.qh[d], sm.kh[d], sf);
    sf = tpa::warp_sum(sf);
    if (lane == 0) sm.bc[0] = sf;
  }
  if (rb) {
    if (tid == 0) {
      c.part[0] = m;
      c.part[1] = l;
      __threadfence();
      atomicAdd(c.stats, 1);
      wait_count(c.stats, c.target);
    }
    consumers_sync();
    if (warp == 0) {  // the head's max and sum over its chunks and the fresh term
      const float sf = sm.bc[0];
      const bool live = lane < c.split && __ldcg(c.head_part + lane * (HD + 2) + 1) > 0.f;
      const float mc = live ? __ldcg(c.head_part + lane * (HD + 2)) : -INFINITY;
      const float M = fmaxf(tpa::warp_max(mc), sf);
      const float L =
          tpa::warp_sum(live ? __ldcg(c.head_part + lane * (HD + 2) + 1) * expf(mc - M) : 0.f) +
          expf(sf - M);
      if (lane == 0) sm.bc[1] = M, sm.bc[2] = L;
    }
    consumers_sync();
    const float M = sm.bc[1], L = sm.bc[2];
    for (int t = tid; t < n; t += kThreads) sm.scores[t] = round_bf16(expf(sm.scores[t] - M) / L);
    consumers_sync();
  }
  // P.V: rows groups of HD / 8 lanes, 8 columns a lane
  {
    float acc[8] = {};
    auto add = [&](int t, const uint4& raw) {
      float f[8];
      bf16x8(raw, f);
      const float pr = sm.scores[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(pr, f[j], acc[j]);
    };
#pragma unroll
    for (int j = 0; j < kEarly; ++j)
      if (rr + j * rows < n) add(rr + j * rows, ve[j]);
    for (int t = rr + kEarly * rows; t < n; t += rows)
      add(t, __ldg(reinterpret_cast<const uint4*>(vb + static_cast<long>(t0 + t) * HD + e * 8)));
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.red[rr * HD + e * 8 + j] = acc[j];
  }
  consumers_sync();
  if (tid < HD) {
    float s = 0.f;
    for (int g = 0; g < rows; ++g) s += sm.red[g * HD + tid];
    c.part[2 + tid] = s;
    if (!rb && tid == 0) c.part[0] = m, c.part[1] = l;
    __threadfence();
  }
  consumers_sync();
  if (tid == 0) sm.bc[3] = atomicAdd(c.done, 1) == c.target - 1 ? 1.f : 0.f;
  consumers_sync();
  if (sm.bc[3] == 0.f) return;
  // the last chunk of the head: merge
  __threadfence();
  if (warp == 0) {
    const float sf = sm.bc[0];
    const bool live = lane < c.split && __ldcg(c.head_part + lane * (HD + 2) + 1) > 0.f;
    const float mc = live ? __ldcg(c.head_part + lane * (HD + 2)) : -INFINITY;
    const float M = fmaxf(tpa::warp_max(mc), sf);
    const float wc = live ? expf(mc - M) : 0.f;
    const float L =
        tpa::warp_sum(live ? __ldcg(c.head_part + lane * (HD + 2) + 1) * wc : 0.f) +
        expf(sf - M);
    if (lane < c.split) sm.red[lane] = rb ? (live ? 1.f : 0.f) : wc / L;
    if (lane == 0) sm.bc[4] = expf(sf - M) / L;
  }
  consumers_sync();
  {  // kThreads / HD groups of HD threads, each a share of the chunks, all loads at once
    constexpr int groups = kThreads / HD;
    const int g = tid / HD, j = tid % HD;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplit / groups; ++k) {
      const int i = g + groups * k;
      if (i < c.split) s = fmaf(sm.red[i], __ldcg(c.head_part + i * (HD + 2) + 2 + j), s);
    }
    sm.red[kMaxSplit + g * HD + j] = s;
  }
  consumers_sync();
  if (tid < HD) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kThreads / HD; ++g) s += sm.red[kMaxSplit + g * HD + tid];
    out[tid] = fmaf(sm.bc[4], __ldcg(v + tid), s);
  }
}

// The bytes of the terms region for inputs of up to I elements.
template <typename W>
__host__ __device__ constexpr int terms_bytes(int I) {
  return Terms<W>::n * pitch_of<typename Terms<W>::T>(I);
}

template <typename W, int HD>
__global__ void __launch_bounds__(kBlockThreads, 1) fused_step_kernel(Params p) {
  const int D = p.D, H = p.H, KVH = p.KVH, hidden = p.hidden, split = p.split;
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x, NS = p.stages;
  const int HH = H * HD, QO = (H + 2 * KVH) * HD, GQ = H / KVH;
  const int imax = max(max(D, HH), hidden);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // kMaxStages
  uint64_t* empty = full + kMaxStages;                 // kMaxStages
  unsigned char* ring = smem + 256;
  unsigned char* terms = ring + static_cast<long>(NS) * p.stage_bytes;
  float* f = reinterpret_cast<float*>(terms + terms_bytes<W>(imax));
  AttnSmem sm;
  sm.scores = f;  // kv_rows
  sm.red = f + p.kv_rows;
  sm.qh = sm.red + kRed;
  sm.kh = sm.qh + HD;
  sm.tmp = sm.kh + HD;
  sm.scratch = sm.tmp + 2 * HD;
  sm.bc = sm.scratch + 32;
  float* wt = sm.bc + 8;   // 4: the terms' weights
  float* psum = wt + 8;    // kWarps x kRows: each warp's share of a product's row sums

  float* xg = p.work;                // residual (D)
  float* qkv = xg + D;               // raw qkv (QO)
  float* ao = qkv + QO;              // merged attention output (H hd)
  float* act = ao + HH;              // SwiGLU activation (hidden)
  float* part = act + hidden;        // H x split x (hd + 2)
  int* cnt = reinterpret_cast<int*>(part + H * split * (HD + 2));  // 1 + 2 H counters

  // the products' geometry
  const int chans[kProducts] = {QO, D, hidden, D};
  const int units[kProducts] = {1, 1, 2, 1};
  const int ins[kProducts] = {D, HH, D, hidden};

  // ---- set-up: barriers, counters, and the ring's first fill
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, kWarps);
    }
    hp::mbar_fence_init();
  }
  if (blk == 0)
    for (int i = tid; i < 1 + 2 * H; i += kBlockThreads) cnt[i] = 0;
  __syncthreads();

  // The producer: lane 0 of the last warp issues the block's slots of every
  // product of every layer in order, slot `it` into ring slot it % NS once
  // its previous use has been freed, a bulk copy a row; from `from` on, up
  // to `upto`. (An L2 prefetch of the slots one ring further measured
  // slower: its traffic queues the phases' own loads.)
  auto produce = [&](uint32_t from, uint32_t upto) {
    uint32_t it = 0;
    for (int l = 0; l < p.L; ++l)
      for (int k = 0; k < kProducts; ++k) {
        int lo;
        const int n = share(chans[k], blk, G, lo);
        const int row_bytes = ins[k] * static_cast<int>(sizeof(W)), pw = pitch_of<W>(ins[k]);
        const int per = slot_channels(n, p.per_slot[k]);
        for (int c = 0; c < n; c += per, ++it) {
          if (it < from) continue;
          if (it >= upto) return;
          const int slot = it % NS;
          if (it >= static_cast<uint32_t>(NS)) wait_slot(empty + slot, ((it / NS) - 1) & 1);
          const int m = min(per, n - c);
          hp::mbar_arrive_expect_tx(full + slot, static_cast<uint32_t>(units[k] * m * row_bytes));
          unsigned char* dst = ring + static_cast<long>(slot) * p.stage_bytes;
          for (int u = 0; u < units[k]; ++u)
            for (int j = 0; j < m; ++j) {
              const char* src = static_cast<const char*>(p.w[k]) +
                                ((static_cast<long>(l) * units[k] + u) * chans[k] + lo + c + j) *
                                    row_bytes;
              for (int o = 0; o < row_bytes; o += kPiece)
                hp::bulk_load(dst + (u * m + j) * pw + o, src + o,
                              static_cast<uint32_t>(min(kPiece, row_bytes - o)), full + slot);
            }
        }
      }
  };
  if (tid == kThreads) produce(0, NS);
  // the residual: this block's rows of it (those of its o and down shares)
  {
    int lo;
    const int n = share(D, blk, G, lo);
    for (int i = tid; i < n; i += kBlockThreads)
      xg[lo + i] = p.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[lo + i])
                            : static_cast<const float*>(p.x)[lo + i];
  }
  cg::this_grid().sync();
  if (tid >= kThreads) {
    if (tid == kThreads) produce(NS, 0xffffffffu);
    return;
  }

  // ---- the consumers
  const int pos = static_cast<int>(*p.pos);
  const int start = static_cast<int>(*p.start);
  const bool rb = p.x_bf16 != 0;
  const int head = blk / split, chunk = blk % split, kvh = head / GQ;
  const int n_hist = pos > start ? pos - start : 0;
  const int cs = (n_hist + split - 1) / split;
  const int t0 = start + min(n_hist, chunk * cs), t1 = start + min(n_hist, (chunk + 1) * cs);
  int barriers = 0;
  uint32_t it = 0;  // the ring's slot count, as the producer's
  // product k against the terms (made by the caller) into psum
  auto run_product = [&](int k, int n) {
    const int per = slot_channels(n, p.per_slot[k]);
    for (int c = 0; c < n; c += per, ++it) {
      const int slot = it % NS;
      slot_mma<W>(ring + static_cast<long>(slot) * p.stage_bytes, full + slot, empty + slot,
                  (it / NS) & 1, c, min(per, n - c), n, units[k], ins[k], terms, wt, psum);
    }
    consumers_sync();
  };
  auto sums = [&](int i) {  // row i of the product
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += psum[w * kRows + i];
    return s;
  };
  auto sync_grid = [&]() { grid_barrier(cnt, G * ++barriers); };

  for (int l = 0; l < p.L; ++l) {
    const long lD = static_cast<long>(l) * D;
    int lo, n;
    // P1: ln1 -> qkv, scale, bias
    n = share(QO, blk, G, lo);
    {
      const long o = static_cast<long>(l) * QO + lo + tid;
      const float sc = tid < n ? __ldg(p.s[P_QKV] + o) : 0.f;
      const float bi = tid < n && p.bqkv != nullptr ? __ldg(p.bqkv + o) : 0.f;
      // layer 0 reads the input itself
      const float* x = l > 0 ? xg : rb ? nullptr : static_cast<const float*>(p.x);
      const auto* xb = l == 0 && rb ? static_cast<const __nv_bfloat16*>(p.x) : nullptr;
      make_terms<W>(x, xb, p.ln1 + lD, D, p.eps, rb, terms, wt, sm.scratch);
      run_product(P_QKV, n);
      if (tid < n) qkv[lo + tid] = sums(tid) * sc + bi;
    }
    sync_grid();
    // P2: attention
    if (blk < H * split) {
      const long cb = (static_cast<long>(l) * KVH + kvh) * p.S * HD;
      const float* qn = p.qknorm != nullptr ? p.qknorm + l * 2 * HD : nullptr;
      Chunk c{part + (head * split + chunk) * (HD + 2), part + head * split * (HD + 2),
              cnt + 1 + head, cnt + 1 + H + head, (l + 1) * split, split};
      chunk_attention<HD>(qkv + head * HD, qkv + HH + kvh * HD, qkv + HH + KVH * HD + kvh * HD,
                          qn, qn != nullptr ? qn + HD : nullptr, p.cos, p.sin, p.eps, p.kc + cb,
                          p.vc + cb, t0, t1, pos, chunk == 0 && head % GQ == 0, rb, c,
                          ao + head * HD, sm);
    }
    sync_grid();
    // P3: o-projection + residual
    n = share(D, blk, G, lo);
    {
      const float sc = tid < n ? __ldg(p.s[P_O] + lD + lo + tid) : 0.f;
      const float xr = tid < n ? __ldcg(xg + lo + tid) : 0.f;
      make_terms<W>(ao, nullptr, nullptr, HH, p.eps, rb, terms, wt, sm.scratch);
      run_product(P_O, n);
      if (tid < n) xg[lo + tid] = xr + sums(tid) * sc;
    }
    sync_grid();
    // P4: ln2 -> gate, up -> silu(gate) * up
    n = share(hidden, blk, G, lo);
    {
      const long o = static_cast<long>(l) * 2 * hidden + lo + tid;
      const float sg = tid < n ? __ldg(p.s[P_GU] + o) : 0.f;
      const float su = tid < n ? __ldg(p.s[P_GU] + o + hidden) : 0.f;
      make_terms<W>(xg, nullptr, p.ln2 + lD, D, p.eps, rb, terms, wt, sm.scratch);
      run_product(P_GU, n);
      if (tid < n) {
        const float g = sums(tid) * sg, u = sums(n + tid) * su;
        act[lo + tid] = g / (1.f + expf(-g)) * u;
      }
    }
    sync_grid();
    // P5: down + residual
    n = share(D, blk, G, lo);
    {
      const float sc = tid < n ? __ldg(p.s[P_DOWN] + lD + lo + tid) : 0.f;
      const float xr = tid < n ? __ldcg(xg + lo + tid) : 0.f;
      make_terms<W>(act, nullptr, nullptr, hidden, p.eps, rb, terms, wt, sm.scratch);
      run_product(P_DOWN, n);
      if (tid < n) xg[lo + tid] = xr + sums(tid) * sc;
    }
    sync_grid();
  }
  if (blk == 0) final_norm(xg, p.norm, D, p.eps, p.h, sm.scratch);
}

template <typename W, int HD>
cudaError_t plan(Params& p, int& blocks, int& smem) {
  auto kernel = fused_step_kernel<W, HD>;
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  blocks = sms;
  p.split = blocks / p.H < kMaxSplit ? blocks / p.H : kMaxSplit;
  if (p.split < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int hh = p.H * HD, qo = (p.H + 2 * p.KVH) * HD;
  const int chans[kProducts] = {qo, p.D, p.hidden, p.D};
  const int units[kProducts] = {1, 1, 2, 1};
  const int ins[kProducts] = {p.D, hh, p.D, p.hidden};
  for (int k = 0; k < kProducts; ++k) {
    p.per_slot[k] = kSlotBytes / (units[k] * pitch_of<W>(ins[k]));
    if (units[k] * p.per_slot[k] > 64) p.per_slot[k] = 64 / units[k];  // four tiles at most
    // every block's channels fit the epilogue's threads
    if (p.per_slot[k] < 1 || (chans[k] + blocks - 1) / blocks > kThreads)
      return cudaErrorInvalidValue;
  }
  p.stage_bytes = kSlotBytes;
  p.kv_rows = (p.S + p.split - 1) / p.split;
  const int imax = p.D > hh ? (p.D > p.hidden ? p.D : p.hidden) : (hh > p.hidden ? hh : p.hidden);
  const long fixed = 256 + terms_bytes<W>(imax) +
                     (p.kv_rows + kRed + 4 * HD + 32 + 8 + 8 + kWarps * kRows) *
                         static_cast<long>(sizeof(float));
  int optin = 0;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  p.stages = static_cast<int>((optin - fixed) / kSlotBytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2) return cudaErrorInvalidValue;
  smem = static_cast<int>(fixed + static_cast<long>(p.stages) * kSlotBytes);
  if ((err = tpa::allow_smem(kernel, smem)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kBlockThreads, smem)) !=
      cudaSuccess)
    return err;
  return fit >= 1 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

template <int N>
struct HeadDim {
  static constexpr int value = N;
};

template <typename F>
cudaError_t dispatch(int w_int8, int hd, F f) {
  if (hd == 128) return w_int8 ? f(int8_t{}, HeadDim<128>{}) : f(__nv_bfloat16{}, HeadDim<128>{});
  return w_int8 ? f(int8_t{}, HeadDim<64>{}) : f(__nv_bfloat16{}, HeadDim<64>{});
}

template <typename W, int HD>
cudaError_t launch(Params& p, int work_floats, cudaStream_t stream) {
  int blocks = 0, smem = 0;
  cudaError_t err = plan<W, HD>(p, blocks, smem);
  if (err != cudaSuccess) return err;
  const int need = p.D + (p.H + 2 * p.KVH) * HD + p.H * HD + p.hidden +
                   p.H * p.split * (HD + 2) + 1 + 2 * p.H;
  if (work_floats < need) return cudaErrorInvalidValue;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_step_kernel<W, HD>),
                                    blocks, kBlockThreads, args, static_cast<size_t>(smem), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The shapes the step takes: a product's input a whole number of 32-byte
// k-steps, and at most kMaxIn values a thread.
bool supported(int w_int8, int D, int hidden, int H, int KVH, int hd) {
  const int step = w_int8 ? 32 : 16;
  const int imax = D > H * hd ? (D > hidden ? D : hidden) : (H * hd > hidden ? H * hd : hidden);
  return H % KVH == 0 && D % step == 0 && hidden % step == 0 && (hd == 64 || hd == 128) &&
         imax <= kMaxIn * kThreads;
}

}  // namespace

// See Params for the layouts. w_int8: weights int8 (else bf16); the cache is
// bf16; hd 64 or 128. The caller checks shapes and dtypes.
extern "C" int tpa_fused_step(const void* x, int x_bf16, const long long* pos,
                              const long long* start, const float* cos, const float* sin,
                              const void* wqkv, const float* sqkv, const float* bqkv,
                              const float* qknorm, const void* wo, const float* so,
                              const void* wgu, const float* sgu, const void* wd, const float* sd,
                              const float* ln1, const float* ln2, const float* norm, void* kc,
                              void* vc, float* h, float* work, int work_floats, float eps,
                              int w_int8, int L, int D, int hidden, int H, int KVH, int hd, int S,
                              cudaStream_t stream) {
  if (!supported(w_int8, D, hidden, H, KVH, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x, p.x_bf16 = x_bf16, p.pos = pos, p.start = start, p.cos = cos, p.sin = sin;
  p.w[P_QKV] = wqkv, p.w[P_O] = wo, p.w[P_GU] = wgu, p.w[P_DOWN] = wd;
  p.s[P_QKV] = sqkv, p.s[P_O] = so, p.s[P_GU] = sgu, p.s[P_DOWN] = sd;
  p.bqkv = bqkv, p.qknorm = qknorm, p.ln1 = ln1, p.ln2 = ln2, p.norm = norm;
  p.kc = static_cast<__nv_bfloat16*>(kc), p.vc = static_cast<__nv_bfloat16*>(vc);
  p.h = h, p.work = work, p.eps = eps;
  p.L = L, p.D = D, p.hidden = hidden, p.H = H, p.KVH = KVH, p.S = S;
  return static_cast<int>(dispatch(w_int8, hd, [&](auto w, auto d) {
    return launch<decltype(w), decltype(d)::value>(p, work_floats, stream);
  }));
}

// The launch's shape for these sizes, without launching: out[0] blocks,
// out[1] key chunks a head, out[2] weight-ring slots, out[3] bytes a slot,
// out[4] shared memory bytes of a block.
extern "C" int tpa_fused_step_plan(int w_int8, int D, int hidden, int H, int KVH, int hd, int S,
                                   int* out, cudaStream_t /*unused*/) {
  if (!supported(w_int8, D, hidden, H, KVH, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.D = D, p.hidden = hidden, p.H = H, p.KVH = KVH, p.S = S;
  int blocks = 0, smem = 0;
  const cudaError_t err = dispatch(w_int8, hd, [&](auto w, auto d) {
    return plan<decltype(w), decltype(d)::value>(p, blocks, smem);
  });
  out[0] = blocks, out[1] = p.split, out[2] = p.stages, out[3] = p.stage_bytes, out[4] = smem;
  return static_cast<int>(err);
}
