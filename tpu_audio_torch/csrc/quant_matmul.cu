// Group-affine q4/q8 dequant-matmul at <= 32 rows: y = x . (q * s + b)^T in
// f32, q unpacked from 32-bit words low bits first, s and b per group of 64
// columns (the MLX checkpoint format).
//
// Replaces tpu_audio/ops/pallas/quant_matmul.py:quant_matmul.
//
// Bound on the H100: device-memory bytes. Each weight is used once per
// activation row, far below the ~295 op/byte ridge: the Qwen3-0.6B tied lm
// head streams 151936 x 1024 nibbles plus two f32 per group, 97.2 MB per
// call; a decoder layer's linear 0.5-3.3 MB, which the card can hold in
// flight at once, so there the call's fixed costs are the time.
// (tools/quant_split.py splits the call's time on the card.)
//
// Design. One launch per call at any 1-32 rows; each weight byte is read
// once.
//  - Work. A tile is 16 output channels (the m16 of mma.sync); a span,
//    what a stage holds, is 1, 2, 4 or 8 tiles over a slice of the
//    columns: S slices of whole groups (S = 1 unless the activations'
//    terms, below, would not fit in shared memory beside the rest), the S
//    blocks of a span's slices one cluster. A cluster walks spans c,
//    c + clusters, ...; the grid is as many clusters as the card holds at
//    once. At a layer's shapes a span is one tile and the 8 consumer warps
//    split its groups (few tiles: each block's chain short); at a head's,
//    2-8 tiles (as many as leave a block 4 spans or more and 2 stages),
//    8 / tiles warps a tile, so a span's barriers and sums are paid once
//    for several tiles.
//  - Weights. A producer warp streams each span's codes (one
//    cp.async.bulk a channel row, rows padded against bank conflicts) and
//    its scales and biases (bulk copies, or cp.async where not 16-byte
//    aligned) into a ring of up to 4 stages under "full" and "empty"
//    mbarriers. It issues them before anything waits on the activations:
//    the kernel launches as a programmatic dependent of the kernel before
//    it, and only the consumer warps run griddepcontrol.wait, then read x.
//    A block lets the next kernel launch once its x is staged.
//  - Activations, in their own dtype (f32 or bf16, widened exactly): each
//    block writes its slice of every row to shared memory as exact bf16
//    terms (bf16 x: itself; f32 x: hi + mid + lo, each the bf16 rounding of
//    what the terms before it leave, which sum to x up to ~2^-24 |x|), in
//    the order the weights' planes take them, and each group's f32 sum.
//  - Products. The codes go to the tensor cores as a wide dot, not for
//    their rate: mma.sync m16n8k16 bf16 with f32 sums, 16 channels as A,
//    the (row, term) columns as B. A code becomes a bf16 operand by a
//    mask and an OR (two at once: 0x4300 | q is 128 + q) and one exact
//    bf16x2 FMA to q - 8 (q4), or, for q8's bytes, to the low nibble l and
//    16 (h - 8) of the high one (q - 128 = 16 (h - 8) + l). The
//    centred codes are exact, their products with the terms exact, and
//    each group's affine folds in as s * sum x (q - c) + (b + c s) * sum x.
//    Every lane loads at any shape; the sums of a tile's warps meet in
//    shared memory in a fixed order, the terms of a row are summed there,
//    and the S slices of a span meet in the cluster's rank 0 through DSMEM.
//  - A wait on a stage that never ends (a fault) traps after ~4 s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = tpa::hopper;

constexpr int kWarps = 8, kConsumers = 32 * kWarps;  // the warps of the products
constexpr int kThreads = kConsumers + 32;             // and one producer warp
constexpr int kBar = 1;                               // the consumers' named barrier
constexpr int kTile = 16;                             // output channels of a tile
constexpr int kGroup = 64;
constexpr int kMaxStages = 4;
constexpr int kBatch = 4;                             // x's units a thread loads at once
constexpr int kRedPitch = 16;                         // floats of a column of the warps' sums
constexpr int kSmemSM = 233472, kSmemBlock = 232448, kReserve = 1024;  // bytes (H100)
constexpr long long kHangCycles = 8000000000ll;       // ~4 s

// A launch's layout, computed once on the host. Byte offsets into a
// block's dynamic shared memory.
struct Plan {
  int B, O, G, tiles;
  int tps, spans;   // 16-channel tiles a stage (a span), and spans
  int S, gs;        // slices, and groups of the largest
  int nc, nt;       // B operand columns (row, term), and their 8-column tiles
  int ws;           // bytes from one channel's codes to the next in a stage
  int sc_off, bi_off, stage_bytes;  // a stage: codes, scales, biases
  int xp;           // bytes from one term column to the next
  int off_x, off_xsum, off_red, off_slot, off_stage, stages, smem;
  long ldx;         // elements from one row of x to the next
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hp::smem_addr(dst)), "l"(src)
               : "memory");
}
// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(hp::smem_addr(bar))
               : "memory");
}

// Until the mbarrier's phase of this parity has completed; traps after ~4 s.
__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity) {
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
    const long long now = clock64();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > kHangCycles)
      __trap();
  }
}

// D (16 x 8, f32) += A (16 x 16, bf16, rows) * B (16 x 8, bf16, columns)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lop3_or(uint32_t a, uint32_t mask, uint32_t magic) {
  uint32_t d;  // (a & mask) | magic
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(magic));
  return d;
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// The two nibbles at bits 0-3 and 16-19 of w as bf16 (128 + n) each, exact.
__device__ __forceinline__ uint32_t nib2(uint32_t w) {
  return lop3_or(w, 0x000F000Fu, 0x43004300u);
}
constexpr uint32_t kOne = 0x3F803F80u, kSixteen = 0x41804180u;  // bf16x2 1, 16
// bf16x2 -136, -128, -2176
constexpr uint32_t kM136 = 0xC308C308u, kM128 = 0xC300C300u, kM2176 = 0xC508C508u;
// q4: q - 8 of the nibbles at bits 0-3 and 16-19.
__device__ __forceinline__ uint32_t q4_pair(uint32_t w) { return fma_bf16x2(nib2(w), kOne, kM136); }
// q8: the low nibbles l, and 16 (h - 8) of the high ones, of bytes 0 and 2.
__device__ __forceinline__ uint32_t q8_lo(uint32_t w) { return fma_bf16x2(nib2(w), kOne, kM128); }
__device__ __forceinline__ uint32_t q8_hi(uint32_t w) {
  return fma_bf16x2(nib2(w >> 4), kSixteen, kM2176);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 columns of x as f32 (bf16 widened exactly).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The block's slice of every row of x as its bf16 terms, in 8-column
// units (unit k of row b: columns 8k.. of the slice, in the order the
// weights' planes take them), and each group's f32 sum. A thread loads K
// units at once. The consumers.
template <int BITS, typename T, int K>
__device__ __forceinline__ void stage_terms(const T* __restrict__ x, const Plan& pl, int g0,
                                            int gs, unsigned char* xt, float* xsum) {
  constexpr int TERMS = std::is_same<T, float>::value ? 3 : 1;
  const int lane = threadIdx.x & 31, units = 8 * gs, total = pl.B * units;
  for (int u0 = threadIdx.x; u0 < total; u0 += K * kConsumers) {
    float v[K][8];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int u = u0 + q * kConsumers, b = u / units, k = u - b * units;
      if (u < total) load8(x + b * pl.ldx + static_cast<long>(g0) * kGroup + 8 * k, v[q]);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int u = u0 + q * kConsumers, b = u / units, k = u - b * units;
      if (u >= total) break;  // the 8 lanes of a group leave together
      constexpr int p4[8] = {0, 4, 1, 5, 2, 6, 3, 7}, p8[8] = {0, 2, 1, 3, 4, 6, 5, 7};
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = v[q][BITS == 4 ? p4[i] : p8[i]];
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[i] = pack2(r[2 * i], r[2 * i + 1]);
          if (term + 1 < TERMS) {  // what this term leaves, exactly
            r[2 * i] -= __uint_as_float(h[i] << 16);
            r[2 * i + 1] -= __uint_as_float(h[i] & 0xFFFF0000u);
          }
        }
        *reinterpret_cast<uint4*>(xt + (b * TERMS + term) * pl.xp + 16 * k) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
      // the group's sum: its 8 units are 8 neighbouring lanes
      float f = ((v[q][0] + v[q][1]) + (v[q][2] + v[q][3])) +
                ((v[q][4] + v[q][5]) + (v[q][6] + v[q][7]));
      const unsigned mask = 0xFFu << (lane & 24);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) f += __shfl_xor_sync(mask, f, o);
      if ((lane & 7) == 0) xsum[b * pl.gs + k / 8] = f;
    }
  }
}

// BITS 4 or 8; T the activations' dtype; NTM the most 8-column tiles of B;
// WIDE: spans of more than one tile. Warps 0-7 compute (the consumers);
// warp 8 issues the stages (the producer). A stage holds a span of tps
// 16-channel tiles; kw = 8 / tps warps share a tile, warp w taking tile
// w / kw of the span and its groups w % kw, w % kw + kw, ... (kw a
// constant 8 when not WIDE: a runtime stride cost a layer's call ~0.3 us).
template <int BITS, typename T, int NTM, bool WIDE>
__global__ void __launch_bounds__(kThreads, NTM > 4 || (BITS == 8 && NTM > 1) ? 1 : 2)
quant_mm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ biases,
                float* __restrict__ out, const Plan pl) {
  constexpr int TERMS = std::is_same<T, float>::value ? 3 : 1;  // bf16 terms of an x value
  constexpr int bpg = BITS * kGroup / 8;  // bytes of a group of one channel's codes
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage has landed
  uint64_t* empty = full + kMaxStages;                  // the consumers are done with it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = pl.S, rank = static_cast<int>(blockIdx.x) % S;
  const int cl = static_cast<int>(blockIdx.x) / S, clusters = static_cast<int>(gridDim.x) / S;
  const int items = (pl.spans - 1 - cl) / clusters + 1;  // spans cl, cl + clusters, ...
  const int g0 = rank * pl.G / S, gs = (rank + 1) * pl.G / S - g0;  // this block's groups
  const int span = kTile * pl.tps;                        // channels of a stage
  const long row_bytes = static_cast<long>(pl.G) * bpg;

  if (S > 1) hp::cluster_arrive();  // this block runs; peers wait for it before storing into it
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      hp::mbar_init(full + s, 1 + 32);  // lane 0's expected bytes, each lane's cp.async
      hp::mbar_init(empty + s, kWarps);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // item j's span into stage j % stages
    const bool whole = S == 1 && ((reinterpret_cast<uintptr_t>(scales) |
                                   reinterpret_cast<uintptr_t>(biases)) & 15) == 0;
    auto issue = [&](int j) {
      const int s = j % pl.stages;
      const long c0 = static_cast<long>(cl + j * clusters) * span;  // the span's first channel
      const int n = pl.O - c0 < span ? static_cast<int>(pl.O - c0) : span;
      if (j >= pl.stages) wait_bar(empty + s, (j / pl.stages - 1) & 1);
      unsigned char* st = smem + pl.off_stage + s * pl.stage_bytes;
      const int bulk = whole ? (4 * n * pl.G) & ~15 : 0;
      if (lane == 0) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(w) + c0 * row_bytes +
                                   static_cast<long>(g0) * bpg;
        hp::mbar_arrive_expect_tx(full + s, static_cast<uint32_t>(n * gs * bpg + 2 * bulk));
        for (int r = 0; r < n; ++r)
          hp::bulk_load(st + r * pl.ws, src + r * row_bytes, gs * bpg, full + s);
        if (bulk > 0) {
          hp::bulk_load(st + pl.sc_off, scales + c0 * pl.G, bulk, full + s);
          hp::bulk_load(st + pl.bi_off, biases + c0 * pl.G, bulk, full + s);
        }
      }
      for (int e = bulk / 4 + lane; e < n * gs; e += 32) {
        const int r = e / gs, k = e - r * gs;
        const long src = (c0 + r) * pl.G + g0 + k;
        cp_async4(st + pl.sc_off + 4 * (r * pl.gs + k), scales + src);
        cp_async4(st + pl.bi_off + 4 * (r * pl.gs + k), biases + src);
      }
      cp_async_arrive(full + s);
    };
    const int first = min(pl.stages, items);
    for (int j = 0; j < first; ++j) issue(j);
    if (S > 1) hp::cluster_wait();
    for (int j = 0; j + pl.stages < items; ++j) {
      if (S > 1) {  // span j's merge, which the consumers reach before stage j's reuse
        hp::cluster_arrive();
        hp::cluster_wait();
      }
      issue(j + pl.stages);
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int kw = WIDE ? kWarps / pl.tps : kWarps, tau = warp / kw;  // this warp's tile
  unsigned char* xt = smem + pl.off_x;
  float* xsum = reinterpret_cast<float*>(smem + pl.off_xsum);
  float* red = reinterpret_cast<float*>(smem + pl.off_red);
  float* slot = reinterpret_cast<float*>(smem + pl.off_slot);

  // This block's slice of every row as terms (see stage_terms), a unit a
  // thread at one pass, kBatch units at once beyond.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (pl.B * 8 * gs <= kConsumers)
    stage_terms<BITS, T, 1>(x, pl, g0, gs, xt, xsum);
  else
    stage_terms<BITS, T, kBatch>(x, pl, g0, gs, xt, xsum);
  hp::named_barrier(kBar, kConsumers);
  // the next kernel may start its own stream now: launched at the start, its
  // blocks' copies competed with this one's staging (fc2 1 row: 6.9 -> 5.2 us)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  constexpr float off = BITS == 4 ? 8.f : 128.f;  // the codes' centre
  for (int j = 0; j < items; ++j) {
    const int s = j % pl.stages;
    const int c0 = (cl + j * clusters) * span;
    wait_bar(full + s, (j / pl.stages) & 1);
    const unsigned char* st = smem + pl.off_stage + s * pl.stage_bytes;
    const unsigned char* wr = st + (kTile * tau + g) * pl.ws;  // channel row g of the tile
    const float* sc = reinterpret_cast<const float*>(st + pl.sc_off) + (kTile * tau + g) * pl.gs;
    const float* bi = reinterpret_cast<const float*>(st + pl.bi_off) + (kTile * tau + g) * pl.gs;

    float acc[NTM][4];
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

    for (int grp = warp % kw; grp < gs; grp += kw) {
      // this lane's codes of channels g and g + 8: q4 words 2t, 2t + 1 of
      // the group, q8 words 4t .. 4t + 3
      uint32_t wa[BITS / 2], wb[BITS / 2];
      if constexpr (BITS == 4) {
        const uint2 a = *reinterpret_cast<const uint2*>(wr + bpg * grp + 8 * t);
        const uint2 c = *reinterpret_cast<const uint2*>(wr + 8 * pl.ws + bpg * grp + 8 * t);
        wa[0] = a.x, wa[1] = a.y, wb[0] = c.x, wb[1] = c.y;
      } else {
        const uint4 a = *reinterpret_cast<const uint4*>(wr + bpg * grp + 16 * t);
        const uint4 c = *reinterpret_cast<const uint4*>(wr + 8 * pl.ws + bpg * grp + 16 * t);
        wa[0] = a.x, wa[1] = a.y, wa[2] = a.z, wa[3] = a.w;
        wb[0] = c.x, wb[1] = c.y, wb[2] = c.z, wb[3] = c.w;
      }
      const float s0 = sc[grp], s1 = sc[8 * pl.gs + grp];
      const float b0 = fmaf(off, s0, bi[grp]), b1 = fmaf(off, s1, bi[8 * pl.gs + grp]);
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) {
        if (nt >= pl.nt) break;
        const int col = 8 * nt + g;  // this lane's column of B
        uint4 xa = make_uint4(0, 0, 0, 0), xb = xa;
        if (col < pl.nc) {
          const unsigned char* xc = xt + col * pl.xp + 128 * grp + 32 * t;
          xa = *reinterpret_cast<const uint4*>(xc);
          xb = *reinterpret_cast<const uint4*>(xc + 16);
        }
        // two chains of k-steps, summed after
        float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (BITS == 4) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint4 xu = u == 0 ? xa : xb;
            mma_bf16(d, q4_pair(wa[u]), q4_pair(wb[u]), q4_pair(wa[u] >> 4), q4_pair(wb[u] >> 4),
                     xu.x, xu.y);
            mma_bf16(e, q4_pair(wa[u] >> 8), q4_pair(wb[u] >> 8), q4_pair(wa[u] >> 12),
                     q4_pair(wb[u] >> 12), xu.z, xu.w);
          }
        } else {
          const uint32_t xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int m = 0; m < BITS / 2; ++m) {
            mma_bf16(d, q8_lo(wa[m]), q8_lo(wb[m]), q8_hi(wa[m]), q8_hi(wb[m]), xs[2 * m],
                     xs[2 * m]);
            mma_bf16(e, q8_lo(wa[m] >> 8), q8_lo(wb[m] >> 8), q8_hi(wa[m] >> 8),
                     q8_hi(wb[m] >> 8), xs[2 * m + 1], xs[2 * m + 1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * nt + 2 * t + (i & 1);  // the accumulator's column
          float a = fmaf(i < 2 ? s0 : s1, d[i] + e[i], acc[nt][i]);
          if (c % TERMS == 0 && c < pl.nc)  // a row's first term carries the group's bias
            a = fmaf(i < 2 ? b0 : b1, xsum[(c / TERMS) * pl.gs + grp], a);
          acc[nt][i] = a;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + s);  // this warp is done with stage s

    // the warps' sums, [warp][column][channel], the channel's bit 3 flipped
    // on odd column pairs (bank conflicts)
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      if (nt >= pl.nt) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * nt + 2 * t + (i & 1), ch = (g + (i < 2 ? 0 : 8)) ^ (((c >> 1) & 1) << 3);
        red[(warp * 8 * pl.nt + c) * kRedPitch + ch] = acc[nt][i];
      }
    }
    hp::named_barrier(kBar, kConsumers);
    if (S > 1 && j == 0) hp::cluster_wait();  // every block of the cluster runs
    // output (row b, channel ch of tile ta): the sum over the tile's warps
    // and the row's terms
    const int outs = span * pl.B;
    float* sl = slot + (j & 1) * S * outs;
    for (int o = threadIdx.x; o < outs; o += kConsumers) {
      // one tile a span: no runtime division
      const int ta = WIDE ? o / (kTile * pl.B) : 0, b = WIDE ? o / kTile % pl.B : o / kTile;
      const int ch = o & (kTile - 1);
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k >= kw) break;
        const int v = ta * kw + k;
#pragma unroll
        for (int term = 0; term < TERMS; ++term) {
          const int c = b * TERMS + term;
          y += red[(v * 8 * pl.nt + c) * kRedPitch + (ch ^ (((c >> 1) & 1) << 3))];
        }
      }
      const int oc = c0 + kTile * ta + ch;
      if (S == 1) {
        if (oc < pl.O) out[static_cast<long>(b) * pl.O + oc] = y;
      } else {
        hp::st_peer(sl + rank * outs + o, 0, y);
      }
    }
    if (S > 1) {  // the slices of the span meet in rank 0
      hp::cluster_arrive();
      hp::cluster_wait();
      if (rank == 0)
        for (int o = threadIdx.x; o < outs; o += kConsumers) {
          const int ta = WIDE ? o / (kTile * pl.B) : 0, b = WIDE ? o / kTile % pl.B : o / kTile;
          const int ch = o & (kTile - 1);
          float y = 0.f;
          for (int r = 0; r < S; ++r) y += sl[r * outs + o];
          const int oc = c0 + kTile * ta + ch;
          if (oc < pl.O) out[static_cast<long>(b) * pl.O + oc] = y;
        }
    } else {
      hp::named_barrier(kBar, kConsumers);  // red is written again by the next span
    }
  }
}

int round16(long v) { return static_cast<int>((v + 15) / 16 * 16); }

int ntm_of(int nt) { return nt <= 1 ? 1 : nt <= 4 ? 4 : 12; }

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// The shared memory of a block at S slices and spans of tps tiles, all but
// the stages; sets the offsets and the stage's layout.
int layout(Plan& pl, int bits, int S, int tps) {
  const int bpg = bits * kGroup / 8, span = kTile * tps;
  pl.S = S;
  pl.tps = tps;
  pl.spans = (pl.tiles + tps - 1) / tps;
  pl.gs = (pl.G + S - 1) / S;
  const int rb = pl.gs * bpg, want = bits == 4 ? 32 : 64;  // rows g, g + 1.. in other banks
  pl.ws = rb + ((want - rb % 128) + 128) % 128;
  pl.sc_off = span * pl.ws;
  pl.bi_off = pl.sc_off + round16(4L * span * pl.gs);
  pl.stage_bytes = pl.bi_off + round16(4L * span * pl.gs);
  pl.xp = 128 * pl.gs + 16;  // columns 16 mod 128 bytes apart: no bank conflicts
  int off = 16 * kMaxStages;
  pl.off_x = off;
  off += round16(static_cast<long>(pl.nc) * pl.xp);
  pl.off_xsum = off;
  off += round16(4L * pl.B * pl.gs);
  pl.off_red = off;
  off += 4 * kWarps * 8 * pl.nt * kRedPitch;
  pl.off_slot = off;
  off += S > 1 ? 2 * 4 * S * span * pl.B : 0;
  pl.off_stage = off;
  return off;
}

// The opt-in of an instantiation to a block's whole shared memory, once (a
// launch takes what its plan needs).
template <int BITS, typename T, int NTM, bool WIDE>
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = quant_mm_kernel<BITS, T, NTM, WIDE>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = tpa::allow_smem(kernel, kSmemBlock - static_cast<int>(attr.sharedSizeBytes));
  done = err == cudaSuccess;
  return err;
}

template <int BITS, typename T, int NTM, bool WIDE>
cudaError_t max_clusters(const Plan& pl, int& clusters) {
  // the clusters of S blocks the card holds at once, by the occupancy
  // calculator, kept per (S, shared memory) of this instantiation
  static int cache[8][3] = {};
  for (auto& c : cache)
    if (c[0] == pl.S && c[1] == pl.smem) {
      clusters = c[2];
      return cudaSuccess;
    }
  auto kernel = quant_mm_kernel<BITS, T, NTM, WIDE>;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.S * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  for (auto& c : cache)
    if (c[0] == 0) {
      c[0] = pl.S, c[1] = pl.smem, c[2] = clusters;
      break;
    }
  return cudaSuccess;
}

// The launch of a call: the fewest slices (1, 2, 4, 8) at which a block
// holds its terms, the warps' sums and one stage; at one slice and up to
// 4 B operand tiles (32 bf16 rows, 10 f32), spans of
// as many tiles (8, 4, 2, 1) as leave each block 4 spans or more (the
// heads: one span's barriers and sums cost a tile's, so a warp takes a
// whole tile) and two stages fit; two blocks an SM where they fit (and the sums are small
// enough for the registers of two), then as many stages (up to 4) as fit
// and as a block has spans.
bool make_plan(Plan& pl, int B, int I, int O, int bits, bool bf16, int& per_sm) {
  pl.B = B, pl.O = O, pl.G = I / kGroup;
  pl.tiles = (O + kTile - 1) / kTile;
  pl.nc = B * (bf16 ? 1 : 3);
  pl.nt = (pl.nc + 7) / 8;
  const int n_sm = sm_count();
  if (n_sm < 1) return false;
  for (int S = 1; S <= 8 && S <= pl.G; S *= 2)
    for (int tps = S == 1 && ntm_of(pl.nt) <= 4 ? 8 : 1; tps >= 1; tps /= 2) {
      const int fixed = layout(pl, bits, S, tps);
      const int two = kSmemSM / 2 - kReserve;
      // two blocks an SM hold 96 registers a thread: q8 spills there above
      // one B tile, f32 x above 4 (the kernel's launch bounds)
      per_sm = S == 1 && ntm_of(pl.nt) <= (bits == 8 ? 1 : 4) && fixed + pl.stage_bytes <= two
                   ? 2 : 1;
      const int budget = per_sm == 2 ? two : kSmemBlock;
      int stages = (budget - fixed) / pl.stage_bytes;
      if (stages < 1) continue;
      // S > 1: about one block an SM (the occupancy calculator sets it at launch)
      const int cap = S == 1 ? per_sm * n_sm : n_sm / S;
      if (tps > 1 && (pl.spans < 4 * cap || stages < 2)) continue;
      const int clusters = pl.spans < cap ? pl.spans : cap;
      const int items = (pl.spans + clusters - 1) / clusters;
      stages = stages < kMaxStages ? stages : kMaxStages;
      pl.stages = stages < items ? stages : items;
      pl.smem = pl.off_stage + pl.stages * pl.stage_bytes;
      return true;
    }
  return false;
}

template <int BITS, typename T, int NTM, bool WIDE>
cudaError_t launch(const void* x, const uint32_t* w, const float* scales, const float* biases,
                   float* out, Plan pl, int per_sm, cudaStream_t stream) {
  auto kernel = quant_mm_kernel<BITS, T, NTM, WIDE>;
  const cudaError_t opted = opt_in<BITS, T, NTM, WIDE>();
  if (opted != cudaSuccess) return opted;
  int clusters = per_sm * sm_count();
  if (pl.S > 1) {
    const cudaError_t err = max_clusters<BITS, T, NTM, WIDE>(pl, clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  if (clusters > pl.spans) clusters = pl.spans;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = pl.S;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.S * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = pl.S > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), w, scales, biases, out, pl);
}

template <int BITS, typename T>
cudaError_t dispatch(const void* x, const uint32_t* w, const float* s, const float* b,
                     float* out, const Plan& pl, int per_sm, cudaStream_t stream) {
  const bool wide = pl.tps > 1;  // only where NTM <= 4 (make_plan)
  switch (ntm_of(pl.nt)) {
    case 1:
      return wide ? launch<BITS, T, 1, true>(x, w, s, b, out, pl, per_sm, stream)
                  : launch<BITS, T, 1, false>(x, w, s, b, out, pl, per_sm, stream);
    case 4:
      return wide ? launch<BITS, T, 4, true>(x, w, s, b, out, pl, per_sm, stream)
                  : launch<BITS, T, 4, false>(x, w, s, b, out, pl, per_sm, stream);
    default: return launch<BITS, T, 12, false>(x, w, s, b, out, pl, per_sm, stream);
  }
}

}  // namespace

// The launch a call of these sizes takes, without launching: out[0..6] =
// slices, blocks an SM, stages, shared memory bytes of a block, B
// operand tiles, channel tiles, tiles a span. Returns 0, or an error if no
// plan fits.
extern "C" int tpa_quant_matmul_plan(int B, int I, int O, int bits, int x_bf16, int* out,
                                     cudaStream_t /*unused*/) {
  if (B < 1 || B > 32 || I <= 0 || O <= 0 || I % kGroup || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int per_sm = 0;
  if (!make_plan(pl, B, I, O, bits, x_bf16 != 0, per_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = pl.S, out[1] = per_sm, out[2] = pl.stages, out[3] = pl.smem, out[4] = pl.nt,
  out[5] = pl.tiles, out[6] = pl.tps;
  return 0;
}

// x (B, I) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), rows ldx elements apart,
// 16-byte aligned; w (O, I * bits / 32) packed words, 16-byte aligned;
// scales, biases (O, I / 64) f32; out (B, O) f32. bits 4 or 8, 1 <= B <= 32,
// I % 64 == 0. One launch.
extern "C" int tpa_quant_matmul(const void* x, int x_bf16, long ldx, const uint32_t* w,
                                const float* scales, const float* biases, float* out, int B,
                                int I, int O, int bits, cudaStream_t stream) {
  if (B < 1 || B > 32 || I <= 0 || O <= 0 || I % kGroup || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long esize = x_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      (ldx * esize) % 16 || reinterpret_cast<uintptr_t>(scales) % 4 ||
      reinterpret_cast<uintptr_t>(biases) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Plan pl;
  int per_sm = 0;
  if (!make_plan(pl, B, I, O, bits, x_bf16 != 0, per_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  pl.ldx = ldx;
  cudaError_t err;
  if (bits == 4)
    err = x_bf16 ? dispatch<4, __nv_bfloat16>(x, w, scales, biases, out, pl, per_sm, stream)
                 : dispatch<4, float>(x, w, scales, biases, out, pl, per_sm, stream);
  else
    err = x_bf16 ? dispatch<8, __nv_bfloat16>(x, w, scales, biases, out, pl, per_sm, stream)
                 : dispatch<8, float>(x, w, scales, biases, out, pl, per_sm, stream);
  return static_cast<int>(err);
}
