// W4A8 decode matmuls at <= 32 rows: group-affine int4 weights x per-row
// int8 activations, exact int32 dots per group, f32 only in the epilogue.
//
// Replaces tpu_audio/ops/pallas/w4a8_matmul.py:w4a8_matmul,
// :w4a8_matmul_stacked, :w4a8_sg_matmul and :w4a8_sg_matmul_stacked. One
// entry point serves the four: `sg` picks the format, the layer index
// offsets the weight pointer into an (L, O, I/2) tensor.
//
// Formats (see ops/kernels/w4a8_matmul.py): byte 64p+j of a packed row
// holds column 128p+j in its low nibble and column 128p+64+j in its high
// nibble.
//   pair:  low = q (group 2p), high = (h - 8) mod 16 (group 2p+1), q, h in
//          [0, 16), f32 scale s and bias b per group of 64:
//          y = sx * sum_g s[o,g] (xq.q)_g + sum_g b[o,g] sum_{i in g} x_i.
//   sg:    low = c + 8, high = c, c in [-8, 7], one f32 scale S per 256
//          columns: y = sx * sum_s S[o,s] (xq.c)_s.
//
// Bound on the H100: device-memory bytes. Each weight byte is used once per
// activation row, far below the ~295 op/byte ridge; a Llama-3.2-3B layer's
// gateup (16384 x 3072) streams 25.2 MB of codes and 6.3 MB of group scales
// and biases per call, 9.4 us at 3.35 TB/s.
//
// Design: a block owns tiles of 16 output channels (the m16 of mma.sync)
// over all I, tile blockIdx.x, blockIdx.x + gridDim.x, ... (the grid is as
// many blocks as the card holds at once, so no block waits for a wave).
// A producer warp streams the tiles into a ring in shared memory, each
// stage under a "full" and an "empty" mbarrier: the codes by bulk copies
// (cp.async.bulk, one per channel row, rows padded so that rows g and g + 1
// sit in other banks), the scales (and biases) by one bulk copy each (by
// cp.async, 4 bytes a lane, where they are not 16-byte aligned). Where a
// tile over all I does not fit in shared memory, a stage holds a chunk of
// its 128-column pairs (a multiple of 8), the chunks in order. It fills
// every stage at once and refills a stage as soon as the 8 consumer warps
// release it; it never waits on the activations, and they never wait
// on its copies being issued (an issuing thread stalls while the memory
// system is full, which held the whole block when the consumers issued).
// It starts once the consumers' first loads of x are out, so those are not
// queued behind the card-wide flood of weight bytes.
// At one row (the decode of one stream) the call is one launch: every block
// quantises the row itself into shared memory (s = max|x| / 127 with floor
// 1e-10, q = clip(rint(x / s), -127, 127), round half to even as
// torch.round; every block computes the same codes, the max does not depend
// on order) with, for the pair layout, each group's f32 sum of x. Above one
// row that would read all of x once a block (256 KB at 8 rows of 8192 f32),
// so a rows kernel (one block a row) writes the codes, scales and sums once,
// and the products run as its programmatic dependents: they start, stream
// their weights, then wait (griddepcontrol.wait) and copy the codes (B x I
// bytes), 8 rows a pass (fewer where 8 rows of codes do not fit), the passes
// inside the products' launch.
// The products are mma.sync m16n8k32 s8 with s32 sums, exact: 16 channels as
// A, 8 activation rows as B. The 8 warps split a tile's 128-column pairs
// (warp w takes pairs w, w + 8, ...), so every lane of every warp loads at
// any I; lane (g, t) reads 16 contiguous bytes of channel rows g and g + 8
// and of its activation row g, bytes 16t.. of the pair: the k order is
// permuted alike on both sides, which a dot does not see. The nibble planes
// become valid s8 operands by masks alone: pair low = w & 0x0F, high = its
// nibble with bit 3 flipped (the stored (h - 8) mod 16 back to h), so both
// groups are exact dots of the codes; super-group low and high as the bytes
// 16 c (the low nibble's bit 3 flipped and moved up), both planes summed in
// one accumulator and >> 4 exactly. A warp applies its groups' scales (and
// the pair layout's biases against the group sums) in f32, the 8 warps' sums
// meet in shared memory in a fixed order, and one store per output leaves.
// Channel rows past O are never copied, so any O works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = tpa::hopper;

constexpr int kWarps = 8, kConsumers = 32 * kWarps;  // the warps of the products
constexpr int kThreads = kConsumers + 32;             // and one producer warp
constexpr int kBarConsumers = 1, kBarIssue = 2;       // named barriers
constexpr int kTile = 16;      // output channels of a tile
constexpr int kRows = 8;       // activation rows of the mma's B operand
constexpr int kHold = 8;       // float4 of x a thread holds: 8192 columns a block
constexpr int kMaxStages = 2;  // more only delays each stage's last byte
constexpr int kSmemSM = 233472, kSmemBlock = 232448, kReserve = 1024;  // bytes (H100)
constexpr unsigned kFull = 0xffffffffu;

// Where everything sits in a block's dynamic shared memory (byte offsets),
// computed once on the host.
struct Plan {
  int B, I, O, tiles;
  int rows;          // activation rows a pass (<= kRows)
  int chunk, chunks; // 128-column pairs a stage, stages a tile
  int stages;        // chunks in flight
  int ws;            // bytes from one channel's codes to the next in a stage
  int gs;            // scales (and biases) from one channel to the next in a stage
  int stage_bytes;   // a chunk's codes, then its scales (and biases)
  int scale_off, bias_off;  // where the scales (and biases) start in a stage
  int red_bytes;
  int off_codes, off_xsum, off_sx, off_red, off_stage, smem;
};

// The rows kernel's output, read by the products of a call of more than one row.
struct Rows {
  const int8_t* xq;    // (B, I) codes
  const float* sx;     // (B) row scales
  const float* xsum;   // (B, I / 64) the groups' f32 sums of x (pair layout)
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

// D (16 x 8, s32) += A (16 x 32, s8, rows) * B (32 x 8, s8, columns)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The nibble planes of four packed bytes as four s8 operands.
__device__ __forceinline__ uint32_t pair_lo(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t pair_hi(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t sg_lo16(uint32_t w) {
  return ((w ^ 0x08080808u) << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t sg_hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f))) & 255u;
}

// The max over 256 threads (a rows kernel's block, or the products' consumer
// warps) through a named barrier; every one gets it.
__device__ __forceinline__ float group_max(float v, float* scratch) {
  v = tpa::warp_max(v);
  hp::named_barrier(kBarConsumers, kConsumers);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  hp::named_barrier(kBarConsumers, kConsumers);
  return tpa::warp_max((threadIdx.x & 31) < kWarps ? scratch[threadIdx.x & 31] : 0.f);
}

// One row x[0, I) by 256 threads (a rows kernel's block, or the products'
// consumer warps, which then signal the producer warp once their loads of x
// are out): its int8 codes as words (column 4i in word i), for the pair
// layout each group's f32 sum of x, and its scale, returned. Warp w takes
// the row's 128-column pairs w, w + 8, ..., lane l columns 4l.. of each. A
// row of up to 8192 columns is loaded at once and held in registers for
// both sweeps; the batches of a longer one are loaded again for the codes.
template <bool SG, bool kInProducts, typename T>
__device__ float quantise_row(const T* __restrict__ x, int I, uint32_t* codes, float* xsum,
                              float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, P = I / 128;
  constexpr int kBatch = kWarps * kHold;  // pairs of a batch
  float4 v[kHold];
  auto load = [&](int p0) {
#pragma unroll
    for (int k = 0; k < kHold; ++k)
      if (p0 + k * kWarps < P) v[k] = load4(x + 128 * (p0 + k * kWarps) + 4 * lane);
  };
  auto absmax = [&](int p0, float m) {
#pragma unroll
    for (int k = 0; k < kHold; ++k)
      if (p0 + k * kWarps < P)
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)), fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
    return m;
  };
  auto encode = [&](int p0, float s) {
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      const int p = p0 + k * kWarps;
      if (p < P) {
        codes[32 * p + lane] =
            code(v[k].x, s) | code(v[k].y, s) << 8 | code(v[k].z, s) << 16 | code(v[k].w, s) << 24;
        if (!SG) {  // lanes 0-15 hold group 2p, lanes 16-31 group 2p + 1
          float f = (v[k].x + v[k].y) + (v[k].z + v[k].w);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) f += __shfl_xor_sync(kFull, f, o);
          if ((lane & 15) == 0) xsum[2 * p + (lane >> 4)] = f;
        }
      }
    }
  };
  float m = 0.f;
  for (int p0 = warp + kBatch; p0 < P; p0 += kBatch) {  // past the first batch
    load(p0);
    m = absmax(p0, m);
  }
  load(warp);
  if (kInProducts) asm volatile("bar.arrive %0, %1;\n" ::"n"(kBarIssue), "n"(kThreads) : "memory");
  const float s = fmaxf(group_max(absmax(warp, m), scratch) / 127.0f, 1e-10f);
  encode(warp, s);
  for (int p0 = warp + kBatch; p0 < P; p0 += kBatch) {
    load(p0);
    encode(p0, s);
  }
  return s;
}

// A call of more than one row: one block a row writes its codes, scale and
// group sums for the products, which are launched as its programmatic
// dependents and stream their weights meanwhile.
template <bool SG, typename T>
__global__ void __launch_bounds__(kConsumers)
w4a8_rows_kernel(const T* __restrict__ x, int I, int8_t* xq, float* sx, float* xsum) {
  __shared__ float scratch[kWarps];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long b = blockIdx.x;
  const float s = quantise_row<SG, false>(x + b * I, I, reinterpret_cast<uint32_t*>(xq + b * I),
                                          xsum + b * (I / 64), scratch);
  if (threadIdx.x == 0) sx[b] = s;
}

// kPDL = false: one row, quantised by every block itself from x.
// kPDL = true: rows r0.. of the rows kernel's output, read once it is done.
// Warps 0-7 compute (the consumers); warp 8 issues the tiles (the producer).
// Item j of a block: chunk j % chunks of its tile j / chunks % my_tiles, in
// row pass j / (chunks my_tiles).
template <bool SG, bool kPDL, typename T>
__global__ void __launch_bounds__(kThreads, 2)
w4a8_kernel(const T* __restrict__ x, const Rows rows, const int8_t* __restrict__ w,
            const float* __restrict__ scales, const float* __restrict__ biases,
            float* __restrict__ out, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's chunk has landed
  uint64_t* empty = full + kMaxStages;                  // the consumers are done with it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int I = pl.I, P = I / 128, G = I / 64, row_bytes = I / 2, GS = SG ? I / 256 : G;
  const int xs = G + 2, cs = I + 64, chunks = pl.chunks;
  const int my_tiles = (pl.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int per_pass = my_tiles * chunks;
  const int items = per_pass * ((pl.B + pl.rows - 1) / pl.rows);
  auto tile_of = [&](int j) {
    return static_cast<int>(blockIdx.x + (j / chunks % my_tiles) * gridDim.x);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      hp::mbar_init(full + s, 1 + 32);  // lane 0's expected bytes, each lane's cp.async
      hp::mbar_init(empty + s, kWarps);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  // item j's chunk into stage j % stages (the producer warp)
  auto issue = [&](int j) {
    const int s = j % pl.stages, tile = tile_of(j), n = min(kTile, pl.O - tile * kTile);
    const int p0 = j % chunks * pl.chunk, np = min(pl.chunk, P - p0);
    const int ng = SG ? np / 2 : 2 * np, g0 = SG ? p0 / 2 : 2 * p0;  // the chunk's groups
    if (j >= pl.stages) hp::mbar_wait(empty + s, (j / pl.stages - 1) & 1);
    unsigned char* st = smem + pl.off_stage + s * pl.stage_bytes;
    const long c0 = static_cast<long>(tile) * kTile;  // the tile's first channel
    // a whole tile's scales (and biases) are contiguous: bulk copies where
    // aligned, the rest, or all, by cp.async
    const bool whole = chunks == 1 && ((reinterpret_cast<uintptr_t>(scales) |
                                        reinterpret_cast<uintptr_t>(biases)) & 15) == 0;
    const int bulk = whole ? (4 * n * ng) & ~15 : 0;
    if (lane == 0) {
      const int8_t* src = w + c0 * row_bytes + 64 * p0;
      hp::mbar_arrive_expect_tx(full + s, static_cast<uint32_t>(n * 64 * np + (SG ? 1 : 2) * bulk));
      for (int r = 0; r < n; ++r)
        hp::bulk_load(st + r * pl.ws, src + static_cast<long>(r) * row_bytes, 64 * np, full + s);
      if (bulk > 0) {
        hp::bulk_load(st + pl.scale_off, scales + c0 * GS, bulk, full + s);
        if (!SG) hp::bulk_load(st + pl.bias_off, biases + c0 * GS, bulk, full + s);
      }
    }
    for (int e = bulk / 4 + lane; e < n * ng; e += 32) {
      const int r = e / ng, k = e - r * ng;
      const long src = (c0 + r) * GS + g0 + k;
      cp_async4(st + pl.scale_off + 4 * (r * pl.gs + k), scales + src);
      if (!SG) cp_async4(st + pl.bias_off + 4 * (r * pl.gs + k), biases + src);
    }
    cp_async_arrive(full + s);
  };
  if (warp == kWarps) {
    // one row: once the consumers' first loads of x are out; more rows: the
    // first tile during the rows kernel, the rest once the codes are staged
    if (kPDL) issue(0);
    hp::named_barrier(kBarIssue, kThreads);
    for (int j = kPDL ? 1 : 0; j < items; ++j) issue(j);
    return;
  }

  unsigned char* codes = smem + pl.off_codes;
  float* xsum = reinterpret_cast<float*>(smem + pl.off_xsum);
  float* sx = reinterpret_cast<float*>(smem + pl.off_sx);
  // rows r0.. of this pass into shared memory
  auto stage_rows = [&](int r0, int nr) {
    if (kPDL) {
      for (int e = threadIdx.x; e < nr * (I / 16); e += kConsumers) {
        const int b = e / (I / 16), c = e - b * (I / 16);
        *reinterpret_cast<int4*>(codes + b * cs + 16 * c) =
            __ldcg(reinterpret_cast<const int4*>(rows.xq + static_cast<long>(r0 + b) * I) + c);
      }
      for (int e = threadIdx.x; e < nr; e += kConsumers) sx[e] = __ldcg(rows.sx + r0 + e);
      if (!SG)
        for (int e = threadIdx.x; e < nr * G; e += kConsumers)
          xsum[e / G * xs + e % G] = __ldcg(rows.xsum + static_cast<long>(r0) * G + e);
    } else {
      const float s = quantise_row<SG, true>(x, I, reinterpret_cast<uint32_t*>(codes), xsum,
                                             reinterpret_cast<float*>(smem + pl.off_red));
      if (threadIdx.x == 0) sx[0] = s;
    }
  };

  if (kPDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage_rows(0, min(pl.rows, pl.B));
  if (kPDL) asm volatile("bar.arrive %0, %1;\n" ::"n"(kBarIssue), "n"(kThreads) : "memory");
  hp::named_barrier(kBarConsumers, kConsumers);

  const int ra = 2 * t;  // the accumulator's rows ra, ra + 1
  float acc[4], bac[4];
  for (int j = 0; j < items; ++j) {
    const int r0 = j / per_pass * pl.rows, nr = min(pl.rows, pl.B - r0);
    if (kPDL && j % per_pass == 0 && j > 0) {  // the next row pass
      stage_rows(r0, nr);
      hp::named_barrier(kBarConsumers, kConsumers);
    }
    const int s = j % pl.stages, c = j % chunks, p0 = c * pl.chunk, p1 = min(P, p0 + pl.chunk);
    hp::mbar_wait(full + s, (j / pl.stages) & 1);
    const unsigned char* wt = smem + pl.off_stage + s * pl.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(wt + pl.scale_off);
    const float* bc = reinterpret_cast<const float*>(wt + pl.bias_off);
    const int gc = SG ? p0 / 2 : 2 * p0;  // the chunk's first group

    if (c == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = bac[i] = 0.f;
#pragma unroll 2
    for (int p = p0 + warp; p < p1; p += kWarps) {
      const int q = 64 * (p - p0) + 16 * t;
      const int4 wa = *reinterpret_cast<const int4*>(wt + g * pl.ws + q);
      const int4 wb = *reinterpret_cast<const int4*>(wt + (g + 8) * pl.ws + q);
      int4 xl = make_int4(0, 0, 0, 0), xh = xl;  // this lane's activation row g of the B operand
      if (g < nr) {
        xl = *reinterpret_cast<const int4*>(codes + g * cs + 128 * p + 16 * t);
        xh = *reinterpret_cast<const int4*>(codes + g * cs + 128 * p + 64 + 16 * t);
      }
      if (SG) {
        int d[4] = {0, 0, 0, 0};
        mma_s8(d, sg_lo16(wa.x), sg_lo16(wb.x), sg_lo16(wa.y), sg_lo16(wb.y), xl.x, xl.y);
        mma_s8(d, sg_lo16(wa.z), sg_lo16(wb.z), sg_lo16(wa.w), sg_lo16(wb.w), xl.z, xl.w);
        mma_s8(d, sg_hi16(wa.x), sg_hi16(wb.x), sg_hi16(wa.y), sg_hi16(wb.y), xh.x, xh.y);
        mma_s8(d, sg_hi16(wa.z), sg_hi16(wb.z), sg_hi16(wa.w), sg_hi16(wb.w), xh.z, xh.w);
        const int k = (p >> 1) - gc;
        const float s0 = sc[g * pl.gs + k], s1 = sc[(g + 8) * pl.gs + k];
        acc[0] = fmaf(s0, static_cast<float>(d[0] >> 4), acc[0]);
        acc[1] = fmaf(s0, static_cast<float>(d[1] >> 4), acc[1]);
        acc[2] = fmaf(s1, static_cast<float>(d[2] >> 4), acc[2]);
        acc[3] = fmaf(s1, static_cast<float>(d[3] >> 4), acc[3]);
      } else {
        int dl[4] = {0, 0, 0, 0}, dh[4] = {0, 0, 0, 0};
        mma_s8(dl, pair_lo(wa.x), pair_lo(wb.x), pair_lo(wa.y), pair_lo(wb.y), xl.x, xl.y);
        mma_s8(dl, pair_lo(wa.z), pair_lo(wb.z), pair_lo(wa.w), pair_lo(wb.w), xl.z, xl.w);
        mma_s8(dh, pair_hi(wa.x), pair_hi(wb.x), pair_hi(wa.y), pair_hi(wb.y), xh.x, xh.y);
        mma_s8(dh, pair_hi(wa.z), pair_hi(wb.z), pair_hi(wa.w), pair_hi(wb.w), xh.z, xh.w);
        const int k = 2 * p - gc;
        const float2 s0 = *reinterpret_cast<const float2*>(sc + g * pl.gs + k);
        const float2 s1 = *reinterpret_cast<const float2*>(sc + (g + 8) * pl.gs + k);
        const float2 b0 = *reinterpret_cast<const float2*>(bc + g * pl.gs + k);
        const float2 b1 = *reinterpret_cast<const float2*>(bc + (g + 8) * pl.gs + k);
        const float2 f0 = *reinterpret_cast<const float2*>(xsum + ra * xs + 2 * p);
        const float2 f1 = *reinterpret_cast<const float2*>(xsum + (ra + 1) * xs + 2 * p);
        acc[0] = fmaf(s0.x, static_cast<float>(dl[0]), fmaf(s0.y, static_cast<float>(dh[0]), acc[0]));
        acc[1] = fmaf(s0.x, static_cast<float>(dl[1]), fmaf(s0.y, static_cast<float>(dh[1]), acc[1]));
        acc[2] = fmaf(s1.x, static_cast<float>(dl[2]), fmaf(s1.y, static_cast<float>(dh[2]), acc[2]));
        acc[3] = fmaf(s1.x, static_cast<float>(dl[3]), fmaf(s1.y, static_cast<float>(dh[3]), acc[3]));
        bac[0] = fmaf(b0.x, f0.x, fmaf(b0.y, f0.y, bac[0]));
        bac[1] = fmaf(b0.x, f1.x, fmaf(b0.y, f1.y, bac[1]));
        bac[2] = fmaf(b1.x, f0.x, fmaf(b1.y, f0.y, bac[2]));
        bac[3] = fmaf(b1.x, f1.x, fmaf(b1.y, f1.y, bac[3]));
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + s);  // this warp is done with stage s
    if (c < chunks - 1) continue;
    // this warp's share of the tile, [warp][row][channel], buffer (tile count) % 2
    float* red = reinterpret_cast<float*>(smem + pl.off_red + (j / chunks & 1) * pl.red_bytes);
    float* rw = red + (warp * kRows + ra) * kTile;
    rw[g] = fmaf(acc[0], sx[ra], bac[0]);
    rw[kTile + g] = fmaf(acc[1], sx[ra + 1], bac[1]);
    rw[g + 8] = fmaf(acc[2], sx[ra], bac[2]);
    rw[kTile + g + 8] = fmaf(acc[3], sx[ra + 1], bac[3]);
    hp::named_barrier(kBarConsumers, kConsumers);
    const int o0 = tile_of(j) * kTile;
    for (int e = threadIdx.x; e < nr * kTile; e += kConsumers) {
      const int r = e / kTile, cc = e % kTile;
      if (o0 + cc < pl.O) {
        float y = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) y += red[(v * kRows + r) * kTile + cc];
        out[static_cast<long>(r0 + r) * pl.O + o0 + cc] = y;
      }
    }
  }
}

int round16(long v) { return static_cast<int>((v + 15) / 16 * 16); }

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

// A stage of `chunk` pairs: its codes (rows padded to 64 mod 128 bytes, so
// that rows g and g + 1 sit in other banks), then its scales (and biases).
void set_chunk(Plan& pl, bool sg, int chunk) {
  pl.chunk = chunk;
  pl.chunks = (pl.I / 128 + chunk - 1) / chunk;
  pl.ws = 64 * chunk + ((64 * chunk) % 128 == 64 ? 0 : 64);
  pl.gs = sg ? chunk / 2 : 2 * chunk;
  pl.scale_off = kTile * pl.ws;
  pl.bias_off = pl.scale_off + round16(4L * kTile * pl.gs);
  pl.stage_bytes = sg ? pl.bias_off : pl.bias_off + round16(4L * kTile * pl.gs);
}

// The layout at `rows` rows a pass, or false if not even a stage of 8 pairs
// fits. Whole tiles (all I in a stage) where they fit: two blocks an SM
// where two stages (or, with no more than two tiles an SM, one) fit beside
// the rest; else one block with up to kMaxStages. Else one block an SM with
// two stages of as many pairs as fit, a multiple of 8, so that warp w still
// sums pairs w, w + 8, ... in order.
bool fit(Plan& pl, bool sg, int rows, int n_sm, int& per_sm, int& stages) {
  const int P = pl.I / 128, G = pl.I / 64;
  pl.rows = rows;
  int off = 16 * kMaxStages;  // the stages' two mbarriers each
  pl.off_codes = off;
  off += round16(static_cast<long>(rows) * (pl.I + 64));
  pl.off_xsum = off;
  off += sg ? 0 : round16(4L * kRows * (G + 2));
  pl.off_sx = off;
  off += round16(4L * kRows);
  pl.off_red = off;
  off += 2 * pl.red_bytes;
  pl.off_stage = off;
  set_chunk(pl, sg, P);
  per_sm = 2;
  stages = (kSmemSM / 2 - kReserve - off) / pl.stage_bytes;
  if (stages >= 2 || (stages >= 1 && pl.tiles <= 2 * n_sm)) return true;
  per_sm = 1;
  stages = (kSmemBlock - off) / pl.stage_bytes;
  if (stages >= 1) return true;
  for (int chunk = P / 8 * 8; chunk >= 8; chunk -= 8) {
    set_chunk(pl, sg, chunk);
    if (2 * pl.stage_bytes <= kSmemBlock - off) {
      stages = 2;
      return true;
    }
  }
  return false;
}

// The layout of a call: 8 rows a pass (B where fewer), fewer where 8 rows of
// codes leave no room for a stage of 8 pairs; false if one row leaves none.
bool make_plan(Plan& pl, bool sg, int B, int I, int O, int n_sm, int& grid) {
  pl.B = B;
  pl.I = I;
  pl.O = O;
  pl.tiles = (O + kTile - 1) / kTile;
  pl.red_bytes = 4 * kWarps * kRows * kTile;
  int per_sm = 0, stages = 0, rows = B < kRows ? B : kRows;
  while (!fit(pl, sg, rows, n_sm, per_sm, stages))
    if (--rows < 1) return false;
  grid = pl.tiles < per_sm * n_sm ? pl.tiles : per_sm * n_sm;
  const int items = (pl.tiles + grid - 1) / grid * pl.chunks * ((B + rows - 1) / rows);
  stages = stages < kMaxStages ? stages : kMaxStages;
  pl.stages = stages < items ? stages : items;
  pl.smem = pl.off_stage + pl.stages * pl.stage_bytes;
  return true;
}

template <bool SG, bool kPDL, typename T>
cudaError_t launch(const void* x, const Rows& rows, const int8_t* w, const float* scales,
                   const float* biases, float* out, const Plan& pl, int grid,
                   cudaStream_t stream) {
  auto kernel = w4a8_kernel<SG, kPDL, T>;
  static int granted = 0;  // the opt-in this instantiation already has
  if (pl.smem > granted) {
    const cudaError_t err = tpa::allow_smem(kernel, pl.smem);
    if (err != cudaSuccess) return err;
    granted = pl.smem;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kPDL ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), rows, w, scales, biases,
                            out, pl);
}

template <bool SG, typename T>
cudaError_t dispatch(const void* x, unsigned char* work, const int8_t* w, const float* scales,
                     const float* biases, float* out, int B, int I, int O,
                     cudaStream_t stream) {
  const int n_sm = sm_count();
  if (n_sm < 1) return cudaErrorNoDevice;
  Plan pl;
  int grid = 0;
  if (!make_plan(pl, SG, B, I, O, n_sm, grid)) return cudaErrorInvalidValue;  // I too large
  if (B == 1) return launch<SG, false, T>(x, Rows{}, w, scales, biases, out, pl, grid, stream);
  if (work == nullptr) return cudaErrorInvalidValue;
  const Rows rows{reinterpret_cast<int8_t*>(work), reinterpret_cast<float*>(work + B * I),
                  reinterpret_cast<float*>(work + B * I + round16(4L * B))};
  w4a8_rows_kernel<SG><<<B, kConsumers, 0, stream>>>(
      static_cast<const T*>(x), I, const_cast<int8_t*>(rows.xq), const_cast<float*>(rows.sx),
      const_cast<float*>(rows.xsum));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<SG, true, T>(x, rows, w, scales, biases, out, pl, grid, stream);
}

}  // namespace

// Bytes of the workspace a call of B rows of I columns needs (0 at B = 1).
extern "C" long tpa_w4a8_work_bytes(int B, int I) {
  return B == 1 ? 0 : static_cast<long>(B) * I + round16(4L * B) + 4L * B * (I / 64);
}

// x (B, I) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (L, O, I/2) int8
// packed, layer `layer` is read; sg = 0: scales, biases (O, I/64) f32; sg =
// 1: scales (O, I/256) f32, biases unused (scales and biases 4-byte
// aligned: a layer's view of stacked ones may start at any float); work:
// tpa_w4a8_work_bytes(B, I) bytes, 16-byte aligned (unused at B = 1); out
// (B, O) f32. 1 <= B <= 32, I % 128 == 0 (I % 256 == 0 for sg), I up to
// about 130,000 (one row of codes beside two stages of 8 pairs).
extern "C" int tpa_w4a8_matmul(const void* x, int x_bf16, const int8_t* w, const float* scales,
                               const float* biases, int sg, void* work, float* out, int B, int I,
                               int O, int layer, cudaStream_t stream) {
  if (B < 1 || B > 32 || I <= 0 || O <= 0 || I % (sg ? 256 : 128) || (!sg && biases == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  w += static_cast<long>(layer) * O * (I / 2);
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(x) % (x_bf16 ? 8 : 16) ||
      reinterpret_cast<uintptr_t>(work) % 16 || reinterpret_cast<uintptr_t>(scales) % 4 ||
      reinterpret_cast<uintptr_t>(biases) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  unsigned char* wk = static_cast<unsigned char*>(work);
  cudaError_t err;
  if (sg)
    err = x_bf16 ? dispatch<true, __nv_bfloat16>(x, wk, w, scales, nullptr, out, B, I, O, stream)
                 : dispatch<true, float>(x, wk, w, scales, nullptr, out, B, I, O, stream);
  else
    err = x_bf16 ? dispatch<false, __nv_bfloat16>(x, wk, w, scales, biases, out, B, I, O, stream)
                 : dispatch<false, float>(x, wk, w, scales, biases, out, B, I, O, stream);
  return static_cast<int>(err);
}
