// W8A8 weight-streaming matmul at <= 32 rows: per-row int8 activations x
// per-output-channel int8 weights, exact int32 sums, x row scale x channel
// scale; in f32, or cast to bf16, optionally plus a bias.
//
// Replaces tpu_audio/ops/pallas/int8_matmul.py:int8_matmul and
// tpu_audio/ops/pallas/int8_matmul.py:int8_matmul_stacked. One entry point
// serves both: the stacked form passes the layer index, which offsets the
// weight pointer into the (L, O, I) tensor.
//
// Bound on the H100: device-memory bytes. Each weight byte is used once per
// activation row (<= 32 times), far below the ~295 op/byte ridge; the lm
// head at large-v3-turbo streams 51866 x 1280 = 66.4 MB per call, a decoder
// layer's linear 1.6-6.6 MB, which the card holds in flight at once, so
// there the call's fixed costs are the time.
// (tools/int8_split.py splits the call's time on the card.)
//
// Design. One launch per call at any 1-32 rows, and no workspace.
//  - Work. A tile is 16 output channels (the m16 of mma.sync). The columns
//    are cut into 64-column chunks and may be split over C blocks (C = 1,
//    2, 4 or 8, chosen by the caller: ops/kernels/int8_matmul.py:plan;
//    more than 1 only where one block would code too much of x), rank r of
//    a cluster of C taking chunks [r n / C, (r + 1) n / C). Cluster c walks
//    tiles c, c + clusters, ... (its items); the grid is as many clusters
//    as the card holds at once, a block an SM.
//  - Weights. A producer warp streams each item's slice, one cp.async.bulk
//    a channel row (rows padded against bank conflicts; a head's whole tile
//    in one copy at <= 8 rows; first to leave L2), into a ring of stages
//    under "full" and "empty" mbarriers. It issues
//    them before anything waits on the activations: the kernel launches as
//    a programmatic dependent of the kernel before it, and only the 16
//    consumer warps run griddepcontrol.wait. Before it they also fetch
//    their items' channel scales and biases, which no kernel before writes.
//  - Rows, quantised in the kernel. The consumers read the block's columns
//    of every row of x in its dtype and take each row's |max| over them (a
//    segmented max over a warp's lanes, then one shared-memory atomic a row
//    on the bits: |x| >= 0 orders as its bits); with C > 1 each rank stores
//    its partial maxima into every rank of the cluster (DSMEM) and, one
//    cluster barrier later, every block holds each row's max, which does
//    not depend on the order. Then s = max / 127 (floor 1e-10) and q =
//    clip(rint(x / s), -127, 127), round half to even as torch.round, from
//    the IEEE quotient wherever it decides q (codes8; the build has no
//    fast-math): the plain version's codes, bit for bit. The block keeps its
//    columns' codes in shared memory, zero past its slice, and lets the
//    next kernel launch.
//  - Products. mma.sync m16n8k32 s8 with s32 sums, 16 channels as A, 8 rows
//    of codes as B, the weights' bytes as they are. Lane (g, t) reads 16
//    bytes at 16t of a 64-byte chunk of channel rows g and g + 8 and of code
//    row g; the k order is permuted alike on both sides, which a dot does
//    not see. A block with few items (a layer's shapes) has its 16 warps
//    split each item's chunks and meet in shared memory; one with many
//    (WIDE: the heads) gives each warp whole items, those of its own stage
//    (so a parity wait never meets a stage's next phase), stored from its
//    registers. The sums are exact, so any split merges exactly: with C > 1
//    a block sends its sums of item j to the item's owner (rank j % C)
//    through DSMEM, and after one cluster barrier each owner adds the C
//    slices' sums of its items (in any order: they are integers).
//  - Epilogue. y = (float(acc) * sx[b]) * s[o], the plain version's order,
//    written as f32 (plus the bias widened to f32, if any) or cast once to
//    bf16, then plus the bias cast to bf16 with one rounding, as
//    ops/quant.int8_linear does. Channels past O are never copied nor
//    stored, rows past B never read nor stored.
//  - A wait on a stage that never ends (a fault) traps after ~4 s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = tpa::hopper;

constexpr int kWarps = 16, kConsumers = 32 * kWarps;  // the warps of the products
constexpr int kThreads = kConsumers + 32;             // and one producer warp
constexpr int kBar = 1;                               // the consumers' named barrier
constexpr int kTile = 16;                             // output channels of a tile
constexpr int kChunk = 64;                            // columns a lane's 16 bytes span
constexpr int kMaxRows = 32, kMaxSlices = 8;
constexpr int kMaxStages = 16;
constexpr int kSmemBlock = 232448;  // bytes a block may hold (H100)
constexpr long long kHangCycles = 8000000000ll;                         // ~4 s
constexpr unsigned kAll = 0xffffffffu;

// A launch's layout, computed once on the host. Byte offsets into a
// block's dynamic shared memory.
struct Plan {
  int B, I, O, tiles;
  int C;             // slices of the columns: the blocks of a cluster
  int nch;           // 64-column chunks of a row
  int rs;            // bytes from one code row to the next
  int ws;            // bytes from one staged channel row to the next
  int stages, stage_bytes;
  int wide;          // a warp takes whole items
  int esc_items;     // items a block's epilogue scales and biases hold
  int off_rmax, off_pmax, off_sx, off_esc, off_codes, off_red, off_slot, off_stage, smem;
  int out_bf16;      // the output in bf16 (else f32)
  int bias_kind;     // 0 none, 1 f32, 2 bf16
};

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

// Store v at the same shared-memory offset as `p` in block `rank` of the cluster.
__device__ __forceinline__ void st_peer_s32(int* p, uint32_t rank, int v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hp::smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(remote), "r"(v) : "memory");
}

// An L2 policy that marks lines first to leave.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
// hopper.cuh's bulk_load with an L2 policy for the bytes read.
__device__ __forceinline__ void bulk_load_once(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(hp::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hp::smem_addr(bar)), "l"(policy)
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

// 8 columns of x, read through L2 (x was written by the kernel before): f32
// as two float4, bf16 packed in a uint4. A thread holds `hold` of them
// between the two sweeps: 16-48 registers (fewer where B <= 8, NT = 1: a
// shorter unrolled batch is quicker there).
struct F32Unit {
  float4 a, b;
};
template <typename T, int NT> struct UnitOf;
template <int NT> struct UnitOf<float, NT> {
  using type = F32Unit;
  static constexpr int hold = NT == 1 ? 2 : 6;
};
template <int NT> struct UnitOf<__nv_bfloat16, NT> {
  using type = uint4;
  static constexpr int hold = NT == 1 ? 4 : 8;
};
__device__ __forceinline__ F32Unit load_unit(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldcg(q), __ldcg(q + 1)};
}
__device__ __forceinline__ uint4 load_unit(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void widen(const F32Unit& u, float (&v)[8]) {
  v[0] = u.a.x, v[1] = u.a.y, v[2] = u.a.z, v[3] = u.a.w;
  v[4] = u.b.x, v[5] = u.b.y, v[6] = u.b.z, v[7] = u.b.w;
}
__device__ __forceinline__ void widen(const uint4& u, float (&v)[8]) {  // exact
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <typename U>
__device__ __forceinline__ float absmax8(const U& u) {
  float v[8];
  widen(u, v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[i]));
  return m;
}

// The 8 codes of a unit at row scale s, r = 1 / s correctly rounded:
// clip(rint(v / s), -127, 127), column 8k + i in byte i. The IEEE quotient
// Z only where it can matter: with |v / s| < 128, t = v r is within 1.9e-5
// of Z (2^-24 relative from r, from the product, and Z's own rounding), so
// rint(t) = rint(Z) unless t lies within 2^-15 of a half-integer; a unit
// with such a value (rare) divides those. t is clipped (|t| exceeds 127 by
// 1e-5 at most) and rounded to an integer by adding 1.5 * 2^23, which
// leaves the code in the float's low byte.
template <typename U>
__device__ __forceinline__ uint2 codes8(const U& u, float s, float r) {
  constexpr float kMagic = 12582912.f, kTie = 0.5f - 3.0517578125e-05f;
  float v[8], m[8];
  widen(u, v);
  bool tie = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = __fmul_rn(v[i], r);
    m[i] = __fadd_rn(fminf(fmaxf(t, -127.f), 127.f), kMagic);
    tie |= fabsf(__fsub_rn(t, __fsub_rn(m[i], kMagic))) > kTie;
  }
  if (tie)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = __fmul_rn(v[i], r);
      if (fabsf(__fsub_rn(t, __fsub_rn(m[i], kMagic))) > kTie)
        m[i] = __fadd_rn(fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f), kMagic);
    }
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = __float_as_uint(m[i]) & 255u;
  return make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                    b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
}

__device__ __forceinline__ float bias_at(const void* bias, int kind, long o) {
  return kind == 2 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o])
                   : static_cast<const float*>(bias)[o];
}

// T the activations' dtype; NT the most 8-row tiles of B (B <= 8 NT); WIDE:
// a warp takes whole items (C = 1, many items a block), else the 16 warps
// split each item's chunks. Warps 0-15 compute (the consumers); warp 16
// issues the stages (the producer). Item j of a block is tile
// cl + j clusters over the block's slice, in stage j % stages.
template <typename T, int NT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const void* __restrict__ bias,
               void* __restrict__ out, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage has landed
  uint64_t* empty = full + kMaxStages;                  // its consumers are done with it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int C = pl.C, B = pl.B, rank = static_cast<int>(blockIdx.x) % C;
  const int cl = static_cast<int>(blockIdx.x) / C, clusters = static_cast<int>(gridDim.x) / C;
  const int items = (pl.tiles - 1 - cl) / clusters + 1;  // tiles cl, cl + clusters, ...
  const int c0 = rank * pl.nch / C, nc = (rank + 1) * pl.nch / C - c0;  // this block's chunks
  const int k0 = kChunk * c0, kb = min(pl.I, kChunk * (c0 + nc)) - k0;  // and columns
  unsigned* rmax = reinterpret_cast<unsigned*>(smem + pl.off_rmax);  // rows' |max| bits
  auto first_channel = [&](int j) { return static_cast<long>(cl + j * clusters) * kTile; };

  if (C > 1) hp::cluster_arrive();  // this block runs; peers wait for it before storing into it
  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, WIDE ? 1 : kWarps);
    }
    hp::mbar_fence_init();
  }
  if (tid < kMaxRows) rmax[tid] = 0;
  __syncthreads();

  if (warp == kWarps) {
    // item j's 16 channel rows of this slice into stage j % stages, a lane a
    // row, marked first to leave L2 (they are read once; x and the rest stay)
    const uint64_t policy = evict_first();
    auto issue = [&](int j) {
      const int s = j % pl.stages;
      const long ch0 = first_channel(j);
      const int n = pl.O - ch0 < kTile ? static_cast<int>(pl.O - ch0) : kTile;
      if (j >= pl.stages) wait_bar(empty + s, (j / pl.stages - 1) & 1);
      unsigned char* st = smem + pl.off_stage + s * pl.stage_bytes;
      if (lane == 0) hp::mbar_arrive_expect_tx(full + s, static_cast<uint32_t>(n * kb));
      __syncwarp();
      if (pl.ws == pl.I) {  // the tile's rows lie end to end: one copy
        if (lane == 0) bulk_load_once(st, w + ch0 * pl.I, n * kb, full + s, policy);
      } else if (lane < n) {
        bulk_load_once(st + lane * pl.ws, w + (ch0 + lane) * pl.I + k0, kb, full + s, policy);
      }
    };
    const int first = min(pl.stages, items);
    for (int j = 0; j < first; ++j) issue(j);
    if (C > 1) {  // the row maxima's exchange
      hp::cluster_wait();
      hp::cluster_arrive();
      hp::cluster_wait();
    }
    for (int j = first; j < items; ++j) issue(j);
    return;
  }

  // ---- the epilogue's channel scales and biases, which no kernel before
  // writes: fetched before the wait on it. The bias as the output adds it.
  float* esc = reinterpret_cast<float*>(smem + pl.off_esc);  // [item][channel]
  float* ebi = esc + pl.esc_items * kTile;
  for (int e = tid; e < items * kTile; e += kConsumers) {
    const long o = first_channel(e / kTile) + (e & (kTile - 1));
    if (o < pl.O) {
      esc[e] = __ldg(scale + o);
      if (pl.bias_kind) {
        const float b = bias_at(bias, pl.bias_kind, o);
        ebi[e] = pl.out_bf16 ? __bfloat162float(__float2bfloat16_rn(b)) : b;
      }
    }
  }

  // ---- the rows: this block's columns of every row, as codes
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // 8-column units, thread tid taking units tid + 512 it; it holds kHold of
  // them (bf16 packed) between the two sweeps
  using Unit = typename UnitOf<T, NT>::type;
  constexpr int kHold = UnitOf<T, NT>::hold;
  const int units = kb / 8, total = B * units, iters = (total + kConsumers - 1) / kConsumers;
  // u / units for u < 2^16 by a product (units <= 2^13): the row of unit u
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(units) + 1u;
  auto row_of = [&](int u) { return static_cast<int>(__umulhi(static_cast<unsigned>(u), magic)); };
  auto at = [&](int u) {
    const int b = row_of(u);
    return x + static_cast<long>(b) * pl.I + k0 + 8 * (u - b * units);
  };
  // the |max| of unit u into its row's: a segmented max over the warp's
  // lanes of one row (units are consecutive across lanes), one atomic a row
  auto fold = [&](int u, const Unit& r) {
    const bool in = u < total;
    unsigned m = in ? __float_as_uint(absmax8(r)) : 0u;  // |x| >= 0 orders as its bits
    const int b = in ? row_of(u) : -1, b0 = __shfl_sync(kAll, b, 0);
    if (b0 == __shfl_sync(kAll, b, 31)) {  // the warp on one row
      m = __reduce_max_sync(kAll, m);
      if (lane == 0 && b0 >= 0) atomicMax(rmax + b0, m);
      return;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned om = __shfl_down_sync(kAll, m, off);
      const int ob = __shfl_down_sync(kAll, b, off);
      if (lane + off < 32 && ob == b) m = max(m, om);
    }
    const int prev = __shfl_up_sync(kAll, b, 1);
    if (in && (lane == 0 || prev != b)) atomicMax(rmax + b, m);
  };
  Unit v[kHold];
  for (int it0 = 0; it0 < iters; it0 += kHold) {
#pragma unroll
    for (int q = 0; q < kHold; ++q) {
      const int u = tid + (it0 + q) * kConsumers;
      if (it0 + q < iters && u < total) v[q] = load_unit(at(u));
    }
#pragma unroll
    for (int q = 0; q < kHold; ++q)
      if (it0 + q < iters) fold(tid + (it0 + q) * kConsumers, v[q]);
  }
  hp::named_barrier(kBar, kConsumers);
  float* sx = reinterpret_cast<float*>(smem + pl.off_sx);
  if (C > 1) {
    float* pmax = reinterpret_cast<float*>(smem + pl.off_pmax);  // [rank][row]
    hp::cluster_wait();  // every block of the cluster runs
    for (int e = tid; e < C * B; e += kConsumers) {
      const int r = e / B, b = e - r * B;
      hp::st_peer(pmax + rank * kMaxRows + b, r, __uint_as_float(rmax[b]));
    }
    hp::cluster_arrive();
    hp::cluster_wait();
    if (tid < B) {
      float m = 0.f;
      for (int r = 0; r < C; ++r) m = fmaxf(m, pmax[r * kMaxRows + tid]);
      sx[tid] = fmaxf(m / 127.0f, 1e-10f);
      sx[kMaxRows + tid] = __frcp_rn(sx[tid]);
    }
  } else if (tid < B) {
    sx[tid] = fmaxf(__uint_as_float(rmax[tid]) / 127.0f, 1e-10f);
    sx[kMaxRows + tid] = __frcp_rn(sx[tid]);
  }
  hp::named_barrier(kBar, kConsumers);
  unsigned char* codes = smem + pl.off_codes;  // [row][column of the slice], rs bytes a row
  for (int it0 = 0; it0 < iters; it0 += kHold) {
    if (iters > kHold) {  // the units kept no longer: read again (from L2)
#pragma unroll
      for (int q = 0; q < kHold; ++q) {
        const int u = tid + (it0 + q) * kConsumers;
        if (it0 + q < iters && u < total) v[q] = load_unit(at(u));
      }
    }
#pragma unroll
    for (int q = 0; q < kHold; ++q) {
      const int u = tid + (it0 + q) * kConsumers;
      if (it0 + q < iters && u < total) {
        const int b = row_of(u), k = u - b * units;
        *reinterpret_cast<uint2*>(codes + b * pl.rs + 8 * k) =
            codes8(v[q], sx[b], sx[kMaxRows + b]);
      }
    }
  }
  // zeros past the slice's columns, to its last chunk's end
  const int pad = (kChunk * nc - kb) / 8;
  for (int e = tid; e < B * pad; e += kConsumers) {
    const int b = e / pad;
    *reinterpret_cast<uint2*>(codes + b * pl.rs + 8 * (units + e - b * pad)) = make_uint2(0, 0);
  }
  hp::named_barrier(kBar, kConsumers);
  // the next kernel may start its own stream now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // ---- the products
  const int g = lane >> 2, t = lane & 3, ntu = (B + 7) / 8, outs = kTile * B;
  // out[b, o] of item j's channel ch from its exact sum
  auto store = [&](int b, int j, int ch, int acc) {
    const long o = first_channel(j) + ch;
    if (o >= pl.O) return;
    const int e = j * kTile + ch;
    const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx[b]), esc[e]);
    const long pos = static_cast<long>(b) * pl.O + o;
    if (pl.out_bf16) {
      __nv_bfloat16 r = __float2bfloat16_rn(y);
      if (pl.bias_kind)  // the bias in bf16, added with one rounding
        r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), ebi[e]));
      static_cast<__nv_bfloat16*>(out)[pos] = r;
    } else {
      static_cast<float*>(out)[pos] = pl.bias_kind ? __fadd_rn(y, ebi[e]) : y;
    }
  };
  // chunks first, first + step, ... of the staged item into two chains of
  // k-steps, summed into d
  auto products = [&](const unsigned char* st, int first, int step, int (&d)[NT][4]) {
    int e[NT][4] = {};
#pragma unroll 2
    for (int c = first; c < nc; c += step) {
      // 16 bytes at 16t of chunk c of channel rows g and g + 8, and of code row g
      const unsigned char* wr = st + g * pl.ws + kChunk * c + 16 * t;
      const int4 wa = *reinterpret_cast<const int4*>(wr);
      const int4 wb = *reinterpret_cast<const int4*>(wr + 8 * pl.ws);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntu) break;
        const int row = 8 * nt + g;
        int4 xa = make_int4(0, 0, 0, 0);
        if (row < B) xa = *reinterpret_cast<const int4*>(codes + row * pl.rs + kChunk * c + 16 * t);
        mma_s8(d[nt], wa.x, wb.x, wa.y, wb.y, xa.x, xa.y);
        mma_s8(e[nt], wa.z, wb.z, wa.w, wb.w, xa.z, xa.w);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[nt][i] += e[nt][i];
  };

  if constexpr (WIDE) {
    // stage s is warp s's, its items in order: a parity wait never sees a
    // stage's next phase for the one before
    static_assert(kMaxStages <= kWarps, "a warp a stage");
    for (int j = warp; j < items; ++j) {
      const int s = j % pl.stages;
      if (s != warp) continue;
      wait_bar(full + s, (j / pl.stages) & 1);
      int d[NT][4] = {};
      products(smem + pl.off_stage + s * pl.stage_bytes, 0, 1, d);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);  // this warp is done with stage s
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntu) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = 8 * nt + 2 * t + (i & 1);
          if (b < B) store(b, j, g + 8 * (i >> 1), d[nt][i]);
        }
      }
    }
  } else {
    int* red = reinterpret_cast<int*>(smem + pl.off_red);    // [warp][row][channel]
    int* slot = reinterpret_cast<int*>(smem + pl.off_slot);  // [item / C][rank][row][channel]
    for (int j = 0; j < items; ++j) {
      const int s = j % pl.stages;
      wait_bar(full + s, (j / pl.stages) & 1);
      int d[NT][4] = {};
      products(smem + pl.off_stage + s * pl.stage_bytes, warp, kWarps, d);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + s);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntu) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = 8 * nt + 2 * t + (i & 1);
          red[(warp * kMaxRows + b) * kTile + g + 8 * (i >> 1)] = d[nt][i];
        }
      }
      hp::named_barrier(kBar, kConsumers);
      // the warps' sums; with C > 1 sent to the item's owner, rank j % C
      int* sl = slot + ((j / C) * C + rank) * outs;
      for (int o = tid; o < outs; o += kConsumers) {  // o = row * 16 + channel
        int y = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) y += red[k * kMaxRows * kTile + o];
        if (C == 1)
          store(o / kTile, j, o & (kTile - 1), y);
        else
          st_peer_s32(sl + o, j % C, y);
      }
      hp::named_barrier(kBar, kConsumers);  // red is written again by the next item
    }
    if (C > 1) {  // the slices' partial sums of each item meet in its owner
      hp::cluster_arrive();
      hp::cluster_wait();
      for (int j = rank; j < items; j += C)
        for (int o = tid; o < outs; o += kConsumers) {
          int y = 0;
          for (int r = 0; r < C; ++r) y += slot[((j / C) * C + r) * outs + o];
          store(o / kTile, j, o & (kTile - 1), y);
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

// The layout of a call of B rows in C slices run by `clusters` clusters
// (one block an SM: the rows' codes want all 16 warps of it); false if no
// stage fits. WIDE where a block takes a stage's worth of items or more
// (C = 1: the heads). As many stages as fit, up to kMaxStages and the most
// items a block takes.
bool make_plan(Plan& pl, int B, int I, int O, int C, int clusters) {
  pl.B = B, pl.I = I, pl.O = O, pl.C = C;
  pl.tiles = (O + kTile - 1) / kTile;
  pl.nch = (I + kChunk - 1) / kChunk;
  pl.wide = C == 1 && pl.tiles >= kMaxStages * clusters;
  const int most = (pl.nch + C - 1) / C;  // chunks of the widest slice
  pl.rs = kChunk * most + (most % 2 ? 0 : kChunk);  // 64 mod 128: rows g, g + 1 in other banks
  // a head's tile in one copy (its rows lie end to end at C = 1) where one
  // row tile of codes leaves the stream the time (B <= 8); else a copy a
  // row, padded: unpadded rows g, g + 1 share banks, which costs more at 16
  // rows than the copies save (tools/int8_split.py's "a copy a row")
  pl.ws = C == 1 && pl.wide && B <= 8 ? I : pl.rs;
  const int items = (pl.tiles + clusters - 1) / clusters;
  pl.esc_items = items;
  int off = 16 * kMaxStages;  // the mbarriers
  pl.off_rmax = off;
  off += 4 * kMaxRows;
  pl.off_pmax = off;
  off += 4 * kMaxRows * kMaxSlices;
  pl.off_sx = off;  // the rows' scales, then their reciprocals
  off += 2 * 4 * kMaxRows;
  pl.off_esc = off;  // the items' channel scales, then biases
  off += round16(2L * 4 * items * kTile);
  pl.off_codes = off;
  off += round16(static_cast<long>(B) * pl.rs);
  pl.off_red = off;  // the warps' sums of an item
  off += pl.wide ? 0 : 4 * kWarps * kMaxRows * kTile;
  pl.off_slot = off;  // an owner's items' partial sums from every rank
  off += C > 1 ? 4 * ((items + C - 1) / C) * C * kTile * B : 0;
  pl.off_stage = off;
  pl.stage_bytes = kTile * pl.ws;
  int stages = (kSmemBlock - off) / pl.stage_bytes;
  if (stages < 1) return false;
  stages = stages < kMaxStages ? stages : kMaxStages;
  pl.stages = stages < items ? stages : items;
  pl.smem = pl.off_stage + pl.stages * pl.stage_bytes;
  return true;
}

// The opt-in of an instantiation to a block's whole shared memory, once (a
// launch takes what its plan needs).
template <typename T, int NT, bool WIDE>
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = int8_mm_kernel<T, NT, WIDE>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = tpa::allow_smem(kernel, kSmemBlock - static_cast<int>(attr.sharedSizeBytes));
  done = err == cudaSuccess;
  return err;
}

// The clusters of C blocks the card holds at once, by the occupancy
// calculator, kept per (C, shared memory) of this instantiation.
template <typename T, int NT, bool WIDE>
cudaError_t max_clusters(const Plan& pl, int& clusters) {
  static int cache[32][3] = {};
  for (auto& c : cache)
    if (c[0] == pl.C && c[1] == pl.smem) {
      clusters = c[2];
      return cudaSuccess;
    }
  auto kernel = int8_mm_kernel<T, NT, WIDE>;
  cudaError_t err = opt_in<T, NT, WIDE>();
  if (err != cudaSuccess) return err;
  if (pl.C == 1) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, pl.smem);
    clusters = per_sm * sm_count();
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = pl.C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.C * 64);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  for (auto& c : cache)
    if (c[0] == 0) {
      c[0] = pl.C, c[1] = pl.smem, c[2] = clusters;
      break;
    }
  return cudaSuccess;
}

template <typename T, int NT>
cudaError_t held_clusters(const Plan& pl, int& clusters) {
  return pl.wide ? max_clusters<T, NT, true>(pl, clusters)
                 : max_clusters<T, NT, false>(pl, clusters);
}

// The plan of a call and its clusters: as many as the card holds at once
// (the plan's sizes grow with the items a cluster takes, so it is made
// again until the two agree), at most one a tile.
template <typename T, int NT>
cudaError_t plan_of(Plan& pl, int B, int I, int O, int C, int& clusters) {
  const int n_sm = sm_count();
  if (n_sm < 1) return cudaErrorNoDevice;
  const int tiles = (O + kTile - 1) / kTile;
  clusters = n_sm / C < tiles ? n_sm / C : tiles;
  if (clusters < 1) clusters = 1;
  for (int round = 0;; ++round) {
    if (!make_plan(pl, B, I, O, C, clusters)) return cudaErrorInvalidValue;
    int held = 0;
    const cudaError_t err = held_clusters<T, NT>(pl, held);
    if (err != cudaSuccess) return err;
    if (held < 1) return cudaErrorInvalidConfiguration;
    if (held >= clusters || round == 3) return cudaSuccess;  // (past 3 rounds: in waves)
    clusters = held;
  }
}

template <typename T, int NT, bool WIDE>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, const void* bias,
                   void* out, const Plan& pl, int clusters, cudaStream_t stream) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = pl.C;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = pl.C > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, int8_mm_kernel<T, NT, WIDE>, static_cast<const T*>(x), w,
                            scale, bias, out, pl);
}

// Plan, and launch unless `plan_only`, the instantiation of x's dtype, B
// and the plan's mode.
template <typename T>
cudaError_t run(int B, int I, int O, int C, bool plan_only, Plan& pl, int& clusters,
                const void* x, const int8_t* w, const float* scale, const void* bias,
                void* out, cudaStream_t stream) {
  const int nt = (B + 7) / 8;
  cudaError_t err;
  if (nt <= 1)
    err = plan_of<T, 1>(pl, B, I, O, C, clusters);
  else if (nt <= 2)
    err = plan_of<T, 2>(pl, B, I, O, C, clusters);
  else
    err = plan_of<T, 4>(pl, B, I, O, C, clusters);
  if (err != cudaSuccess || plan_only) return err;
  if (pl.wide) {
    if (nt <= 1) return launch<T, 1, true>(x, w, scale, bias, out, pl, clusters, stream);
    if (nt <= 2) return launch<T, 2, true>(x, w, scale, bias, out, pl, clusters, stream);
    return launch<T, 4, true>(x, w, scale, bias, out, pl, clusters, stream);
  }
  if (nt <= 1) return launch<T, 1, false>(x, w, scale, bias, out, pl, clusters, stream);
  if (nt <= 2) return launch<T, 2, false>(x, w, scale, bias, out, pl, clusters, stream);
  return launch<T, 4, false>(x, w, scale, bias, out, pl, clusters, stream);
}

// The sizes a launch takes: a block's x units (8 columns) number under 2^16
// (its row division by a product).
bool valid(int B, int I, int O, int C) {
  const int nch = (I + kChunk - 1) / kChunk;
  return B >= 1 && B <= kMaxRows && I > 0 && I % 16 == 0 && O > 0 &&
         (C == 1 || C == 2 || C == 4 || C == 8) && C <= nch &&
         static_cast<long>(B) * ((nch + C - 1) / C) * (kChunk / 8) <= 60000;
}

}  // namespace

// The launch a call of these sizes takes, without launching: out[0..6] =
// stages, shared memory bytes of a block, blocks, clusters, bytes a staged
// row, 8-row tiles of B, wide. Returns 0, or an error if no plan fits.
extern "C" int tpa_int8_matmul_plan(int B, int I, int O, int x_bf16, int C, int* out,
                                    cudaStream_t /*unused*/) {
  if (!valid(B, I, O, C)) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl = {};
  int clusters = 0;
  const cudaError_t err =
      x_bf16 ? run<__nv_bfloat16>(B, I, O, C, true, pl, clusters, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr)
             : run<float>(B, I, O, C, true, pl, clusters, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.stages, out[1] = pl.smem, out[2] = C * clusters, out[3] = clusters, out[4] = pl.rs,
  out[5] = (B + 7) / 8, out[6] = pl.wide;
  return 0;
}

// x (B, I) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous, 16-byte
// aligned; w (L, O, I) int8, layer `layer` is read; scale (O) f32; bias (O)
// f32 (bias_kind 1), bf16 (2) or none (0, bias unused); out (B, O) f32
// (out_bf16 = 0) or bf16 (1). 1 <= B <= 32, I % 16 == 0; C (1, 2, 4, 8)
// slices of the columns, at most I / 64 rounded up. One launch.
extern "C" int tpa_int8_matmul(const void* x, int x_bf16, const int8_t* w, const float* scale,
                               const void* bias, int bias_kind, void* out, int out_bf16, int B,
                               int I, int O, int layer, int C, cudaStream_t stream) {
  if (!valid(B, I, O, C) || bias_kind < 0 || bias_kind > 2 || (bias_kind && !bias))
    return static_cast<int>(cudaErrorInvalidValue);
  w += static_cast<long>(layer) * O * I;
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Plan pl = {};
  pl.out_bf16 = out_bf16 != 0;
  pl.bias_kind = bias_kind;
  int clusters = 0;
  const cudaError_t err =
      x_bf16 ? run<__nv_bfloat16>(B, I, O, C, false, pl, clusters, x, w, scale, bias, out, stream)
             : run<float>(B, I, O, C, false, pl, clusters, x, w, scale, bias, out, stream);
  return static_cast<int>(err);
}
