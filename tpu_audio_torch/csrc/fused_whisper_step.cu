// The whole Whisper decoder step at B=1, T=1, all layers, in one
// cooperative launch.
//
// Replaces tpu_audio/ops/pallas/fused_whisper_step.py:fused_whisper_decode_step.
//
// Bound on the H100: device-memory bytes, ~35 us at 3.35 TB/s for a step of
// large-v3-turbo (91.8 MB of int8 decoder weights, 15.4 MB of int8 cross-K/V,
// <= 9.2 MB of bf16 self cache). What a step costs above that is the chain
// of dependent phases: eight a layer, each ended by a grid barrier (~1.8 us
// on the card), each a few round trips to L2 long (tools/step_split.py).
//
// Design. The blocks are co-resident (cudaLaunchCooperativeKernel, two an
// SM) and cooperative_groups' grid sync ends each phase of a layer:
//   P1 LN1 -> q, k, v; k and v of the current token go to the cache slot
//      `pos` in place;           P2 self-attention;
//   P3 o-projection + residual;  P4 LN -> cross-q, K scale folded in;
//   P5 cross-attention over the t_valid int8 keys;
//   P6 cross-o + residual;       P7 LN2 -> fc1 + erf-GELU;
//   P8 fc2 + residual;
// and after the last layer block 0 writes the final LN.
//  - Weights. Block b computes rows [R b / G, R (b + 1) / G) of every
//    product, contiguous in memory, so a few bulk copies (cp.async.bulk,
//    completion on an mbarrier) bring them into shared memory. With two
//    buffers (int8 weights) the copy for the next product is issued as
//    this product starts, once the phase's input is in shared memory, and
//    lands during the barrier and the phases before its use; with one
//    (bf16 weights, twice the bytes) when this product has read the buffer.
//    A copy issued before the phase's own loads, or an L2 prefetch two
//    products ahead, measured slower: its traffic queues those loads.
//  - A product reads its rows from shared memory, 16 bytes a lane, against
//    its input vector in shared memory stored permuted so that the lanes'
//    float4 reads are contiguous; int8 becomes f32 by a byte permute
//    (decode_dot.cuh), not the conversion unit. Its row sums go to shared
//    memory and a thread a row applies scale, bias and residual, the
//    residual's rows loaded before the input.
//  - A LayerNorm reads the residual once into registers and takes the
//    variance about the mean.
//  - Attention. Head h's keys are split over `split` blocks, which read
//    their chunk's rows from global memory (staging them a phase ahead by
//    cp.async, or loading all of a chunk into shared memory first,
//    measured slower). A chunk leaves (max, sum of exp, P.V) in
//    the workspace; the chunk that arrives last at its head's counter
//    (atomicAdd after a fence) merges the head's chunks and, for
//    self-attention, the current token's own term, so no grid barrier
//    separates the passes and every other block reads D merged values, not
//    the partials. With f32 activations one pass per chunk is exact up to
//    the order of the f32 sums; with bf16 activations each probability is
//    rounded against the head's max and sum, as the reference rounds it, so
//    a chunk first publishes its max and sum, waits at the head's counter
//    for the others, then forms its P.V.
// The product, the LayerNorm and the chunk's attention are functions of
// their own (__noinline__): inlined into the kernel they spilled and ran
// slower. Weights are int8 with a per-channel f32 scale or bf16 (scale 1);
// the LN output, the attention outputs and the GELU output are rounded to
// bf16 before a product when the activations are bf16. Sums are f32.
//
// Data written during the launch (the residual, q/k/v, partials, merged
// outputs, the fc1 output) is read after a barrier or an acquire with
// __ldcg, from L2, so that no SM's L1 can hand back a stale line.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "decode_dot.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;
namespace hp = tpa::hopper;

namespace {

constexpr int HD = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSplit = 32;     // key chunks per head (one lane each when merging)
constexpr int kPart = HD + 2;     // a chunk's partial: max, sum, P.V[64]
constexpr int kMaxPer = 8;        // residual values a thread holds in a LayerNorm: D <= 2048
constexpr int kPieceBytes = 16384;  // a weight copy is issued in pieces of at most this
constexpr float kScale = 0.35355339059327373f;  // 64^-0.25
enum { Q, K, V, O, QC, OC, FC1, FC2, kMats };
// the products of a layer in order (P_QKV spans Q, K and V)
enum { P_QKV, P_O, P_QC, P_OC, P_FC1, P_FC2, kProducts };
// per-head arrival counters: a pass's (max, sum) published, a chunk's P.V written
enum { SELF_STATS, SELF_DONE, CROSS_STATS, CROSS_DONE, kCounters };

struct Params {
  const void* x;
  int x_bf16;
  const long long* pos;
  const void* w[kMats];    // (L, O, I) int8 or bf16
  const float* s[kMats];   // (L, O) or null (scale 1)
  const float* b[kMats];   // (L, O) or null (no bias)
  const float* ln;         // (L, 3, 2, D)
  const float* lnf;        // (2, D)
  void* kc;                // (L, S, D) bf16 or f32
  void* vc;
  const int8_t* k8;        // (L, T_pad, D)
  const float* ksc;        // (L, D)
  const int8_t* v8;
  const float* vsc;
  float* h;                // (D)
  float* work;
  int L, D, hidden, H, S, t_pad, t_valid;
  int split;               // key chunks per head
  int nbuf;                // weight buffers in shared memory (1 or 2)
  int w_bytes;             // bytes of one weight buffer
  int kv_rows;             // the most keys of a chunk (its scores' buffer)
  int max_rows;            // the most rows of a product a block computes
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Where element i of a product's input vector sits in shared memory: lane
// v of a warp reads elements [per v, per (v + 1)) of the input against its
// 16 bytes of a weight row (per = 16 / sizeof(W) elements) as per / 4
// float4, the j-th of them at float4 j * nv + v, so that consecutive lanes
// read consecutive float4.
template <typename W>
__device__ __forceinline__ int perm(int i, int nv) {
  constexpr int per = 16 / static_cast<int>(sizeof(W));
  const int v = i / per, r = i % per;
  return ((r >> 2) * nv + v) * 4 + (r & 3);
}

// sums[r] = row r . a for the n rows (I elements each) at wst (shared),
// against the input ap (shared, permuted); a warp a row. The caller syncs.
template <typename W>
__device__ __noinline__ void step_product(const unsigned char* wst, int n, int I, const float* ap,
                                     float* sums) {
  constexpr int per = 16 / static_cast<int>(sizeof(W));
  const int nv = I / per, lane = threadIdx.x & 31;
  const float4* a4 = reinterpret_cast<const float4*>(ap);
  for (int r = threadIdx.x >> 5; r < n; r += kWarps) {
    const int4* wr = reinterpret_cast<const int4*>(wst + static_cast<long>(r) * I * sizeof(W));
    float acc[per / 4] = {};
    for (int v = lane; v < nv; v += 32) {
      float f[per];
      tpa::dec::load_f32<W, per>(reinterpret_cast<const W*>(wr + v), f);
#pragma unroll
      for (int j = 0; j < per / 4; ++j) {
        const float4 x = a4[j * nv + v];
        acc[j] = fmaf(f[4 * j], x.x, acc[j]);
        acc[j] = fmaf(f[4 * j + 1], x.y, acc[j]);
        acc[j] = fmaf(f[4 * j + 2], x.z, acc[j]);
        acc[j] = fmaf(f[4 * j + 3], x.w, acc[j]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < per / 4; ++j) s += acc[j];
    s = tpa::warp_sum(s);
    if (lane == 0) sums[r] = s;
  }
}

// LayerNorm of the D-vector x (global, written in this launch) with wb =
// (weight, bias), the residual read once: y_i into out[perm(i, nv)],
// rounded to bf16 when rb (a product's input), or, with nv 0, into out[i].
// Called by the whole block; syncs at the end.
template <typename W>
__device__ __noinline__ void step_layer_norm(const float* x, const float* wb, int D, bool rb, int nv,
                                        float* out, float* scratch) {
  float v[kMaxPer];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < D ? __ldcg(x + i) : 0.f;
    s += v[k];
  }
  const float mean = tpa::block_sum<kWarps>(s, scratch) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const float c = v[k] - mean;
    if (threadIdx.x + k * kThreads < D) q = fmaf(c, c, q);
  }
  const float r = rsqrtf(tpa::block_sum<kWarps>(q, scratch) / D + 1e-5f);
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= D) continue;
    const float y = (v[k] - mean) * r * wb[i] + wb[D + i];
    if (nv == 0)
      out[i] = y;
    else
      out[perm<W>(i, nv)] = rb ? round_bf16(y) : y;
  }
  __syncthreads();
}

// Four consecutive elements of type T at p as floats.
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  tpa::dec::s8x4(*reinterpret_cast<const uint32_t*>(p), f);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  float a[2], b[2];
  tpa::dec::bf16x2(w.x, a);
  tpa::dec::bf16x2(w.y, b);
  f[0] = a[0], f[1] = a[1], f[2] = b[0], f[3] = b[1];
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}

// A chunk of one head's keys: where its partial goes, the head's partials,
// the head's arrival counters and the count at which every chunk of this
// layer has arrived at one.
struct Chunk {
  float* part;
  const float* head_part;
  int* stats;
  int* done;
  int target, split;
};

// One head's attention, its keys split over `split` chunks; this block has
// chunk rows ks, vs (shared, n rows of HD elements) and the head's query q
// (global). Leaves (max, sum of exp, P.V) in c.part; the chunk that arrives
// last at c.done merges the head's partials with the fresh term
// (self-attention: the current token's scaled key kf and value vf, global;
// null for cross-attention), multiplies by vscale (cross-attention) and
// writes out (global, HD). With rb, each probability is exp(s - M) / L
// rounded to bf16 against the head's max M and sum L (the chunks publish
// theirs at c.stats first and wait for the others) and the values are
// rounded to bf16 too; else each chunk's P.V is unnormalised, against its
// own max, and the merge rescales. Shared: qh (HD), scores (n), red (16 x
// HD), scratch (32), bc (4).
template <typename T>
__device__ __noinline__ void chunk_attention(const T* ks, const T* vs, int stride, int n, const float* q,
                                             const float* kf, const float* vf,
                                             const float* vscale, float* out, bool rb, Chunk c,
                                             float* qh, float* scores, float* red, float* scratch,
                                             float* bc) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < HD) qh[tid] = __ldcg(q + tid);
  __syncthreads();
  // scores: 8 lanes a row, 8 elements a lane, 32 rows a pass
  const int e = lane & 7;
  float mloc = -INFINITY;
  for (int base = 0; base < n; base += kThreads / 8) {  // the same trip count for every lane
    const int t = base + tid / 8;
    float s = 0.f;
    if (t < n) {
      float f[8];
      tpa::dec::load_f32<T, 8>(ks + static_cast<long>(t) * stride + e * 8, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s = fmaf(qh[e * 8 + k], f[k], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (t < n) {
      if (e == 0) scores[t] = s;
      mloc = fmaxf(mloc, s);
    }
  }
  const float m = tpa::block_max<kWarps>(mloc, scratch);  // syncs: scores visible
  float lsum = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float x = expf(scores[t] - m);
    if (!rb) scores[t] = x;
    lsum += x;
  }
  const float l = tpa::block_sum<kWarps>(lsum, scratch);  // syncs
  // the fresh score of self-attention, by warp 0
  float sf = -INFINITY;
  if (kf != nullptr && tid < 32)
    sf = tpa::warp_sum(qh[lane] * __ldcg(kf + lane) + qh[lane + 32] * __ldcg(kf + lane + 32));
  if (rb) {
    if (tid == 0) {
      c.part[0] = m;
      c.part[1] = l;
      __threadfence();
      atomicAdd(c.stats, 1);
      while (ld_acquire(c.stats) < c.target) __nanosleep(32);
    }
    __syncthreads();
    if (tid < 32) {  // the head's max and sum over its chunks and the fresh term
      const bool live = lane < c.split && __ldcg(c.head_part + lane * kPart + 1) > 0.f;
      const float mc = live ? __ldcg(c.head_part + lane * kPart) : -INFINITY;
      const float M = fmaxf(tpa::warp_max(mc), sf);
      const float L = tpa::warp_sum(live ? __ldcg(c.head_part + lane * kPart + 1) * expf(mc - M)
                                         : 0.f) +
                      (sf > -INFINITY ? expf(sf - M) : 0.f);
      if (tid == 0) bc[0] = M, bc[1] = L;
    }
    __syncthreads();
    const float M = bc[0], L = bc[1];
    for (int t = tid; t < n; t += kThreads) scores[t] = round_bf16(expf(scores[t] - M) / L);
    __syncthreads();
  }
  // P.V: 16 row groups of 16 threads, 4 columns a thread
  {
    const int g = tid / 16, j = (tid % 16) * 4;
    float acc[4] = {};
    for (int t = g; t < n; t += kThreads / 16) {
      float v[4];
      load4(vs + static_cast<long>(t) * stride + j, v);
      const float pr = scores[t];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(pr, rb ? round_bf16(v[k]) : v[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) red[g * HD + j + k] = acc[k];
  }
  __syncthreads();
  if (tid < HD) {
    float s = 0.f;
    for (int g = 0; g < kThreads / 16; ++g) s += red[g * HD + tid];
    c.part[2 + tid] = s;
    if (!rb && tid == 0) c.part[0] = m, c.part[1] = l;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) bc[2] = atomicAdd(c.done, 1) == c.target - 1 ? 1.f : 0.f;
  __syncthreads();
  if (bc[2] == 0.f) return;
  // the last chunk of the head: merge
  __threadfence();
  if (tid < 32) {
    const bool live = lane < c.split && __ldcg(c.head_part + lane * kPart + 1) > 0.f;
    const float mc = live ? __ldcg(c.head_part + lane * kPart) : -INFINITY;
    const float M = fmaxf(tpa::warp_max(mc), sf);
    const float wc = live ? expf(mc - M) : 0.f;
    const float L = tpa::warp_sum(live ? __ldcg(c.head_part + lane * kPart + 1) * wc : 0.f) +
                    (sf > -INFINITY ? expf(sf - M) : 0.f);
    if (lane < c.split) red[lane] = rb ? (live ? 1.f : 0.f) : wc / L;
    if (tid == 0) bc[3] = sf > -INFINITY ? expf(sf - M) / L : 0.f;
  }
  __syncthreads();
  {  // four groups of HD threads, each a quarter of the chunks, all loads at once
    const int g = tid / HD, j = tid % HD;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplit / 4; ++k) {
      const int i = g + 4 * k;
      if (i < c.split) s = fmaf(red[i], __ldcg(c.head_part + i * kPart + 2 + j), s);
    }
    red[kMaxSplit + g * HD + j] = s;
  }
  __syncthreads();
  if (tid < HD) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kThreads / HD; ++g) s += red[kMaxSplit + g * HD + tid];
    if (vf != nullptr) s = fmaf(bc[3], __ldcg(vf + tid), s);
    if (vscale != nullptr) s *= vscale[tid];
    out[tid] = s;
  }
}

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fused_whisper_step_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, H = p.H, hidden = p.hidden, split = p.split, G = gridDim.x;
  const int tid = threadIdx.x, blk = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // weight buffers 0, 1
  unsigned char* wbuf = smem + 128;
  float* a = reinterpret_cast<float*>(wbuf + p.nbuf * p.w_bytes);  // a product's input, permuted
  float* scores = a + (hidden > D ? hidden : D);              // kv_rows: a chunk's scores
  float* red = scores + p.kv_rows;                            // 16 x HD
  float* qh = red + 16 * HD;                                  // HD
  float* scratch = qh + HD;                                   // 32
  float* bc = scratch + 32;                                   // 4: values broadcast to the block
  float* sums = bc + 4;                                       // max_rows: a product's row sums

  float* xg = p.work;                               // residual (D)
  float* qg = xg + D;
  float* kg = qg + D;
  float* vg = kg + D;
  float* qsg = vg + D;                              // cross-q, K scale folded in
  float* ao = qsg + D;                              // merged attention output (D)
  float* act = ao + D;                              // fc1 output (hidden)
  float* part = act + hidden;                       // H x split x kPart
  int* cnt = reinterpret_cast<int*>(part + H * split * kPart);  // kCounters x H

  const int pos = static_cast<int>(*p.pos);
  const bool rb = p.x_bf16 != 0;
  const bool attn_block = blk < H * split;
  const int head = blk / split, chunk = blk % split;
  C* kc = static_cast<C*>(p.kc);
  C* vc = static_cast<C*>(p.vc);
  const int n_prod = p.L * kProducts;
  const int per = 16 / static_cast<int>(sizeof(W));

  // ---- weights: block blk computes rows [R blk / G, R (blk + 1) / G) of product g
  auto rows = [&](int g, int& r0) {
    const int k = g % kProducts;
    const int R = k == P_QKV ? 3 * D : k == P_FC1 ? hidden : D;
    r0 = static_cast<int>(static_cast<long>(R) * blk / G);
    return static_cast<int>(static_cast<long>(R) * (blk + 1) / G) - r0;
  };
  // this block's rows of product g, a segment a matrix: fn(first row,
  // offset of that row among the block's rows, rows)
  auto segments = [&](int g, auto fn) {
    const int l = g / kProducts, k = g % kProducts;
    int r0;
    const int n = rows(g, r0);
    const int nm = k == P_QKV ? 3 : 1;  // matrices of the product
    const int rm = (k == P_QKV ? 3 * D : k == P_FC1 ? hidden : D) / nm;  // rows each
    const long in = k == P_FC2 ? hidden : D;
    const int m0 = k == P_QKV ? Q : k == P_O ? O : k == P_QC ? QC : k == P_OC ? OC
                 : k == P_FC1 ? FC1 : FC2;
    for (int i = 0; i < nm; ++i) {
      const int lo = max(r0, i * rm), hi = min(r0 + n, (i + 1) * rm);
      if (hi > lo)
        fn(static_cast<const W*>(p.w[m0 + i]) + (static_cast<long>(l) * rm + lo - i * rm) * in,
           lo - r0, hi - lo);
    }
  };
  auto stage = [&](int g) {  // thread 0: into buffer g % nbuf
    uint64_t* br = bar + g % p.nbuf;
    unsigned char* dst = wbuf + (g % p.nbuf) * p.w_bytes;
    int r0;
    const long row_bytes = static_cast<long>(g % kProducts == P_FC2 ? hidden : D) * sizeof(W);
    hp::mbar_arrive_expect_tx(br, static_cast<uint32_t>(rows(g, r0) * row_bytes));
    segments(g, [&](const W* src, int off, int cnt) {
      for (long o = 0; o < cnt * row_bytes; o += kPieceBytes) {
        const long left = cnt * row_bytes - o;
        hp::bulk_load(dst + off * row_bytes + o, reinterpret_cast<const char*>(src) + o,
                  static_cast<uint32_t>(left < kPieceBytes ? left : kPieceBytes), br);
      }
    });
  };
  // product g's rows in shared memory, once they have landed
  auto staged = [&](int g) -> const unsigned char* {
    hp::mbar_wait(bar + g % p.nbuf, (g / p.nbuf) & 1);
    return wbuf + (g % p.nbuf) * p.w_bytes;
  };
  // product g of I inputs against a (in shared memory) into sums; with two
  // buffers, the next product's copy starts first: its buffer was last read
  // by the product before this one, and no load of this phase's input is
  // left to queue behind it
  auto run_product = [&](int g, int I) {
    if (p.nbuf == 2 && tid == 0 && g + 1 < n_prod) stage(g + 1);
    int r0;
    step_product<W>(staged(g), rows(g, r0), I, a, sums);
  };
  // after product g: with one buffer, the next product's copy
  auto end_product = [&](int g) {
    if (p.nbuf == 1) {
      __syncthreads();
      if (tid == 0 && g + 1 < n_prod) stage(g + 1);
    }
  };
  const int nv_d = D / per, nv_h = hidden / per;
  auto load_a = [&](const float* src, int n, int nv) {  // a global vector into a, permuted
    for (int i = tid; i < n; i += kThreads) {
      const float y = __ldcg(src + i);
      a[perm<W>(i, nv)] = rb ? round_bf16(y) : y;
    }
    __syncthreads();
  };
  auto sc = [&](int m, long i) { return p.s[m] != nullptr ? p.s[m][i] : 1.f; };
  auto bi = [&](int m, long i) { return p.b[m] != nullptr ? p.b[m][i] : 0.f; };

  const int cs = (pos + split - 1) / split;  // self chunk rows
  const int s0 = min(pos, chunk * cs), s1 = min(pos, s0 + cs);
  const int ct = (p.t_valid + split - 1) / split;  // cross chunk rows
  const int c0 = min(p.t_valid, chunk * ct), c1 = min(p.t_valid, c0 + ct);
  auto chunk_of = [&](int kind, int l) {
    return Chunk{part + (head * split + chunk) * kPart, part + head * split * kPart,
                 cnt + kind * H + head, cnt + (kind + 1) * H + head, (l + 1) * split, split};
  };

  // ---- set-up
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) hp::mbar_init(bar + i, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) stage(0);
  for (int i = blk * kThreads + tid; i < D; i += G * kThreads)
    xg[i] = rb ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i])
               : static_cast<const float*>(p.x)[i];
  if (blk == 0)
    for (int i = tid; i < kCounters * H; i += kThreads) cnt[i] = 0;
  grid.sync();

  for (int l = 0; l < p.L; ++l) {
    const long lD = static_cast<long>(l) * D, lH = static_cast<long>(l) * hidden;
    const int g0 = l * kProducts;
    int r0, n;
    float xres;  // this thread's row of the residual, for a residual product's epilogue
    // P1: LN1 -> q, k, v; the slot of the current token
    n = rows(g0 + P_QKV, r0);
    step_layer_norm<W>(xg, p.ln + (l * 3 + 0) * 2 * D, D, rb, nv_d, a, scratch);
    run_product(g0 + P_QKV, D);
    __syncthreads();
    if (tid < n) {
      const int o = r0 + tid, m = o / D, c = o % D;
      const float y = sums[tid] * sc(m, lD + c) + bi(m, lD + c);
      if (m == Q) {
        qg[c] = y * kScale;
      } else if (m == K) {
        kg[c] = y * kScale;
        store(kc + (static_cast<long>(l) * p.S + pos) * D + c, y * kScale);
      } else {
        vg[c] = y;
        store(vc + (static_cast<long>(l) * p.S + pos) * D + c, y);
      }
    }
    end_product(g0 + P_QKV);
    grid.sync();
    // P2: self-attention over the positions < pos and the current token
    if (attn_block) {
      const long base = (static_cast<long>(l) * p.S + s0) * D + head * HD;
      chunk_attention<C>(kc + base, vc + base, D, s1 - s0, qg + head * HD,
                         kg + head * HD, vg + head * HD, nullptr, ao + head * HD, rb,
                         chunk_of(SELF_STATS, l), qh, scores, red, scratch, bc);
    }
    grid.sync();
    // P3: o-projection + residual
    n = rows(g0 + P_O, r0);
    xres = tid < n ? __ldcg(xg + r0 + tid) : 0.f;
    load_a(ao, D, nv_d);
    run_product(g0 + P_O, D);
    __syncthreads();
    if (tid < n) xg[r0 + tid] = xres + sums[tid] * sc(O, lD + r0 + tid) + bi(O, lD + r0 + tid);
    end_product(g0 + P_O);
    grid.sync();
    // P4: LN -> cross-q with the K scale folded in
    n = rows(g0 + P_QC, r0);
    step_layer_norm<W>(xg, p.ln + (l * 3 + 1) * 2 * D, D, rb, nv_d, a, scratch);
    run_product(g0 + P_QC, D);
    __syncthreads();
    if (tid < n) {
      const long o = lD + r0 + tid;
      qsg[r0 + tid] = (sums[tid] * sc(QC, o) + bi(QC, o)) * kScale * p.ksc[o];
    }
    end_product(g0 + P_QC);
    grid.sync();
    // P5: cross-attention over the t_valid int8 keys
    if (attn_block) {
      const long base = (static_cast<long>(l) * p.t_pad + c0) * D + head * HD;
      chunk_attention<int8_t>(p.k8 + base, p.v8 + base, D, c1 - c0,
                              qsg + head * HD, nullptr, nullptr, p.vsc + lD + head * HD,
                              ao + head * HD, rb, chunk_of(CROSS_STATS, l), qh, scores, red,
                              scratch, bc);
    }
    grid.sync();
    // P6: cross-o + residual
    n = rows(g0 + P_OC, r0);
    xres = tid < n ? __ldcg(xg + r0 + tid) : 0.f;
    load_a(ao, D, nv_d);
    run_product(g0 + P_OC, D);
    __syncthreads();
    if (tid < n) xg[r0 + tid] = xres + sums[tid] * sc(OC, lD + r0 + tid) + bi(OC, lD + r0 + tid);
    end_product(g0 + P_OC);
    grid.sync();
    // P7: LN2 -> fc1 + erf-GELU
    n = rows(g0 + P_FC1, r0);
    step_layer_norm<W>(xg, p.ln + (l * 3 + 2) * 2 * D, D, rb, nv_d, a, scratch);
    run_product(g0 + P_FC1, D);
    __syncthreads();
    if (tid < n) {
      const long o = lH + r0 + tid;
      const float y = sums[tid] * sc(FC1, o) + bi(FC1, o);
      act[r0 + tid] = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    }
    end_product(g0 + P_FC1);
    grid.sync();
    // P8: fc2 + residual
    n = rows(g0 + P_FC2, r0);
    xres = tid < n ? __ldcg(xg + r0 + tid) : 0.f;
    load_a(act, hidden, nv_h);
    run_product(g0 + P_FC2, hidden);
    __syncthreads();
    if (tid < n) xg[r0 + tid] = xres + sums[tid] * sc(FC2, lD + r0 + tid) + bi(FC2, lD + r0 + tid);
    end_product(g0 + P_FC2);
    grid.sync();
  }
  if (blk == 0) step_layer_norm<W>(xg, p.lnf, D, false, 0, p.h, scratch);
}

// The launch's shape for these sizes: blocks (two an SM where they fit),
// key chunks a head, weight buffers and their bytes, and the shared memory
// of a block. Fails if the card cannot hold the grid at once.
template <typename W, typename C>
cudaError_t plan(Params& p, int& blocks, int& smem) {
  auto kernel = fused_whisper_step_kernel<W, C>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int big = p.hidden > p.D ? p.hidden : p.D;
  for (int per_sm = kBlocksPerSm; per_sm >= 1; --per_sm) {
    const int G = sms * per_sm;
    p.split = G / p.H < kMaxSplit ? G / p.H : kMaxSplit;
    if (p.split < 1) continue;
    const int self_rows = (p.S + p.split - 1) / p.split;
    const int cross_rows = (p.t_pad + p.split - 1) / p.split;
    p.kv_rows = self_rows > cross_rows ? self_rows : cross_rows;
    p.max_rows = ((3 * p.D > p.hidden ? 3 * p.D : p.hidden) + G - 1) / G;
    if (p.max_rows > kThreads) continue;
    const int shares[3][2] = {{3 * p.D, p.D}, {p.hidden, p.D}, {p.D, p.hidden}};  // rows, inputs
    long w_bytes = 0;
    for (const auto& s : shares) {
      const long b = static_cast<long>((s[0] + G - 1) / G) * s[1] * sizeof(W);
      w_bytes = b > w_bytes ? b : w_bytes;
    }
    p.w_bytes = static_cast<int>((w_bytes + 15) / 16 * 16);
    for (p.nbuf = 2; p.nbuf >= 1; --p.nbuf) {
      const long bytes = 128 + static_cast<long>(p.nbuf) * p.w_bytes +
                         (big + p.kv_rows + 16 * HD + HD + 32 + 4 + p.max_rows) * sizeof(float);
      int fit = 0;
      if (bytes > 227 * 1024) continue;
      if ((err = tpa::allow_smem(kernel, static_cast<int>(bytes))) != cudaSuccess) return err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads,
                                                               static_cast<int>(bytes))) !=
          cudaSuccess)
        return err;
      if (fit >= per_sm) {
        blocks = G;
        smem = static_cast<int>(bytes);
        return cudaSuccess;
      }
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

template <typename W, typename C>
cudaError_t launch(Params& p, int work_floats, cudaStream_t stream) {
  int blocks = 0, smem = 0;
  cudaError_t err = plan<W, C>(p, blocks, smem);
  if (err != cudaSuccess) return err;
  if (work_floats < 6 * p.D + p.hidden + p.H * p.split * kPart + kCounters * p.H)
    return cudaErrorInvalidValue;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_whisper_step_kernel<W, C>), blocks, kThreads, args,
      static_cast<size_t>(smem), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename F>
cudaError_t dispatch(int w_int8, int cache_f32, F f) {
  if (w_int8) return cache_f32 ? f(int8_t{}, float{}) : f(int8_t{}, __nv_bfloat16{});
  return cache_f32 ? f(__nv_bfloat16{}, float{}) : f(__nv_bfloat16{}, __nv_bfloat16{});
}

}  // namespace

// See Params for the layouts. w_int8: weights int8 (else bf16); cache_f32:
// the self cache is f32 (else bf16). The caller checks shapes and dtypes.
extern "C" int tpa_fused_whisper_step(
    const void* x, int x_bf16, const long long* pos, const void* wq, const void* wk,
    const void* wv, const void* wo, const void* wqc, const void* woc, const void* w1,
    const void* w2, const float* sq, const float* sk, const float* sv, const float* so,
    const float* sqc, const float* soc, const float* s1, const float* s2, const float* bq,
    const float* bk, const float* bv, const float* bo, const float* bqc, const float* boc,
    const float* b1, const float* b2, const float* ln, const float* lnf, void* kc, void* vc,
    const int8_t* k8, const float* ksc, const int8_t* v8, const float* vsc, float* h,
    float* work, int work_floats, int w_int8, int cache_f32, int L, int D, int hidden, int H,
    int S, int t_pad, int t_valid, cudaStream_t stream) {
  if (D != H * HD || D % 16 || hidden % 16 || D > kMaxPer * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,  x_bf16, pos, {wq, wk, wv, wo, wqc, woc, w1, w2},
           {sq, sk, sv, so, sqc, soc, s1, s2}, {bq, bk, bv, bo, bqc, boc, b1, b2},
           ln, lnf, kc, vc, k8, ksc, v8, vsc, h, work, L, D, hidden, H, S, t_pad, t_valid,
           0, 0, 0, 0, 0};
  return static_cast<int>(dispatch(w_int8, cache_f32, [&](auto w, auto c) {
    return launch<decltype(w), decltype(c)>(p, work_floats, stream);
  }));
}

// The launch's shape for these sizes, without launching: out[0] blocks,
// out[1] key chunks a head, out[2] weight buffers, out[3] shared memory
// bytes of a block.
extern "C" int tpa_fused_whisper_step_plan(int w_int8, int cache_f32, int L, int D, int hidden,
                                           int H, int S, int t_pad, int* out,
                                           cudaStream_t /*unused*/) {
  Params p{};
  p.L = L, p.D = D, p.hidden = hidden, p.H = H, p.S = S, p.t_pad = t_pad;
  int blocks = 0, smem = 0;
  const cudaError_t err = dispatch(w_int8, cache_f32, [&](auto w, auto c) {
    return plan<decltype(w), decltype(c)>(p, blocks, smem);
  });
  out[0] = blocks, out[1] = p.split, out[2] = p.nbuf, out[3] = smem;
  return static_cast<int>(err);
}
