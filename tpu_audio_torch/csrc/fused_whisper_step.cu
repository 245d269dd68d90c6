// The whole Whisper decoder step at B=1, T=1, all layers, in one
// cooperative launch.
//
// Replaces tpu_audio/ops/pallas/fused_whisper_step.py:fused_whisper_decode_step.
//
// Bound on the H100: launch issue first. The per-layer path costs ~150
// launches a step; this is one. Then device-memory bytes: at large-v3-turbo
// a step reads 91.8 MB of int8 decoder weights, 15.4 MB of int8 cross-K/V
// and <= 9.2 MB of bf16 self cache, ~35 us at 3.35 TB/s.
//
// Design. The blocks are co-resident (cudaLaunchCooperativeKernel, the
// count from the occupancy API) and cooperative_groups' grid sync separates
// the dependent phases of each layer:
//   P1 LN1 (every block, into shared memory) -> q, k, v products; k and v
//      of the current token go to the cache slot `pos` in place;
//   P2 self-attention: head h's positions < pos split over `split`
//      blocks; pass 1 keeps a chunk's scores in shared memory and writes
//      their max and sum of exp, and after a grid sync pass 2 combines the
//      head's chunks and the current token's own score into the softmax
//      max and sum, normalises the probabilities (rounded to bf16 with
//      bf16 activations, as the reference does) and writes P.V;
//   P3 every block sums the chunks' P.V plus the fresh term of the current
//      token -> o-projection + residual;
//   P4 LN -> cross-q, K scale folded in;   P5 cross-attention over the
//      t_valid int8 keys, the same two passes;   P6 sum, V scale ->
//      cross-o + residual;
//   P7 LN2 -> fc1 + erf-GELU;   P8 fc2 + residual;
// and after the last layer block 0 writes the final LN. A product gives
// each warp whole output channels; its lanes stream the weight row as
// 16-byte vectors (cache-streaming loads) against the f32 input vector in
// shared memory. Weights are int8 with a per-channel f32 scale or bf16
// (scale 1); the LN output, the attention outputs and the GELU output are
// rounded to bf16 before a product when the activations are bf16, as the
// TPU kernel rounds to its compute dtype. Sums are f32.
//
// Data written during the launch (the residual, q/k/v, partials, the
// fc1 output) is read after a grid sync with __ldcg, from L2, so that no
// SM's L1 can hand back a stale line; only the weights and the cache rows
// < pos, which no block writes, go through the read-only path.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpa::step;

constexpr int HD = 64;
constexpr int kMaxSplit = 32;      // key chunks per head (one lane each when merging)
constexpr int kBlocksPerSm = 2;
constexpr int kPart = HD + 2;      // a partial: max, sum, P.V[64]
constexpr float kScale = 0.35355339059327373f;  // 64^-0.25
enum { Q, K, V, O, QC, OC, FC1, FC2, kMats };

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
  int L, D, hidden, H, S, t_pad, t_valid, split;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// LayerNorm of the D-vector x (global) with wb = (weight, bias) into
// `out` (shared memory), rounded to bf16 when `rb`. Called by the whole block.
__device__ void layer_norm(const float* x, const float* wb, int D, float* out, bool rb,
                           float* scratch) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) s += __ldcg(x + i);
  const float mean = tpa::block_sum<kWarps>(s, scratch) / D;
  float v = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = __ldcg(x + i) - mean;
    v = fmaf(c, c, v);
  }
  const float r = rsqrtf(tpa::block_sum<kWarps>(v, scratch) / D + 1e-5f);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float y = (__ldcg(x + i) - mean) * r * wb[i] + wb[D + i];
    out[i] = rb ? round_bf16(y) : y;
  }
  __syncthreads();
}

// The fresh score q.k of head h, by a whole warp.
__device__ float fresh_score(const float* q, const float* k, int h) {
  const int lane = threadIdx.x & 31;
  return tpa::warp_sum(__ldcg(q + h * HD + lane) * __ldcg(k + h * HD + lane) +
                       __ldcg(q + h * HD + lane + 32) * __ldcg(k + h * HD + lane + 32));
}

// The attention output of every head into out (shared, D): the sum of its
// chunks' P.V and, for self-attention (q != null), the fresh term
// exp(sf - m) / l * v, times vscale when given, rounded to bf16 when `rb`.
__device__ void merge(const float* part, int H, int split, const float* q, const float* k,
                      const float* v, const float* vscale, bool rb, float* fresh, float* out,
                      int D) {
  for (int h = threadIdx.x >> 5; h < H; h += kWarps) {
    if (q == nullptr) break;
    const float sf = fresh_score(q, k, h);
    const float2 ml = head_stats(part + h * split * kPart, split, kPart, sf);
    if ((threadIdx.x & 31) == 0) fresh[h] = expf(sf - ml.x) / ml.y;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int h = d / HD, j = d % HD;
    float s = 0.f;
    for (int i = 0; i < split; ++i) s += __ldcg(part + (h * split + i) * kPart + 2 + j);
    if (q != nullptr) s = fmaf(fresh[h], __ldcg(v + d), s);
    if (vscale != nullptr) s *= vscale[d];
    out[d] = rb ? round_bf16(s) : s;
  }
  __syncthreads();
}

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads) fused_whisper_step_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, H = p.H, hidden = p.hidden, split = p.split;
  extern __shared__ float smem[];
  float* a = smem;                                  // max(D, hidden): product input
  float* qh = a + (hidden > D ? hidden : D);        // 64: one head's query
  float* scores = qh + HD;                          // max(S, t_pad)
  float* red = scores + (p.S > p.t_pad ? p.S : p.t_pad);  // 64 x 64
  float2* stats = reinterpret_cast<float2*>(red + HD * HD);  // 1: a head's max, sum
  float* fresh = red + HD * HD + 2;                 // H: weights of the fresh terms
  float* scratch = fresh + H;                       // 32

  float* xg = p.work;                               // residual (D)
  float* qg = xg + D;
  float* kg = qg + D;
  float* vg = kg + D;
  float* qsg = vg + D;                              // cross-q, K scale folded in
  float* act = qsg + D;                             // fc1 output (hidden)
  float* part = act + hidden;                       // H x split x kPart

  const int pos = static_cast<int>(*p.pos);
  const bool rb = p.x_bf16 != 0;
  const bool attn_block = blockIdx.x < H * split;
  const int head = blockIdx.x / split, chunk = blockIdx.x % split;
  C* kc = static_cast<C*>(p.kc);
  C* vc = static_cast<C*>(p.vc);
  auto sc = [&](int m, long i) { return p.s[m] != nullptr ? p.s[m][i] : 1.f; };
  auto bi = [&](int m, long i) { return p.b[m] != nullptr ? p.b[m][i] : 0.f; };
  auto wrow = [&](int m, int l, int out, int in, int o) {
    return static_cast<const W*>(p.w[m]) + (static_cast<long>(l) * out + o) * in;
  };

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < D; i += gridDim.x * kThreads)
    xg[i] = rb ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i])
               : static_cast<const float*>(p.x)[i];
  grid.sync();

  for (int l = 0; l < p.L; ++l) {
    const long lD = static_cast<long>(l) * D;
    // P1: LN1 -> q, k, v; the slot of the current token
    layer_norm(xg, p.ln + (l * 3 + 0) * 2 * D, D, a, rb, scratch);
    gemv<W>(3 * D, D, a, [&](int o) { return wrow(o / D, l, D, D, o % D); },
            [&](int o, float acc) {
              const int m = o / D, c = o % D;
              const float y = acc * sc(m, lD + c) + bi(m, lD + c);
              if (m == Q) {
                qg[c] = y * kScale;
              } else if (m == K) {
                kg[c] = y * kScale;
                store(kc + (static_cast<long>(l) * p.S + pos) * D + c, y * kScale);
              } else {
                vg[c] = y;
                store(vc + (static_cast<long>(l) * p.S + pos) * D + c, y);
              }
            });
    grid.sync();
    // P2: self-attention over the positions < pos, in two passes: the
    // chunk scores and their max and sum, then the normalised P.V
    const int cs = (pos + split - 1) / split;
    const int s0 = min(pos, chunk * cs), s1 = min(pos, s0 + cs);
    const long sbase = static_cast<long>(l) * p.S * D + head * HD;
    float* my_part = part + (head * split + chunk) * kPart;
    if (attn_block) {
      if (threadIdx.x < HD) qh[threadIdx.x] = __ldcg(qg + head * HD + threadIdx.x);
      __syncthreads();
      attn_scores<C, HD>(kc + sbase, D, s0, s1, qh, scores, my_part, scratch);
    }
    grid.sync();
    if (attn_block) {
      if (threadIdx.x < 32) {
        const float2 ml = head_stats(part + head * split * kPart, split, kPart,
                                     fresh_score(qg, kg, head));
        if (threadIdx.x == 0) stats[0] = ml;
      }
      __syncthreads();
      attn_values<C, HD>(vc + sbase, D, s0, s1, stats[0], rb, scores, red, my_part);
    }
    grid.sync();
    // P3: merge with the fresh term -> o-projection + residual
    merge(part, H, split, qg, kg, vg, nullptr, rb, fresh, a, D);
    gemv<W>(D, D, a, [&](int o) { return wrow(O, l, D, D, o); },
            [&](int o, float acc) { xg[o] = __ldcg(xg + o) + acc * sc(O, lD + o) + bi(O, lD + o); });
    grid.sync();
    // P4: LN -> cross-q with the K scale folded in
    layer_norm(xg, p.ln + (l * 3 + 1) * 2 * D, D, a, rb, scratch);
    gemv<W>(D, D, a, [&](int o) { return wrow(QC, l, D, D, o); },
            [&](int o, float acc) {
              qsg[o] = (acc * sc(QC, lD + o) + bi(QC, lD + o)) * kScale * p.ksc[lD + o];
            });
    grid.sync();
    // P5: cross-attention over the t_valid int8 keys, the same two passes
    const int ct = (p.t_valid + split - 1) / split;
    const int c0 = min(p.t_valid, chunk * ct), c1 = min(p.t_valid, c0 + ct);
    const long cbase = static_cast<long>(l) * p.t_pad * D + head * HD;
    if (attn_block) {
      if (threadIdx.x < HD) qh[threadIdx.x] = __ldcg(qsg + head * HD + threadIdx.x);
      __syncthreads();
      attn_scores<int8_t, HD>(p.k8 + cbase, D, c0, c1, qh, scores, my_part, scratch);
    }
    grid.sync();
    if (attn_block) {
      if (threadIdx.x < 32) {
        const float2 ml = head_stats(part + head * split * kPart, split, kPart, -INFINITY);
        if (threadIdx.x == 0) stats[0] = ml;
      }
      __syncthreads();
      attn_values<int8_t, HD>(p.v8 + cbase, D, c0, c1, stats[0], rb, scores, red, my_part);
    }
    grid.sync();
    // P6: merge, V scale -> cross-o + residual
    merge(part, H, split, nullptr, nullptr, nullptr, p.vsc + lD, rb, fresh, a, D);
    gemv<W>(D, D, a, [&](int o) { return wrow(OC, l, D, D, o); },
            [&](int o, float acc) { xg[o] = __ldcg(xg + o) + acc * sc(OC, lD + o) + bi(OC, lD + o); });
    grid.sync();
    // P7: LN2 -> fc1 + erf-GELU
    layer_norm(xg, p.ln + (l * 3 + 2) * 2 * D, D, a, rb, scratch);
    const long lH = static_cast<long>(l) * hidden;
    gemv<W>(hidden, D, a, [&](int o) { return wrow(FC1, l, hidden, D, o); },
            [&](int o, float acc) {
              const float y = acc * sc(FC1, lH + o) + bi(FC1, lH + o);
              const float g = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
              act[o] = rb ? round_bf16(g) : g;
            });
    grid.sync();
    // P8: fc2 + residual
    for (int i = threadIdx.x; i < hidden; i += kThreads) a[i] = __ldcg(act + i);
    __syncthreads();
    gemv<W>(D, hidden, a, [&](int o) { return wrow(FC2, l, D, hidden, o); },
            [&](int o, float acc) { xg[o] = __ldcg(xg + o) + acc * sc(FC2, lD + o) + bi(FC2, lD + o); });
    grid.sync();
  }
  if (blockIdx.x == 0) {
    layer_norm(xg, p.lnf, D, a, false, scratch);
    for (int i = threadIdx.x; i < D; i += kThreads) p.h[i] = a[i];
  }
}

template <typename W, typename C>
cudaError_t launch(Params& p, int work_floats, cudaStream_t stream) {
  auto kernel = fused_whisper_step_kernel<W, C>;
  const int smem = ((p.hidden > p.D ? p.hidden : p.D) + HD + (p.S > p.t_pad ? p.S : p.t_pad) +
                    HD * HD + p.H + 32 + 2) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = tpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const int blocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  p.split = blocks / p.H < kMaxSplit ? blocks / p.H : kMaxSplit;
  if (p.split < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (work_floats < 5 * p.D + p.hidden + p.H * p.split * kPart) return cudaErrorInvalidValue;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), blocks, kThreads, args,
                                    smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  if (D != H * HD || D % 16 || hidden % 16) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,  x_bf16, pos, {wq, wk, wv, wo, wqc, woc, w1, w2},
           {sq, sk, sv, so, sqc, soc, s1, s2}, {bq, bk, bv, bo, bqc, boc, b1, b2},
           ln, lnf, kc, vc, k8, ksc, v8, vsc, h, work, L, D, hidden, H, S, t_pad, t_valid, 0};
  cudaError_t err;
  if (w_int8)
    err = cache_f32 ? launch<int8_t, float>(p, work_floats, stream)
                    : launch<int8_t, __nv_bfloat16>(p, work_floats, stream);
  else
    err = cache_f32 ? launch<__nv_bfloat16, float>(p, work_floats, stream)
                    : launch<__nv_bfloat16, __nv_bfloat16>(p, work_floats, stream);
  return static_cast<int>(err);
}
