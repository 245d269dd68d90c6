// The whole Llama / Qwen2 / Qwen3 decoder stack for one token at B=1, all
// layers, in one cooperative launch.
//
// Replaces tpu_audio/ops/pallas/fused_step.py:fused_decode_step.
//
// Bound on the H100: device-memory bytes once the launches are gone. The
// per-layer path issues some 20 small launches a layer; this is one a step.
// At Qwen3-0.6B a step reads 880.8 MB of bf16 layer weights (440.4 MB
// int8) plus the cache rows [start, pos): ~0.263 ms (0.131 ms) at 3.35 TB/s.
//
// Design. The blocks are co-resident (cudaLaunchCooperativeKernel, the
// count from the occupancy API) and cooperative_groups' grid sync separates
// the dependent phases of each layer:
//   P1 RMSNorm ln1 (every block, into shared memory) -> the fused qkv
//      product, x the per-channel scale, + the optional bias;
//   P2 attention pass 1: query head h's keys [start, pos) split over
//      `split` blocks. Each block normalises (Qwen3 q/k RMS) and rotates
//      (half-split RoPE from the supplied cos/sin) its q head and its KV
//      head (j // (H / KVH)) itself, keeps its chunk's scores in shared
//      memory and writes their max and sum of exp; chunk 0 of the first
//      query head of each KV head writes the new k/v slot at `pos`;
//   P3 pass 2: the head's softmax over the chunks and the current token's
//      fresh score q.k, the probabilities rounded to the activation dtype
//      (as the reference rounds them before the value product), P.V;
//   P4 every block sums the chunks' P.V plus the fresh term -> o-projection
//      + residual;   P5 RMSNorm ln2 -> gate and up;   P6 silu(gate) * up ->
//      down + residual;
// and after the last layer block 0 writes the final RMSNorm. A product gives
// each warp whole output channels; its lanes stream the weight row as
// 16-byte vectors (cache-streaming loads) against the f32 input vector in
// shared memory. Weights are int8 with a per-channel f32 scale applied to
// the dot's output (W8A16: codes cast to the activation type, activations
// not quantised) or bf16 with scale 1. With bf16 activations the normed
// input, the attention output and the SwiGLU activation are rounded to bf16
// before their products, as the TPU kernel rounds to its compute dtype.
// Sums are f32.
//
// Data written during the launch (the residual, qkv, gate/up, partials) is
// read after a grid sync with __ldcg, from L2, so that no SM's L1 can hand
// back a stale line; only the weights and the cache rows < pos, which no
// block writes, go through the read-only path.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tpa::step;

constexpr int kMaxSplit = 32;  // key chunks per head (one lane each when merging)
constexpr int kBlocksPerSm = 2;

struct Params {
  const void* x;
  int x_bf16;
  const long long* pos;
  const long long* start;
  const float* cos;      // (hd)
  const float* sin;
  const void* wqkv;      // (L, QO, D) int8 or bf16, QO = (H + 2 KVH) hd
  const float* sqkv;     // (L, QO)
  const float* bqkv;     // (L, QO) or null
  const float* qknorm;   // (L, 2, hd) or null
  const void* wo;        // (L, D, H hd)
  const float* so;       // (L, D)
  const void* wgu;       // (L, 2 hidden, D): gate rows, then up rows
  const float* sgu;      // (L, 2 hidden)
  const void* wd;        // (L, D, hidden)
  const float* sd;       // (L, D)
  const float* ln1;      // (L, D)
  const float* ln2;
  const float* norm;     // (D)
  __nv_bfloat16* kc;     // (L, KVH, S, hd)
  __nv_bfloat16* vc;
  float* h;              // (D)
  float* work;
  float eps;
  int L, D, hidden, H, KVH, S, split;
};

// RMSNorm of the D-vector x (global, written in this launch) with weight w
// into `out` (shared memory), rounded to bf16 when `rb`. The whole block.
__device__ void rms_norm(const float* x, const float* w, int D, float eps, float* out, bool rb,
                         float* scratch) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = __ldcg(x + i);
    s = fmaf(v, v, s);
  }
  const float r = rsqrtf(tpa::block_sum<kWarps>(s, scratch) / D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float y = __ldcg(x + i) * r * w[i];
    out[i] = rb ? round_bf16(y) : y;
  }
  __syncthreads();
}

// One head of HD raw projection outputs `src` (global) -> `dst` (shared):
// the optional per-head RMS with weight nw, then the half-split rotation
// with cos/sin, times `scale`. The whole block; HD <= kThreads.
template <int HD>
__device__ void norm_rope(const float* src, const float* nw, float eps, const float* cos,
                          const float* sin, float scale, float* tmp, float* dst, float* scratch) {
  const int d = threadIdx.x;
  const float v = d < HD ? __ldcg(src + d) : 0.f;
  float r = 1.f;
  if (nw != nullptr) r = rsqrtf(tpa::block_sum<kWarps>(v * v, scratch) / HD + eps);
  if (d < HD) tmp[d] = nw != nullptr ? v * r * nw[d] : v;
  __syncthreads();
  if (d < HD) {
    const float rot = d < HD / 2 ? -tmp[d + HD / 2] : tmp[d - HD / 2];
    dst[d] = (tmp[d] * cos[d] + rot * sin[d]) * scale;
  }
  __syncthreads();
}

template <typename W, int HD>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, H = p.H, KVH = p.KVH, hidden = p.hidden, split = p.split;
  const int G = H / KVH, HH = H * HD, QO = (H + 2 * KVH) * HD;
  constexpr int kPart = HD + 2;  // a partial: max, sum, P.V[HD]
  const int amax = hidden > D ? (hidden > HH ? hidden : HH) : (D > HH ? D : HH);
  extern __shared__ float smem[];
  float* a = smem;                    // amax: product input
  float* qh = a + amax;               // HD: this block's rotated, scaled query head
  float* kh = qh + HD;                // HD: its rotated key head
  float* tmp = kh + HD;               // HD
  float* red = tmp + HD;              // kThreads * 8
  float* scratch = red + kThreads * 8;  // 32
  float* scores = scratch + 32;       // S
  float* stats = scratch + 30;        // 2: one head's max and sum (block_sum uses 8)

  float* xg = p.work;                 // residual (D)
  float* qkv = xg + D;                // raw qkv (QO)
  float* gu = qkv + QO;               // raw gate, up (2 hidden)
  float* fresh = gu + 2 * hidden;     // H: fresh-term weight of each head
  float* part = fresh + H;            // H x split x kPart

  const int pos = static_cast<int>(*p.pos);
  const int start = static_cast<int>(*p.start);
  const bool rb = p.x_bf16 != 0;
  const bool attn_block = blockIdx.x < H * split;
  const int head = blockIdx.x / split, chunk = blockIdx.x % split, kvh = head / G;
  const float qscale = rsqrtf(static_cast<float>(HD));
  auto wrow = [&](const void* w, int l, int out, int in, int o) {
    return static_cast<const W*>(w) + (static_cast<long>(l) * out + o) * in;
  };

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < D; i += gridDim.x * kThreads)
    xg[i] = rb ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i])
               : static_cast<const float*>(p.x)[i];
  grid.sync();

  const int n_hist = pos > start ? pos - start : 0;
  const int cs = (n_hist + split - 1) / split;
  const int s0 = start + min(n_hist, chunk * cs), s1 = start + min(n_hist, (chunk + 1) * cs);

  for (int l = 0; l < p.L; ++l) {
    const long lD = static_cast<long>(l) * D;
    // P1: ln1 -> qkv, scale, bias
    rms_norm(xg, p.ln1 + lD, D, p.eps, a, rb, scratch);
    const long lQ = static_cast<long>(l) * QO;
    gemv<W>(QO, D, a, [&](int o) { return wrow(p.wqkv, l, QO, D, o); },
            [&](int o, float acc) {
              qkv[o] = acc * p.sqkv[lQ + o] + (p.bqkv != nullptr ? p.bqkv[lQ + o] : 0.f);
            });
    grid.sync();
    // P2: attention pass 1 over this block's chunk of [start, pos)
    const long cbase = ((static_cast<long>(l) * KVH + kvh) * p.S) * HD;
    float* my_part = part + (head * split + chunk) * kPart;
    if (attn_block) {
      const float* qn = p.qknorm != nullptr ? p.qknorm + l * 2 * HD : nullptr;
      norm_rope<HD>(qkv + head * HD, qn, p.eps, p.cos, p.sin, qscale, tmp, qh, scratch);
      norm_rope<HD>(qkv + HH + kvh * HD, qn != nullptr ? qn + HD : nullptr, p.eps, p.cos, p.sin,
                    1.f, tmp, kh, scratch);
      if (chunk == 0 && head % G == 0 && threadIdx.x < HD) {  // the new slot
        p.kc[cbase + static_cast<long>(pos) * HD + threadIdx.x] = __float2bfloat16(kh[threadIdx.x]);
        p.vc[cbase + static_cast<long>(pos) * HD + threadIdx.x] =
            __float2bfloat16(__ldcg(qkv + HH + KVH * HD + kvh * HD + threadIdx.x));
      }
      attn_scores<__nv_bfloat16, HD>(p.kc + cbase, HD, s0, s1, qh, scores, my_part, scratch);
    }
    grid.sync();
    // P3: pass 2 with the fresh score -> the chunk's P.V
    if (attn_block) {
      if (threadIdx.x < 32) {
        float sf = 0.f;
        for (int d = threadIdx.x; d < HD; d += 32) sf = fmaf(qh[d], kh[d], sf);
        sf = tpa::warp_sum(sf);
        const float2 ml = head_stats(part + head * split * kPart, split, kPart, sf);
        if (threadIdx.x == 0) {
          stats[0] = ml.x;
          stats[1] = ml.y;
          if (chunk == 0) fresh[head] = expf(sf - ml.x) / ml.y;
        }
      }
      __syncthreads();
      attn_values<__nv_bfloat16, HD>(p.vc + cbase, HD, s0, s1, make_float2(stats[0], stats[1]),
                                      rb, scores, red, my_part);
    }
    grid.sync();
    // P4: merge with the fresh term -> o-projection + residual
    for (int d = threadIdx.x; d < HH; d += kThreads) {
      const int hh = d / HD, j = d % HD;
      float s = 0.f;
      for (int i = 0; i < split; ++i) s += __ldcg(part + (hh * split + i) * kPart + 2 + j);
      s = fmaf(__ldcg(fresh + hh), __ldcg(qkv + HH + KVH * HD + (hh / G) * HD + j), s);
      a[d] = rb ? round_bf16(s) : s;
    }
    __syncthreads();
    gemv<W>(D, HH, a, [&](int o) { return wrow(p.wo, l, D, HH, o); },
            [&](int o, float acc) { xg[o] = __ldcg(xg + o) + acc * p.so[lD + o]; });
    grid.sync();
    // P5: ln2 -> gate, up
    rms_norm(xg, p.ln2 + lD, D, p.eps, a, rb, scratch);
    const long lG = static_cast<long>(l) * 2 * hidden;
    gemv<W>(2 * hidden, D, a, [&](int o) { return wrow(p.wgu, l, 2 * hidden, D, o); },
            [&](int o, float acc) { gu[o] = acc * p.sgu[lG + o]; });
    grid.sync();
    // P6: silu(gate) * up -> down + residual
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      const float g = __ldcg(gu + i), u = __ldcg(gu + hidden + i);
      const float act = g / (1.f + expf(-g)) * u;
      a[i] = rb ? round_bf16(act) : act;
    }
    __syncthreads();
    gemv<W>(D, hidden, a, [&](int o) { return wrow(p.wd, l, D, hidden, o); },
            [&](int o, float acc) { xg[o] = __ldcg(xg + o) + acc * p.sd[lD + o]; });
    grid.sync();
  }
  if (blockIdx.x == 0) {
    rms_norm(xg, p.norm, D, p.eps, a, false, scratch);
    for (int i = threadIdx.x; i < D; i += kThreads) p.h[i] = a[i];
  }
}

template <typename W, int HD>
cudaError_t launch(Params& p, int work_floats, cudaStream_t stream) {
  auto kernel = fused_step_kernel<W, HD>;
  const int hh = p.H * HD;
  const int amax = p.hidden > p.D ? (p.hidden > hh ? p.hidden : hh) : (p.D > hh ? p.D : hh);
  const int smem = (amax + 3 * HD + kThreads * 8 + 32 + p.S) * static_cast<int>(sizeof(float));
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
  const int need = p.D + (p.H + 2 * p.KVH) * HD + 2 * p.hidden + p.H + p.H * p.split * (HD + 2);
  if (work_floats < need) return cudaErrorInvalidValue;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), blocks, kThreads, args,
                                    smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  if (H % KVH || D % 16 || hidden % 16 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,  x_bf16, pos, start, cos, sin, wqkv, sqkv, bqkv, qknorm, wo, so, wgu, sgu, wd, sd,
           ln1, ln2, norm, static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), h,
           work, eps, L, D, hidden, H, KVH, S, 0};
  cudaError_t err;
  if (hd == 128)
    err = w_int8 ? launch<int8_t, 128>(p, work_floats, stream)
                 : launch<__nv_bfloat16, 128>(p, work_floats, stream);
  else
    err = w_int8 ? launch<int8_t, 64>(p, work_floats, stream)
                 : launch<__nv_bfloat16, 64>(p, work_floats, stream);
  return static_cast<int>(err);
}
