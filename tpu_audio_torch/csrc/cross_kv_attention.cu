// One-token cross-attention over int8 cross-K/V, one decoder layer.
//
// Replaces tpu_audio/ops/pallas/cross_kv_attention.py:cross_attention_decode.
//
// q (B, H, 64) f32; k8, v8 (L, B, T_pad, H*64) int8 with per-(batch,
// channel) f32 scales of layer `layer`. The K scale folds into q, so
// scores = sum_d (q_d * ks_d) * K8[t, d]; the V scale multiplies the output
// after the division by the softmax sum. Keys t >= t_valid (the padding
// of T up to T_pad) are never read.
//
// Bound on the H100: device-memory bytes. Per decode step and layer at
// large-v3-turbo batch 16 the kernel reads 2 x 16 x 1500 x 1280 = 61 MB of
// int8 K/V and does 2 FLOP per byte, far below the ~295 FLOP/byte ridge.
// Keeping 3.35 TB/s busy takes ~18 KB in flight an SM, and the arithmetic
// (a byte to f32, a multiply-add) must stay under the memory time: the
// conversion unit (I2F, 16 a cycle an SM) would take ~17 us for the 61 MB
// alone, so a byte becomes a float by a byte permute (decode_dot.cuh).
//
// Design: a cluster of kRanks blocks per (batch, head pair), each a chunk of
// ceil(t_valid / kRanks) keys, 128 threads. Eight lanes take a row's two
// heads (128 contiguous bytes: one head's 64 bytes a block read 0.87 times
// as fast) as 16-byte vectors, 32 rows a trip. Each lane copies its key and
// value vectors of a trip into its own slots of a shared-memory ring by
// cp.async, kStages - 1 trips ahead of the one it computes (4 * 160 blocks
// at batch 16, all resident), and keeps an online softmax (its row group's
// max, sum of exp and unnormalised P.V of its 16 channels, rescaled when
// the max grows), so that the value rows stream with the keys and no score
// is kept. The row groups merge their (max, sum, P.V) through shuffles and
// shared memory, and the ranks through distributed shared memory into rank
// 0, which divides by the sum and applies the V scale.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "decode_dot.cuh"
#include "hopper.cuh"

namespace hp = tpa::hopper;

namespace {

constexpr int HD = 64;
constexpr int kThreads = 128;
constexpr int kHeads = 2;                   // heads a block: a 128-byte row segment
constexpr int kRanks = 4;                   // blocks (key chunks) a (batch, head)
constexpr int kPart = 16;                   // int8 channels per lane (one int4)
constexpr int kRowLanes = kHeads * HD / kPart;  // 8 lanes a row's two heads
constexpr int kGroups = kThreads / kRowLanes;  // 16 rows a half trip, two a trip
constexpr int kStages = 4;                  // trips in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hp::smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// At most n of this thread's newest commit groups still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// A row group's online-softmax state: the max m, the sum of exp(s - m), and
// its channels' sum of exp(s - m) * v.
struct State {
  float m, l, acc[kPart];
};

// Merge b into a (both against their own max).
__device__ __forceinline__ void merge(State& a, const State& b) {
  const float m = fmaxf(a.m, b.m);
  const float wa = a.m == -INFINITY ? 0.f : expf(a.m - m);
  const float wb = b.m == -INFINITY ? 0.f : expf(b.m - m);
  a.l = a.l * wa + b.l * wb;
#pragma unroll
  for (int j = 0; j < kPart; ++j) a.acc[j] = a.acc[j] * wa + b.acc[j] * wb;
  a.m = m;
}

__device__ __forceinline__ State shfl_xor(const State& s, int mask) {
  State o;
  o.m = __shfl_xor_sync(0xffffffffu, s.m, mask);
  o.l = __shfl_xor_sync(0xffffffffu, s.l, mask);
#pragma unroll
  for (int j = 0; j < kPart; ++j) o.acc[j] = __shfl_xor_sync(0xffffffffu, s.acc[j], mask);
  return o;
}

__global__ void __launch_bounds__(kThreads)
cross_attention_decode_kernel(const float* __restrict__ q,       // (B, H, HD)
                              const int8_t* __restrict__ k8,     // (L, B, T_pad, D)
                              const int8_t* __restrict__ v8,
                              const float* __restrict__ k_scale,  // (B, D)
                              const float* __restrict__ v_scale,  // (B, D)
                              float* __restrict__ out,            // (B, H, HD)
                              int layer, int batch, int t_pad, int H, int t_valid) {
  // rank 0 receives every rank's (m, l, P.V[HD]) of both heads; a block's warps meet here
  __shared__ float slots[kRanks][kHeads][HD + 2];
  __shared__ State warps[kThreads / 32 - 1][kRowLanes];
  __shared__ int4 ring[kStages][4][kThreads];  // keys a, b, values a, b of a trip
  hp::cluster_arrive();  // this block runs; peers wait for it before storing into it

  const int D = H * HD;
  const int pairs = H / kHeads;
  const int rank = blockIdx.x, b = blockIdx.y / pairs, h0 = blockIdx.y % pairs * kHeads;
  const int tid = threadIdx.x, part = tid % kRowLanes, grp = tid / kRowLanes;
  const int bh = b * H + h0 + part / 4;  // this lane's (batch, head)
  const long base = ((static_cast<long>(layer) * batch + b) * t_pad) * D + h0 * HD + part * kPart;
  const int cs = (t_valid + kRanks - 1) / kRanks;
  const int t0 = min(t_valid, rank * cs), t1 = min(t_valid, t0 + cs);

  float qr[kPart];
#pragma unroll
  for (int j = 0; j < kPart; ++j)
    qr[j] = q[static_cast<long>(bh) * HD + (part % 4) * kPart + j] *
            k_scale[static_cast<long>(b) * D + h0 * HD + part * kPart + j];

  // the key and value rows of a trip: a ring of kStages trips, each lane's
  // own four 16-byte slots, copied by cp.async kStages - 1 trips ahead
  const int trips = (t1 - t0 + 2 * kGroups - 1) / (2 * kGroups);
  auto issue = [&](int i) {
    if (i < trips) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + i * 2 * kGroups + r * kGroups + grp;
        if (t < t1) {
          cp_async16(&ring[i % kStages][r][tid], k8 + base + static_cast<long>(t) * D);
          cp_async16(&ring[i % kStages][2 + r][tid], v8 + base + static_cast<long>(t) * D);
        }
      }
    }
    cp_async_commit();  // an empty group past the last trip keeps the count
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  State st;
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int j = 0; j < kPart; ++j) st.acc[j] = 0.f;
  // every lane runs the same trip count, so the shuffles see a full warp
  for (int i = 0; i < trips; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int ta = t0 + i * 2 * kGroups + grp, tb = ta + kGroups;
    const bool va = ta < t1, vb = tb < t1;
    float f[kPart];
    float sa = 0.f, sb = 0.f;
    tpa::dec::load_f32<int8_t, kPart>(reinterpret_cast<const int8_t*>(&ring[i % kStages][0][tid]), f);
#pragma unroll
    for (int j = 0; j < kPart; ++j) sa = fmaf(qr[j], f[j], sa);
    tpa::dec::load_f32<int8_t, kPart>(reinterpret_cast<const int8_t*>(&ring[i % kStages][1][tid]), f);
#pragma unroll
    for (int j = 0; j < kPart; ++j) sb = fmaf(qr[j], f[j], sb);
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    const float mn = fmaxf(st.m, fmaxf(va ? sa : -INFINITY, vb ? sb : -INFINITY));
    if (mn > st.m) {  // the max grew: rescale what is summed so far
      const float r = st.m == -INFINITY ? 0.f : expf(st.m - mn);
      st.l *= r;
#pragma unroll
      for (int j = 0; j < kPart; ++j) st.acc[j] *= r;
      st.m = mn;
    }
    const float pa = va ? expf(sa - st.m) : 0.f, pb = vb ? expf(sb - st.m) : 0.f;
    st.l += pa + pb;
    tpa::dec::load_f32<int8_t, kPart>(reinterpret_cast<const int8_t*>(&ring[i % kStages][2][tid]), f);
#pragma unroll
    for (int j = 0; j < kPart; ++j) st.acc[j] = fmaf(pa, f[j], st.acc[j]);
    tpa::dec::load_f32<int8_t, kPart>(reinterpret_cast<const int8_t*>(&ring[i % kStages][3][tid]), f);
#pragma unroll
    for (int j = 0; j < kPart; ++j) st.acc[j] = fmaf(pb, f[j], st.acc[j]);
  }
  // the row groups of a warp (lanes with the same part), then the two warps
  for (int mask = kRowLanes; mask < 32; mask <<= 1) merge(st, shfl_xor(st, mask));
  if (tid >= 32 && (tid & 31) < kRowLanes) warps[tid / 32 - 1][part] = st;
  __syncthreads();
  hp::cluster_wait();  // every block of the cluster runs
  if (tid < kRowLanes) {
    for (int w = 0; w < kThreads / 32 - 1; ++w) merge(st, warps[w][part]);
#pragma unroll
    for (int j = 0; j < kPart; ++j)
      hp::st_peer(&slots[rank][part / 4][2 + (part % 4) * kPart + j], 0, st.acc[j]);
    if (part % 4 == 0) {
      hp::st_peer(&slots[rank][part / 4][0], 0, st.m);
      hp::st_peer(&slots[rank][part / 4][1], 0, st.l);
    }
  }
  hp::cluster_arrive();
  hp::cluster_wait();
  if (rank != 0) return;
  for (int i = tid; i < kHeads * HD; i += kThreads) {
    const int hh = i / HD, j = i % HD;
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRanks; ++r) m = fmaxf(m, slots[r][hh][0]);
    float l = 0.f, s = 0.f;
#pragma unroll
    for (int r = 0; r < kRanks; ++r) {
      const float w = slots[r][hh][0] == -INFINITY ? 0.f : expf(slots[r][hh][0] - m);
      l = fmaf(slots[r][hh][1], w, l);
      s = fmaf(slots[r][hh][2 + j], w, s);
    }
    const long o = static_cast<long>(b) * D + (h0 + hh) * HD + j;
    out[(static_cast<long>(b) * H + h0 + hh) * HD + j] = s / l * v_scale[o];
  }
}

}  // namespace

extern "C" int tpa_cross_attention_decode(const float* q, const int8_t* k8, const int8_t* v8,
                                          const float* k_scale, const float* v_scale,
                                          float* out, int layer, int batch, int t_pad, int H,
                                          int t_valid, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kRanks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  if (H % kHeads) return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = dim3(kRanks, batch * H / kHeads, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cross_attention_decode_kernel, q, k8, v8,
                                             k_scale, v_scale, out, layer, batch, t_pad, H,
                                             t_valid);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
