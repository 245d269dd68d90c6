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
//   pair:  low = q (group 2p), high = (q - 8) mod 16 (group 2p+1), q in
//          [0, 16), f32 scale s and bias b per group of 64:
//          y = sx * sum_g s[o,g] (xq.q)_g + sum_g b[o,g] sum_{i in g} x_i.
//   sg:    low = c + 8, high = c, c in [-8, 7], one f32 scale S per 256
//          columns: y = sx * sum_s S[o,s] (xq.c)_s.
//
// Bound on the H100: device-memory bytes. Each weight byte is used once per
// activation row (<= 8 rows a pass), far below the ~295 op/byte ridge; the
// Llama-3.2-3B tied head streams 241 MB of codes + 61.6 MB of group scales
// and biases per call.
//
// Design: kernel 1 quantises each activation row (one block per row; s =
// max|x| / 127 with floor 1e-10, q = clip(rint(x / s), -127, 127), round
// half to even as torch.round) and writes, per group of 64 columns, the f32
// sum of x and the int sum of the codes. Kernel 2 stages the codes in
// shared memory transposed to [row][word of the pair][pair], so that lane p
// reads its own pair's words without bank conflicts, with the group sums.
// Each warp owns kOut output channels; each lane one group pair p at a time
// (64 packed bytes: four 16-byte cache-streaming loads per channel, the
// kOut channels' loads in flight together). Two AND masks split a word into
// its nibble planes as int8 lanes: lo = w & 0x0F, hi16 = w & 0xF0 (16x the
// signed high nibble); __dp4a dots them with the codes of the two planes.
// The high plane's sum is exact in 16ths (>> 4 is exact), and the stored
// biases fold back in integers before any scale: pair + 8 * (sum of the
// group's codes) on the high plane, sg - 8 * sum on the low plane. A pair
// layout lane then applies its two group scales and the two bias terms; the
// two lanes of an sg super-group (pairs 2s, 2s+1 sit in adjacent lanes)
// add their integer dots by one shuffle before the super-group scale. The
// epilogue writes warp_sum(acc) * sx[b] (+ warp_sum of the bias terms).
// Channels past O are never read, so any O works. Rows run in passes of at
// most 8, so the shared tile stays under 80 KB at I = 8192.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kGroup = 64;
constexpr int kMaxRowsPerPass = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
w4a8_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                 float* __restrict__ xsum, int* __restrict__ xqs, int I) {
  __shared__ float scratch[kWarps];
  const long base = static_cast<long>(blockIdx.x) * I;
  float m = 0.f;
  for (int i = threadIdx.x; i < I; i += kThreads) m = fmaxf(m, fabsf(tpa::to_float(x[base + i])));
  m = tpa::block_max<kWarps>(m, scratch);
  const float s = fmaxf(m / 127.0f, 1e-10f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = I / kGroup;
  for (int g = warp; g < G; g += kWarps) {
    float fs = 0.f;
    int qs = 0;
    for (int j = lane; j < kGroup; j += 32) {
      const long idx = base + g * kGroup + j;
      const float v = tpa::to_float(x[idx]);
      const int q = static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
      xq[idx] = static_cast<int8_t>(q);
      fs += v;
      qs += q;
    }
    fs = tpa::warp_sum(fs);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) qs += __shfl_xor_sync(kFull, qs, o);
    if (lane == 0) {
      xsum[static_cast<long>(blockIdx.x) * G + g] = fs;
      xqs[static_cast<long>(blockIdx.x) * G + g] = qs;
    }
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

__device__ __forceinline__ int word_of(const int4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// kRows activation rows (B <= kRows; rows B.. are zero), kOut channels a warp.
template <bool SG, int kRows, int kOut>
__global__ void __launch_bounds__(kThreads)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const float* __restrict__ xsum, const int* __restrict__ xqs,
                 const int8_t* __restrict__ w, const float* __restrict__ scales,
                 const float* __restrict__ biases, float* __restrict__ out, int B, int I, int O) {
  extern __shared__ int smem[];
  const int P = I / 128, G = I / kGroup, NS = I / 256, words = I / 4;
  const int ps = P | 1;  // odd stride between a pair's words: no bank conflicts
  int* xs = smem;                                                   // [kRows][32][ps]
  float* fsum = reinterpret_cast<float*>(xs + kRows * 32 * ps);     // [kRows][G]
  int* qsum = reinterpret_cast<int*>(fsum + kRows * G);             // [kRows][G]
  for (int e = threadIdx.x; e < kRows * words; e += kThreads) {
    const int b = e / words, n = e % words;  // word n of a row: pair n / 32, word n % 32
    xs[(b * 32 + (n & 31)) * ps + (n >> 5)] =
        b < B ? reinterpret_cast<const int*>(xq)[static_cast<long>(b) * words + n] : 0;
  }
  for (int e = threadIdx.x; e < kRows * G; e += kThreads) {
    const bool live = e / G < B;
    fsum[e] = live ? xsum[e] : 0.f;
    qsum[e] = live ? xqs[e] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kOut;
  if (o0 >= O) return;  // whole warps only: the shuffles below see every lane
  long orow[kOut];
  const int4* rows[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {  // channels past O re-read channel o0 and are dropped
    orow[r] = o0 + r < O ? o0 + r : o0;
    rows[r] = reinterpret_cast<const int4*>(w + orow[r] * (I / 2));
  }

  float acc[kOut][kRows], accb[kOut][kRows];
#pragma unroll
  for (int r = 0; r < kOut; ++r)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[r][b] = accb[r][b] = 0.f;

  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    const bool on = p < P;
    const int pc = on ? p : 0;
    int4 raw[kOut][4];
#pragma unroll
    for (int r = 0; r < kOut; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) raw[r][q] = on ? __ldcs(rows[r] + 4 * p + q) : make_int4(0, 0, 0, 0);
    int dl[kOut][kRows], dh[kOut][kRows];
#pragma unroll
    for (int r = 0; r < kOut; ++r)
#pragma unroll
      for (int b = 0; b < kRows; ++b) dl[r][b] = dh[r][b] = 0;
    // weight word t = 4q + m covers low-plane words t and high-plane words
    // 16 + t of the pair's 32 activation words
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      int lo[kOut], hi[kOut];
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        const unsigned v = static_cast<unsigned>(word_of(raw[r][t >> 2], t & 3));
        lo[r] = static_cast<int>(v & 0x0F0F0F0Fu);
        hi[r] = static_cast<int>(v & 0xF0F0F0F0u);
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int a_lo = xs[(b * 32 + t) * ps + pc], a_hi = xs[(b * 32 + 16 + t) * ps + pc];
#pragma unroll
        for (int r = 0; r < kOut; ++r) {
          dl[r][b] = __dp4a(lo[r], a_lo, dl[r][b]);
          dh[r][b] = __dp4a(hi[r], a_hi, dh[r][b]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      if (SG) {
        const float s = on && !(lane & 1) ? __ldg(scales + orow[r] * NS + (p >> 1)) : 0.f;
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          int d = on ? dl[r][b] - 8 * qsum[b * G + 2 * pc] + (dh[r][b] >> 4) : 0;
          d += __shfl_xor_sync(kFull, d, 1);  // the super-group's other pair
          acc[r][b] = fmaf(s, static_cast<float>(d), acc[r][b]);
        }
      } else {
        const float2 s = on ? __ldg(reinterpret_cast<const float2*>(scales + orow[r] * G) + p)
                            : make_float2(0.f, 0.f);
        const float2 bi = on ? __ldg(reinterpret_cast<const float2*>(biases + orow[r] * G) + p)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          const int d_hi = (dh[r][b] >> 4) + 8 * qsum[b * G + 2 * pc + 1];
          acc[r][b] = fmaf(s.x, static_cast<float>(dl[r][b]),
                           fmaf(s.y, static_cast<float>(d_hi), acc[r][b]));
          accb[r][b] = fmaf(bi.x, fsum[b * G + 2 * pc],
                            fmaf(bi.y, fsum[b * G + 2 * pc + 1], accb[r][b]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = o0 + r;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      float y = tpa::warp_sum(acc[r][b]) * sx[b];
      if (!SG) y += tpa::warp_sum(accb[r][b]);
      if (lane == 0 && b < B && o < O) out[static_cast<long>(b) * O + o] = y;
    }
  }
}

template <bool SG, int kRows, int kOut>
cudaError_t launch(const int8_t* xq, const float* sx, const float* xsum, const int* xqs,
                   const int8_t* w, const float* scales, const float* biases, float* out, int B,
                   int I, int O, cudaStream_t stream) {
  const int P = I / 128, G = I / kGroup;
  const int smem = kRows * (32 * (P | 1) + 2 * G) * static_cast<int>(sizeof(int));
  auto kernel = w4a8_gemv_kernel<SG, kRows, kOut>;
  cudaError_t err = tpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int per_block = kWarps * kOut;
  kernel<<<(O + per_block - 1) / per_block, kThreads, smem, stream>>>(xq, sx, xsum, xqs, w, scales,
                                                                      biases, out, B, I, O);
  return cudaGetLastError();
}

template <bool SG>
cudaError_t launch_rows(const int8_t* xq, const float* sx, const float* xsum, const int* xqs,
                        const int8_t* w, const float* s, const float* b, float* out, int B, int I,
                        int O, cudaStream_t stream) {
  if (B <= 1) return launch<SG, 1, 4>(xq, sx, xsum, xqs, w, s, b, out, B, I, O, stream);
  if (B <= 2) return launch<SG, 2, 4>(xq, sx, xsum, xqs, w, s, b, out, B, I, O, stream);
  if (B <= 4) return launch<SG, 4, 2>(xq, sx, xsum, xqs, w, s, b, out, B, I, O, stream);
  return launch<SG, 8, 2>(xq, sx, xsum, xqs, w, s, b, out, B, I, O, stream);
}

}  // namespace

// x (B, I) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (L, O, I/2) int8
// packed, layer `layer` is read; sg = 0: scales, biases (O, I/64) f32; sg =
// 1: scales (O, I/256) f32, biases unused; xq (B, I) int8, sx (B) f32, xsum
// (B, I/64) f32 and xqs (B, I/64) int32 are workspace; out (B, O) f32.
// 1 <= B <= 32, I % 128 == 0 (I % 256 == 0 for sg).
extern "C" int tpa_w4a8_matmul(const void* x, int x_bf16, const int8_t* w, const float* scales,
                               const float* biases, int sg, int8_t* xq, float* sx, float* xsum,
                               int* xqs, float* out, int B, int I, int O, int layer,
                               cudaStream_t stream) {
  if (B < 1 || B > 32 || I <= 0 || I % (sg ? 256 : 128) || (!sg && biases == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  w += static_cast<long>(layer) * O * (I / 2);
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 8 || reinterpret_cast<uintptr_t>(biases) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (x_bf16)
    w4a8_rows_kernel<<<B, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), xq, sx,
                                                 xsum, xqs, I);
  else
    w4a8_rows_kernel<<<B, kThreads, 0, stream>>>(static_cast<const float*>(x), xq, sx, xsum,
                                                 xqs, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = I / kGroup;
  for (int b0 = 0; b0 < B; b0 += kMaxRowsPerPass) {
    const int rows = B - b0 < kMaxRowsPerPass ? B - b0 : kMaxRowsPerPass;
    const int8_t* xb = xq + static_cast<long>(b0) * I;
    const float* sb = sx + b0;
    const float* fb = xsum + static_cast<long>(b0) * G;
    const int* qb = xqs + static_cast<long>(b0) * G;
    float* ob = out + static_cast<long>(b0) * O;
    err = sg ? launch_rows<true>(xb, sb, fb, qb, w, scales, biases, ob, rows, I, O, stream)
             : launch_rows<false>(xb, sb, fb, qb, w, scales, biases, ob, rows, I, O, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
