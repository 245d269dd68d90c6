// Fused Whisper log-mel: frame -> Hann window -> 400-point real DFT by an
// FFT in shared memory -> power -> banded Slaney mel -> log10(max(., 1e-10)),
// one launch for a whole clip.
//
// Replaces tpu_audio/ops/pallas/fused_mel.py:fused_log_mel.
//
// Bound on the H100: device-memory bytes. A 30 s chunk is 3001 frames, 1.9
// MB of audio in and 1.5 MB of log-mel out (n_mels 128), ~1.0 us at 3.35
// TB/s; its arithmetic is ~10 kFLOP of f64 a frame (the window, the FFT, the
// split and the power) and ~0.9 kFLOP of f32 (the bands, the log), ~0.9 us
// at the FP64 peak. The TPU kernel wrote the DFT as a GEMM against a
// window-folded basis for its matrix unit: 30x the arithmetic of an FFT.
// (tools/mel_split.py splits the call's time on the card.)
//
// Design. A block takes kFrames frames; the grid covers the clip.
//  - Audio. One cp.async.bulk stages the tile's span, (nf - 1) * 160 + 400
//    samples, in shared memory under an mbarrier: a hop is 640 bytes, so each
//    span starts 16-byte aligned whenever the signal does (the wrapper
//    refuses a signal that does not). Frames overlap (hop 160 of 400), so
//    framing costs no gather.
//  - FFT. The 400 windowed real samples of a frame become 200 complex ones,
//    z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] (the window applied as the frame
//    is read); a Stockham FFT of 200 points runs on them in three passes of
//    radix 5, 5 and 8 (in that order: the first pass's stores then fall on
//    distinct banks), ping-ponging between two shared buffers; a split pass
//    turns Z into the 201 bins X[k] = E[k] + e^{-2 pi i k / 400} O[k], two
//    bins (k and 200 - k) an item. Each pass's items run j-fastest within a
//    frame, so a warp's loads are consecutive. The window's products, the
//    transform and the split run in `real`, float64, with float64 twiddle
//    tables from the host: in float32 an FFT rounds every intermediate
//    against the loudest bin, which puts ~eps * |X|max into the quiet bins,
//    and on chip_smoke.py's dynamic-range gate (a 440 Hz tone at 0.5 over
//    noise at 1e-5) lands further from float64 than the 1.5x of the f32
//    GEMM's distance that the gate allows: 1.79x at 128 mels (1.27x at 80)
//    for the float32 copy that tools/mel_split.py builds and gates, which
//    is only ~15% faster (H100). In float64 the kernel is 1.2e-6 from it,
//    the GEMM 8.6e-3.
//  - Power and mel. |X|^2 is rounded once to f32 in shared memory. A thread
//    takes a mel band: its f32 Slaney weights (first bin, count, offset into
//    the packed weights: ops/kernels/fused_mel.py:_constants) in registers,
//    it sums only the band's bins, in increasing bin order, for each frame
//    of the tile at once, then log10f(fmaxf(acc, 1e-10f)); a block's rows of
//    the (num_frames, n_mels) output are one contiguous run, stored
//    coalesced.
//  - Occupancy. 4 frames and 160 threads a block, 27.8 KB of shared memory,
//    at most 64 registers: 751 blocks for a 30 s chunk, 6 resident a SM, so
//    one chunk fills the 132 SMs at once.
//  - A wait on the staging barrier that never ends (a fault) traps after
//    ~4 s.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = tpa::hopper;

constexpr int kFrames = 4;    // frames a block
constexpr int kThreads = 160;
constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kN = kNfft / 2;          // complex points of the FFT
constexpr int kBins = kNfft / 2 + 1;   // one-sided bins
constexpr int kPairs = kN / 2 + 1;     // split items: bins k and 200 - k
// The FFT's arithmetic (see the design above).
using real = double;
using cplx = std::conditional_t<std::is_same_v<real, double>, double2, float2>;
// The twiddle table: each pass's (R - 1) x Ns factors e^{-2 pi i k r / (Ns R)}
// at [r - 1][k] (lanes of consecutive k read consecutive entries), then the
// split's e^{-2 pi i k / 400}, k <= 100 (ops/kernels/fused_mel.py:twiddles).
constexpr int kTw2 = 4 * 1, kTw3 = kTw2 + 4 * 5, kTwSplit = kTw3 + 7 * 25;
// Frame strides in complex values, chosen so that no quarter-warp's 16-byte
// accesses meet on a bank, frames crossed included: buffer A (the first and
// third passes' outputs) 201; buffer B (the second's) 233, its groups of 25
// points 29 apart (`padded`).
constexpr int kStrideA = kN + 1, kStrideB = kN + 4 * (kN / 25) + 1;
constexpr int kBytesA = kFrames * kStrideA * static_cast<int>(sizeof(cplx));
constexpr int kBytesB = kFrames * kStrideB * static_cast<int>(sizeof(cplx));
constexpr int kSmem = kBytesA + kBytesB + 16;  // buffers A and B, the mbarrier
constexpr int kMaxBand = 16;  // bins a mel band may span (the wrapper checks)
constexpr long long kHangCycles = 8000000000ll;  // ~4 s
static_assert((kFrames - 1) * kHop + kNfft <= kBytesB / 4, "the audio span fits buffer B");
static_assert(kFrames * kBins <= kBytesB / 4, "the power fits buffer B");

// Index n of a frame of 200 in buffer B: 4 slots after each 25.
__device__ __forceinline__ int padded(int n) { return n + 4 * (n / 25); }

__device__ __forceinline__ cplx add(cplx a, cplx b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cplx sub(cplx a, cplx b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cplx mul(cplx a, cplx b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ cplx neg_i(cplx a) { return {a.y, -a.x}; }  // -i a
// A table's float64 entry in `real`.
__device__ __forceinline__ cplx entry(const double2* t) {
  const double2 e = __ldg(t);
  return {static_cast<real>(e.x), static_cast<real>(e.y)};
}

// Forward DFT of 5 points in place.
__device__ __forceinline__ void dft(cplx (&v)[5]) {
  constexpr real c1 = 0.30901699437494742410;   // cos(2 pi / 5)
  constexpr real c2 = -0.80901699437494742410;  // cos(4 pi / 5)
  constexpr real s1 = 0.95105651629515357212;   // sin(2 pi / 5)
  constexpr real s2 = 0.58778525229247312917;   // sin(4 pi / 5)
  const cplx t1 = add(v[1], v[4]), t2 = add(v[2], v[3]);
  const cplx t3 = sub(v[1], v[4]), t4 = sub(v[2], v[3]);
  const cplx a1 = {v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y};
  const cplx a2 = {v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y};
  const cplx b1 = {s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y};
  const cplx b2 = {s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y};
  v[0] = add(v[0], add(t1, t2));
  v[1] = add(a1, neg_i(b1));
  v[4] = sub(a1, neg_i(b1));
  v[2] = add(a2, neg_i(b2));
  v[3] = sub(a2, neg_i(b2));
}

// Forward DFT of 8 points in place (three radix-2 stages).
__device__ __forceinline__ void dft(cplx (&v)[8]) {
  constexpr real h = 0.70710678118654752440;  // 1 / sqrt(2)
  cplx a[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = add(v[r], v[r + 4]);
    a[r + 4] = sub(v[r], v[r + 4]);
  }
  a[5] = {(a[5].x + a[5].y) * h, (a[5].y - a[5].x) * h};   // * e^{-i pi / 4}
  a[6] = neg_i(a[6]);                                      // * e^{-i pi / 2}
  a[7] = {(a[7].y - a[7].x) * h, -(a[7].x + a[7].y) * h};  // * e^{-3 i pi / 4}
  const cplx b0 = add(a[0], a[2]), b2 = sub(a[0], a[2]);
  const cplx b1 = add(a[1], a[3]), b3 = neg_i(sub(a[1], a[3]));
  const cplx b4 = add(a[4], a[6]), b6 = sub(a[4], a[6]);
  const cplx b5 = add(a[5], a[7]), b7 = neg_i(sub(a[5], a[7]));
  v[0] = add(b0, b1);
  v[4] = sub(b0, b1);
  v[2] = add(b2, b3);
  v[6] = sub(b2, b3);
  v[1] = add(b4, b5);
  v[5] = sub(b4, b5);
  v[3] = add(b6, b7);
  v[7] = sub(b6, b7);
}

// One Stockham pass of radix R after sub-transforms of Ns points: item j
// of a frame twiddles in[j + r N / R] by e^{-2 pi i (j % Ns) r / (Ns R)}
// (tw[(r - 1) Ns + j % Ns]), takes their DFT, and stores output r at
// (j / Ns) Ns R + j % Ns + r Ns. The input's frames lie kIn apart, the
// output's kOut; kPadIn / kPadOut: that buffer is B, with its groups padded.
template <int R, int Ns, int kIn, bool kPadIn, int kOut, bool kPadOut>
__device__ __forceinline__ void stockham(const cplx* __restrict__ in, cplx* __restrict__ out,
                                         const double2* __restrict__ tw, int nf) {
  constexpr int L = kN / R;
  for (int i = threadIdx.x; i < nf * L; i += kThreads) {
    const int f = i / L, j = i - f * L, k = j % Ns;
    cplx v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * L;
      v[r] = in[f * kIn + (kPadIn ? padded(n) : n)];
      if (r > 0) v[r] = mul(v[r], entry(tw + (r - 1) * Ns + k));
    }
    dft(v);
    const int base = (j / Ns) * Ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = base + r * Ns;
      out[f * kOut + (kPadOut ? padded(n) : n)] = v[r];
    }
  }
}

// The first pass (radix 5, Ns 1: no twiddles), reading the staged audio:
// z[n] of frame f from samples f * hop + 2n and 2n + 1, windowed (the f32
// window's values, held as f64: in f64 the products are exact).
__device__ __forceinline__ void first_pass(const float* __restrict__ wav,
                                           const double2* __restrict__ window,
                                           cplx* __restrict__ out, int nf) {
  constexpr int L = kN / 5;
  for (int i = threadIdx.x; i < nf * L; i += kThreads) {
    const int f = i / L, j = i - f * L;
    const float2* src = reinterpret_cast<const float2*>(wav + f * kHop);
    cplx v[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float2 s = src[j + r * L];
      const cplx w = entry(window + j + r * L);
      v[r] = {s.x * w.x, s.y * w.y};
    }
    dft(v);
    cplx* dst = out + f * kStrideA + 5 * j;
#pragma unroll
    for (int r = 0; r < 5; ++r) dst[r] = v[r];
  }
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

__global__ void __launch_bounds__(kThreads, 6)
fused_log_mel_kernel(const float* __restrict__ audio,      // 16-byte aligned
                     const double2* __restrict__ window,   // (200,) pairs of the Hann window
                     const double2* __restrict__ tw,       // the twiddle table
                     const int4* __restrict__ bands,       // (n_mels,) first, count, offset, 0
                     const float* __restrict__ weights,    // the bands' packed weights
                     float* __restrict__ out,              // (num_frames, n_mels)
                     int num_frames, int n_mels) {
  extern __shared__ __align__(16) unsigned char smem[];
  cplx* buf_a = reinterpret_cast<cplx*>(smem);
  cplx* buf_b = reinterpret_cast<cplx*>(smem + kBytesA);
  float* wav = reinterpret_cast<float*>(buf_b);    // the span, until the second pass
  float* power = reinterpret_cast<float*>(buf_b);  // (kFrames, kBins), after the third
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBytesA + kBytesB);
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, num_frames - f0);
  const long start = static_cast<long>(f0) * kHop;
  const int n_samples = (nf - 1) * kHop + kNfft;

  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, n_samples * 4);
    hp::bulk_load(wav, audio + start, n_samples * 4, bar);
  }
  wait_bar(bar, 0);

  first_pass(wav, window, buf_a, nf);
  __syncthreads();
  stockham<5, 5, kStrideA, false, kStrideB, true>(buf_a, buf_b, tw + kTw2, nf);
  __syncthreads();
  stockham<8, 25, kStrideB, true, kStrideA, false>(buf_b, buf_a, tw + kTw3, nf);
  __syncthreads();

  // Split: E = (Z[k] + conj Z[200-k]) / 2, O = (Z[k] - conj Z[200-k]) / 2i,
  // X[k] = E + W^k O and X[200-k] = conj(E - W^k O), W = e^{-2 pi i / 400}.
  for (int i = threadIdx.x; i < nf * kPairs; i += kThreads) {
    const int f = i / kPairs, k = i - f * kPairs;
    const cplx zk = buf_a[f * kStrideA + k], zn = buf_a[f * kStrideA + (kN - k) % kN];
    const cplx e = {real(0.5) * (zk.x + zn.x), real(0.5) * (zk.y - zn.y)};
    const cplx o = {real(0.5) * (zk.y + zn.y), real(0.5) * (zn.x - zk.x)};
    const cplx t = mul(entry(tw + kTwSplit + k), o);
    const cplx lo = add(e, t), hi = sub(e, t);
    power[f * kBins + kN - k] = static_cast<float>(hi.x * hi.x + hi.y * hi.y);
    power[f * kBins + k] = static_cast<float>(lo.x * lo.x + lo.y * lo.y);  // k = 100: this one
  }
  __syncthreads();

  // A thread a band: its weights in registers, then each frame of the tile.
  for (int m = threadIdx.x; m < n_mels; m += kThreads) {
    const int4 band = __ldg(bands + m);
    float w[kMaxBand];
#pragma unroll
    for (int c = 0; c < kMaxBand; ++c) w[c] = c < band.y ? __ldg(weights + band.z + c) : 0.f;
    float acc[kFrames];  // every frame's sum at once (rows past nf are not stored)
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float* p = power + f * kBins + band.x;
      acc[f] = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxBand; ++c)
        if (c < band.y) acc[f] = fmaf(p[c], w[c], acc[f]);
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      if (f >= nf) break;
      out[static_cast<long>(f0 + f) * n_mels + m] = log10f(fmaxf(acc[f], 1e-10f));
    }
  }
}

}  // namespace

extern "C" int tpa_fused_log_mel(const float* audio, int n_audio, const double* window,
                                 const double* twiddles, const int* bands, const float* weights,
                                 float* out, int num_frames, int n_mels, cudaStream_t stream) {
  if (num_frames < 1 || static_cast<long>(num_frames - 1) * kHop + kNfft > n_audio ||
      (reinterpret_cast<uintptr_t>(audio) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = tpa::allow_smem(fused_log_mel_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_frames + kFrames - 1) / kFrames;
  fused_log_mel_kernel<<<blocks, kThreads, kSmem, stream>>>(
      audio, reinterpret_cast<const double2*>(window),
      reinterpret_cast<const double2*>(twiddles), reinterpret_cast<const int4*>(bands), weights,
      out, num_frames, n_mels);
  return static_cast<int>(cudaGetLastError());
}
