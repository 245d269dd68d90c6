// W8A8 weight-streaming matmul at <= 32 rows: per-row int8 activations x
// per-output-channel int8 weights, exact int32 sums, x row scale x channel
// scale.
//
// Replaces tpu_audio/ops/pallas/int8_matmul.py:int8_matmul and
// tpu_audio/ops/pallas/int8_matmul.py:int8_matmul_stacked. One entry point
// serves both: the stacked form passes the layer index, which offsets the
// weight pointer into the (L, O, I) tensor.
//
// Bound on the H100: device-memory bytes. Each weight byte is used once per
// activation row (<= 32 times), far below the ~295 op/byte ridge; the lm
// head at large-v3-turbo streams 51866 x 1280 = 66.4 MB per call.
//
// Design: kernel 1 quantises each activation row (one block per row):
// s = max|x| / 127 (floor 1e-10), q = clip(rint(x / s), -127, 127), which
// rounds half to even like torch.round and jnp.round. Kernel 2 copies the
// codes into shared memory and gives each warp kOut output channels; the
// lanes stream a channel's weights as 16-byte vectors (cache-streaming
// loads, the weights are read once), the kOut rows' loads in flight
// together, and accumulate with __dp4a into int32. The epilogue writes
// (float(acc) * sx[b]) * s[o], the order of the plain version. Channels
// past O are never read, so any O works. Rows run in passes whose codes fit
// 160 KB of shared memory (all 32 up to I = 5120; 16 at Llama-3.2-3B's
// down projection, I = 8192).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 160 * 1024;  // the staged codes of a pass, at most

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int I) {
  __shared__ float scratch[kWarps];
  const long base = static_cast<long>(blockIdx.x) * I;
  float m = 0.f;
  for (int i = threadIdx.x; i < I; i += kThreads) m = fmaxf(m, fabsf(tpa::to_float(x[base + i])));
  m = tpa::block_max<kWarps>(m, scratch);
  const float s = fmaxf(m / 127.0f, 1e-10f);
  for (int i = threadIdx.x; i < I; i += kThreads) {
    const float q = rintf(tpa::to_float(x[base + i]) / s);
    xq[base + i] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

// kRows activation rows (B <= kRows; rows B.. are zero in shared memory),
// kOut output channels per warp.
template <int kRows, int kOut>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 float* __restrict__ out, int B, int I, int O) {
  extern __shared__ int4 xs[];  // kRows x I int8 codes
  const int n16 = I / 16;
  for (int v = threadIdx.x; v < kRows * n16; v += kThreads)
    xs[v] = v < B * n16 ? reinterpret_cast<const int4*>(xq)[v] : make_int4(0, 0, 0, 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kOut;
  if (o0 >= O) return;
  const int4* rows[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r)  // rows past O re-read row o0 and are dropped
    rows[r] = reinterpret_cast<const int4*>(w + static_cast<long>(o0 + r < O ? o0 + r : o0) * I);

  int acc[kOut][kRows];
#pragma unroll
  for (int r = 0; r < kOut; ++r)
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[r][b] = 0;

  for (int v = lane; v < n16; v += 32) {
    int4 wv[kOut];
#pragma unroll
    for (int r = 0; r < kOut; ++r) wv[r] = __ldcs(rows[r] + v);
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const int4 a = xs[b * n16 + v];
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        int s = __dp4a(wv[r].x, a.x, acc[r][b]);
        s = __dp4a(wv[r].y, a.y, s);
        s = __dp4a(wv[r].z, a.z, s);
        acc[r][b] = __dp4a(wv[r].w, a.w, s);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = o0 + r;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      int s = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == (b & 31) && b < B && o < O)
        out[static_cast<long>(b) * O + o] = static_cast<float>(s) * sx[b] * scale[o];
    }
  }
}

template <int kRows, int kOut>
cudaError_t launch_gemv(const int8_t* xq, const float* sx, const int8_t* w, const float* scale,
                        float* out, int B, int I, int O, cudaStream_t stream) {
  const int smem = kRows * I;
  cudaError_t err = tpa::allow_smem(int8_gemv_kernel<kRows, kOut>, smem);
  if (err != cudaSuccess) return err;
  const int per_block = kWarps * kOut;
  int8_gemv_kernel<kRows, kOut><<<(O + per_block - 1) / per_block, kThreads, smem, stream>>>(
      xq, sx, w, scale, out, B, I, O);
  return cudaGetLastError();
}

}  // namespace

// x (B, I) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (L, O, I) int8, layer
// `layer` is read; scale (O) f32; xq (B, I) int8 and sx (B) f32 are
// workspace; out (B, O) f32. B <= 32, I % 16 == 0.
extern "C" int tpa_int8_matmul(const void* x, int x_bf16, const int8_t* w, const float* scale,
                               int8_t* xq, float* sx, float* out, int B, int I, int O, int layer,
                               cudaStream_t stream) {
  if (B < 1 || B > 32 || I % 16) return static_cast<int>(cudaErrorInvalidValue);
  w += static_cast<long>(layer) * O * I;
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(xq) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (x_bf16)
    quantize_rows_kernel<<<B, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), xq,
                                                     sx, I);
  else
    quantize_rows_kernel<<<B, kThreads, 0, stream>>>(static_cast<const float*>(x), xq, sx, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows in passes whose codes fit the shared memory a block may use
  int per_pass = 32;
  while (per_pass > 1 && per_pass * I > kMaxSmemBytes) per_pass /= 2;
  for (int b0 = 0; b0 < B && err == cudaSuccess; b0 += per_pass) {
    const int rows = B - b0 < per_pass ? B - b0 : per_pass;
    const int8_t* xb = xq + static_cast<long>(b0) * I;
    float* ob = out + static_cast<long>(b0) * O;
    if (rows <= 1) err = launch_gemv<1, 4>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
    else if (rows <= 2) err = launch_gemv<2, 4>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
    else if (rows <= 4) err = launch_gemv<4, 2>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
    else if (rows <= 8) err = launch_gemv<8, 2>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
    else if (rows <= 16) err = launch_gemv<16, 1>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
    else err = launch_gemv<32, 1>(xb, sx + b0, w, scale, ob, rows, I, O, stream);
  }
  return static_cast<int>(err);
}
