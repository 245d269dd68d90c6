// What the two clustered o-projections share (fused_encoder.cu's bf16
// oproj_ln_bf16 and fused_encoder_int8.cu's oproj_ln): a thread-block
// cluster of ceil(D / 256) blocks takes a 128-row tile, each block 256 of
// its D output columns, so that LayerNorm2's row statistics are summed over
// all D columns through distributed shared memory; y and h leave as bf16
// through a staged tile in shared memory with 16-byte stores.
//
// Both kernels run two consumer warpgroups of 64 rows (256 threads) and
// keep the accumulator layout of hopper.cuh: this thread's rows of a tile
// are r0 and r0 + 8, r0 = 64 wg + 16 (tid / 32) + lane / 4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace tpa {
namespace oproj {

namespace hp = tpa::hopper;

constexpr int BM = 128;         // rows a tile
constexpr int BN = 256;         // output columns a block
constexpr int kMaxCluster = 8;  // D <= 2048, a portable cluster

// Whether H heads of 64 (D = 64 H) split into a cluster of ceil(D / 256)
// blocks: H even (D a multiple of 128), D at most 2048.
inline bool heads_fit(int H) { return H > 0 && H % 2 == 0 && H * 64 <= kMaxCluster * BN; }

// The row sums of lo and hi (this thread's partial sums of rows r0 and
// r0 + 8) over all D columns, every block and lane of the cluster adding
// the same terms in the same order: the four lanes of a row, then every
// rank's partial through its shared memory, taken by the four lanes in
// turn. `buf` holds [rank][row], kMaxCluster x BM floats at the same offset
// in every block; one cluster barrier. A buffer is written again only after
// the next exchange's barrier (the caller alternates two buffers), by which
// time every block has read it.
__device__ __forceinline__ void cluster_row_sums(float* buf, float& lo, float& hi, uint32_t rank,
                                                 uint32_t n_ranks, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, o);
    hi += __shfl_xor_sync(0xffffffffu, hi, o);
  }
  for (uint32_t q = lane % 4; q < n_ranks; q += 4) {
    hp::st_peer(buf + rank * BM + r0, q, lo);
    hp::st_peer(buf + rank * BM + r0 + 8, q, hi);
  }
  hp::cluster_arrive();
  hp::cluster_wait();
  lo = 0.f;
  hi = 0.f;
  for (uint32_t q = lane % 4; q < n_ranks; q += 4) {
    lo += buf[q * BM + r0];
    hi += buf[q * BM + r0 + 8];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, o);
    hi += __shfl_xor_sync(0xffffffffu, hi, o);
  }
}

// Warpgroup wg's 64 staged rows of a W-column bf16 tile (row stride ldc
// elements in shared memory) out to dst (rows of D elements) at row m0 + r,
// column col0, with 16-byte stores: a thread keeps one 8-column chunk and
// walks every (128 / (W / 8))-th row; rows past M are not stored. The named
// barriers (1 + wg) order the staging before the stores and the stores
// before the next staging.
template <int W>
__device__ __forceinline__ void store_staged_rows(const __nv_bfloat16* cst, int ldc,
                                                  __nv_bfloat16* dst, int m0, int col0, int M,
                                                  int D) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  hp::named_barrier(1 + wg, 128);
  constexpr int kChunks = W / 8;
  const int c = (tid % kChunks) * 8;
  for (int r = wg * 64 + tid / kChunks; r < wg * 64 + 64; r += 128 / kChunks) {
    if (m0 + r >= M) break;
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(m0 + r) * D + col0 + c) =
        *reinterpret_cast<const uint4*>(cst + r * ldc + c);
  }
  hp::named_barrier(1 + wg, 128);
}

// h = (y - mean) * rstd * g2 + b2, each product and sum rounded on its own,
// in the plain versions' order.
__device__ __forceinline__ float ln_value(float v, float mu, float rstd, float w, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), w), bias);
}

// A launch of `grid` blocks of `threads` in clusters of `cluster` blocks;
// attr holds its one attribute.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, dim3 grid, dim3 cluster,
                                         int threads, int smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster.x;
  attr->val.clusterDim.y = cluster.y;
  attr->val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` over M rows of width D in clusters of ceil(D / 256) blocks
// (blockIdx.x the rank), as many clusters as the card holds at once (at
// most one a row tile), each walking row tiles blockIdx.y, blockIdx.y +
// gridDim.y, ...; or, given `clusters`, report how many of its clusters the
// card holds at once instead.
template <typename Kernel, typename... Args>
cudaError_t launch_row_clusters(Kernel kernel, int threads, int smem, int M, int D,
                                cudaStream_t stream, int* clusters, Args... args) {
  const unsigned n_ranks = (D + BN - 1) / BN;
  cudaError_t err = tpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + BM - 1) / BM;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(&attr, dim3(n_ranks, tiles), dim3(n_ranks, 1, 1), threads, smem, stream);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess || clusters != nullptr) {
    if (clusters != nullptr) *clusters = active;
    return err;
  }
  if (active < 1) return cudaErrorLaunchOutOfResources;
  cfg.gridDim.y = tiles < active ? tiles : active;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace oproj
}  // namespace tpa
