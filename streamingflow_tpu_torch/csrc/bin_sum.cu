// Per-bin sums of point rows, with the pillar-statistics epilogue.
//
// Replaces the TPU kernel streamingflow_tpu/ops/pallas_bin.py::_bin_sum_kernel
// (one-hot matmuls on the MXU, a way around the TPU's slow scatter).  On
// Hopper a scatter into shared memory is the natural form: one block per
// 2048-bin tile accumulates its rows with shared-memory atomics, then the
// epilogue turns the sums into the output channels and writes them once.
//
// What bounds it on an H100: bytes.  Per flagship cloud it reads ~5 MB of
// rows and writes 15 x 2,560,001 bf16 = 77 MB, next to no arithmetic.  The
// design keeps the fp32 sums (154 MB per cloud) in shared memory: they never
// reach device memory, and the output is written once, coalesced, channel
// first, in its final type.
//
// Input contract (as the TPU kernel's): rows are grouped by tile (ids
// nondecreasing in id / 2048) and offsets[t] .. offsets[t + 1] are tile t's
// rows.  Rows whose id falls outside the block's tile are skipped, as the TPU
// kernel's global-id compare skips them.  Sums do not depend on row order
// beyond fp32 reassociation (atomics make that order vary run to run).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bin_sum_tile.cuh"

namespace {

using bin_tile::kBinsPerTile;
using bin_tile::kThreads;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
bin_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
               const int* __restrict__ offsets, OutT* __restrict__ out,
               int n_bins, int C, int n_feat) {
  extern __shared__ float acc[];
  const int base = blockIdx.x * kBinsPerTile;
  bin_tile::accumulate(acc, data, ids, offsets[blockIdx.x],
                       offsets[blockIdx.x + 1], base, C);
  bin_tile::write(acc, out, base, n_bins, C, n_feat);
}

template <typename OutT>
cudaError_t launch(const float* data, const int* ids, const int* offsets,
                   void* out, int n_tiles, int n_bins, int C, int n_feat,
                   cudaStream_t stream) {
  const int smem = C * kBinsPerTile * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      bin_sum_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bin_sum_kernel<OutT><<<n_tiles, kThreads, smem, stream>>>(
      data, ids, offsets, static_cast<OutT*>(out), n_bins, C, n_feat);
  return cudaGetLastError();
}

}  // namespace

// data (P, C) fp32 rows; ids (P,) int32 clipped to [0, n_bins) and grouped
// by tile; offsets (n_tiles + 1,) int32; out (C, n_bins) fp32 or bf16.
extern "C" int sf_bin_sum(const float* data, const int* ids,
                          const int* offsets, void* out, int n_tiles,
                          int n_bins, int C, int n_feat, int out_bf16,
                          void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(data, ids, offsets, out, n_tiles,
                                       n_bins, C, n_feat, s)
               : launch<float>(data, ids, offsets, out, n_tiles, n_bins, C,
                               n_feat, s);
  return static_cast<int>(err);
}
