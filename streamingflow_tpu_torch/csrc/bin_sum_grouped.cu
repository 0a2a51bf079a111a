// Per-bin sums of point rows with several tiles a block: the grouped
// variant of csrc/bin_sum.cu, an experiment on no model path.
//
// Replaces the TPU kernel tools/exp_bin_variants.py::_kernel_grouped (K1's
// one-hot matmuls, one program per k_tiles consecutive 2048-bin tiles, an
// empty tile written as zeros without accumulating).  The function is K1's:
// per-bin fp32 sums of rows by clipped id, the optional pillar epilogue, one
// write of (C, n_bins) in the output type.
//
// What bounds it on an H100: bytes, as K1 (~5 MB of rows in, 77 MB of bf16
// out per flagship cloud).  The question the variant asks of this card: K1
// runs one 120 KiB block per SM over ~10 waves of 1251 tiles, and most tiles
// of a LiDAR cloud hold no point.  Here a block takes k_tiles tiles in turn,
// reuses one set of shared-memory sums, and an empty tile (offsets[t + 1] <=
// offsets[t]) skips the zeroing, the two barriers and the epilogue and only
// streams its zeros out.  That needs epilogue(0) == 0, which holds for the
// raw sums and the pillar statistics.  The last group checks its tiles
// against n_tiles, where the TPU version padded the tile count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bin_sum_tile.cuh"

namespace {

using bin_tile::kBinsPerTile;
using bin_tile::kThreads;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
bin_sum_grouped_kernel(const float* __restrict__ data,
                       const int* __restrict__ ids,
                       const int* __restrict__ offsets,
                       OutT* __restrict__ out, int n_tiles, int n_bins, int C,
                       int n_feat, int k_tiles) {
  extern __shared__ float acc[];
  for (int k = 0; k < k_tiles; ++k) {
    const int t = blockIdx.x * k_tiles + k;
    if (t >= n_tiles) break;
    const int base = t * kBinsPerTile;
    const int start = offsets[t], end = offsets[t + 1];
    if (end <= start) {  // block-uniform: no row, the tile is zeros
      const int width = min(kBinsPerTile, n_bins - base);
      for (int c = 0; c < C; ++c) {
        OutT* row = out + static_cast<size_t>(c) * n_bins + base;
        for (int b = threadIdx.x; b < width; b += kThreads)
          bin_tile::store(row + b, 0.f);
      }
      continue;
    }
    bin_tile::accumulate(acc, data, ids, start, end, base, C);
    bin_tile::write(acc, out, base, n_bins, C, n_feat);
    __syncthreads();  // the sums are read before the next tile zeroes them
  }
}

template <typename OutT>
cudaError_t launch(const float* data, const int* ids, const int* offsets,
                   void* out, int n_tiles, int n_bins, int C, int n_feat,
                   int k_tiles, cudaStream_t stream) {
  const int smem = C * kBinsPerTile * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      bin_sum_grouped_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_groups = (n_tiles + k_tiles - 1) / k_tiles;
  bin_sum_grouped_kernel<OutT><<<n_groups, kThreads, smem, stream>>>(
      data, ids, offsets, static_cast<OutT*>(out), n_tiles, n_bins, C, n_feat,
      k_tiles);
  return cudaGetLastError();
}

}  // namespace

// data (P, C) fp32 rows; ids (P,) int32 clipped to [0, n_bins) and grouped
// by tile; offsets (n_tiles + 1,) int32; out (C, n_bins) fp32 or bf16;
// k_tiles >= 1 tiles a block.
extern "C" int sf_bin_sum_grouped(const float* data, const int* ids,
                                  const int* offsets, void* out, int n_tiles,
                                  int n_bins, int C, int n_feat, int out_bf16,
                                  int k_tiles, void* stream) {
  if (n_tiles == 0) return 0;
  if (k_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(data, ids, offsets, out, n_tiles,
                                       n_bins, C, n_feat, k_tiles, s)
               : launch<float>(data, ids, offsets, out, n_tiles, n_bins, C,
                               n_feat, k_tiles, s);
  return static_cast<int>(err);
}
