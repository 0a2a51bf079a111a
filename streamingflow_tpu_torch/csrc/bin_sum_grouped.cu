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
// out per flagship cloud).  It runs K1's sub-tile code (bin_sum_tile.cuh):
// block (g, s) takes sub-tile s of the k_tiles consecutive tiles of group g
// in turn, reusing its shared-memory sums, and an empty tile (no row between
// its bounds) skips the zeroing, the barriers and the epilogue and only
// streams its zeros out with 16-byte stores.  That needs epilogue(0) == 0,
// which holds for the raw sums and the pillar statistics.  The question the
// variant asks of this card: do fewer, longer-lived blocks beat K1's one
// sub-tile a block?  The last group checks its tiles against n_tiles, where
// the TPU version padded the tile count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bin_sum_tile.cuh"

namespace {

using bin_tile::kSubsPerTile;
using bin_tile::kThreads;

template <typename OutT, int kGroup>
__global__ void __launch_bounds__(kThreads)
bin_sum_grouped_kernel(const bin_tile::Params p, int k_tiles) {
  extern __shared__ float4 smem[];
  __shared__ bin_tile::Lists lists;
  const int group = blockIdx.x / kSubsPerTile;
  const int s = blockIdx.x % kSubsPerTile;
  for (int k = 0; k < k_tiles; ++k) {
    const int t = group * k_tiles + k;
    if (t >= p.n_tiles) break;
    bin_tile::sub_tile<OutT, kGroup>(p, t, s, reinterpret_cast<float*>(smem),
                                     lists);
    __syncthreads();  // the sums are read before the next tile zeroes them
  }
}

template <typename OutT, int kGroup>
cudaError_t launch(const bin_tile::Params& p, int k_tiles,
                   cudaStream_t stream) {
  const int smem = bin_tile::shared_bytes(p.C);
  const cudaError_t err =
      bin_tile::set_shared(bin_sum_grouped_kernel<OutT, kGroup>, smem);
  if (err != cudaSuccess) return err;
  const int n_groups = (p.n_tiles + k_tiles - 1) / k_tiles;
  bin_sum_grouped_kernel<OutT, kGroup>
      <<<n_groups * kSubsPerTile, kThreads, smem, stream>>>(p, k_tiles);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_type(const bin_tile::Params& p, int k_tiles,
                        cudaStream_t stream) {
  return p.C <= 16 ? launch<OutT, 16>(p, k_tiles, stream)
                   : launch<OutT, 32>(p, k_tiles, stream);
}

}  // namespace

// sf_bin_sum's arguments (csrc/bin_sum.cu), then k_tiles >= 1 tiles a block.
extern "C" int sf_bin_sum_grouped(const float* data, const int* ids,
                                  const int* bounds, void* out, int n_rows,
                                  int n_bins, int n_tiles, int bins_per_cloud,
                                  int n_store, long long row_stride,
                                  long long cloud_stride, int C, int n_feat,
                                  int out_bf16, int k_tiles, void* stream) {
  if (n_tiles == 0) return 0;
  if (k_tiles < 1 || C < 1 || C > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const bin_tile::Params p{data,       ids,          bounds, out,
                           row_stride, cloud_stride, n_rows, n_bins,
                           n_tiles,    bins_per_cloud, n_store, C,
                           n_feat,     0.0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = out_bf16 ? launch_type<__nv_bfloat16>(p, k_tiles, s)
                             : launch_type<float>(p, k_tiles, s);
  return static_cast<int>(err);
}
