// Per-bin sums of point rows, with the pillar-statistics epilogue.
//
// Replaces the TPU kernel streamingflow_tpu/ops/pallas_bin.py::_bin_sum_kernel
// (one-hot matmuls on the MXU, a way around the TPU's slow scatter).  On
// Hopper a scatter into shared memory is the natural form: a block sums one
// sub-tile of a 2048-bin tile with shared-memory atomics, then the epilogue
// turns the sums into the output channels and writes them once, in their
// final type.
//
// What bounds it on an H100: bytes, and of them the output (94% of a
// flagship cloud's 81.9 MB: 0.0245 ms at 3.35 TB/s).  The fp32 sums never
// reach device memory.  bin_sum_tile.cuh says how the design keeps enough
// blocks a SM and enough bytes in flight: sub-tiles of 512 bins in 31 KiB
// of shared memory, one row a lane group, 16-byte stores, no work for the
// 8-bin groups no point touched.
//
// One launch writes one cloud, or several: the batched pillar path offsets
// each cloud's ids by a multiple of 2048 bins (tiles never straddle clouds)
// and the kernel writes every cloud's stored bins straight into its slice of
// one (clouds, C, n_store) output.  A sub-tile that stores no bin (the
// trash bin's tile of each cloud there) is skipped.
//
// Input contract (as the TPU kernel's): rows are grouped by tile of their
// clipped id (nondecreasing id / 2048), and bounds[t - 1] is the first row
// of tile t.  Rows whose id falls outside the block's tile are skipped, as
// the TPU kernel's global-id compare skips them.  Sums do not depend on row
// order beyond fp32 reassociation (atomics make that order vary run to run);
// with scale > 0 the deterministic route sums exact integers in 1 / scale
// units (bin_sum_tile.cuh), the same bits every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bin_sum_tile.cuh"

namespace {

using bin_tile::kSubsPerTile;
using bin_tile::kThreads;

template <typename OutT, int kGroup, bool kDet>
__global__ void __launch_bounds__(kThreads)
bin_sum_kernel(const bin_tile::Params p) {
  extern __shared__ float4 smem[];
  __shared__ bin_tile::Lists lists;
  // deterministic route: the integer sums first, the fp32 ones after
  long long* acc_i = reinterpret_cast<long long*>(smem);
  float* acc = kDet ? reinterpret_cast<float*>(
                          acc_i + p.C * bin_tile::kRowStride)
                    : reinterpret_cast<float*>(smem);
  bin_tile::sub_tile<OutT, kGroup, kDet>(p, blockIdx.x / kSubsPerTile,
                                         blockIdx.x % kSubsPerTile, acc,
                                         lists, acc_i);
}

template <typename OutT, int kGroup, bool kDet>
cudaError_t launch(const bin_tile::Params& p, cudaStream_t stream) {
  const int smem = bin_tile::shared_bytes(p.C, kDet);
  const cudaError_t err =
      bin_tile::set_shared(bin_sum_kernel<OutT, kGroup, kDet>, smem);
  if (err != cudaSuccess) return err;
  bin_sum_kernel<OutT, kGroup, kDet>
      <<<p.n_tiles * kSubsPerTile, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT, bool kDet>
cudaError_t launch_group(const bin_tile::Params& p, cudaStream_t stream) {
  return p.C <= 16 ? launch<OutT, 16, kDet>(p, stream)
                   : launch<OutT, 32, kDet>(p, stream);
}

template <typename OutT>
cudaError_t launch_type(const bin_tile::Params& p, cudaStream_t stream) {
  return p.scale > 0 ? launch_group<OutT, true>(p, stream)
                     : launch_group<OutT, false>(p, stream);
}

}  // namespace

// data (n_rows, C) fp32, C <= 32; ids (n_rows,) int32, grouped by tile of
// the id clipped to [0, n_bins); bounds (n_tiles - 1,) int32; out fp32 or
// bf16, 16-byte aligned, laid out as bin_tile::Params says.  scale > 0:
// the deterministic route, in 1 / scale units (a power of two).
extern "C" int sf_bin_sum(const float* data, const int* ids,
                          const int* bounds, void* out, int n_rows,
                          int n_bins, int n_tiles, int bins_per_cloud,
                          int n_store, long long row_stride,
                          long long cloud_stride, int C, int n_feat,
                          int out_bf16, double scale, void* stream) {
  if (n_tiles == 0) return 0;
  if (C < 1 || C > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bin_tile::Params p{data,       ids,          bounds, out,
                           row_stride, cloud_stride, n_rows, n_bins,
                           n_tiles,    bins_per_cloud, n_store, C,
                           n_feat,     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = out_bf16 ? launch_type<__nv_bfloat16>(p, s)
                             : launch_type<float>(p, s);
  return static_cast<int>(err);
}
