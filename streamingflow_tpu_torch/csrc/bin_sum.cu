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

namespace {

constexpr int kBinsPerTile = 2048;
constexpr int kThreads = 512;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc: [C][kBinsPerTile] fp32 sums in shared memory.
// n_feat < 0: raw sums.  n_feat = c >= 3: the pillar epilogue over channels
// [count, c point features, z^2, C - 2 - c z-occupancy bins] giving
// [log1p(count), c means, z std, occupancy clamped to 1], zero where the
// count is 0.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
bin_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
               const int* __restrict__ offsets, OutT* __restrict__ out,
               int n_bins, int C, int n_feat) {
  extern __shared__ float acc[];
  const int base = blockIdx.x * kBinsPerTile;
  for (int i = threadIdx.x; i < C * kBinsPerTile; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int start = offsets[blockIdx.x];
  const int end = offsets[blockIdx.x + 1];
  for (int r = start + threadIdx.x; r < end; r += kThreads) {
    const int b = ids[r] - base;
    if (b < 0 || b >= kBinsPerTile) continue;
    const float* row = data + static_cast<size_t>(r) * C;
    for (int c = 0; c < C; ++c) atomicAdd(&acc[c * kBinsPerTile + b], row[c]);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < kBinsPerTile; b += kThreads) {
    const int g = base + b;
    if (g >= n_bins) break;
    OutT* col = out + g;
    if (n_feat < 0) {
      for (int c = 0; c < C; ++c)
        store(col + static_cast<size_t>(c) * n_bins, acc[c * kBinsPerTile + b]);
      continue;
    }
    const float count = acc[b];
    if (!(count > 0.f)) {
      for (int c = 0; c < C; ++c)
        store(col + static_cast<size_t>(c) * n_bins, 0.f);
      continue;
    }
    const float denom = fmaxf(count, 1.f);
    store(col, log1pf(count));
    for (int i = 0; i < n_feat; ++i)
      store(col + static_cast<size_t>(1 + i) * n_bins,
            acc[(1 + i) * kBinsPerTile + b] / denom);
    const float z_mean = acc[3 * kBinsPerTile + b] / denom;
    const float z_sq = acc[(1 + n_feat) * kBinsPerTile + b] / denom;
    store(col + static_cast<size_t>(1 + n_feat) * n_bins,
          sqrtf(fmaxf(__fsub_rn(z_sq, __fmul_rn(z_mean, z_mean)), 0.f)));
    for (int c = 2 + n_feat; c < C; ++c)
      store(col + static_cast<size_t>(c) * n_bins,
            fminf(acc[c * kBinsPerTile + b], 1.f));
  }
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
