// One 2048-bin tile of the per-bin sums: what csrc/bin_sum.cu (one tile a
// block) and csrc/bin_sum_grouped.cu (several tiles a block in turn) share.
// acc is [C][kBinsPerTile] fp32 sums in the block's shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bin_tile {

constexpr int kBinsPerTile = 2048;
constexpr int kThreads = 512;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Zero acc and add the rows [start, end) whose id lies in the tile at
// ``base`` (a row of another tile is skipped, as the TPU kernel's global-id
// compare skips it).  Ends with the sums complete and visible to the block.
__device__ __forceinline__ void accumulate(float* acc,
                                           const float* __restrict__ data,
                                           const int* __restrict__ ids,
                                           int start, int end, int base,
                                           int C) {
  for (int i = threadIdx.x; i < C * kBinsPerTile; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int r = start + threadIdx.x; r < end; r += kThreads) {
    const int b = ids[r] - base;
    if (b < 0 || b >= kBinsPerTile) continue;
    const float* row = data + static_cast<size_t>(r) * C;
    for (int c = 0; c < C; ++c) atomicAdd(&acc[c * kBinsPerTile + b], row[c]);
  }
  __syncthreads();
}

// Write the tile's bins of out (C, n_bins), channel first.
// n_feat < 0: raw sums.  n_feat = c >= 3: the pillar epilogue over channels
// [count, c point features, z^2, C - 2 - c z-occupancy bins] giving
// [log1p(count), c means, z std, occupancy clamped to 1], zero where the
// count is 0.
template <typename OutT>
__device__ __forceinline__ void write(const float* acc,
                                      OutT* __restrict__ out, int base,
                                      int n_bins, int C, int n_feat) {
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

}  // namespace bin_tile
