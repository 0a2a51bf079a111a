// One sub-tile of the per-bin sums: what csrc/bin_sum.cu (one sub-tile a
// block) and csrc/bin_sum_grouped.cu (the same sub-tile of several tiles a
// block, in turn) share.
//
// What bounds it on an H100: bytes, and of them the output.  A flagship
// cloud reads 5.1 MB of rows and ids and writes 15 x 2.56 M bf16 = 76.8 MB
// (94% of the bytes): 0.0245 ms at 3.35 TB/s.  The first design (one
// 2048-bin tile a block, 120 KiB of sums) ran at 13% of that: one block a
// SM, nothing to hide its zero / accumulate / write phases, 15 serial loads
// and atomics a row on a thread, and 2-byte stores one channel at a time.
// This one:
//   - a block sums a sub-tile of kSubBins bins of its 2048-bin tile: the
//     sums take C x (kSubBins + 4) fp32 (31 KiB at 15 channels and 512
//     bins), so several blocks share a SM and one block's writes hide
//     another's loads.  Each block scans its tile's ids (coalesced) and
//     keeps only the rows of its sub-tile: the ids are read once a
//     sub-tile, the rows once;
//   - a group of 16 lanes (32 above 16 channels) takes one row, lane c its
//     channel c, so a row is one coalesced load and one atomic a lane.  A
//     group adds consecutive rows of one bin in a register before its
//     atomic: the trash bin, where every point outside the grid lands, then
//     costs a few atomics a chunk of rows, not one a row;
//   - the epilogue gives a thread 8 consecutive bins of one channel and
//     writes them as one 16-byte store (two for fp32).  About 85% of the
//     8-bin groups of a flagship cloud hold no point: the block marks the
//     groups its rows touch, stores every untouched group as zeros with no
//     read of its sums and no arithmetic, then runs the epilogue over a
//     list of the touched groups only, every lane busy.  The pillar means
//     multiply by one reciprocal a bin.  (On the card this split beat both
//     the epilogue inside the zeros' loop and an epilogue finished in
//     shared memory before one coalesced pass; dropping the epilogue showed
//     it, not the stores, to be most of what is left above the bound);
//   - the next chunk's ids are loaded while the current one is summed, the
//     first while the sums are zeroed.
// Rows of the sums are kSubBins + 4 floats apart: the 16-byte reads stay
// aligned and the atomics of one row's channels spread over the banks.
// Ids are clipped here, not by the caller (clipping keeps the tile order).
//
// The atomics add a bin's partial sums in an order that varies from run to
// run, so its fp32 sum varies in its last bits.  The deterministic route
// (kDet, Params::scale > 0: the route under torch.use_deterministic_
// algorithms) keeps the sums as 64-bit integers in units of 1 / scale: each
// partial (a group's fp32 sum of consecutive rows of one bin, the same
// rows whatever the schedule) is rounded to an integer and added with an
// integer atomic, which is exact, so the total does not depend on the
// order.  The caller picks scale = 2^S with S such that the rows' summed
// magnitudes stay below 2^62 units.  The sums are turned back into fp32
// (the nearest float of the exact integer) before the epilogue; they take
// 8 bytes a bin and channel of shared memory beside the fp32 ones.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BIN_SUM_SUB_BINS
#define BIN_SUM_SUB_BINS 512
#endif

namespace bin_tile {

constexpr int kBinsPerTile = 2048;  // the input contract's tile
constexpr int kSubBins = BIN_SUM_SUB_BINS;
constexpr int kSubsPerTile = kBinsPerTile / kSubBins;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowStride = kSubBins + 4;  // floats between rows of the sums
static_assert(kBinsPerTile % kSubBins == 0 && kSubBins % 32 == 0,
              "a sub-tile is a multiple of 32 bins dividing the tile");

// out holds n_clouds blocks of C channel rows: bin j < n_store of cloud k
// at out + k * cloud_stride + c * row_stride + j.  Global bin g of the ids
// is bin g % bins_per_cloud of cloud g / bins_per_cloud; bins_per_cloud is
// a multiple of the tile, or n_bins for one cloud.
struct Params {
  const float* data;   // (n_rows, C) fp32
  const int* ids;      // (n_rows,) grouped by tile of the clipped id
  const int* bounds;   // (n_tiles - 1,) first row of tiles 1 .. n_tiles - 1
  void* out;
  long long row_stride, cloud_stride;
  int n_rows, n_bins, n_tiles, bins_per_cloud, n_store, C, n_feat;
  double scale;  // > 0: the deterministic route's units a 1 (kDet)
};

// Shared memory of a block besides the sums: one chunk of matched rows,
// which 8-bin groups of the sub-tile a row touched, and those groups listed.
struct Lists {
  int row[kThreads];
  int bin[kThreads];
  int warp_count[kWarps];
  int n_touched;
  unsigned char touched[kSubBins / 8];
  unsigned char touched_list[kSubBins / 8];
};
static_assert(kSubBins / 8 <= 256, "group indices fit a byte");

// The sums' C rows and one row of 1 / max(count, 1) for the pillar means;
// on the deterministic route first the C rows of integer sums.
inline int shared_bytes(int C, bool det = false) {
  return (C + 1) * kRowStride * static_cast<int>(sizeof(float)) +
         (det ? C * kRowStride * static_cast<int>(sizeof(long long)) : 0);
}

// Opt a kernel in to ``bytes`` of dynamic shared memory and ask for the
// largest shared-memory carveout, so that as many blocks as the sums allow
// share a SM.
template <typename Kernel>
cudaError_t set_shared(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 values to a 16-byte aligned address.
__device__ __forceinline__ void store8(float* p, const float f[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float f[8]) {
  uint4 v;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(f[0], f[1]);
  v.x = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(f[2], f[3]);
  v.y = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(f[4], f[5]);
  v.z = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(f[6], f[7]);
  v.w = *reinterpret_cast<unsigned*>(&h);
  *reinterpret_cast<uint4*>(p) = v;
}

// Output channel c of sub-tile bins b0 .. b0 + 7 from the sums.
// n_feat < 0: raw sums.  n_feat = c >= 3: the pillar epilogue over channels
// [count, c point features, z^2, C - 2 - c z-occupancy bins] giving
// [log1p(count), c means, z std, occupancy clamped to 1], zero where the
// count is 0.  The means multiply by row C of acc, 1 / max(count, 1) (one
// division a bin, not one a bin and channel: the divisions cost more than
// the stores); the z std divides, so that its cancellation sees the plain
// version's roundings.
__device__ __forceinline__ void epilogue8(const float* acc, int C, int c,
                                          int b0, int n_feat, float f[8]) {
  load8(acc + c * kRowStride + b0, f);
  if (n_feat < 0) return;
  float count[8], x[8];
  load8(acc + b0, count);
  if (c == 1 + n_feat) load8(acc + 3 * kRowStride + b0, x);
  else if (c >= 1 && c <= n_feat) load8(acc + C * kRowStride + b0, x);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float denom = fmaxf(count[k], 1.f);
    float v;
    if (c == 0) {
      v = log1pf(count[k]);
    } else if (c <= n_feat) {
      v = f[k] * x[k];
    } else if (c == 1 + n_feat) {
      const float z_mean = x[k] / denom;
      v = sqrtf(fmaxf(__fsub_rn(f[k] / denom, __fmul_rn(z_mean, z_mean)),
                      0.f));
    } else {
      v = fminf(f[k], 1.f);
    }
    f[k] = count[k] > 0.f ? v : 0.f;
  }
}

// Store output channel c of local bins j .. j + 7 (those below n_store):
// one 16-byte store when they all are and the address is aligned.
template <typename OutT>
__device__ __forceinline__ void store_group(const Params& p, OutT* out, int c,
                                            int j, const float f[8]) {
  if (j >= p.n_store) return;
  OutT* dst = out + c * p.row_stride + j;
  if (j + 8 <= p.n_store && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    store8(dst, f);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j + k < p.n_store) store1(dst + k, f[k]);
  }
}

// Write the sub-tile's stored bins (local bins j0 .. of cloud ``cloud``),
// channel first.  First every 8-bin group no row touched (all of them when
// lists is nullptr), as zeros with no read of the sums: epilogue(0) == 0 for
// the raw sums and the pillar statistics; consecutive threads take
// consecutive groups of a channel, so the stores coalesce.  Then only the
// listed touched groups, every thread busy with a (channel, group) of them,
// where a warp of the first loop would run the epilogue for the few touched
// groups among its 32 with most of its lanes idle.
template <typename OutT>
__device__ __forceinline__ void write(const Params& p, const float* acc,
                                      const Lists* lists, int cloud, int j0) {
  constexpr int kGroups8 = kSubBins / 8;
  OutT* out = static_cast<OutT*>(p.out) + cloud * p.cloud_stride;
  const float zeros[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < p.C * kGroups8; i += kThreads) {
    const int g = i % kGroups8;
    if (lists == nullptr || !lists->touched[g])
      store_group(p, out, i / kGroups8, j0 + g * 8, zeros);
  }
  if (lists == nullptr) return;
  const int n = lists->n_touched;
  for (int i = threadIdx.x; i < p.C * n; i += kThreads) {
    const int c = i / n;
    const int b0 = lists->touched_list[i - c * n] * 8;
    float f[8];
    epilogue8(acc, p.C, c, b0, p.n_feat, f);
    store_group(p, out, c, j0 + b0, f);
  }
}

// Adds a partial sum to bin ``cur`` of channel ``lane``: an fp32 atomic,
// or on the deterministic route (acc_i) its rounded integer in 1 / scale
// units, an exact integer atomic.
template <bool kDet>
__device__ __forceinline__ void add_partial(const Params& p, float* acc,
                                            long long* acc_i, int lane,
                                            int cur, float sum) {
  if constexpr (kDet) {
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  &acc_i[lane * kRowStride + cur]),
              static_cast<unsigned long long>(
                  __double2ll_rn(static_cast<double>(sum) * p.scale)));
  } else {
    atomicAdd(&acc[lane * kRowStride + cur], sum);
  }
}

// Add the n listed rows to acc: a group of kGroup lanes takes one row, lane
// c its channel c; a group walks entries group, group + kGroups, ... and
// keeps a run of one bin in a register until the bin changes.
template <int kGroup, bool kDet = false>
__device__ __forceinline__ void add_rows(const Params& p, float* acc,
                                         long long* acc_i,
                                         const Lists& lists, int n) {
  constexpr int kGroups = kThreads / kGroup;
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x % kGroup;
  const bool active = lane < p.C;
  float sum = 0.f;
  int cur = -1;
  for (int e0 = threadIdx.x / kGroup; e0 < n; e0 += kGroups * kUnroll) {
    float v[kUnroll];
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kGroups;
      b[u] = e < n ? lists.bin[e] : -1;
      v[u] = (e < n && active)
                 ? __ldg(p.data + static_cast<size_t>(lists.row[e]) * p.C +
                         lane)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b[u] == cur) {
        sum += v[u];
      } else {
        if (cur >= 0 && active)
          add_partial<kDet>(p, acc, acc_i, lane, cur, sum);
        cur = b[u];
        sum = v[u];
      }
    }
  }
  if (cur >= 0 && active) add_partial<kDet>(p, acc, acc_i, lane, cur, sum);
}

// Sub-tile s of tile t: zero the sums, add the tile's rows that fall in the
// sub-tile (a row of another tile is skipped, as the TPU kernel's global-id
// compare skips it), write.  Every early return is block-uniform.  kDet:
// acc_i holds the integer sums (the deterministic route).
template <typename OutT, int kGroup, bool kDet = false>
__device__ __forceinline__ void sub_tile(const Params& p, int t, int s,
                                         float* acc, Lists& lists,
                                         long long* acc_i = nullptr) {
  const int base = t * kBinsPerTile + s * kSubBins;  // first global bin
  if (base >= p.n_bins) return;
  const int cloud = base / p.bins_per_cloud;
  const int j0 = base - cloud * p.bins_per_cloud;
  if (j0 >= p.n_store) return;  // none of its bins is stored
  const int start = t == 0 ? 0 : p.bounds[t - 1];
  const int end = t == p.n_tiles - 1 ? p.n_rows : p.bounds[t];
  if (end <= start) {  // no row: the sub-tile is zeros
    write<OutT>(p, nullptr, nullptr, cloud, j0);
    return;
  }
  // the first chunk's ids are in flight while the sums are zeroed
  int next = start + threadIdx.x < end ? __ldg(p.ids + start + threadIdx.x)
                                       : 0;
  if constexpr (kDet) {
    for (int i = threadIdx.x; i < p.C * kRowStride; i += kThreads)
      acc_i[i] = 0;
  } else {
    for (int i = threadIdx.x; i < p.C * kRowStride / 4; i += kThreads)
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < kSubBins / 8; i += kThreads)
    lists.touched[i] = 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = start; r0 < end; r0 += kThreads) {
    // which rows of this chunk fall in the sub-tile, listed in row order
    const int r = r0 + threadIdx.x;
    int b = -1;
    if (r < end) {
      const int id = min(max(next, 0), p.n_bins - 1);
      b = id - base;
      if (b >= kSubBins) b = -1;
    }
    if (r + kThreads < end) next = __ldg(p.ids + r + kThreads);
    const unsigned hit = __ballot_sync(0xffffffffu, b >= 0);
    if (lane == 0) lists.warp_count[warp] = __popc(hit);
    __syncthreads();  // counts visible; also orders the zeroing before adds
    int pos = __popc(hit & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int count = lists.warp_count[w];
      pos += w < warp ? count : 0;
      n += count;
    }
    if (b >= 0) {
      lists.row[pos] = r;
      lists.bin[pos] = b;
      lists.touched[b / 8] = 1;
    }
    __syncthreads();
    add_rows<kGroup, kDet>(p, acc, acc_i, lists, n);
    __syncthreads();  // lists free for the next chunk; sums final after last
  }
  if constexpr (kDet) {  // the exact integer sums back to fp32
    const double unit = 1.0 / p.scale;
    for (int i = threadIdx.x; i < p.C * kRowStride; i += kThreads)
      acc[i] = __double2float_rn(__ll2double_rn(acc_i[i]) * unit);
    __syncthreads();
  }
  if (warp == 0) {  // list the touched groups
    int n = 0;
    for (int g0 = 0; g0 < kSubBins / 8; g0 += 32) {
      const bool on = g0 + lane < kSubBins / 8 && lists.touched[g0 + lane];
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on)
        lists.touched_list[n + __popc(m & ((1u << lane) - 1u))] = g0 + lane;
      n += __popc(m);
    }
    if (lane == 0) lists.n_touched = n;
  }
  if (p.n_feat >= 0) {  // 1 / max(count, 1) of the touched bins, row C
    for (int b = threadIdx.x; b < kSubBins; b += kThreads)
      if (lists.touched[b / 8])
        acc[p.C * kRowStride + b] = 1.f / fmaxf(acc[b], 1.f);
  }
  __syncthreads();
  write<OutT>(p, acc, &lists, cloud, j0);
}

}  // namespace bin_tile
