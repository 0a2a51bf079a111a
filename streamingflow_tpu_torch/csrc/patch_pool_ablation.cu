// Experiment: what held the pool's first design back, reading or reducing?
//
// The first hand-written design of the camera pool (csrc/patch_pool.cu's
// forward before its redesign): one block of 128 threads a group, the
// patch decision by row_fit behind a block barrier, then one warp a row, a
// lane reading 4 bytes and adding them into the grid with two scalar fp32
// atomics.  With atomics = 1 this is that design as it shipped; with
// atomics = 0 each warp keeps its sums in registers and the block stores
// them once (64 floats into sink[block]), so the time is that of its loads
// and its patch decision alone.  Only chip_smoke.py's patch_pool phase
// calls it; no model path does.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "patch_pool_fit.cuh"

template <bool kAtomics>
__global__ void __launch_bounds__(kThreads)
row_atomic_kernel(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ coords,
                  const uint8_t* __restrict__ kept, float* __restrict__ out,
                  int* __restrict__ drops, float* __restrict__ sink, int N,
                  int D, int fH, int fW, int WB, int nx, int ny) {
  __shared__ int s_cell[kThreads];
  __shared__ long long s_row[kThreads];
  __shared__ float2 s_sum[kWarps][32];

  const RowFit fit = row_fit(coords, kept, N, D, fH, fW, WB, nx, ny);
  if (!fit.any_kept) return;  // block-uniform

  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const int n_drop = __popc(__ballot_sync(0xffffffffu, fit.dropped));
  if (lane == 0 && n_drop) atomicAdd(&drops[fit.f], n_drop);
  s_cell[r] = fit.cell;
  s_row[r] = fit.p;
  __syncthreads();

  float* frame = out + (size_t)fit.f * nx * ny * kChan;
  float2 sum = make_float2(0.f, 0.f);
  const int rows = fH * kUBlock;
  for (int i = warp; i < rows; i += kWarps) {
    const int cell = s_cell[i];
    if (cell < 0) continue;
    const float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(x + s_row[i] * kChan)[lane]);
    if (kAtomics) {
      float* dst = frame + (size_t)cell * kChan + 2 * lane;
      atomicAdd(dst, v.x);
      atomicAdd(dst + 1, v.y);
    } else {
      sum.x += v.x;
      sum.y += v.y;
    }
  }
  if (kAtomics) return;
  s_sum[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sum.x += s_sum[w][lane].x;
      sum.y += s_sum[w][lane].y;
    }
    reinterpret_cast<float2*>(sink + (size_t)blockIdx.x * kChan)[lane] = sum;
  }
}

}  // namespace

// As sf_patch_pool for bf16 rows, plus sink (groups, 64) fp32 for
// atomics = 0 (out is then left as it was).
extern "C" int sf_patch_pool_row_atomics(const void* x, const int* coords,
                                         const uint8_t* kept, float* out,
                                         int* drops, float* sink, int F,
                                         int N, int D, int fH, int fW,
                                         int nx, int ny, int atomics,
                                         void* stream) {
  const int WB = (fW + kUBlock - 1) / kUBlock;
  const long long groups = (long long)F * N * D * WB;
  if (groups == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (atomics)
    row_atomic_kernel<true><<<(unsigned)groups, kThreads, 0, s>>>(
        xb, coords, kept, out, drops, sink, N, D, fH, fW, WB, nx, ny);
  else
    row_atomic_kernel<false><<<(unsigned)groups, kThreads, 0, s>>>(
        xb, coords, kept, out, drops, sink, N, D, fH, fW, WB, nx, ny);
  return static_cast<int>(cudaGetLastError());
}
