// Camera lift-splat pool with the patch budget of the TPU kernel.
//
// Replaces the TPU kernel
// streamingflow_tpu/ops/pallas_patch_pool.py::_patch_pool_kernel/_one_group,
// and holds the pool's backward (_pool_bwd there, plain jnp outside any TPU
// kernel) as a second kernel.  The function: frustum rows are grouped by (frame, camera,
// depth bin, 4 image columns), fH * 4 rows a group.  A group's patch origin
// is its min kept x and its min kept y floored to a multiple of 8, both
// clamped into the grid; a kept row is added into its BEV cell only if it
// falls inside the 16 x 24 patch from that origin, and the kept rows that do
// not fit are counted per frame.  The TPU kernel reached the cells with a
// one-hot matmul, because the TPU scatters slowly; here each kept row is
// added straight into its cell with fp32 atomics.
//
// What bounds it on an H100: bytes.  Per flagship forecast it reads 1.45 M
// rows x 64 bf16 features (186 MB) plus coords and mask, and writes the
// 3 x 200 x 200 x 64 fp32 grid.  The design reads x in place, in its
// (F, N, D, fH, fW, 64) layout: one warp moves a row's 128 bytes in one
// coalesced load, and nothing is repacked.  Atomic order varies from run to
// run, so sums agree with a sequential sum up to fp32 reassociation.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatchH = 16;  // x cells per patch
constexpr int kPatchW = 24;  // y cells per patch
constexpr int kUBlock = 4;   // image columns per group
constexpr int kThreads = 128;  // one thread per group row (fH * 4 <= 128)
constexpr int kWarps = kThreads / 32;
constexpr int kChan = 64;

// The patch-budget decision for thread r's row of group blockIdx.x.
struct RowFit {
  int f;           // frame of the group
  long long p;     // flat row index into (F, N, D, fH, fW); -1 for a thread
                   // beyond the group's rows or the image's columns
  int cell;        // cx * ny + cy if the row is summed, else -1
  bool dropped;    // kept, but outside the group's patch
  bool any_kept;   // the group has a kept row (the same in every thread)
};

__device__ RowFit row_fit(const int* __restrict__ coords,
                          const uint8_t* __restrict__ kept, int N, int D,
                          int fH, int fW, int WB, int nx, int ny) {
  __shared__ int s_min[2][kWarps];

  int g = blockIdx.x;
  const int wb = g % WB;
  g /= WB;
  const int d = g % D;
  g /= D;
  const int n = g % N;
  const int f = g / N;

  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  bool valid = false;
  int cx = INT_MAX, cy = INT_MAX;
  long long p = -1;
  if (r < fH * kUBlock) {
    const int h = r / kUBlock, w = wb * kUBlock + r % kUBlock;
    if (w < fW) {
      p = ((((long long)f * N + n) * D + d) * fH + h) * fW + w;
      if (kept[p] && coords[2 * p] >= 0) {
        valid = true;
        cx = coords[2 * p];
        cy = coords[2 * p + 1];
      }
    }
  }

  int mx = cx, my = cy;
  for (int o = 16; o > 0; o >>= 1) {
    mx = min(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    my = min(my, __shfl_xor_sync(0xffffffffu, my, o));
  }
  if (lane == 0) {
    s_min[0][warp] = mx;
    s_min[1][warp] = my;
  }
  __syncthreads();
  int minx = INT_MAX, miny = INT_MAX;
  for (int i = 0; i < kWarps; ++i) {
    minx = min(minx, s_min[0][i]);
    miny = min(miny, s_min[1][i]);
  }

  const int x0 = min(max(minx, 0), nx - kPatchH);
  const int y0 = min(max((miny >> 3) * 8, 0), ny - kPatchW);  // floor
  const int lx = cx - x0, ly = cy - y0;
  const bool fits =
      valid && lx >= 0 && lx < kPatchH && ly >= 0 && ly < kPatchW;
  return {f, p, fits ? cx * ny + cy : -1, valid && !fits, minx != INT_MAX};
}

__global__ void __launch_bounds__(kThreads)
patch_pool_kernel(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ coords,
                  const uint8_t* __restrict__ kept, float* __restrict__ out,
                  int* __restrict__ drops, int N, int D, int fH, int fW,
                  int WB, int nx, int ny) {
  __shared__ int s_cell[kThreads];
  __shared__ long long s_row[kThreads];

  const RowFit fit = row_fit(coords, kept, N, D, fH, fW, WB, nx, ny);
  if (!fit.any_kept) return;  // block-uniform

  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const int n_drop = __popc(__ballot_sync(0xffffffffu, fit.dropped));
  if (lane == 0 && n_drop) atomicAdd(&drops[fit.f], n_drop);
  s_cell[r] = fit.cell;
  s_row[r] = fit.p;
  __syncthreads();

  // one warp per row, two channels per lane
  float* frame = out + (size_t)fit.f * nx * ny * kChan;
  const int rows = fH * kUBlock;
  for (int i = warp; i < rows; i += kWarps) {
    const int cell = s_cell[i];
    if (cell < 0) continue;
    const float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(x + s_row[i] * kChan)[lane]);
    float* dst = frame + (size_t)cell * kChan + 2 * lane;
    atomicAdd(dst, v.x);
    atomicAdd(dst + 1, v.y);
  }
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// Backward of the pool: the pool is linear in x, so each row's gradient is
// the output cotangent at the row's cell if the forward summed the row, and
// zero if it did not (not kept, or lost to the patch budget).  Same groups
// and the same decision as the forward; one warp writes a row's 64 values.
// Bound by bytes: the cotangent grid is read (it stays in L2), one gradient
// row is written per frustum row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_pool_bwd_kernel(const float* __restrict__ dout,
                      const int* __restrict__ coords,
                      const uint8_t* __restrict__ kept, T* __restrict__ dx,
                      int N, int D, int fH, int fW, int WB, int nx, int ny) {
  __shared__ int s_cell[kThreads];
  __shared__ long long s_row[kThreads];

  const RowFit fit = row_fit(coords, kept, N, D, fH, fW, WB, nx, ny);
  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  s_cell[r] = fit.cell;
  s_row[r] = fit.p;
  __syncthreads();

  const float* frame = dout + (size_t)fit.f * nx * ny * kChan;
  const int rows = fH * kUBlock;
  for (int i = warp; i < rows; i += kWarps) {
    const long long p = s_row[i];
    if (p < 0) continue;  // a column beyond the image
    const int cell = s_cell[i];
    float2 v = make_float2(0.f, 0.f);
    if (cell >= 0)
      v = reinterpret_cast<const float2*>(frame + (size_t)cell * kChan)[lane];
    store2(dx + p * kChan + 2 * lane, v);
  }
}

}  // namespace

// x (F, N, D, fH, fW, 64) bf16; coords (F, N, D, fH, fW, 2) int32;
// kept (F, N, D, fH, fW) bool; out (F, nx, ny, 64) fp32 and drops (F,)
// int32, both zeroed by the caller.  fH * 4 <= 128.
extern "C" int sf_patch_pool(const void* x, const int* coords,
                             const uint8_t* kept, float* out, int* drops,
                             int F, int N, int D, int fH, int fW, int nx,
                             int ny, void* stream) {
  const int WB = (fW + kUBlock - 1) / kUBlock;
  const long long groups = (long long)F * N * D * WB;
  if (groups == 0) return 0;
  patch_pool_kernel<<<(unsigned)groups, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), coords, kept, out, drops, N, D,
      fH, fW, WB, nx, ny);
  return static_cast<int>(cudaGetLastError());
}

// dout (F, nx, ny, 64) fp32; coords and kept as above; dx (F, N, D, fH, fW,
// 64) fp32 or bf16, every row written.
extern "C" int sf_patch_pool_bwd(const float* dout, const int* coords,
                                 const uint8_t* kept, void* dx, int F, int N,
                                 int D, int fH, int fW, int nx, int ny,
                                 int dx_bf16, void* stream) {
  const int WB = (fW + kUBlock - 1) / kUBlock;
  const long long groups = (long long)F * N * D * WB;
  if (groups == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx_bf16)
    patch_pool_bwd_kernel<<<(unsigned)groups, kThreads, 0, s>>>(
        dout, coords, kept, static_cast<__nv_bfloat16*>(dx), N, D, fH, fW, WB,
        nx, ny);
  else
    patch_pool_bwd_kernel<<<(unsigned)groups, kThreads, 0, s>>>(
        dout, coords, kept, static_cast<float*>(dx), N, D, fH, fW, WB, nx,
        ny);
  return static_cast<int>(cudaGetLastError());
}
