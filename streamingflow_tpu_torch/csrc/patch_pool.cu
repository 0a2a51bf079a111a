// Camera lift-splat pool with the patch budget of the TPU kernel.
//
// Replaces the TPU kernel
// streamingflow_tpu/ops/pallas_patch_pool.py::_patch_pool_kernel/_one_group,
// forward only.  The function: frustum rows are grouped by (frame, camera,
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

__global__ void __launch_bounds__(kThreads)
patch_pool_kernel(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ coords,
                  const uint8_t* __restrict__ kept, float* __restrict__ out,
                  int* __restrict__ drops, int N, int D, int fH, int fW,
                  int WB, int nx, int ny) {
  __shared__ int s_min[2][kWarps];
  __shared__ int s_cell[kThreads];
  __shared__ long long s_row[kThreads];

  int g = blockIdx.x;
  const int wb = g % WB;
  g /= WB;
  const int d = g % D;
  g /= D;
  const int n = g % N;
  const int f = g / N;

  const int r = threadIdx.x;
  const int lane = r & 31, warp = r >> 5;
  const int rows = fH * kUBlock;
  bool valid = false;
  int cx = INT_MAX, cy = INT_MAX;
  long long p = 0;
  if (r < rows) {
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
  if (minx == INT_MAX) return;  // no kept row in the group (block-uniform)

  const int x0 = min(max(minx, 0), nx - kPatchH);
  const int y0 = min(max((miny >> 3) * 8, 0), ny - kPatchW);  // floor
  const int lx = cx - x0, ly = cy - y0;
  const bool fits =
      valid && lx >= 0 && lx < kPatchH && ly >= 0 && ly < kPatchW;
  const int n_drop = __popc(__ballot_sync(0xffffffffu, valid && !fits));
  if (lane == 0 && n_drop) atomicAdd(&drops[f], n_drop);
  s_cell[r] = fits ? cx * ny + cy : -1;
  s_row[r] = p;
  __syncthreads();

  // one warp per row, two channels per lane
  float* frame = out + (size_t)f * nx * ny * kChan;
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
