// The patch budget of the camera pool, shared by csrc/patch_pool.cu (its
// backward) and csrc/patch_pool_ablation.cu: the group geometry and the
// decision, for one thread a group row, of which rows the forward sums.
// Included inside an anonymous namespace by each source, after <climits>
// and <cstdint>.
#pragma once

constexpr int kPatchH = 16;  // x cells per patch
constexpr int kPatchW = 24;  // y cells per patch
constexpr int kUBlock = 4;   // image columns per group
constexpr int kThreads = 128;  // the row budget of a group (fH * 4 <= 128);
                               // the backward's block, one thread a row
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

