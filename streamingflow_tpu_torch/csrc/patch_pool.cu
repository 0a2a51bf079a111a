// Camera lift-splat pool with the patch budget of the TPU kernel.
//
// Replaces the TPU kernel
// streamingflow_tpu/ops/pallas_patch_pool.py::_patch_pool_kernel/_one_group,
// and holds the pool's backward (_pool_bwd there, plain jnp outside any TPU
// kernel) as a second kernel.  The function: frustum rows are grouped by
// (frame, camera, depth bin, 4 image columns), fH * 4 rows a group.  A
// group's patch origin is its min kept x and its min kept y floored to a
// multiple of 8, both clamped into the grid; a kept row is added into its
// BEV cell only if it falls inside the 16 x 24 patch from that origin, and
// the kept rows that do not fit are counted per frame.  Each value is
// rounded to bf16 before the fp32 sum.  The TPU kernel reached the cells
// with a one-hot matmul, because the TPU scatters slowly; nothing here needs
// the tensor cores.
//
// What bounds the forward on an H100: bytes.  Per flagship forecast it
// reads 1.38 M kept rows x 64 bf16 features (176 MB) plus coords and mask,
// and writes the 3 x 200 x 200 x 64 fp32 grid (30.7 MB, which stays in the
// 50 MB L2).  The design, for that bound:
//   - one warp a group, no block barrier: the group's coords and mask come
//     in one burst (a lane takes 4 rows), the patch origin is a warp min,
//     the drop count one ballot and one atomic a warp, an empty group leaves
//     at once;
//   - a quarter of the warp walks one image column down h, a lane holding 8
//     channels: one warp load covers one h-step of the group, 4 rows of
//     contiguous memory, with 16-byte loads a lane, several h-steps issued
//     ahead of their use and marked evict-first so the grid stays in L2;
//   - a column's rows change cell about every 27 h-steps (rows in memory
//     order change every 1.25), so a quarter keeps a running fp32 sum of its
//     run of rows that share a cell and adds it to the grid with two float4
//     reductions a lane only when the cell changes: ~0.8 M float4
//     reductions a flagship forecast in place of 88 M scalar atomics;
//   - fp32 rows are read as they are and rounded to bf16 in registers
//     (round to nearest even, as a cast), so no cast pass runs before it.
// Reduction order varies from run to run, so sums agree with a sequential
// sum up to fp32 reassociation.  The deterministic route (scale > 0, the
// route under torch.use_deterministic_algorithms) adds each run's fp32 sum,
// rounded to an integer in units of 1 / scale, into a 64-bit integer grid
// with integer atomics: exact, so the grid does not depend on their order
// (a run is the same rows whatever the schedule), and the caller turns it
// into fp32.  The caller picks scale = 2^S such that a frame's summed
// magnitudes stay below 2^62 units.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "patch_pool_fit.cuh"

// ---------------------------------------------------------------- forward

constexpr int kPoolWarps = 4;  // groups a block, one warp each
constexpr int kPoolThreads = kPoolWarps * 32;
constexpr int kRowsPerLane = kThreads / 32;  // group rows whose coords a
                                             // lane loads

// A lane's 8 channels of one row: where they sit in the row and how they
// load.  bf16: channels 8s .. 8s+7, one 16-byte load; fp32: channels
// 4s .. 4s+3 and 32+4s .. 32+4s+3, two 16-byte loads, each covering 128
// contiguous bytes across the quarter.  s is the lane's index in its
// quarter.
template <typename T> struct Lane;

template <> struct Lane<__nv_bfloat16> {
  static constexpr int kAhead = 8;  // h-steps loaded before their use
  struct Vec { uint4 a; };
  __device__ static int off0(int s) { return 8 * s; }
  __device__ static int off1(int s) { return 8 * s + 4; }
  __device__ static Vec load(const __nv_bfloat16* row, int s) {
    return {__ldcs(reinterpret_cast<const uint4*>(row) + s)};
  }
  __device__ static void add(float (&acc)[8], const Vec& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v.a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <> struct Lane<float> {
  static constexpr int kAhead = 4;
  struct Vec { float4 a, b; };
  __device__ static int off0(int s) { return 4 * s; }
  __device__ static int off1(int s) { return 32 + 4 * s; }
  __device__ static Vec load(const float* row, int s) {
    const float4* r = reinterpret_cast<const float4*>(row);
    return {__ldcs(r + s), __ldcs(r + 8 + s)};
  }
  __device__ static void add(float (&acc)[8], const Vec& v) {
    acc[0] += round_bf16(v.a.x);
    acc[1] += round_bf16(v.a.y);
    acc[2] += round_bf16(v.a.z);
    acc[3] += round_bf16(v.a.w);
    acc[4] += round_bf16(v.b.x);
    acc[5] += round_bf16(v.b.y);
    acc[6] += round_bf16(v.b.z);
    acc[7] += round_bf16(v.b.w);
  }
};

// Adds a run's sums into its cell: two float4 reductions (red.global.add
// .v4.f32 on sm_90).  Built with PATCH_POOL_LOADS_ONLY, an experiment that
// times the loads alone, the sums go into a register total instead, stored
// once at the end of the group.
__device__ __forceinline__ void flush(float* cell, int o0, int o1,
                                      float (&acc)[8], float (&total)[8]) {
#ifdef PATCH_POOL_LOADS_ONLY
#pragma unroll
  for (int i = 0; i < 8; ++i) total[i] += acc[i];
#else
  atomicAdd(reinterpret_cast<float4*>(cell + o0),
            make_float4(acc[0], acc[1], acc[2], acc[3]));
  atomicAdd(reinterpret_cast<float4*>(cell + o1),
            make_float4(acc[4], acc[5], acc[6], acc[7]));
#endif
}

// The deterministic route's flush: each sum rounded to an integer in
// 1 / scale units and added with an exact 64-bit integer atomic.
__device__ __forceinline__ void flush(long long* cell, int o0, int o1,
                                      float (&acc)[8], float (&total)[8],
                                      double scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  cell + (i < 4 ? o0 + i : o1 + i - 4)),
              static_cast<unsigned long long>(
                  __double2ll_rn(static_cast<double>(acc[i]) * scale)));
}

// kDet: the deterministic route, ``out`` a 64-bit integer grid in units
// of 1 / scale; else an fp32 grid.
template <typename T, bool kDet>
__global__ void __launch_bounds__(kPoolThreads)
patch_pool_kernel(const T* __restrict__ x, const int* __restrict__ coords,
                  const uint8_t* __restrict__ kept, void* __restrict__ out,
                  int* __restrict__ drops, int N, int D, int fH, int fW,
                  int WB, int nx, int ny, long long groups, double scale) {
  __shared__ int s_cell[kPoolWarps][kThreads];  // cell of each group row

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long group = (long long)blockIdx.x * kPoolWarps + warp;
  if (group >= groups) return;  // warp-uniform
  long long g = group;
  const int wb = g % WB;
  g /= WB;
  const int d = g % D;
  g /= D;
  const int n = g % N;
  const int f = g / N;
  // row (h, w) of the group is row (plane * fH + h) * fW + w of x
  const long long plane = ((long long)f * N + n) * D + d;

  // the group's coords and mask in one burst: lane takes rows lane + 32 i,
  // row r at h = r / 4, column wb * 4 + r % 4
  int2 c[kRowsPerLane];
  bool k[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int r = lane + 32 * i, h = r >> 2, w = wb * kUBlock + (r & 3);
    k[i] = false;
    c[i] = make_int2(0, 0);
    if (h < fH && w < fW) {
      const long long p = (plane * fH + h) * fW + w;
      k[i] = kept[p];
      c[i] = reinterpret_cast<const int2*>(coords)[p];
    }
  }
  int mx = INT_MAX, my = INT_MAX;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    k[i] = k[i] && c[i].x >= 0;
    if (k[i]) {
      mx = min(mx, c[i].x);
      my = min(my, c[i].y);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = min(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    my = min(my, __shfl_xor_sync(0xffffffffu, my, o));
  }
  if (mx == INT_MAX) return;  // no kept row: warp-uniform

  const int x0 = min(max(mx, 0), nx - kPatchH);
  const int y0 = min(max((my >> 3) * 8, 0), ny - kPatchW);  // floor
  int n_drop = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int lx = c[i].x - x0, ly = c[i].y - y0;
    const bool fits =
        k[i] && lx >= 0 && lx < kPatchH && ly >= 0 && ly < kPatchW;
    s_cell[warp][lane + 32 * i] = fits ? c[i].x * ny + c[i].y : -1;
    n_drop += __popc(__ballot_sync(0xffffffffu, k[i] && !fits));
  }
  if (lane == 0 && n_drop) atomicAdd(&drops[f], n_drop);
  __syncwarp();

  // quarter q walks column wb * 4 + q down h; lane s of it holds 8 channels
  using L = Lane<T>;
  constexpr int kAhead = L::kAhead;
  const int q = lane >> 3, s = lane & 7;
  const int o0 = L::off0(s), o1 = L::off1(s);
  const T* col = x + (plane * fH * fW + wb * kUBlock + q) * kChan;
  const long long h_stride = (long long)fW * kChan;
  using Acc = typename std::conditional<kDet, long long, float>::type;
  Acc* frame = static_cast<Acc*>(out) + (size_t)f * nx * ny * kChan;
  const int* cells = s_cell[warp] + q;

  float acc[8], total[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = total[i] = 0.f;
  int run = -1;  // cell of the running sum, -1 before the first row
  for (int h0 = 0; h0 < fH; h0 += kAhead) {
    typename L::Vec v[kAhead];
    int cell[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int h = h0 + u;
      cell[u] = h < fH ? cells[h * kUBlock] : -1;
      if (cell[u] >= 0) v[u] = L::load(col + h * h_stride, s);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (cell[u] < 0) continue;
      if (cell[u] != run) {
        if (run >= 0) {
          if constexpr (kDet)
            flush(frame + (size_t)run * kChan, o0, o1, acc, total, scale);
          else
            flush(frame + (size_t)run * kChan, o0, o1, acc, total);
        }
        run = cell[u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      }
      L::add(acc, v[u]);
    }
  }
  if (run >= 0) {
    if constexpr (kDet)
      flush(frame + (size_t)run * kChan, o0, o1, acc, total, scale);
    else
      flush(frame + (size_t)run * kChan, o0, o1, acc, total);
  }
#ifdef PATCH_POOL_LOADS_ONLY
  if constexpr (!kDet) {
    if (run >= 0) {
      float* dst = frame + (size_t)run * kChan;
      *reinterpret_cast<float4*>(dst + o0) =
          make_float4(total[0], total[1], total[2], total[3]);
      *reinterpret_cast<float4*>(dst + o1) =
          make_float4(total[4], total[5], total[6], total[7]);
    }
  }
#endif
}

// ---------------------------------------------------------------- backward

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

// x (F, N, D, fH, fW, 64) bf16 (x_fp32 0) or fp32 (x_fp32 1), 16-byte
// aligned; coords (F, N, D, fH, fW, 2) int32, 8-byte aligned; kept
// (F, N, D, fH, fW) bool; out (F, nx, ny, 64) fp32 (scale > 0: int64, the
// deterministic route's sums in 1 / scale units) and drops (F,) int32,
// both zeroed by the caller.  fH * 4 <= 128.
extern "C" int sf_patch_pool(const void* x, const int* coords,
                             const uint8_t* kept, void* out, int* drops,
                             int F, int N, int D, int fH, int fW, int nx,
                             int ny, int x_fp32, double scale, void* stream) {
  const int WB = (fW + kUBlock - 1) / kUBlock;
  const long long groups = (long long)F * N * D * WB;
  if (groups == 0) return 0;
  const unsigned blocks = (unsigned)((groups + kPoolWarps - 1) / kPoolWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool det = scale > 0;
  if (x_fp32 && det)
    patch_pool_kernel<float, true><<<blocks, kPoolThreads, 0, st>>>(
        static_cast<const float*>(x), coords, kept, out, drops, N, D, fH, fW,
        WB, nx, ny, groups, scale);
  else if (x_fp32)
    patch_pool_kernel<float, false><<<blocks, kPoolThreads, 0, st>>>(
        static_cast<const float*>(x), coords, kept, out, drops, N, D, fH, fW,
        WB, nx, ny, groups, scale);
  else if (det)
    patch_pool_kernel<__nv_bfloat16, true><<<blocks, kPoolThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), coords, kept, out, drops, N, D,
        fH, fW, WB, nx, ny, groups, scale);
  else
    patch_pool_kernel<__nv_bfloat16, false><<<blocks, kPoolThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), coords, kept, out, drops, N, D,
        fH, fW, WB, nx, ny, groups, scale);
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
