// d weights of the submanifold 3x3x3 conv over z-fused column rows: the
// weight gradient of K3 (csrc/winfuse.cu).
//
// Replaces the XLA vjp inside the JAX package's
// streamingflow_tpu/ops/pallas_winfuse.py::_winfuse_bwd, autograd of the
// 'sep' conv over the map's full found (no Pallas kernel computes it
// there).  For the cotangent g of the conv's output:
//
//   dw[3k + tz, i, j] = sum_{v : src[k, v] >= 0} sum_{zo, 0 <= zi < nz}
//                       feats[src[k, v], zi*Cin + i] * g[v, zo*Cout + j]
//   with zi = zo + tz - 1, fp32 sums, written as fp32 (27, Cin, Cout).
//
// (d feats is K3's own forward over the reversed map, csrc/winfuse.cu.)
//
// What bounds it on an H100: bytes.  g read once and every source row a
// found tap reads, once: at stage 2 of the flagship (5 clouds x 86,016
// column slots, nz 21, 32 -> 32, bf16) ~1.16 GB, 0.35 ms at 3.35 TB/s.  The
// products on every slot would be ~0.5 TFLOP (~7 ms on the fp32 CUDA
// cores), but after the masked BN the cotangent is zero at every inactive
// site, ~95% of the (column, z) rows, and the products those rows need are
// a few percent of that.
//
// Design (a first, simple one):
//   - A block walks chunks of TV output columns (grid-stride).  It stages
//     the chunk's cotangent rows in shared memory (widened to fp32, one
//     contiguous read), marks the (column, z) items whose row is not all
//     zero and lists them in ascending order (one warp, ballots).
//   - Then tap by tap: the source rows of the chunk's columns that have
//     the tap and an active item, between zero z-halo rows, so item
//     (c, zo) of z tap tz reads staged row zo + tz of column c.  A warp
//     stages a column, 16 bytes a lane (8 bf16 or 4 fp32 values): the
//     staging's index arithmetic, not its bytes, held a first version
//     that staged value by value at ~18.6 ms for stage 2.
//   - Each thread owns one (tz, i, 4 output channels) unit of every tap:
//     36 fp32 sums in registers for the whole run.  Thread groups of
//     larger blocks (narrow widths) take every groups-th item.
//   - At the end the groups' sums are added in a fixed order in shared
//     memory and each block writes one partial (27, Cin, Cout); a second
//     kernel adds the partials in block order.  No float atomics, so the
//     gradient is the same from run to run.
// The products run on the CUDA cores (fp32 FMA).  The kernel stays far
// above its bound (PERF.md, K3's rows): at stage 2 each of 768 threads walks
// every active item of every tap for 4 products, with its shared-memory
// loads and index arithmetic around them, and the 36 sums spill under the
// 80-register cap of 768 threads.  Tensor cores (mma.sync as the forward's
// bf16 kernel, or wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 768;          // threads a block, at most
constexpr int kMaxTv = 32;             // columns a chunk, at most
constexpr int kSmemBudget = 96 * 1024;  // bytes of a chunk's staging
constexpr int kMaxSmem = 232448;       // bytes a block may have on an H100

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of values (4 fp32 or 8 bf16) widened into floats at dst (16-byte
// aligned); the null pointer picks the type
__device__ __forceinline__ void widen16(float* dst, uint4 raw, const float*) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
__device__ __forceinline__ void widen16(float* dst, uint4 raw,
                                        const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Shared memory of a chunk of tv columns (rows = nz + 2):
//   g_s    [tv * nz][cout4] fp32 cotangent rows, channels past cout zero
//   x_s    [tv][rows][cin] the current tap's source rows at z + 1 (rows 0
//          and nz + 1 are the z halo)
//   item_s [tv * nz] the active items (c * nz + zo), ascending
//   flag_s [tv * nz] 1 where the item's cotangent row is not all zero
//   src_s  [9][tv] the chunk's source row of each tap, -1 if not taken
//   colf_s [tv] 1 where the column has an active item
//   count_s     the number of active items
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ feats, const int* __restrict__ src,
             const T* __restrict__ g, float* __restrict__ part, int n_out,
             int nz, int cin, int cout, int tv, int groups, int vec_f,
             int vec_g) {
  extern __shared__ float4 smem4[];
  const int cout4 = (cout + 3) & ~3;
  const int j4n = cout4 >> 2;
  const int units = 3 * cin * j4n;
  const int units_pad = (units + 31) & ~31;
  const int rows = nz + 2;
  const int n_items = tv * nz;
  float* g_s = reinterpret_cast<float*>(smem4);
  float* x_s = g_s + n_items * cout4;
  int* item_s = reinterpret_cast<int*>(x_s + tv * rows * cin);
  int* flag_s = item_s + n_items;
  int* src_s = flag_s + n_items;
  int* colf_s = src_s + kTaps * tv;
  int* count_s = colf_s + tv;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int unit = tid % units_pad;
  const int group = tid / units_pad;  // a whole warp is in one group
  const bool mine = unit < units;
  const int tz = unit / (cin * j4n);
  const int ci = (unit / j4n) % cin;
  const int j4 = unit % j4n;
  float acc[kTaps][4];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

  const int seg = rows * cin;  // a staged column: nz rows and the halo
  const int row_in = nz * cin;
  const int row_g = nz * cout;
  const int per = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes
  const int warp = tid >> 5, lane = tid & 31, n_warps = nthr >> 5;
  const T* tag = nullptr;
  // the halo rows stay zero: the staging writes rows 1 .. nz only
  for (int e = tid; e < tv * seg; e += nthr) x_s[e] = 0.f;
  const int n_chunks = (n_out + tv - 1) / tv;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * tv;
    const int nc = min(tv, n_out - v0);
    const T* gc = g + static_cast<long long>(v0) * row_g;
    if (vec_g) {
      // the chunk's rows are one contiguous run of g, 16 bytes a load
      const int n = nc * row_g;
      const uint4* gv = reinterpret_cast<const uint4*>(gc);
      for (int q = tid; q < n / per; q += nthr)
        widen16(g_s + q * per, __ldg(gv + q), tag);
      for (int e = n + tid; e < n_items * cout; e += nthr) g_s[e] = 0.f;
    } else if (cout4 == cout) {
      const int n = nc * nz * cout;
      for (int e = tid; e < n_items * cout; e += nthr)
        g_s[e] = e < n ? widen(gc[e]) : 0.f;
    } else {
      for (int e = tid; e < n_items * cout4; e += nthr) {
        const int it = e / cout4;
        const int j = e - it * cout4;
        g_s[e] = it < nc * nz && j < cout
                     ? widen(gc[static_cast<long long>(it) * cout + j])
                     : 0.f;
      }
    }
    for (int e = tid; e < kTaps * tv; e += nthr) {
      const int k = e / tv;
      const int c = e - k * tv;
      src_s[e] = c < nc ? src[static_cast<long long>(k) * n_out + v0 + c]
                        : -1;
    }
    __syncthreads();
    for (int it = tid; it < n_items; it += nthr) {
      const float4* r = reinterpret_cast<const float4*>(g_s + it * cout4);
      bool any = false;
      for (int q = 0; q < j4n; ++q) {
        const float4 a = r[q];
        any |= a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
      }
      flag_s[it] = any;
    }
    __syncthreads();
    if (tid < 32) {
      // ascending order, so every run sums in the same order
      int base = 0;
      for (int s0 = 0; s0 < n_items; s0 += 32) {
        const int it = s0 + tid;
        const bool f = it < n_items && flag_s[it];
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f) item_s[base + __popc(m & ((1u << tid) - 1u))] = it;
        base += __popc(m);
      }
      if (tid == 0) *count_s = base;
    }
    for (int c = tid; c < tv; c += nthr) {
      int f = 0;
      for (int z = 0; z < nz; ++z) f |= flag_s[c * nz + z];
      colf_s[c] = f;
    }
    __syncthreads();
    const int n_act = *count_s;
    if (n_act == 0) continue;  // the same for every thread

#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      // a warp a column, 16 bytes a lane where the rows allow it; columns
      // without the tap or without an active item are left unread
      for (int c = warp; c < nc; c += n_warps) {
        const int s = src_s[k * tv + c];
        if (s < 0 || !colf_s[c]) continue;
        float* xr = x_s + c * seg + cin;
        const T* fr = feats + static_cast<long long>(s) * row_in;
        if (vec_f) {
          const uint4* fv = reinterpret_cast<const uint4*>(fr);
          for (int q = lane; q < row_in / per; q += 32)
            widen16(xr + q * per, __ldg(fv + q), tag);
        } else {
          for (int e = lane; e < row_in; e += 32) xr[e] = widen(fr[e]);
        }
      }
      __syncthreads();
      if (mine) {
        for (int a = group; a < n_act; a += groups) {
          const int it = item_s[a];
          const int c = it / nz;
          if (src_s[k * tv + c] < 0) continue;
          const int zo = it - c * nz;
          const float xv = x_s[(c * rows + zo + tz) * cin + ci];
          const float4 gv =
              reinterpret_cast<const float4*>(g_s)[it * j4n + j4];
          acc[k][0] = fmaf(xv, gv.x, acc[k][0]);
          acc[k][1] = fmaf(xv, gv.y, acc[k][1]);
          acc[k][2] = fmaf(xv, gv.z, acc[k][2]);
          acc[k][3] = fmaf(xv, gv.w, acc[k][3]);
        }
      }
      __syncthreads();
    }
  }

  // one partial a block: the groups' sums added in group order
  const int n_w = 27 * cin * cout;
  float* out = part + static_cast<long long>(blockIdx.x) * n_w;
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(smem4);
  if (groups > 1) {
    for (int e = tid; e < n_w; e += nthr) red_s[e] = 0.f;
    __syncthreads();
  }
  for (int q = 0; q < groups; ++q) {
    if (mine && group == q) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 * 4 + jj;
          if (j >= cout) continue;
          const int e = ((3 * k + tz) * cin + ci) * cout + j;
          if (groups == 1)
            out[e] = acc[k][jj];
          else
            red_s[e] += acc[k][jj];
        }
    }
    if (groups > 1) __syncthreads();
  }
  if (groups > 1)
    for (int e = tid; e < n_w; e += nthr) out[e] = red_s[e];
}

// out[e] = sum of the blocks' partials, in block order
__global__ void wgrad_reduce(const float* __restrict__ part,
                             float* __restrict__ out, int n_parts, int n_w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p)
    s += part[static_cast<long long>(p) * n_w + e];
  out[e] = s;
}

template <typename T>
int launch(const void* feats, const int* src, const void* g, void* scratch,
           int max_parts, void* out, int n_out, int nz, int cin, int cout,
           void* stream) {
  if (cin < 1 || cin > 32 || cout < 1 || cout > 32 || nz < 1 || nz > 256 ||
      max_parts < 1 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cout4 = (cout + 3) & ~3;
  const int units = 3 * cin * (cout4 / 4);
  const int units_pad = (units + 31) & ~31;
  if (units_pad > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = kThreads / units_pad;
  const int threads = units_pad * groups;
  const int rows = nz + 2;
  const size_t per_col =
      (static_cast<size_t>(nz) * cout4 + static_cast<size_t>(rows) * cin) *
          sizeof(float) +
      (2 * static_cast<size_t>(nz) + kTaps + 1) * sizeof(int);
  const int tv = static_cast<int>(
      per_col >= kSmemBudget ? 1
                             : (kSmemBudget / per_col > kMaxTv
                                    ? kMaxTv
                                    : kSmemBudget / per_col));
  const int n_w = 27 * cin * cout;
  size_t smem = per_col * tv + sizeof(int);
  if (groups > 1 && smem < n_w * sizeof(float)) smem = n_w * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wgrad_kernel<T>, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n_out + tv - 1) / tv;
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  if (grid > max_parts) grid = max_parts;
  if (grid > n_chunks) grid = n_chunks;
  float* part = static_cast<float*>(scratch);
  if (grid > 0) {
    // 16-byte loads where every row starts on 16 bytes (and, for the
    // source rows, each staged column's first row does too)
    const size_t es = sizeof(T);
    const int vec_f = (static_cast<size_t>(nz) * cin * es) % 16 == 0 &&
                      cin % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(feats) % 16 == 0;
    const int vec_g = cout % 4 == 0 &&
                      (static_cast<size_t>(nz) * cout * es) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0;
    wgrad_kernel<T><<<grid, threads, smem, st>>>(
        static_cast<const T*>(feats), src, static_cast<const T*>(g), part,
        n_out, nz, cin, cout, tv, groups, vec_f, vec_g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wgrad_reduce<<<(n_w + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(out), grid, n_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (R, nz*Cin) and g (n_out, nz*Cout) in fp32 or bf16, src (9, n_out)
// int32 (-1: tap not taken), scratch max_parts x 27*Cin*Cout fp32 partials,
// out (27, Cin, Cout) fp32.  Returns a cudaError_t (0 = launched).
extern "C" int sf_winfuse_wgrad_fp32(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* out, int n_out,
                                     int nz, int cin, int cout,
                                     void* stream) {
  return launch<float>(feats, src, g, scratch, max_parts, out, n_out, nz,
                       cin, cout, stream);
}

extern "C" int sf_winfuse_wgrad_bf16(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* out, int n_out,
                                     int nz, int cin, int cout,
                                     void* stream) {
  return launch<__nv_bfloat16>(feats, src, g, scratch, max_parts, out, n_out,
                               nz, cin, cout, stream);
}
