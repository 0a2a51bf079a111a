// Submanifold 3x3x3 conv over z-fused column rows.
//
// Replaces the TPU kernel
// streamingflow_tpu/ops/pallas_winfuse.py::_winfuse_kernel.  That kernel
// read each block of 256 output columns through three fixed 304-row windows
// of source rows (one DMA per dx), picked the taps out with one-hot matmuls
// and ran the z conv as a banded (nz*Cin, nz*Cout) matmul: shapes for VMEM
// and the MXU, with ~nz/3 times the useful FLOPs.  Here the function is
// computed directly: each output column gathers its <= 9 neighbour rows by
// index, and the 3-tap z conv is a dot product per output site.  A tap that
// is not found, or that the plan dropped, arrives as source row -1.
//
//   out[v, zo*Cout + j] = sum_{k < 9, src[k, v] >= 0}
//                         sum_{tz < 3, 0 <= zi < nz}
//                         sum_i feats[src[k, v], zi*Cin + i] * w[3k + tz, i, j]
//   with zi = zo + tz - 1, fp32 sums, written once in the input type.
//
// What bounds it on an H100: bytes.  The fused layout holds every z of a
// column, but LiDAR columns are nearly empty in z (~1.3 active sites of 41
// at stage 1, ~1.9 of 21 at stage 2), and the inputs are zero at inactive
// sites.  The work the data needs is the products of the nonzero input
// rows, a small fraction of the dense-z count; the rows themselves (every
// slot, every z, read once, and the output written once) set the bound.
// Design: as many blocks as fit on the card stay resident and walk tiles of
// `tv` output columns, so each block stages the weights (zero-padded to
// CIN x G, in the input type) into shared memory once.  For each in-plane
// tap a tile's neighbour rows go through shared memory as fp32, one thread
// per (column, z) row (16-byte loads where the rows allow), and the thread
// flags the rows that hold a nonzero value.  A group of G lanes (G >= Cout,
// one lane per output channel) owns (column, output z) items and keeps
// their sums in registers; it skips an item's z tap, uniformly across the
// group, when the input row is all zero, so the multiply-adds follow the
// nonzero rows.  Skipping exact zeros leaves every sum unchanged.  Tensor
// cores (mma / wgmma) and a gather pipelined across taps are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// 16 bytes of row values -> floats (4 fp32 or 8 bf16)
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    o[2 * q] = f.x;
    o[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory:
//   w_s    [27][CIN][G] in T, zero past cin and past cout
//   x_s    [tv][nz + 2][CIN] fp32, the current tap's rows at z + 1 (rows 0
//          and nz + 1 are the z halo); lanes past cin stay zero
//   flag_s [tv][nz + 2] int, 1 where the row holds a nonzero value
//   off_s  [tv * nz] int, c * (nz + 2) + zo for item (c, zo): its x_s row
//          of input z = zo - 1
//   src_s  [9][tv] the tile's source row of each tap, -1 if not found
template <typename T, int CIN, int G>
__global__ void __launch_bounds__(kThreads)
winfuse_kernel(const T* __restrict__ feats, const int* __restrict__ src,
               const T* __restrict__ w,
               T* __restrict__ out, int n_out, int nz, int cin, int cout,
               int tv) {
  constexpr int kGroups = kThreads / G;
  constexpr int kVec = 16 / sizeof(T);  // row values in 16 bytes
  extern __shared__ float4 smem4[];
  const int rows = nz + 2;
  const int n_items = tv * nz;  // <= kThreads = kGroups * G
  float* x_s = reinterpret_cast<float*>(smem4);
  T* w_s = reinterpret_cast<T*>(x_s + tv * rows * CIN);
  int* flag_s = reinterpret_cast<int*>(w_s + 27 * CIN * G);
  int* off_s = flag_s + tv * rows;
  int* src_s = off_s + n_items;
  const int tid = threadIdx.x;
  const int lane = tid % G;
  const int group = tid / G;

  for (int e = tid; e < 27 * CIN * G; e += kThreads) {
    const int j = e % G;
    const int i = (e / G) % CIN;
    const int t = e / (G * CIN);
    if (j < cout && i < cin)
      w_s[e] = w[(t * cin + i) * cout + j];
    else
      store(w_s + e, 0.f);
  }
  for (int e = tid; e < tv * rows * CIN; e += kThreads) x_s[e] = 0.f;
  for (int e = tid; e < tv * rows; e += kThreads) flag_s[e] = 0;
  for (int e = tid; e < n_items; e += kThreads)
    off_s[e] = (e / nz) * rows + e % nz;

  const int row_len = nz * cin;
  // rows of exactly CIN channels that start on 16 bytes are read 16 bytes
  // at a time, others one value at a time
  const bool vec = cin == CIN &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int n_tiles = (n_out + tv - 1) / tv;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int v0 = tile * tv;
    float acc[G];
#pragma unroll
    for (int t = 0; t < G; ++t) acc[t] = 0.f;
    __syncthreads();  // the previous tile's taps are no longer read
    for (int e = tid; e < kTaps * tv; e += kThreads) {
      const int v = v0 + e % tv;
      const size_t at = static_cast<size_t>(e / tv) * n_out + v;
      src_s[e] = v < n_out ? src[at] : -1;
    }
    for (int k = 0; k < kTaps; ++k) {
      __syncthreads();  // src_s is written, the previous tap's rows read
      // one thread per input row (column, z): its values and its flag
      if (tid < n_items) {
        const int cc = tid / nz;
        const int from = src_s[k * tv + cc];
        const int row = off_s[tid] + 1;
        bool nonzero = false;
        if (from >= 0) {
          const T* p = feats + static_cast<size_t>(from) * row_len +
                       (tid - cc * nz) * cin;
          float* dst = x_s + row * CIN;
          if (vec) {
#pragma unroll
            for (int q = 0; q < CIN / kVec; ++q) {
              float o[kVec];
              load16(p + q * kVec, o);
#pragma unroll
              for (int u = 0; u < kVec; u += 4) {
                reinterpret_cast<float4*>(dst + q * kVec)[u / 4] =
                    make_float4(o[u], o[u + 1], o[u + 2], o[u + 3]);
                nonzero |= o[u] != 0.f || o[u + 1] != 0.f ||
                           o[u + 2] != 0.f || o[u + 3] != 0.f;
              }
            }
          } else {
            for (int i = 0; i < cin; ++i) {
              const float v = to_f(p[i]);
              dst[i] = v;
              nonzero |= v != 0.f;
            }
          }
        }
        flag_s[row] = nonzero;
      }
      __syncthreads();
      for (int tz = 0; tz < 3; ++tz) {
        float wr[CIN];
        const T* wp = w_s + (3 * k + tz) * CIN * G + lane;
#pragma unroll
        for (int i = 0; i < CIN; ++i) wr[i] = to_f(wp[i * G]);
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int item = group + kGroups * t;
          if (item >= n_items) break;
          const int row = off_s[item] + tz;  // input z = zo + tz - 1
          if (!flag_s[row]) continue;
          const float4* xr =
              reinterpret_cast<const float4*>(x_s + row * CIN);
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < CIN / 4; ++q) {
            const float4 xv = xr[q];
            s = fmaf(xv.x, wr[4 * q + 0], s);
            s = fmaf(xv.y, wr[4 * q + 1], s);
            s = fmaf(xv.z, wr[4 * q + 2], s);
            s = fmaf(xv.w, wr[4 * q + 3], s);
          }
          acc[t] += s;
        }
      }
    }
    if (lane < cout) {
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int item = group + kGroups * t;
        if (item >= n_items) break;
        const int c = item / nz;
        if (v0 + c >= n_out) break;
        store(out + (static_cast<size_t>(v0) * nz + item) * cout + lane,
              acc[t]);
      }
    }
  }
}

template <typename T, int CIN, int G>
cudaError_t launch(const void* feats, const int* src, const void* w,
                   void* out, int n_out, int nz, int cin, int cout,
                   cudaStream_t stream) {
  const int tv = kThreads / nz;
  const size_t rows = static_cast<size_t>(tv) * (nz + 2);
  const size_t smem = sizeof(float) * rows * CIN + sizeof(T) * 27 * CIN * G +
                      sizeof(int) * (rows + tv * nz + kTaps * tv);
  cudaError_t err = cudaFuncSetAttribute(
      winfuse_kernel<T, CIN, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // blocks stay resident and walk the tiles, so the weights are staged
  // once per block
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, winfuse_kernel<T, CIN, G>, kThreads, smem)) !=
          cudaSuccess)
    return err;
  const int tiles = (n_out + tv - 1) / tv;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  winfuse_kernel<T, CIN, G><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), src, static_cast<const T*>(w),
      static_cast<T*>(out), n_out, nz, cin, cout, tv);
  return cudaGetLastError();
}

template <typename T, int CIN>
cudaError_t by_cout(const void* feats, const int* src, const void* w,
                    void* out, int n_out, int nz, int cin, int cout,
                    cudaStream_t stream) {
  if (cout <= 16)
    return launch<T, CIN, 16>(feats, src, w, out, n_out, nz, cin, cout,
                              stream);
  return launch<T, CIN, 32>(feats, src, w, out, n_out, nz, cin, cout,
                            stream);
}

template <typename T>
cudaError_t by_cin(const void* feats, const int* src, const void* w,
                   void* out, int n_out, int nz, int cin, int cout,
                   cudaStream_t stream) {
  if (cin <= 8)
    return by_cout<T, 8>(feats, src, w, out, n_out, nz, cin, cout, stream);
  if (cin <= 16)
    return by_cout<T, 16>(feats, src, w, out, n_out, nz, cin, cout, stream);
  return by_cout<T, 32>(feats, src, w, out, n_out, nz, cin, cout, stream);
}

}  // namespace

// feats (R, nz*cin) fp32 or bf16 rows; src (9, n_out) int32 rows of feats,
// -1 for a tap that is not taken; w (27, cin, cout) in the feats type; out
// (n_out, nz*cout) in the feats type.  1 <= cin, cout <= 32, 1 <= nz <= 256.
extern "C" int sf_winfuse(const void* feats, const int* src, const void* w,
                          void* out, int n_out, int nz, int cin, int cout,
                          int bf16, void* stream) {
  if (cin < 1 || cin > 32 || cout < 1 || cout > 32 || nz < 1 ||
      nz > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? by_cin<__nv_bfloat16>(feats, src, w, out, n_out, nz, cin, cout,
                                   s)
           : by_cin<float>(feats, src, w, out, n_out, nz, cin, cout, s);
  return static_cast<int>(err);
}
