// K3's fp32 forward (and d feats, the same conv over the reversed map):
// csrc/winfuse.cu's function on fp32 rows,
//
//   out[v, zo*Cout + j] = sum_{k < 9, src[k, v] >= 0}
//                         sum_{tz < 3, 0 <= zi < nz}
//                         sum_i feats[src[k, v], zi*Cin + i] * w[3k + tz, i, j]
//   with zi = zo + tz - 1, fp32 sums, written as fp32,
//
// for the released weights' evaluation and the fp32 training step (fp32
// points, COMPUTE_DTYPE 'auto') and the chip checks at rtol 1e-5.  Replaces
// the same TPU kernel, streamingflow_tpu/ops/pallas_winfuse.py::
// _winfuse_kernel, at fp32.
//   - Up to 32 channels in and out (namespace tf32, csrc/winfuse_tf32.cuh):
//     the bf16 kernel's structure (csrc/winfuse_tc.cuh) on the tensor cores
//     in 3xTF32, each operand split into two TF32 pieces and three products
//     a pair (csrc/tf32_mma.cuh), an error of fp32's order.  One-pass TF32
//     would miss 1e-5; the inputs, sums and output stay fp32, and TF32
//     stays off elsewhere (device.pin_tf32).  What bounds it: the products.
//   - Past 32 (stages 3 and 4 on columns: 64 and 128, namespace fp32): the
//     first port's CUDA-core tile with the rows staged at 32, 64 or 128
//     channels and the tap's weights staged with them, each item's sum
//     taken over the input channels 32 at a time; block row y of the grid
//     computes output channels 32y .. 32y + 31.
// Kept apart from csrc/winfuse.cu so that its kernels, and the bf16 ones'
// ablation builds, compile in their own nvcc processes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100

// ------------------------------------------------- fp32, past 32 channels

namespace fp32 {

constexpr int kThreads = 256;

// More than 32 channels in or out (stages 3 and 4 on columns: 64 and
// 128), the first port's CUDA-core design: block (x, y) computes output
// channels 32y .. 32y + 31 (a lane each) of its tiles of columns; the rows
// of a tap are staged at CIN (32, 64 or 128) channels, and the tap's
// weights for the block's channels with them; each item's sum runs over
// the input channels 32 at a time.
//
// Shared memory:
//   x_s    [tv][nz + 2][CIN], the current tap's rows at z + 1 (rows 0 and
//          nz + 1 are the z halo); lanes past cin stay zero
//   w_s    [3][CIN][32], the tap's weights for the block's channels
//   flag_s [tv][nz + 2] int, 1 where the row holds a nonzero value
//   off_s  [tv * nz] int, c * (nz + 2) + zo for item (c, zo): its x_s row
//          of input z = zo - 1
//   src_s  [9][tv] the tile's source row of each tap, -1 if not found
constexpr int kWideG = 32;

template <int CIN>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const float* __restrict__ feats, const int* __restrict__ src,
            const float* __restrict__ w, float* __restrict__ out, int n_out,
            int nz, int cin, int cout, int tv) {
  constexpr int G = kWideG;
  constexpr int kGroups = kThreads / G;
  extern __shared__ float4 smem4[];
  const int rows = nz + 2;
  const int n_items = tv * nz;  // <= kThreads
  float* x_s = reinterpret_cast<float*>(smem4);
  float* w_s = x_s + tv * rows * CIN;
  int* flag_s = reinterpret_cast<int*>(w_s + 3 * CIN * G);
  int* off_s = flag_s + tv * rows;
  int* src_s = off_s + n_items;
  const int tid = threadIdx.x;
  const int lane = tid % G;
  const int group = tid / G;
  const int j0 = G * blockIdx.y;

  for (int e = tid; e < tv * rows * CIN; e += kThreads) x_s[e] = 0.f;
  for (int e = tid; e < tv * rows; e += kThreads) flag_s[e] = 0;
  for (int e = tid; e < n_items; e += kThreads)
    off_s[e] = (e / nz) * rows + e % nz;

  const int row_len = nz * cin;
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
      for (int e = tid; e < 3 * CIN * G; e += kThreads) {
        const int j = e % G;
        const int i = (e / G) % CIN;
        const int tz = e / (G * CIN);
        w_s[e] = j0 + j < cout && i < cin
                     ? w[((3 * k + tz) * cin + i) * cout + j0 + j]
                     : 0.f;
      }
      if (tid < n_items) {
        const int cc = tid / nz;
        const int from = src_s[k * tv + cc];
        const int row = off_s[tid] + 1;
        bool nonzero = false;
        if (from >= 0) {
          const float* p = feats + static_cast<size_t>(from) * row_len +
                           (tid - cc * nz) * cin;
          float* dst = x_s + row * CIN;
          if (vec) {
            for (int q = 0; q < CIN / 4; ++q) {
              const float4 o = reinterpret_cast<const float4*>(p)[q];
              reinterpret_cast<float4*>(dst)[q] = o;
              nonzero |= o.x != 0.f || o.y != 0.f || o.z != 0.f ||
                         o.w != 0.f;
            }
          } else {
            for (int i = 0; i < cin; ++i) {
              dst[i] = p[i];
              nonzero |= p[i] != 0.f;
            }
          }
        }
        flag_s[row] = nonzero;
      }
      __syncthreads();
      for (int tz = 0; tz < 3; ++tz) {
        for (int c0 = 0; c0 < CIN; c0 += 32) {
          float wr[32];
          const float* wp = w_s + (tz * CIN + c0) * G + lane;
#pragma unroll
          for (int i = 0; i < 32; ++i) wr[i] = wp[i * G];
#pragma unroll
          for (int t = 0; t < G; ++t) {
            const int item = group + kGroups * t;
            if (item >= n_items) break;
            const int row = off_s[item] + tz;  // input z = zo + tz - 1
            if (!flag_s[row]) continue;
            const float4* xr =
                reinterpret_cast<const float4*>(x_s + row * CIN + c0);
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
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
    }
    if (j0 + lane < cout) {
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int item = group + kGroups * t;
        if (item >= n_items) break;
        const int c = item / nz;
        if (v0 + c >= n_out) break;
        out[(static_cast<size_t>(v0) * nz + item) * cout + j0 + lane] =
            acc[t];
      }
    }
  }
}

template <int CIN>
cudaError_t launch_wide(const float* feats, const int* src, const float* w,
                        float* out, int n_out, int nz, int cin, int cout,
                        int sms, cudaStream_t stream) {
  auto smem_of = [&](int tv) {
    const size_t rows = static_cast<size_t>(tv) * (nz + 2);
    return sizeof(float) * (rows * CIN + 3 * CIN * kWideG) +
           sizeof(int) * (rows + static_cast<size_t>(tv) * nz + kTaps * tv);
  };
  int tv = kThreads / nz;
  while (tv > 1 && smem_of(tv) > static_cast<size_t>(kMaxSmem)) --tv;
  const size_t smem = smem_of(tv);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wide_kernel<CIN>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int chunks = (cout + kWideG - 1) / kWideG;
  const int tiles = (n_out + tv - 1) / tv;
  const int slots = sms * per_sm / chunks > 0 ? sms * per_sm / chunks : 1;
  const int blocks = tiles < slots ? tiles : slots;
  wide_kernel<CIN><<<dim3(blocks, chunks), kThreads, smem, stream>>>(
      feats, src, w, out, n_out, nz, cin, cout, tv);
  return cudaGetLastError();
}

}  // namespace fp32

// the mbarrier, bulk-copy and ring helpers of the bf16 kernel
#include "winfuse_tc.cuh"

// ------------------------------------------------------------ fp32, 3xTF32

#include "winfuse_tf32.cuh"

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// feats (R, nz*cp) fp32 rows; src (9, n_out) int32 rows of feats, -1 for
// a tap that is not taken; out (n_out, nz*cout) fp32; 1 <= nz <= 256.
// Narrow (cin, cout <= 32): rows at channel pitch cp (8, 16 or 32; channels
// past cin zero), 16-byte aligned, and w the B values of the 3xTF32 kernel
// (the wrapper's tf32_tap_weights: 9 taps x 3*cp/8 k8 steps x n_pad/16 x 32
// lanes x 4, n_pad = 16 if cout <= 16 else 32).  Wide (cin or cout past 32,
// up to 128): cp = cin, and w (27, cin, cout) fp32.
extern "C" int sf_winfuse_fp32(const void* feats, const int* src,
                               const void* w, void* out, int n_out, int nz,
                               int cp, int cin, int cout, void* stream) {
  const bool is_wide = cin > 32 || cout > 32;
  if (cin < 1 || cin > 128 || cout < 1 || cout > 128 || nz < 1 ||
      nz > 256 || (is_wide ? cp != cin : (cp != 8 && cp != 16 && cp != 32)) ||
      cin > cp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_wide && (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* f = static_cast<const float*>(feats);
  const float* wf = static_cast<const float*>(w);
  const float4* wq = static_cast<const float4*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_wide) {
    if (cin <= 32)
      err = fp32::launch_wide<32>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
    else if (cin <= 64)
      err = fp32::launch_wide<64>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
    else
      err = fp32::launch_wide<128>(f, src, wf, o, n_out, nz, cin, cout, sms,
                                   s);
  } else if (cp == 8)
    err = tf32::by_cout<8>(f, src, wq, o, n_out, nz, cout, sms, s);
  else if (cp == 16)
    err = tf32::by_cout<16>(f, src, wq, o, n_out, nz, cout, sms, s);
  else
    err = tf32::by_cout<32>(f, src, wq, o, n_out, nz, cout, sms, s);
  return static_cast<int>(err);
}
