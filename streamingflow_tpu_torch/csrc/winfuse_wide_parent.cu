// The wide (Cin or Cout past 32) bf16 kernels of K3 as they were before
// their redesign, kept only as the yardstick of the A/B that chip_smoke.py
// times beside the kernels that replaced them (csrc/winfuse.cu's wide
// forward, csrc/winfuse_wgrad.cu's wide d weights).  Nothing of the model
// path calls them.
//
//   - sf_winfuse_bf16_parent: block row y of the grid computes output
//     channels 32y .. 32y + 31, so a tile's source rows are gathered once
//     per 32 output channels; the warp-specialised kernel of the narrow
//     widths, each ring step carrying its tap's B fragments for the block's
//     channels, in a ring of 3.  Its weights are laid out as
//     chip_smoke.py's parent_wide_tap_weights lays them out.
//   - sf_winfuse_wgrad_bf16_parent: dW cut into 32 x 32 chunks of
//     (Cin, Cout), one block row each, every block row staging the whole
//     cotangent rows and listing the active items again; partials added in
//     block order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WINFUSE_WGRAD_PART
#define WINFUSE_WGRAD_PART 0
#endif

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100

#include "winfuse_tc.cuh"

// the d weights' kernels in a namespace of their own: both headers
// define a namespace tc
namespace wgrad {
#include "winfuse_wgrad_tc.cuh"
}  // namespace wgrad

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

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t reduce(const float* part, void* out, int n_parts, int n_w,
                   cudaStream_t st) {
  wgrad_reduce<<<(n_w + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(out), n_parts, n_w);
  return cudaGetLastError();
}

}  // namespace

// as sf_winfuse_bf16 of csrc/winfuse.cu, wide widths only (cp 32, 64 or
// 128 with cp > 32 or cout > 32)
extern "C" int sf_winfuse_bf16_parent(const void* feats, const int* src,
                                      const void* wk, void* out, int n_out,
                                      int nz, int cp, int cout,
                                      void* stream) {
  if ((cp != 32 && cp != 64 && cp != 128) || (cp == 32 && cout <= 32) ||
      cout < 1 || cout > 128 || nz < 1 || nz > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp == 32)
    err = tc::launch<32, 4, true>(feats, src, wk, out, n_out, nz, cout, sms,
                                  s);
  else if (cp == 64)
    err = tc::launch<64, 4, true>(feats, src, wk, out, n_out, nz, cout, sms,
                                  s);
  else
    err = tc::launch<128, 4, true>(feats, src, wk, out, n_out, nz, cout, sms,
                                   s);
  return static_cast<int>(err);
}

// as sf_winfuse_wgrad_bf16 of csrc/winfuse_wgrad.cu before its redesign,
// wide widths only (cin or cout past 32; cp and np 32, 64 or 128)
extern "C" int sf_winfuse_wgrad_bf16_parent(const void* feats,
                                            const int* src, const void* g,
                                            void* scratch, int max_parts,
                                            void* out, int n_out, int nz,
                                            int cp, int cin, int np,
                                            int cout, void* stream) {
  auto pitch_ok = [](int p) { return p == 32 || p == 64 || p == 128; };
  if (!(cin > 32 || cout > 32) || !pitch_ok(cp) || !pitch_ok(np) ||
      cin < 1 || cin > cp || cout < 1 || cout > np || nz < 1 || nz > 256 ||
      max_parts < 1 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0, grid = 0;
  cudaError_t err = sm_count(&sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (err == cudaSuccess)
    err = wgrad::tc::launch<32, 32, true>(feats, src, g, part, max_parts, n_out, nz,
                                    cin, cout, sms, st, &grid, cp, np);
  if (err == cudaSuccess) err = reduce(part, out, grid, 27 * cin * cout, st);
  return static_cast<int>(err);
}
