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
//   - Past 32 (stages 3 and 4 on columns: 64 and 128, namespace wide_tf32,
//     csrc/winfuse_wide_tf32.cuh): the wide bf16 kernel's structure
//     (z-major items, the rows' activity masks, B in slabs through a ring)
//     in the same 3xTF32, tiles of 384 items, the rows staged 32 channels
//     at a time and B split on the host.  What bounds it: the products,
//     then B's traffic from L2.
// Kept apart from csrc/winfuse.cu so that its kernels, and the bf16 ones'
// ablation builds, compile in their own nvcc processes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100

#include "winfuse_masks.cuh"

// the mbarrier, bulk-copy and ring helpers of the bf16 kernel
#include "winfuse_tc.cuh"

// ------------------------------------------------------------ fp32, 3xTF32

#include "winfuse_tf32.cuh"

// ------------------------------------------------- fp32, past 32 channels

#include "winfuse_wide_tf32.cuh"

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// feats (R, nz*cp) fp32 rows at channel pitch cp (channels past the
// layer's cin zero), 16-byte aligned; src (9, n_out) int32 rows of feats,
// -1 for a tap that is not taken; out (n_out, nz*cout) fp32; 1 <= nz <=
// 256.  Narrow (cp 8, 16 or 32 and cout <= 32): w the B values of the
// 3xTF32 kernel (the wrapper's tf32_tap_weights: 9 taps x 3*cp/8 k8 steps x
// n_pad/16 x 32 lanes x 4, n_pad = 16 if cout <= 16 else 32).  Wide (cp 64
// or 128, or cp 32 with 32 < cout <= 128): w the B values of every chunk
// of 64*ng output channels (ng 1 or 2, the wrapper's wide_tf32_groups),
// split into TF32 hi and lo, in the kernel's substep order (the wrapper's
// wide_tf32_tap_weights), and masks uint32 scratch of n_rows (feats'
// rows) for the rows' activity where nz <= 32.  The narrow kernels do not
// read masks, n_rows and ng.
extern "C" int sf_winfuse_fp32(const void* feats, const int* src,
                               const void* w, void* out, int n_out, int nz,
                               int cp, int cout, void* masks, int n_rows,
                               int ng, void* stream) {
  const bool is_wide = cp > 32 || cout > 32;
  if ((cp != 8 && cp != 16 && cp != 32 && cp != 64 && cp != 128) ||
      (is_wide && cp < 32) || cout < 1 || cout > 128 || nz < 1 ||
      nz > 256 || (ng != 1 && ng != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* f = static_cast<const float*>(feats);
  const float4* wq = static_cast<const float4*>(w);
  const uint4* wu = static_cast<const uint4*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_wide) {
    uint32_t* m = static_cast<uint32_t*>(masks);
    if (m == nullptr && nz <= wide_tf32::kMaxMaskZ)
      return static_cast<int>(cudaErrorInvalidValue);
    if (cp == 32)
      err = wide_tf32::by_groups<32>(f, src, m, n_rows, wu, o, n_out, nz,
                                     cout, ng, sms, s);
    else if (cp == 64)
      err = wide_tf32::by_groups<64>(f, src, m, n_rows, wu, o, n_out, nz,
                                     cout, ng, sms, s);
    else
      err = wide_tf32::by_groups<128>(f, src, m, n_rows, wu, o, n_out, nz,
                                      cout, ng, sms, s);
  } else if (cp == 8)
    err = tf32::by_cout<8>(f, src, wq, o, n_out, nz, cout, sms, s);
  else if (cp == 16)
    err = tf32::by_cout<16>(f, src, wq, o, n_out, nz, cout, sms, s);
  else
    err = tf32::by_cout<32>(f, src, wq, o, n_out, nz, cout, sms, s);
  return static_cast<int>(err);
}
