// Submanifold 3x3x3 conv over z-fused column rows.
//
// Replaces the TPU kernel
// streamingflow_tpu/ops/pallas_winfuse.py::_winfuse_kernel.  That kernel
// read each block of 256 output columns through three fixed 304-row windows
// of source rows (one DMA per dx), picked the taps out with one-hot matmuls
// and ran the z conv as a banded (nz*Cin, nz*Cout) matmul: shapes for VMEM
// and the MXU, with ~nz/3 times the useful FLOPs.  Here each output column
// gathers its <= 9 neighbour rows by index.  A tap that is not found, or
// that the plan dropped, arrives as source row -1.
//
//   out[v, zo*Cout + j] = sum_{k < 9, src[k, v] >= 0}
//                         sum_{tz < 3, 0 <= zi < nz}
//                         sum_i feats[src[k, v], zi*Cin + i] * w[3k + tz, i, j]
//   with zi = zo + tz - 1, fp32 sums, written once in the input type.
//
// What bounds it on an H100: bytes.  The rows every taken tap reads (every
// z of a column, read once) and the output (every slot, every z) set the
// bound: 1.1 GB, 0.33 ms at stage 2 of the flagship.  A tile's rows are
// fetched once per tap that reads them (~6 found taps a column), so the
// traffic from L2 into the SMs is several times that.  The dense-z
// products (every z of every found tap, as the fused layout computes them)
// are ~0.23 TFLOP at stage 2: ~0.25 ms at the bf16 tensor-core peak, far
// above the fp32 CUDA cores' 67 TFLOP/s.  The kernel stays well above both
// (PERF.md, K3's findings): how fast the gather and the products are
// dispatched holds it.
//
// bf16 (the serving path): tensor cores, the gather pipelined across taps.
//   - One in-plane tap is one small GEMM with a contiguous K.  A tile's
//     source columns are staged with a zero z-halo row on each side, so
//     output item (c, zo) of tap k reads staged rows zo .. zo + 2 of column
//     c: K = 3*CP values, CP the channel pitch (8, 16 or 32; the wrapper
//     pads other widths), and B_k = w[3k:3k+3] as (3*CP, Cout), row
//     tz*CP + i (the wrapper's tap_weights).  Item rows overlap, so the A
//     fragments come from ldmatrix with one row address a lane.
//   - mma.sync.m16n8k16 bf16 with fp32 accumulators.  M runs over a tile
//     of 16 (up to 32) columns' items numbered c*nz + zo straight across
//     column boundaries, 16 to a fragment; the z halo keeps item
//     (c, nz - 1) off column c + 1.  A fragment whose columns have no found
//     tap skips the tap; a lane whose row belongs to a column without the
//     tap reads the zero tail instead.
//   - Warp-specialised: one copy warp and 8 warps of products, joined by
//     a ring of 6 (tile, tap) steps with full / empty mbarriers, no block
//     barrier in the loop.  The copy warp's lane c moves column c's whole
//     fused row (contiguous in feats and in shared memory) with one bulk
//     copy (cp.async.bulk, completing on the step's mbarrier); the rows of
//     the next steps land while a step's products run.  Per-thread
//     cp.async (16 bytes a thread) could not be dispatched fast enough.
//   - Each block stages all 9 B_k once, in the mma fragment order (one
//     16-byte shared load a lane for two n-tiles), stays resident and
//     walks tiles b, b + gridDim.x, ..., so neighbouring tiles' shared
//     source rows meet in L2.  The product warps load the next k16 step's
//     A and B fragments before the current step's mma.
// fp32 (chip checks at rtol 1e-5, the fp32 parity forward): TF32 tensor
// cores would miss 1e-5, so fp32 keeps the exact CUDA-core kernel of the
// first port: rows widened in shared memory, one lane an output channel,
// all-zero input rows skipped uniformly across a lane group.
//
// Past 32 channels in or out (stages 3 and 4 on columns: 64 and 128, with
// DENSE_TAIL_FROM_STAGE 0, 4 or 5) a first, simple design: block row y of
// the grid computes output channels 32y .. 32y + 31, so a tile's source
// rows are gathered once per 32 output channels.
//   - bf16: the same warp-specialised kernel with CP 32, 64 or 128 and
//     N = 32; the 9 taps' B no longer fit in shared memory beside the
//     ring, so each ring step carries its tap's B fragments for the block's
//     channels (one more bulk copy), in a ring of 3.
//   - fp32: the CUDA-core tile with the rows staged at 32, 64 or 128
//     channels and the tap's weights staged with them, each item's sum
//     taken over the input channels 32 at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100

// ------------------------------------------------------------------ fp32

namespace fp32 {

constexpr int kThreads = 256;

// Shared memory:
//   w_s    [27][CIN][G], zero past cin and past cout
//   x_s    [tv][nz + 2][CIN], the current tap's rows at z + 1 (rows 0 and
//          nz + 1 are the z halo); lanes past cin stay zero
//   flag_s [tv][nz + 2] int, 1 where the row holds a nonzero value
//   off_s  [tv * nz] int, c * (nz + 2) + zo for item (c, zo): its x_s row
//          of input z = zo - 1
//   src_s  [9][tv] the tile's source row of each tap, -1 if not found
template <int CIN, int G>
__global__ void __launch_bounds__(kThreads)
winfuse_kernel(const float* __restrict__ feats, const int* __restrict__ src,
               const float* __restrict__ w, float* __restrict__ out,
               int n_out, int nz, int cin, int cout, int tv) {
  constexpr int kGroups = kThreads / G;
  extern __shared__ float4 smem4[];
  const int rows = nz + 2;
  const int n_items = tv * nz;  // <= kThreads = kGroups * G
  float* x_s = reinterpret_cast<float*>(smem4);
  float* w_s = x_s + tv * rows * CIN;
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
    w_s[e] = j < cout && i < cin ? w[(t * cin + i) * cout + j] : 0.f;
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
          const float* p = feats + static_cast<size_t>(from) * row_len +
                           (tid - cc * nz) * cin;
          float* dst = x_s + row * CIN;
          if (vec) {
#pragma unroll
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
        float wr[CIN];
        const float* wp = w_s + (3 * k + tz) * CIN * G + lane;
#pragma unroll
        for (int i = 0; i < CIN; ++i) wr[i] = wp[i * G];
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
        out[(static_cast<size_t>(v0) * nz + item) * cout + lane] = acc[t];
      }
    }
  }
}

template <int CIN, int G>
cudaError_t launch(const float* feats, const int* src, const float* w,
                   float* out, int n_out, int nz, int cin, int cout,
                   int sms, cudaStream_t stream) {
  const int tv = kThreads / nz;
  const size_t rows = static_cast<size_t>(tv) * (nz + 2);
  const size_t smem = sizeof(float) * (rows * CIN + 27 * CIN * G) +
                      sizeof(int) * (rows + tv * nz + kTaps * tv);
  cudaError_t err = cudaFuncSetAttribute(
      winfuse_kernel<CIN, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, winfuse_kernel<CIN, G>, kThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (n_out + tv - 1) / tv;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  winfuse_kernel<CIN, G><<<blocks, kThreads, smem, stream>>>(
      feats, src, w, out, n_out, nz, cin, cout, tv);
  return cudaGetLastError();
}

template <int CIN>
cudaError_t by_cout(const float* feats, const int* src, const float* w,
                    float* out, int n_out, int nz, int cin, int cout,
                    int sms, cudaStream_t stream) {
  if (cout <= 16)
    return launch<CIN, 16>(feats, src, w, out, n_out, nz, cin, cout, sms,
                           stream);
  return launch<CIN, 32>(feats, src, w, out, n_out, nz, cin, cout, sms,
                         stream);
}

// More than 32 channels in or out (stages 3 and 4 on columns: 64 and 128).
// The first design's tile of columns, with block (x, y) computing output
// channels 32y .. 32y + 31 (a lane each) of its tiles: the rows of a tap
// are staged at CIN (32, 64 or 128) channels, and the tap's weights for the
// block's channels, w_s [3][CIN][32], are staged with them; each item's
// sum runs over the input channels 32 at a time.
//
// Shared memory: x_s [tv][nz + 2][CIN], w_s [3][CIN][32], then flag_s,
// off_s and src_s as in winfuse_kernel.
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

// ------------------------------------------------------------------ bf16

namespace tc {

// the products; with the copy warp 9 warps, so a thread may hold more
// registers than 128 (12 warps capped it there and spilled)
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one warp for the copies
constexpr int kStages = 6;     // ring of staged (tile, tap) steps
constexpr int kStagesWide = 3;  // the wide kernel's ring (a step carries B)
constexpr int kWideN = 32;     // output channels a block of the wide kernel
constexpr int kMaxTile = 32;   // columns of a tile, a lane of the copy warp each
constexpr int kTail = 4;       // zero rows after a stage's columns
constexpr int kNoCol = 63;     // column of an item past the tile

// channel pitch CP -> k16 steps of K = 3*CP (CP = 8 pads 24 to 32) and
// bytes of a staged row
template <int CP>
struct Geo {
  static constexpr int kSteps = (3 * CP + 15) / 16;
  static constexpr int kPad = 16 * kSteps;
  static constexpr int kPitch = 2 * CP;
};
// m16 fragments a consumer warp owns in a tile: 48 accumulators a thread
template <int NT>
__host__ __device__ constexpr int frags_per_warp() { return 12 / NT; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16) from global src to shared dst by the copy
// engine; they count against bar's expected transaction bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool W>
__host__ __device__ constexpr int ring_steps() {
  return W ? kStagesWide : kStages;
}
template <int CP>
__host__ __device__ constexpr size_t stage_bytes(int tile, int nz) {
  return static_cast<size_t>(tile * (nz + 2) + kTail) * Geo<CP>::kPitch;
}
// bytes of one tap's B fragments for kWideN output channels (wide kernel)
template <int CP>
__host__ __device__ constexpr size_t tap_b_bytes() {
  return static_cast<size_t>(Geo<CP>::kPad) * kWideN * 2;
}
// bytes of one ring step: its staged rows, and in the wide kernel its B
template <int CP, bool W>
__host__ __device__ constexpr size_t step_bytes(int tile, int nz) {
  return stage_bytes<CP>(tile, nz) + (W ? tap_b_bytes<CP>() : 0);
}
template <int CP, int NT, bool W>
__host__ __device__ constexpr size_t smem_bytes(int tile, int nz) {
  return (W ? 0 : static_cast<size_t>(kTaps) * Geo<CP>::kPad * 8 * NT * 2) +
         ring_steps<W>() * (step_bytes<CP, W>(tile, nz) + 16 + 4) +
         4 * kConsumers * (frags_per_warp<NT>() + 1);
}

// Shared memory:
//   w_s    [9][kSteps][NT/2][32 lanes] uint4: a lane's B fragments (b0, b1)
//          of n-tiles 2p and 2p + 1 for one tap and k16 step
//   rows   [kStages][tile * (nz + 2) + kTail][2*CP bytes]: a step's staged
//          source columns, row c*(nz + 2) + 1 + z for input z of column c
//          (a column's nz rows are contiguous, as in feats); rows
//          c*(nz + 2) and c*(nz + 2) + nz + 1 (the z halo) and the tail stay
//          zero (a column whose tap is not found is read as the tail)
//   full_s, empty_s [kStages] mbarriers: a step's rows have landed (the
//          copy warp's arrive and the bulk copies' bytes); the consumer
//          warps are done with a buffer (one arrive a warp)
//   found_s [kStages] uint32: bit c set where column c's tap is found
//   arow_s [kConsumerWarps][kFrags][32] int: of each lane's ldmatrix row
//          item (c, zo), c << 16 | the staged row of its input z = zo - 1,
//          c*(nz + 2) + zo (past the tile's items: kNoCol << 16 | the tail)
//   fmask_s [kConsumerWarps][kFrags] uint32: the columns a fragment's
//          items lie in
//
// W (wide, Cin or Cout past 32; CP 32, 64 or 128, NT 4): no w_s.  Block
// (x, y) computes output channels kWideN*y .. kWideN*y + 31, and each ring
// step carries, after its rows, its tap's B fragments for those channels
// (tap_b_bytes, in w_s's order, one bulk copy by the copy warp's lane 0
// from wk as the wrapper's wide_tap_weights lays it out); the ring has
// kStagesWide steps.
template <int CP, int NT, bool W>
__global__ void __launch_bounds__(kThreads)
winfuse_kernel(const __nv_bfloat16* __restrict__ feats,
               const int* __restrict__ src,
               const __nv_bfloat16* __restrict__ wk,
               __nv_bfloat16* __restrict__ out, int n_out, int nz, int cout,
               int tile_log2) {
  using G = Geo<CP>;
  constexpr int kSteps = G::kSteps;
  constexpr int kPitch = G::kPitch;
  constexpr int kFrags = frags_per_warp<NT>();
  constexpr int kRing = ring_steps<W>();
  const int tile = 1 << tile_log2;
  extern __shared__ uint4 smem[];
  uint4* w_s = smem;
  const int w_vecs = W ? 0 : kTaps * kSteps * (NT / 2) * 32;
  unsigned char* rows = reinterpret_cast<unsigned char*>(w_s + w_vecs);
  const size_t stage = stage_bytes<CP>(tile, nz);
  const size_t step = step_bytes<CP, W>(tile, nz);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + kRing * step);
  uint32_t* found_s = reinterpret_cast<uint32_t*>(bars + 2 * kRing);
  int* arow_s = reinterpret_cast<int*>(found_s + kRing);
  uint32_t* fmask_s =
      reinterpret_cast<uint32_t*>(arow_s + kConsumers * kFrags);
  const uint32_t rows_u32 = smem_u32(rows);
  const uint32_t full_u32 = smem_u32(bars);
  const uint32_t empty_u32 = full_u32 + 8 * kRing;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_items = tile * nz;
  const int n_tiles = (n_out + tile - 1) / tile;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  // items run column-major, item i = c*nz + zo for output z zo of column c
  // (straight across column boundaries), fragment f of consumer warp w
  // holds items 16*(w + kConsumerWarps*f) .. + 15
  for (int e = tid; e < kConsumers * kFrags; e += kThreads) {
    const int first = 16 * (e / 32);  // fragment e/32 = w + kConsumerWarps*f
    const int ln = e % 32;
    const int it = first + ln % 8 + 8 * ((ln / 8) % 2);  // ldmatrix row
    const int w = (e / 32) % kConsumerWarps, f = (e / 32) / kConsumerWarps;
    arow_s[(w * kFrags + f) * 32 + ln] =
        it < n_items ? (it / nz) << 16 | ((it / nz) * (nz + 2) + it % nz)
                     : kNoCol << 16 | (tile * (nz + 2));
    if (ln == 0) {
      uint32_t m = 0;
      if (first < n_items)
        for (int c = first / nz; c <= min(first + 15, n_items - 1) / nz; ++c)
          m |= 1u << c;
      fmask_s[w * kFrags + f] = m;
    }
  }

  // B fragments of every tap, staged once (the wide kernel's come with
  // each step).  Lane l's fragment of n-tile nt
  // and k16 step ks holds b0 = B[k0, k0 + 1][n], b1 = B[k0 + 8, k0 + 9][n]
  // with k0 = 16*ks + 2*(l % 4), n = 8*nt + l/4.  wk is read 16 bytes (8 n
  // values of one K row) a load and each value put in its place.
  if constexpr (!W) {
    __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(w_s);
    for (int e = tid; e < kTaps * G::kPad * NT; e += kThreads) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wk) + e);
      const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&v);
      const int nt = e % NT;
      const int kr = e / NT;  // row tap*kPad + kk of wk
      const int kk = kr % G::kPad;
      const int kin = kk % 16;
      const int frag =
          ((kr / G::kPad * kSteps + kk / 16) * (NT / 2) + nt / 2) * 32;
      const int word = (nt % 2) * 2 + kin / 8;  // b0 / b1 of n-tile nt
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ln = frag + 4 * c + (kin % 8) / 2;
        wb[(ln * 4 + word) * 2 + kin % 2] = vals[c];
      }
    }
  }
  // every staged row zero, so every column of every stage starts zero
  for (int e = tid; e < kRing * static_cast<int>(step / 16); e += kThreads)
    reinterpret_cast<uint4*>(rows)[e] = make_uint4(0, 0, 0, 0);
  if (tid < kRing) {
    mbar_init(full_u32 + 8 * tid, 1);
    mbar_init(empty_u32 + 8 * tid, kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- the copy warp: lane c stages column c of every step, its fused
    // row (nz z rows, contiguous in feats and in the buffer) in one bulk
    // copy.  A column whose tap is not found keeps stale rows: the
    // consumers read the zero tail in its place.
    const uint32_t row_bytes = nz * kPitch;
    const uint32_t b_bytes = W ? tap_b_bytes<CP>() : 0;
    // this block's output channels' B fragments, tap after tap
    const char* wk_chunk = reinterpret_cast<const char*>(wk) +
                           static_cast<size_t>(blockIdx.y) * kTaps * b_bytes;
    const bool mine = lane < tile;
    int cur[kTaps], nxt[kTaps];
    int s = 0;
    for (int lt = 0; lt <= my_tiles; ++lt) {
      // the next tile's sources are in flight while this tile's taps go out
#pragma unroll
      for (int k = 0; k < kTaps; ++k) cur[k] = nxt[k];
      const int v = (blockIdx.x + lt * gridDim.x) * tile + lane;
      const bool in = mine && lt < my_tiles && v < n_out;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        nxt[k] = in ? __ldg(src + static_cast<size_t>(k) * n_out + v) : -1;
      if (lt == 0) continue;
#pragma unroll
      for (int k = 0; k < kTaps; ++k, ++s) {
        const int b = s % kRing;
        mbar_wait(empty_u32 + 8 * b, ((s / kRing) & 1) ^ 1);
        const int from = cur[k];
        const uint32_t base = rows_u32 + b * step;
        // the found bits and the copies' bytes, then the copies
        const uint32_t found = __ballot_sync(0xffffffffu, from >= 0);
        __syncwarp();
        if (lane == 0) {
          found_s[b] = found;
          mbar_arrive_tx(full_u32 + 8 * b,
                         __popc(found) * row_bytes + b_bytes);
        }
        __syncwarp();
        if (from >= 0)
          bulk_copy(base + (lane * (nz + 2) + 1) * kPitch,
                    feats + static_cast<size_t>(from) * nz * CP, row_bytes,
                    full_u32 + 8 * b);
        if (W && lane == 0)
          bulk_copy(base + static_cast<uint32_t>(stage),
                    wk_chunk + static_cast<size_t>(k) * b_bytes, b_bytes,
                    full_u32 + 8 * b);
      }
    }
    return;
  }

  // ---- consumers
  const int g = lane / 4, q = lane % 4;
  float acc[kFrags][NT][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0.f;

  int s = 0;
  for (int lt = 0; lt < my_tiles; ++lt) {
    for (int k = 0; k < kTaps; ++k, ++s) {
      const int b = s % kRing;
      mbar_wait(full_u32 + 8 * b, (s / kRing) & 1);
      const uint32_t bits = found_s[b];
      // the fragments with a found column (the others add nothing)
      uint32_t live = 0;
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
        if (bits & fmask_s[warp * kFrags + f]) live |= 1u << f;
      if (live) {
        const uint32_t base = rows_u32 + b * step;
        const uint32_t tail = base + tile * (nz + 2) * kPitch;
        // this lane's row of each live fragment: its item's staged rows, or
        // the zero tail where the item's column has no found tap
        uint32_t row[kFrags];
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          const int e = arow_s[(warp * kFrags + f) * 32 + lane];
          const int c = e >> 16;
          row[f] = c < kMaxTile && ((bits >> c) & 1)
                       ? base + (e & 0xffff) * kPitch
                       : tail;
        }
        const uint4* wt =
            (W ? reinterpret_cast<const uint4*>(rows + b * step + stage)
               : w_s + k * kSteps * (NT / 2) * 32) +
            lane;
        // the fragments of k16 step ks: B for two n-tiles a uint4, and A
        // of each live fragment; this lane's 8-value chunk of K is staged
        // row + kk / CP, chunk (kk % CP) / 8 (past 3*CP, CP = 8: zeros)
        uint4 bq[2][NT / 2];
        uint32_t a[2][kFrags][4];
        auto load = [&](int ks, int slot) {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p)
            bq[slot][p] = wt[(ks * (NT / 2) + p) * 32];
          const int kk = 16 * ks + 8 * (lane / 16);
          const uint32_t off =
              kk < 3 * CP ? (kk / CP) * kPitch + ((kk % CP) / 8) * 16 : 0;
#pragma unroll
          for (int f = 0; f < kFrags; ++f)
            if ((live >> f) & 1) {
              ldmatrix_x4(row[f] + off, a[slot][f]);
              if (16 * ks + 8 >= 3 * CP) a[slot][f][2] = a[slot][f][3] = 0u;
            }
        };
        load(0, 0);
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks + 1 < kSteps) load(ks + 1, (ks + 1) % 2);
#pragma unroll
          for (int f = 0; f < kFrags; ++f) {
            if (!((live >> f) & 1)) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint4& bb = bq[ks % 2][nt / 2];
              mma_bf16(acc[f][nt], a[ks % 2][f], nt % 2 ? bb.z : bb.x,
                       nt % 2 ? bb.w : bb.y);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_u32 + 8 * b);
    }
    // the tile's outputs, every item
    const int v0 = (blockIdx.x + lt * gridDim.x) * tile;
    const int j0 = W ? kWideN * blockIdx.y : 0;
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int it = 16 * (warp + kConsumerWarps * f) + g + 8 * h;
        if (it >= n_items || v0 + it / nz >= n_out) continue;
        __nv_bfloat16* o = out + (static_cast<size_t>(v0) * nz + it) * cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int jj = j0 + 8 * nt + 2 * q;
          const float x0 = acc[f][nt][2 * h], x1 = acc[f][nt][2 * h + 1];
          if (jj + 1 < cout && cout % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + jj) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            if (jj < cout) o[jj] = __float2bfloat16(x0);
            if (jj + 1 < cout) o[jj + 1] = __float2bfloat16(x1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0.f;
    }
  }
}

// columns of a tile: the most (a power of 2, <= kMaxTile) whose items fit
// the consumers' fragments and whose ring fits in shared memory
template <int CP, int NT, bool W>
int tile_columns(int nz) {
  int tile = kMaxTile;
  while (tile > 1 &&
         ((tile * nz + 15) / 16 > kConsumerWarps * frags_per_warp<NT>() ||
          smem_bytes<CP, NT, W>(tile, nz) > kMaxSmem))
    tile /= 2;
  return tile;
}

template <int CP, int NT, bool W = false>
cudaError_t launch(const void* feats, const int* src, const void* wk,
                   void* out, int n_out, int nz, int cout, int sms,
                   cudaStream_t stream) {
  const int tile = tile_columns<CP, NT, W>(nz);
  int tile_log2 = 0;
  while ((1 << tile_log2) < tile) ++tile_log2;
  const size_t smem = smem_bytes<CP, NT, W>(tile, nz);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      winfuse_kernel<CP, NT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, winfuse_kernel<CP, NT, W>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the wide kernel: one block row a kWideN-channel chunk of the output
  const int chunks = W ? (cout + kWideN - 1) / kWideN : 1;
  const int tiles = (n_out + tile - 1) / tile;
  const int slots = sms * per_sm / chunks > 0 ? sms * per_sm / chunks : 1;
  const int blocks = tiles < slots ? tiles : slots;
  winfuse_kernel<CP, NT, W><<<dim3(blocks, chunks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), src,
      static_cast<const __nv_bfloat16*>(wk),
      static_cast<__nv_bfloat16*>(out), n_out, nz, cout, tile_log2);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_cout(const void* feats, const int* src, const void* wk,
                    void* out, int n_out, int nz, int cout, int sms,
                    cudaStream_t stream) {
  if (cout <= 16)
    return launch<CP, 2>(feats, src, wk, out, n_out, nz, cout, sms, stream);
  return launch<CP, 4>(feats, src, wk, out, n_out, nz, cout, sms, stream);
}

}  // namespace tc

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// feats (R, nz*cin) fp32 rows; src (9, n_out) int32 rows of feats, -1 for
// a tap that is not taken; w (27, cin, cout) fp32; out (n_out, nz*cout)
// fp32.  1 <= cin, cout <= 128 (past 32 in or out: the wide kernel),
// 1 <= nz <= 256.
extern "C" int sf_winfuse_fp32(const void* feats, const int* src,
                               const void* w, void* out, int n_out, int nz,
                               int cin, int cout, void* stream) {
  if (cin < 1 || cin > 128 || cout < 1 || cout > 128 || nz < 1 ||
      nz > fp32::kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* f = static_cast<const float*>(feats);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin > 32 || cout > 32) {
    if (cin <= 32)
      err = fp32::launch_wide<32>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
    else if (cin <= 64)
      err = fp32::launch_wide<64>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
    else
      err = fp32::launch_wide<128>(f, src, wf, o, n_out, nz, cin, cout, sms,
                                   s);
  } else if (cin <= 8)
    err = fp32::by_cout<8>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
  else if (cin <= 16)
    err = fp32::by_cout<16>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
  else
    err = fp32::by_cout<32>(f, src, wf, o, n_out, nz, cin, cout, sms, s);
  return static_cast<int>(err);
}

// feats (R, nz*cp) bf16 rows at channel pitch cp (channels past the
// layer's cin zero), 16-byte aligned; src (9, n_out) int32 as above; out
// (n_out, nz*cout) bf16; 1 <= nz <= 256.  Narrow (cp 8, 16 or 32 and
// 1 <= cout <= 32): wk (9, k_pad, n_pad) bf16 per-tap weights, row
// tz*cp + i, zero past cin and cout, k_pad = 3*cp rounded up to 16,
// n_pad = 16 if cout <= 16 else 32.  Wide (cp 64 or 128, or cp 32 with
// 32 < cout <= 128): wk the B fragments of every 32-channel output chunk
// and tap in the kernel's order (the wrapper's wide_tap_weights).
extern "C" int sf_winfuse_bf16(const void* feats, const int* src,
                               const void* wk, void* out, int n_out, int nz,
                               int cp, int cout, void* stream) {
  const bool wide = cp > 32 || cout > 32;
  if ((cp != 8 && cp != 16 && cp != 32 && cp != 64 && cp != 128) ||
      (wide && cp < 32) || cout < 1 || cout > 128 || nz < 1 || nz > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (cp == 32)
      err = tc::launch<32, 4, true>(feats, src, wk, out, n_out, nz, cout, sms,
                                    s);
    else if (cp == 64)
      err = tc::launch<64, 4, true>(feats, src, wk, out, n_out, nz, cout, sms,
                                    s);
    else
      err = tc::launch<128, 4, true>(feats, src, wk, out, n_out, nz, cout,
                                     sms, s);
  } else if (cp == 8)
    err = tc::by_cout<8>(feats, src, wk, out, n_out, nz, cout, sms, s);
  else if (cp == 16)
    err = tc::by_cout<16>(feats, src, wk, out, n_out, nz, cout, sms, s);
  else
    err = tc::by_cout<32>(feats, src, wk, out, n_out, nz, cout, sms, s);
  return static_cast<int>(err);
}
