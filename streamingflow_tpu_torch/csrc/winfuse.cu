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
// fp32 rows take csrc/winfuse_fp32.cu (3xTF32 on the tensor cores at
// every width: the narrow kernel's structure up to 32 channels, the wide
// one's past them).
//
// Past 32 channels in or out (stages 3 and 4 on columns: 64 and 128, with
// DENSE_TAIL_FROM_STAGE 0, 4 or 5):
//   - bf16 (namespace wide): a block computes all output channels of its
//     tile (NG groups of 64, one block row of the grid per NG groups), so a
//     tap's source rows cross into shared memory once a tile.  One tap's B
//     at stage 4 (3*128 x 128 bf16, 96 KB) does not fit beside the rows
//     twice, so B streams in (tap, z tap) slabs (whole taps where a tap's
//     slab is at most 24 KB) through a ring of 3 or 4, while the taps' rows
//     sit in their own ring.  The 8 warps own 64 output channels each (8
//     n-tiles) and 3 m16 fragments of a tile of up to 48 columns (tile*nz
//     items: 190 of 192 at stage 4, 374 of 384 at stage 3).  Items run
//     z-major (neighbouring columns at one z a fragment), and a first
//     kernel (csrc/winfuse_masks.cuh's row_masks) marks the source rows
//     that are not all zero (-0 counting as zero; up to 32 z; past it
//     every z is marked): only those of found columns are
//     staged, and a fragment none of whose rows is marked at a z tap skips
//     it (neighbouring columns' inputs at one z are inactive together more
//     often than a column's z are).  Every
//     thread issues its share of the copies (the slab in 16 KB bulk
//     copies, the rows 16 bytes a cp.async into chunks XOR-swizzled by row,
//     so an ldmatrix's 8 rows fall in 8 bank groups), all completing on one
//     mbarrier a ring slot; one block barrier a substep.  What bounds it:
//     the products of the marked rows (the dense z of every found tap
//     before skipping, ~2-4x the active sites') and, at stage 3, the
//     shared-memory reads of B fragments, which every warp loads for its
//     64 channels; the slabs, 9 a tile at stage 3 and 27 at stage 4, come
//     from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Built with WINFUSE_WIDE_PART=1 (the copies and barriers alone, no
// products) or 2 (the products alone, of whatever the buffers hold, the
// fragments skipped as the row masks say), the wide bf16 kernel is an
// ablation whose result is wrong; chip_smoke.py times both to split the
// kernel's time.
#ifndef WINFUSE_WIDE_PART
#define WINFUSE_WIDE_PART 0
#endif


namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100

#include "winfuse_masks.cuh"

// ------------------------------------------------------------------ bf16

#include "winfuse_tc.cuh"

// ------------------------------------------------------------- bf16, wide

// Past 32 channels in or out (CP 32, 64 or 128; Cout up to 128).  A block
// computes every output channel of its tile, in 64-channel groups (NG of
// them, one block row of the grid per NG groups), so a tap's source rows
// cross into shared memory once a tile.
namespace wide {

using rowmask::kMaxMaskZ;
using rowmask::row_live;
using tc::bulk_copy;
using tc::cp_async16;
using tc::cp_async_arrive;
using tc::ldmatrix_x4;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::mma_bf16;
using tc::smem_u32;

constexpr int kWarps = 8;            // every warp copies and multiplies
constexpr int kThreads = 32 * kWarps;
constexpr int kFrags = 3;            // m16 fragments a warp owns in a tile
constexpr int kMaxTile = 48;         // columns of a tile
constexpr int kMaxItems = kWarps * kFrags * 16;
constexpr int kCopyBytes = 16384;    // bytes of one bulk copy of a slab

// A configuration: channel pitch CP, NG groups of 64 output channels, TZS
// z taps a substep (3: a whole tap, 1: one z tap), a ring of SLOTS
// substeps' weights and kRowBufs taps' rows.
template <int CP, int NG, int TZS, int SLOTS>
struct Cfg {
  static constexpr int kRow = 2 * CP;              // bytes of a staged row
  static constexpr int kSteps = TZS * CP / 16;     // k16 steps a substep
  static constexpr int kSlab = TZS * CP * 64 * NG * 2;  // B bytes a substep
  static constexpr int kPerTap = 3 / TZS;          // substeps a tap
  static constexpr int kSubsteps = kTaps * kPerTap;  // a tile
  static constexpr int kAhead = SLOTS - 1;         // substeps in flight
  // row buffers: a tap's rows go out kAhead substeps before its first
  // and are read until its last
  static constexpr int kRowBufs = (kAhead + 2 * kPerTap - 1) / kPerTap;
  static size_t smem_bytes(int tile, int nz) {
    return static_cast<size_t>(SLOTS) * kSlab +
           static_cast<size_t>(kRowBufs) * tile * nz * kRow + kRow +
           8 * SLOTS + 4 * (4 * kTaps * kMaxTile + kMaxItems);
  }
};
// the configuration of a width: whole taps where a tap's B (3*CP x 64*NG)
// is at most 24 KB, else one z tap a substep; a ring of 4 slabs up to 16
// KB, else 3
template <int CP, int NG>
struct Pick {
  static constexpr int kTZS = CP * NG <= 64 ? 3 : 1;
  static constexpr int kSlots = kTZS == 1 && CP * NG <= 128 ? 4 : 3;
  using C = Cfg<CP, NG, kTZS, kSlots>;
};

// 16-byte chunk j of staged row r lies at chunk j ^ swizzle(r): the 8 rows
// of an ldmatrix (8 neighbouring columns at one z, rows nz apart, nz odd)
// then fall in 8 different 16-byte bank groups
template <int CP>
__device__ __forceinline__ int swizzle(int r) {
  return CP == 32 ? (r >> 1) & 3 : r & 7;
}

// A tile of `tile` columns has n_items = tile*nz items (c, zo), numbered
// z-major, zo*tile + c, so a fragment's 16 items are neighbouring columns
// at one z, whose inputs at a z tap are inactive together more often than
// a column's z are; warp w owns output channels
// 64*(w % NG) .. + 63 (8 n-tiles) of fragments mg, mg + MG, mg + 2*MG
// (MG = 8 / NG, mg = w / NG), each 16 items.  The tile's work is 27 / TZS
// substeps (tap k, z taps tz0 .. tz0 + TZS - 1), K = TZS*CP each.
//
// Shared memory:
//   slabs [SLOTS][TZS*CP/16][NG*4][32 lanes] uint4: a substep's B
//         fragments, lane l's (b0, b1) of n-tiles 2p and 2p + 1 (the
//         wrapper's wide_tap_weights, one contiguous slab a substep)
//   rows  [kRowBufs][n_items][2*CP bytes]: a tap's active source rows, row
//         c*nz + z holding input z of column c's source (chunks swizzled),
//         so item (c, zo)'s input z = zo + tz - 1 is row c*nz + z.  A row
//         whose bit is clear (not found, or all zero) is not copied and
//         never read: a lane whose row is clear, or whose z leaves the
//         column, reads the zero row, and a fragment with no set row at a
//         z tap skips it.
//   zero  [2*CP bytes] zeros
//   full  [SLOTS] mbarriers: a substep's slab (and at a tap's first
//         substep the tap's rows) have landed; every thread arrives once
//         a use, when its cp.async copies land
//   src_s, zm_s [2][9][kMaxTile]: each column's source row of each tap
//         and that row's activity mask (0 where the tap is not taken), of
//         this tile and the next
//   col_s [n_items] int: the column of each staged row
//
// The ring: after one block barrier a substep (substep s - 1 is read),
// every thread issues its share of substep s + kAhead's copies (the slab
// in 16 KB bulk copies, the active rows 16 bytes a cp.async), then every
// warp works on substep s.
template <int CP, int NG, int TZS, int SLOTS>
__global__ void __launch_bounds__(kThreads, 1)
winfuse_kernel(const __nv_bfloat16* __restrict__ feats,
               const int* __restrict__ src,
               const uint32_t* __restrict__ masks,
               const __nv_bfloat16* __restrict__ wk,
               __nv_bfloat16* __restrict__ out, int n_out, int nz, int cout,
               int tile) {
  using C = Cfg<CP, NG, TZS, SLOTS>;
  constexpr int kMG = kWarps / NG;
  constexpr int kTapSteps = CP / 16;  // k16 steps of one z tap
  constexpr int kPieces = CP / 8;     // 16-byte pieces of a row
  extern __shared__ uint4 smem[];
  unsigned char* slabs = reinterpret_cast<unsigned char*>(smem);
  const int n_items = tile * nz;
  const int rows_bytes = n_items * C::kRow;
  unsigned char* rows = slabs + SLOTS * C::kSlab;
  unsigned char* zero = rows + C::kRowBufs * rows_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + C::kRow);
  int* src_s = reinterpret_cast<int*>(full + SLOTS);
  uint32_t* zm_s = reinterpret_cast<uint32_t*>(src_s + 2 * kTaps * kMaxTile);
  int* col_s = reinterpret_cast<int*>(zm_s + 2 * kTaps * kMaxTile);
  const uint32_t full_u32 = smem_u32(full);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ng = warp % NG, mg = warp / NG;
  const int j0 = 64 * (NG * blockIdx.y + ng);
  const char* wk_chunk =
      reinterpret_cast<const char*>(wk) +
      static_cast<size_t>(blockIdx.y) * C::kSubsteps * C::kSlab;
  const int n_tiles = (n_out + tile - 1) / tile;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * C::kSubsteps;
  const bool masked = nz <= kMaxMaskZ;

  for (int e = tid; e < C::kRow / 16; e += kThreads)
    reinterpret_cast<uint4*>(zero)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < n_items; e += kThreads) col_s[e] = e / nz;
  if (tid < SLOTS) mbar_init(full_u32 + 8 * tid, kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // this lane's ldmatrix item of fragment f (item 16*(mg + MG*f) + lane %
  // 8 + 8*((lane / 8) % 2), its k half lane / 16): c << 16 | zo, or -1
  // past the tile
  int fi[kFrags];
#pragma unroll
  for (int f = 0; f < kFrags; ++f) {
    const int it = 16 * (mg + kMG * f) + lane % 8 + 8 * ((lane / 8) % 2);
    fi[f] = it < n_items ? (it % tile) << 16 | (it / tile) : -1;
  }
  // tile lt's source rows (-1: tap not taken, or past the columns) and
  // their masks (every z where no mask is kept)
  auto load_src = [&](int lt) {
    if (lt >= my_tiles) return;
    const int v0 = (blockIdx.x + lt * gridDim.x) * tile;
    const int at = (lt & 1) * kTaps * kMaxTile;
    for (int e = tid; e < kTaps * tile; e += kThreads) {
      const int k = e / tile, c = e - k * tile;
      const int s = v0 + c < n_out
          ? __ldg(src + static_cast<size_t>(k) * n_out + v0 + c) : -1;
      src_s[at + k * kMaxTile + c] = s;
      zm_s[at + k * kMaxTile + c] =
          s < 0 ? 0u : masked ? __ldg(masks + s) : 0xffffffffu;
    }
  };
  // substep s's slab into slot s % SLOTS and, at its tap's first
  // substep, the tap's active rows into rows buffer tap % kRowBufs, both
  // on the slot's mbarrier
  auto issue = [&](int s) {
    if (s >= total) return;
    const int lt = s / C::kSubsteps, ks = s - lt * C::kSubsteps;
    const uint32_t bar = full_u32 + 8 * (s % SLOTS);
    if (WINFUSE_WIDE_PART != 2 && tid * kCopyBytes < C::kSlab) {
      const int bytes = min(kCopyBytes, C::kSlab - tid * kCopyBytes);
      mbar_expect_tx(bar, bytes);
      // the block's reads of the slot come before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(smem_u32(slabs + (s % SLOTS) * C::kSlab) + tid * kCopyBytes,
                wk_chunk + static_cast<size_t>(ks) * C::kSlab +
                    tid * kCopyBytes,
                bytes, bar);
    }
    if (WINFUSE_WIDE_PART != 2 && ks % C::kPerTap == 0) {
      const int at = ((lt & 1) * kTaps + ks / C::kPerTap) * kMaxTile;
      const uint32_t buf =
          smem_u32(rows + ((s / C::kPerTap) % C::kRowBufs) * rows_bytes);
      for (int e = tid; e < n_items * kPieces; e += kThreads) {
        const int r = e / kPieces, piece = e - r * kPieces;
        const int c = col_s[r], z = r - c * nz;
        if (row_live(zm_s[at + c], z))
          cp_async16(buf + r * C::kRow + 16 * (piece ^ swizzle<CP>(r)),
                     feats + (static_cast<size_t>(src_s[at + c]) * nz + z) *
                                 CP + 8 * piece);
      }
    }
    cp_async_arrive(bar);
  };

  float acc[kFrags][8][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0.f;

  load_src(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < C::kAhead; ++s) issue(s);
  const uint32_t zero_u32 = smem_u32(zero);
  for (int s = 0; s < total; ++s) {
    const int lt = s / C::kSubsteps, ks = s - lt * C::kSubsteps;
    const int k = ks / C::kPerTap, tz0 = TZS * (ks - k * C::kPerTap);
    mbar_wait(full_u32 + 8 * (s % SLOTS), (s / SLOTS) & 1);
    __syncthreads();  // substep s - 1 is read by every warp
    if (ks == 0) load_src(lt + 1);
    issue(s + C::kAhead);

    const uint32_t* zm = zm_s + ((lt & 1) * kTaps + k) * kMaxTile;
    const uint32_t base =
        smem_u32(rows + ((s / C::kPerTap) % C::kRowBufs) * rows_bytes);
    const uint4* bw = reinterpret_cast<const uint4*>(
                          slabs + (s % SLOTS) * C::kSlab) +
                      ng * 4 * 32 + lane;
#pragma unroll
    for (int t = 0; t < TZS; ++t) {
      if (WINFUSE_WIDE_PART == 1) break;
      const int tz = tz0 + t;
      // this lane's row of each fragment at z tap tz and its swizzle, and
      // the fragments with a set row
      uint32_t arow[kFrags];
      int sw[kFrags];
      uint32_t live = 0;
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        const int c = fi[f] >> 16, zo = fi[f] & 0xffff;
        const int z = zo + tz - 1;  // input z
        const int r = c * nz + z;   // its staged row
        const bool ok =
            fi[f] >= 0 && z >= 0 && z < nz && row_live(zm[c], z);
        arow[f] = ok ? base + r * C::kRow : zero_u32;
        sw[f] = swizzle<CP>(r);
        live |= static_cast<uint32_t>(__any_sync(0xffffffffu, ok)) << f;
      }
      if (!live) continue;
      uint4 bq[2][4];
      uint32_t a[2][kFrags][4];
      auto load = [&](int kk, int slot) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          bq[slot][p] = bw[((t * kTapSteps + kk) * NG * 4 + p) * 32];
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
          if ((live >> f) & 1)
            ldmatrix_x4(arow[f] + 16 * ((2 * kk + lane / 16) ^ sw[f]),
                        a[slot][f]);
      };
      load(0, 0);
#pragma unroll
      for (int kk = 0; kk < kTapSteps; ++kk) {
        if (kk + 1 < kTapSteps) load(kk + 1, (kk + 1) % 2);
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (!((live >> f) & 1)) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const uint4& bb = bq[kk % 2][nt / 2];
            mma_bf16(acc[f][nt], a[kk % 2][f], nt % 2 ? bb.z : bb.x,
                     nt % 2 ? bb.w : bb.y);
          }
        }
      }
    }
    if (ks == C::kSubsteps - 1) {
      // the tile's outputs, every item, rounded once to bf16
      const int v0 = (blockIdx.x + lt * gridDim.x) * tile;
      const int g = lane / 4, q = lane % 4;
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int it = 16 * (mg + kMG * f) + g + 8 * h;
          const int c = it % tile;
          if (it >= n_items || v0 + c >= n_out) continue;
          __nv_bfloat16* o =
              out + ((static_cast<size_t>(v0) + c) * nz + it / tile) * cout;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
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
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0.f;
      }
    }
  }
}

// output-channel groups of 64 a block computes: 2 where Cout passes 64
// and a tile's items still fill fragments of half the warps (nz <= 128;
// the wrapper's wide_groups keeps the same rule)
inline int groups(int cout, int nz) { return cout > 64 && nz <= 128 ? 2 : 1; }

template <int CP, int NG>
cudaError_t launch(const void* feats, const int* src, uint32_t* masks,
                   int n_rows, const void* wk, void* out, int n_out, int nz,
                   int cout, int sms, cudaStream_t stream) {
  using P = Pick<CP, NG>;
  using C = typename P::C;
  const auto kernel = winfuse_kernel<CP, NG, P::kTZS, P::kSlots>;
  // columns of a tile: the most (<= kMaxTile) whose items fit the warps'
  // fragments and whose buffers fit in shared memory
  int tile = (kWarps / NG) * kFrags * 16 / nz;
  if (tile > kMaxTile) tile = kMaxTile;
  while (tile > 0 && C::smem_bytes(tile, nz) > kMaxSmem) --tile;
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(tile, nz);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = rowmask::launch_row_masks(
           static_cast<const __nv_bfloat16*>(feats), masks, n_rows, nz, CP,
           stream)) != cudaSuccess)
    return err;
  // one block row a chunk of 64*NG output channels
  const int chunks = (cout + 64 * NG - 1) / (64 * NG);
  const int tiles = (n_out + tile - 1) / tile;
  const int slots = sms * per_sm / chunks > 0 ? sms * per_sm / chunks : 1;
  const int blocks = tiles < slots ? tiles : slots;
  kernel<<<dim3(blocks, chunks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), src, masks,
      static_cast<const __nv_bfloat16*>(wk),
      static_cast<__nv_bfloat16*>(out), n_out, nz, cout, tile);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_groups(const void* feats, const int* src, uint32_t* masks,
                      int n_rows, const void* wk, void* out, int n_out,
                      int nz, int cout, int sms, cudaStream_t stream) {
  if (groups(cout, nz) == 2)
    return launch<CP, 2>(feats, src, masks, n_rows, wk, out, n_out, nz, cout,
                         sms, stream);
  return launch<CP, 1>(feats, src, masks, n_rows, wk, out, n_out, nz, cout,
                       sms, stream);
}

}  // namespace wide

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// feats (R, nz*cp) bf16 rows at channel pitch cp (channels past the
// layer's cin zero), 16-byte aligned; src (9, n_out) int32 as above; out
// (n_out, nz*cout) bf16; 1 <= nz <= 256.  Narrow (cp 8, 16 or 32 and
// 1 <= cout <= 32): wk (9, k_pad, n_pad) bf16 per-tap weights, row
// tz*cp + i, zero past cin and cout, k_pad = 3*cp rounded up to 16,
// n_pad = 16 if cout <= 16 else 32.  Wide (cp 64 or 128, or cp 32 with
// 32 < cout <= 128): wk the B fragments of every chunk of 64*NG output
// channels (NG = wide::groups(cout, nz)), tap and z tap in the kernel's
// order (the wrapper's wide_tap_weights), and masks uint32 scratch of
// n_rows (feats' rows) for the rows' activity where nz <= 32.  The narrow
// kernels do not read masks and n_rows.
extern "C" int sf_winfuse_bf16(const void* feats, const int* src,
                               const void* wk, void* out, int n_out, int nz,
                               int cp, int cout, void* masks, int n_rows,
                               void* stream) {
  const bool is_wide = cp > 32 || cout > 32;
  if ((cp != 8 && cp != 16 && cp != 32 && cp != 64 && cp != 128) ||
      (is_wide && cp < 32) || cout < 1 || cout > 128 || nz < 1 || nz > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_out == 0) return 0;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_wide) {
    uint32_t* m = static_cast<uint32_t*>(masks);
    if (m == nullptr && nz <= wide::kMaxMaskZ)
      return static_cast<int>(cudaErrorInvalidValue);
    if (cp == 32)
      err = wide::by_groups<32>(feats, src, m, n_rows, wk, out, n_out, nz,
                                cout, sms, s);
    else if (cp == 64)
      err = wide::by_groups<64>(feats, src, m, n_rows, wk, out, n_out, nz,
                                cout, sms, s);
    else
      err = wide::by_groups<128>(feats, src, m, n_rows, wk, out, n_out, nz,
                                 cout, sms, s);
  } else if (cp == 8)
    err = tc::by_cout<8>(feats, src, wk, out, n_out, nz, cout, sms, s);
  else if (cp == 16)
    err = tc::by_cout<16>(feats, src, wk, out, n_out, nz, cout, sms, s);
  else
    err = tc::by_cout<32>(feats, src, wk, out, n_out, nz, cout, sms, s);
  return static_cast<int>(err);
}
