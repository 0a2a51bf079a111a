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
// column slots, nz 21, 32 -> 32, bf16) ~1.1 GB, 0.33 ms at 3.35 TB/s.  After
// the masked BN the cotangent is zero at every inactive site, ~92% of the
// (column, z) rows at stage 2, so the products needed are a few percent of
// the dense ones: ~0.04 ms on the bf16 tensor cores.
//
// bf16 (the training step's LiDAR branch): tensor cores.  For in-plane tap
// k, dW_k = A_k^T B is one GEMM whose depth runs over the items (column v,
// output z zo): A_k[item, (tz, i)] = feats[src[k, v], zo + tz - 1, i] (M =
// 3*CP rows (tz, i), CP the channel pitch 8, 16 or 32; the wrapper pitches
// other widths), B[item, j] = g[v, zo, j] (N = NP, Cout's pitch).
//   - A block walks chunks of TV output columns (grid-stride).  A chunk's
//     cotangent rows are one contiguous run of g: the copy engine brings
//     them into one of two shared buffers (bulk copies on an mbarrier)
//     while the block works on the chunk before.  The block flags the rows
//     that are not all zero (a ballot a 32 items; -0 counts as zero) and
//     lists them in ascending order (a warp scan of the flag words): only
//     those items enter the GEMM's depth.
//   - One warp a tap (9 warps), each owning every m16n8 tile of its dW_k in
//     registers for the whole run (6 x 4 tiles, 96 fp32 a lane, at stage
//     2).  A warp walks the chunk's list 16 items (one k16 step) at a time.
//     For each item whose column has the tap it copies the source column's
//     three z rows zo - 1 .. zo + 1 (contiguous in feats) into its own ring
//     of 3 steps (cp.async, 16 bytes a lane; no block barrier), so item
//     row tz*CP + i of the staging is A_k's row: the z shift tz is a row
//     offset into the staged rows.
//   - mma.sync.m16n8k16 bf16 with fp32 accumulators.  Both operands come by
//     ldmatrix.trans with one row address a lane: A's 8x8 matrices are 8
//     items by 8 (tz, i), B's 8 items by 8 output channels.  A lane whose
//     item is past the list (the pad to 16), whose column lacks the tap,
//     or whose z row zo + tz - 1 lies outside the column reads a zeroed
//     shared row instead: no branch around the mma.
//   - Bytes: g once (the flags need every row), and for each listed item
//     and found tap 3 source rows from L2 (a row two items of a column
//     share is fetched twice; at ~2 active z a column that is still a
//     fraction of the column's nz rows).  Where the time goes (PERF.md,
//     K3's d weights; chip_smoke.py splits it with the ablations below):
//     at stage 2 the row gathers take the largest part, then g and the
//     lists, then the products.
//   - At the end each warp writes its tap's (3, Cin, Cout) of the block's
//     partial; wgrad_reduce adds the partials in block order.  No float
//     atomics, and the order of every sum is fixed, so the gradient is the
//     same from run to run.
// fp32 (evaluating and training from fp32 points, the chip checks at 1e-4
// of the fp64 sums): the same design on the tensor cores in 3xTF32, a k8
// step 8 listed items (csrc/winfuse_wgrad_tf32.cuh); the same bits every
// run.  One-pass TF32 would miss the bar; the fp32 inputs, sums and dW stay
// fp32, and TF32 stays off elsewhere (device.pin_tf32).
//
// Past 32 channels in or out (stages 3 and 4 on columns):
//   - bf16 (namespace wide): one warp a tap would hold 9 x 384 x 128 fp32
//     sums at stage 4, so dW is cut into pieces, tap k's rows (tz, i) for
//     one z tap (three where they fit 64 registers a thread) by every
//     output channel: 27 pieces at 128 -> 128, 9 at 64 -> 64, one block
//     row each.  The cotangent is read and its nonzero items listed once,
//     by wgrad_list (one warp a chunk of columns, into a scratch list), and
//     a piece's blocks stage only the listed items' cotangent rows and
//     their source rows for the piece's tap and z taps, once a piece (not
//     once per 32 x 32 chunk of dW).  Every thread stages its share of a
//     ring of 3 steps of 64 listed items (cp.async; a piece whose row does
//     not exist writes zeros: src-size 0), 8 warps each own MTW x NTW
//     m16n8 tiles of the piece, and both operands come by ldmatrix.trans
//     from items padded by 16 bytes (8 items of an ldmatrix in 8 bank
//     groups).  The partials add in block order as before: the same bits
//     every run.  What bounds it: the listed items' rows from L2, staged
//     once for each of the 9 or 27 pieces, and one pass over the whole
//     cotangent for the lists.
//   - fp32 (namespace wide_tf32, csrc/winfuse_wgrad_wide_tf32.cuh): the
//     same lists and pieces in 3xTF32, k8 steps of 8 listed items, the
//     staged items 8 words past a multiple of 32 for the 32-bit fragment
//     loads; the partials add in block order as before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Built with WINFUSE_WGRAD_PART=1 (the cotangent rows and the lists alone,
// no k16 step) or 2 (the steps without their row gathers: products of
// stale rows), the bf16 kernel is an ablation whose result is wrong;
// chip_smoke.py times both to split the kernel's time.
#ifndef WINFUSE_WGRAD_PART
#define WINFUSE_WGRAD_PART 0
#endif

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;  // bytes a block may have on an H100


// ------------------------------------------------------------------ bf16

#include "winfuse_wgrad_tc.cuh"

// ------------------------------------------------------------ fp32, 3xTF32

#include "winfuse_wgrad_tf32.cuh"

// ------------------------------------------------------------- bf16, wide

// Past 32 channels in or out (CP, NP 32, 64 or 128).  The cotangent's
// nonzero items are listed once, by wgrad_list; then block (x, y) owns
// one piece of dW, tap k's rows (tz, i) for TZ z taps and every output
// channel, and walks chunks x, x + X, ... of the listed items, so each
// source row a piece needs crosses into shared memory once a piece.
namespace wide {

using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;
using tc::smem_u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStepItems = 64;     // listed items a step: 4 k16 steps
constexpr int kStages = 3;         // ring of steps
constexpr int kListItems = 2048;   // items (column, z) of a chunk, at most

// items of a chunk's columns: the most whole columns within kListItems
inline int chunk_columns(int nz) {
  return kListItems / nz > 0 ? kListItems / nz : 1;
}

// CP, NP -> a piece (TZ z taps: all three where the piece's fp32 sums fit
// 64 registers a thread, else one) and its tiles: 8 warps in a WM x WN
// grid, each with MTW x NTW m16n8 tiles of the piece's (TZ*CP) x NP
template <int CP, int NP>
struct Geo {
  static constexpr int kTZ = 3 * CP * NP <= 64 * 256 ? 3 : 1;
  static constexpr int kMT = kTZ * CP / 16;
  static constexpr int kNT = NP / 8;
  static constexpr int kNTW = kNT < 4 ? kNT : 4;
  static constexpr int kWN = kNT / kNTW;
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kMTW = (kMT + kWM - 1) / kWM;
  // bytes of a staged item: its TZ source rows, its cotangent row, each
  // 16 bytes longer (an odd number of 16-byte groups, so the 8 items of an
  // ldmatrix fall in 8 bank groups)
  static constexpr int kAPitch = kTZ * 2 * CP + 16;
  static constexpr int kBPitch = 2 * NP + 16;
  static constexpr int kStep = kStepItems * (kAPitch + kBPitch);
};
template <int CP, int NP>
__host__ __device__ constexpr size_t smem_bytes(int tv) {
  return static_cast<size_t>(kStages) * Geo<CP, NP>::kStep +
         4 * (static_cast<size_t>(kListItems) + tv);
}

// 16 bytes from src to shared dst, or 16 zero bytes where !ok (src-size
// 0: nothing is read)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst,
                                                   const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One warp a chunk of tv columns: the chunk's items (c*nz + zo) whose
// cotangent row (NP values of T, bf16 or fp32) is not all zero (-0 counts
// as zero), ascending, into lists[chunk * tv * nz ..], their number into
// counts[chunk].  A row's 16-byte pieces are read by neighbouring lanes:
// load j of the warp's 32 items reads pieces 32j .. 32j + 31, and its
// ballot holds item l's kPieces bits (l*kPieces mod 32 on) where j =
// l*kPieces / 32 (kPieces divides 32), so no flag passes through memory.
// One warp a chunk and no grid-stride loop: a loop over chunks kept each
// lane's base address on the stack (ptxas, 4-8 bytes of spill).
template <typename T, int NP>
__global__ void __launch_bounds__(256)
wgrad_list(const T* __restrict__ g, int* __restrict__ lists,
           int* __restrict__ counts, int n_out, int nz, int tv) {
  // every value's magnitude bits of a 32-bit word
  constexpr uint32_t kMagnitude = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  constexpr int kPieces = NP * static_cast<int>(sizeof(T)) / 16;  // a row
  static_assert(kPieces >= 4 && kPieces <= 32 && 32 % kPieces == 0,
                "a row's pieces divide a warp's load");
  constexpr uint32_t kItemBits =
      kPieces == 32 ? 0xffffffffu : (1u << (kPieces % 32)) - 1u;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int my_load = lane * kPieces / 32, my_bit = lane * kPieces % 32;
  const int c = blockIdx.x * 8 + w;
  if (c >= (n_out + tv - 1) / tv) return;
  const int v0 = c * tv;
  const int n_items = min(tv, n_out - v0) * nz;
  const uint4* rows = reinterpret_cast<const uint4*>(g) +
                      static_cast<size_t>(v0) * nz * kPieces;
  int* list = lists + static_cast<size_t>(c) * tv * nz;
  int base = 0;
  for (int i0 = 0; i0 < n_items; i0 += 32, rows += 32 * kPieces) {
    const int n = min(32, n_items - i0) * kPieces;  // pieces to read
    uint32_t mine = 0;  // this lane's item's pieces that are not zero
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int e = 32 * j + lane;
      bool nonzero = false;
      if (e < n) {
        const uint4 x = __ldg(rows + e);
        nonzero = ((x.x | x.y | x.z | x.w) & kMagnitude) != 0u;
      }
      const uint32_t b = __ballot_sync(0xffffffffu, nonzero);
      if (j == my_load) mine = (b >> my_bit) & kItemBits;
    }
    const bool any = mine != 0u;  // false past the chunk's items
    const uint32_t m = __ballot_sync(0xffffffffu, any);
    if (any) list[base + __popc(m & ((1u << lane) - 1u))] = i0 + lane;
    base += __popc(m);
  }
  if (lane == 0) counts[c] = base;
}

// Block (x, y): tap k = y / (3 / TZ), z taps tz0 = TZ * (y % (3 / TZ)) ..
// tz0 + TZ - 1, every output channel; chunks x, x + gridDim.x, ...
//
// Shared memory:
//   ring   [kStages][kStepItems] staged items: a_s [64][kAPitch] (source
//          rows zo - 1 + tz0 .. + TZ - 1 of the item's column for tap k,
//          row tz - tz0 at byte 2*CP*(tz - tz0); zeros where the tap is not
//          found, z leaves the column or the item is past the list), then
//          b_s [64][kBPitch] (the cotangent row; zeros past the list)
//   list_s [kListItems] the chunk's listed items, c << 16 | zo
//   src_s  [tv] the chunk's source row of tap k for each column
//
// A step: every thread stages (cp.async) its share of step st + 2, then
// each warp runs its tiles of dW_k^T += A^T B over the step's 64 items
// (four k16 steps), A and B both by ldmatrix.trans.  The partial is written at the end: the
// block's rows of part[x], added in block order by wgrad_reduce.
template <int CP, int NP>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_mma(const __nv_bfloat16* __restrict__ feats,
          const int* __restrict__ src, const __nv_bfloat16* __restrict__ g,
          const int* __restrict__ lists, const int* __restrict__ counts,
          float* __restrict__ part, int n_out, int nz, int cin, int cout,
          int tv) {
  using G = Geo<CP, NP>;
  constexpr int kAPieces = G::kTZ * CP / 8;  // 16-byte pieces of an item
  constexpr int kBPieces = NP / 8;
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  int* list_s = reinterpret_cast<int*>(ring + kStages * G::kStep);
  int* src_s = list_s + kListItems;
  const uint32_t ring_u32 = smem_u32(ring);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % G::kWM, wn = warp / G::kWM;
  const int k = blockIdx.y / (3 / G::kTZ);
  const int tz0 = G::kTZ * (blockIdx.y % (3 / G::kTZ));
  const int n_chunks = (n_out + tv - 1) / tv;

  float acc[G::kMTW][G::kNTW][4];
#pragma unroll
  for (int t = 0; t < G::kMTW; ++t)
#pragma unroll
    for (int u = 0; u < G::kNTW; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][u][r] = 0.f;

  // this lane's ldmatrix rows (as csrc's narrow kernel): A's item and
  // channel half, B's item and output-channel half
  const int ia = (lane & 7) + ((lane >> 4) << 3);
  const int ca = 8 * ((lane >> 3) & 1);
  const int ib = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int jb = 8 * (lane >> 4);

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * tv;
    const int nc = min(tv, n_out - v0);
    const int n_act = __ldg(counts + chunk);
    __syncthreads();  // the previous chunk's lists and ring are read
    const int* lc = lists + static_cast<size_t>(chunk) * tv * nz;
    for (int a = tid; a < n_act; a += kThreads) {
      const int it = __ldg(lc + a);
      const int c = it / nz;
      list_s[a] = c << 16 | (it - c * nz);
    }
    for (int c = tid; c < nc; c += kThreads)
      src_s[c] = __ldg(src + static_cast<size_t>(k) * n_out + v0 + c);
    __syncthreads();
    const int n_steps = (n_act + kStepItems - 1) / kStepItems;

    auto stage = [&](int st) {
      if (st < n_steps) {
        const uint32_t a_u32 = ring_u32 + (st % kStages) * G::kStep;
        const uint32_t b_u32 = a_u32 + kStepItems * G::kAPitch;
        for (int e = tid; e < kStepItems * (kAPieces + kBPieces);
             e += kThreads) {
          if (e < kStepItems * kAPieces) {
            const int il = e / kAPieces, p = e - il * kAPieces;
            const int t = p / (CP / 8), pc = p - t * (CP / 8);
            const int a = kStepItems * st + il;
            const int ent = a < n_act ? list_s[a] : -1;
            const int s = ent >= 0 ? src_s[ent >> 16] : -1;
            const int z = (ent & 0xffff) - 1 + tz0 + t;
            const bool ok = s >= 0 && z >= 0 && z < nz;
            cp_async16_or_zero(
                a_u32 + il * G::kAPitch + 16 * p,
                ok ? feats + (static_cast<size_t>(s) * nz + z) * CP + 8 * pc
                   : feats,
                ok);
          } else {
            const int e2 = e - kStepItems * kAPieces;
            const int il = e2 / kBPieces, pc = e2 - il * kBPieces;
            const int a = kStepItems * st + il;
            const bool ok = a < n_act;
            const int ent = ok ? list_s[a] : 0;
            cp_async16_or_zero(
                b_u32 + il * G::kBPitch + 16 * pc,
                g + ((static_cast<size_t>(v0) + (ent >> 16)) * nz +
                     (ent & 0xffff)) * NP + 8 * pc,
                ok);
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) stage(st);
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step st has landed; step st - 1 is read
      stage(st + kStages - 1);
      const uint32_t a_u32 = ring_u32 + (st % kStages) * G::kStep;
      const uint32_t b_u32 = a_u32 + kStepItems * G::kAPitch;
#pragma unroll
      for (int h = 0; h < kStepItems / 16; ++h) {
        // k16 step h: items 16h .. 16h + 15 of the step
        uint32_t af[G::kMTW][4];
#pragma unroll
        for (int t = 0; t < G::kMTW; ++t) {
          const int mt = wm + G::kWM * t;
          if (mt < G::kMT)
            ldmatrix_x4_trans(a_u32 + (16 * h + ia) * G::kAPitch +
                                  2 * (16 * mt + ca),
                              af[t]);
        }
        uint32_t bf[G::kNTW][2];
#pragma unroll
        for (int p = 0; p < G::kNTW / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(b_u32 + (16 * h + ib) * G::kBPitch +
                                2 * (8 * (wn * G::kNTW + 2 * p) + jb),
                            r);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int t = 0; t < G::kMTW; ++t) {
          if (wm + G::kWM * t >= G::kMT) continue;
#pragma unroll
          for (int u = 0; u < G::kNTW; ++u)
            mma_bf16(acc[t][u], af[t], bf[u][0], bf[u][1]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // the piece's rows of this block's partial: accumulator r of tile
  // (t, u) is dW_k[tz0*CP + m][j], m = 16*mt + lane/4 + 8*(r/2), j =
  // 8*nt + 2*(lane % 4) + r % 2
  float* out = part + static_cast<size_t>(blockIdx.x) * 27 * cin * cout;
#pragma unroll
  for (int t = 0; t < G::kMTW; ++t) {
    const int mt = wm + G::kWM * t;
    if (mt >= G::kMT) continue;
#pragma unroll
    for (int u = 0; u < G::kNTW; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 16 * mt + (lane >> 2) + 8 * (r >> 1);
        const int j = 8 * (wn * G::kNTW + u) + 2 * (lane & 3) + (r & 1);
        const int tz = tz0 + m / CP, i = m % CP;
        if (i < cin && j < cout)
          out[((3 * k + tz) * cin + i) * cout + j] = acc[t][u][r];
      }
  }
}

// pieces of dW (block rows): 9 taps, by three z taps or one
template <int CP, int NP>
constexpr int pieces() {
  return kTaps * (3 / Geo<CP, NP>::kTZ);
}

// the list, then the pieces; *grid_out gets the number of partials
template <int CP, int NP>
cudaError_t launch(const void* feats, const int* src, const void* g,
                   float* part, int max_parts, int* lists, int n_out, int nz,
                   int cin, int cout, int sms, cudaStream_t st,
                   int* grid_out) {
  const int tv = chunk_columns(nz);
  const int n_chunks = (n_out + tv - 1) / tv;
  *grid_out = 0;
  if (n_chunks == 0) return cudaSuccess;
  int* counts = lists + static_cast<size_t>(n_chunks) * tv * nz;
  // one warp a chunk
  wgrad_list<__nv_bfloat16, NP><<<(n_chunks + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(g), lists, counts, n_out, nz, tv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<CP, NP>(tv);
  if ((err = cudaFuncSetAttribute(
           wgrad_mma<CP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wgrad_mma<CP, NP>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // block rows of pieces; columns of chunks to fill the card's slots
  int grid = per_sm * sms / pieces<CP, NP>();
  if (grid < 1) grid = 1;
  if (grid > max_parts) grid = max_parts;
  if (grid > n_chunks) grid = n_chunks;
  *grid_out = grid;
  wgrad_mma<CP, NP><<<dim3(grid, pieces<CP, NP>()), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(feats), src,
      static_cast<const __nv_bfloat16*>(g), lists, counts, part, n_out, nz,
      cin, cout, tv);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_np(int np, const void* feats, const int* src, const void* g,
                  float* part, int max_parts, int* lists, int n_out, int nz,
                  int cin, int cout, int sms, cudaStream_t st,
                  int* grid_out) {
  if constexpr (CP == 32) {
    if (np == 32) return cudaErrorInvalidValue;  // narrow
  } else if (np == 32)
    return launch<CP, 32>(feats, src, g, part, max_parts, lists, n_out, nz,
                          cin, cout, sms, st, grid_out);
  if (np == 64)
    return launch<CP, 64>(feats, src, g, part, max_parts, lists, n_out, nz,
                          cin, cout, sms, st, grid_out);
  return launch<CP, 128>(feats, src, g, part, max_parts, lists, n_out, nz,
                         cin, cout, sms, st, grid_out);
}

}  // namespace wide

// ------------------------------------------------------------- fp32, wide

#include "winfuse_wgrad_wide_tf32.cuh"

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

// feats (R, nz*cp) and g (n_out, nz*np) fp32 at channel pitches cp and
// np (channels past cin, cout zero), both 16-byte aligned; src (9, n_out)
// int32 (-1: tap not taken), scratch max_parts x 27*cin*cout fp32
// partials, out (27, cin, cout) fp32.  1 <= nz <= 256.  Narrow (cin, cout
// <= 32): cp and np 8, 16 or 32.  Wide (cin or cout past 32): cp and np 32,
// 64 or 128, and lists int32 scratch as the bf16 entry's.  Returns a
// cudaError_t (0 = launched).
extern "C" int sf_winfuse_wgrad_fp32(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* lists, void* out,
                                     int n_out, int nz, int cp, int cin,
                                     int np, int cout, void* stream) {
  const bool is_wide = cin > 32 || cout > 32;
  auto pitch_ok = [is_wide](int p) {
    return is_wide ? p == 32 || p == 64 || p == 128
                   : p == 8 || p == 16 || p == 32;
  };
  if (!pitch_ok(cp) || !pitch_ok(np) || cin < 1 || cin > cp || cout < 1 ||
      cout > np || nz < 1 || nz > 256 || max_parts < 1 || n_out < 0 ||
      (is_wide && lists == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0, grid = 0;
  cudaError_t err = sm_count(&sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const float* f = static_cast<const float*>(feats);
  const float* gf = static_cast<const float*>(g);
  int* li = static_cast<int*>(lists);
  if (err == cudaSuccess && is_wide) {
    if (cp == 32)
      err = wide_tf32::by_np<32>(np, f, src, gf, part, max_parts, li, n_out,
                                 nz, cin, cout, sms, st, &grid);
    else if (cp == 64)
      err = wide_tf32::by_np<64>(np, f, src, gf, part, max_parts, li, n_out,
                                 nz, cin, cout, sms, st, &grid);
    else
      err = wide_tf32::by_np<128>(np, f, src, gf, part, max_parts, li, n_out,
                                  nz, cin, cout, sms, st, &grid);
  } else if (err == cudaSuccess && cp == 8)
    err = tf32::by_np<8>(np, f, src, gf, part, max_parts, n_out, nz, cin,
                         cout, sms, st, &grid);
  else if (err == cudaSuccess && cp == 16)
    err = tf32::by_np<16>(np, f, src, gf, part, max_parts, n_out, nz, cin,
                          cout, sms, st, &grid);
  else if (err == cudaSuccess)
    err = tf32::by_np<32>(np, f, src, gf, part, max_parts, n_out, nz, cin,
                          cout, sms, st, &grid);
  if (err == cudaSuccess) err = reduce(part, out, grid, 27 * cin * cout, st);
  return static_cast<int>(err);
}

// feats (R, nz*cp) bf16 rows at channel pitch cp (channels past cin zero)
// and g (n_out, nz*np) bf16 at pitch np (channels past cout zero), both
// 16-byte aligned; src (9, n_out) int32 as above; scratch and out as
// above, out (27, cin, cout).  1 <= cin <= cp, 1 <= cout <= np,
// 1 <= nz <= 256.  Narrow: cp and np 8, 16 or 32, cin and cout <= 32.
// Wide (cin or cout past 32): cp and np 32, 64 or 128, and lists int32
// scratch of n_chunks * tv * nz + n_chunks (tv = wide::chunk_columns(nz),
// n_chunks = ceil(n_out / tv): the wrapper's wgrad_list_ints); the
// narrow kernels do not read it.
extern "C" int sf_winfuse_wgrad_bf16(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* lists, void* out,
                                     int n_out, int nz, int cp, int cin,
                                     int np, int cout, void* stream) {
  const bool is_wide = cin > 32 || cout > 32;
  auto pitch_ok = [is_wide](int p) {
    return is_wide ? p == 32 || p == 64 || p == 128
                   : p == 8 || p == 16 || p == 32;
  };
  if (!pitch_ok(cp) || !pitch_ok(np) || cin < 1 || cin > cp || cout < 1 ||
      cout > np || nz < 1 || nz > 256 || max_parts < 1 || n_out < 0 ||
      (is_wide && lists == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0, grid = 0;
  cudaError_t err = sm_count(&sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int* li = static_cast<int*>(lists);
  if (err == cudaSuccess && is_wide) {
    if (cp == 32)
      err = wide::by_np<32>(np, feats, src, g, part, max_parts, li, n_out,
                            nz, cin, cout, sms, st, &grid);
    else if (cp == 64)
      err = wide::by_np<64>(np, feats, src, g, part, max_parts, li, n_out,
                            nz, cin, cout, sms, st, &grid);
    else
      err = wide::by_np<128>(np, feats, src, g, part, max_parts, li, n_out,
                             nz, cin, cout, sms, st, &grid);
  } else if (err == cudaSuccess) {
    if (cp == 8)
      err = tc::by_np<8>(np, feats, src, g, part, max_parts, n_out, nz, cin,
                         cout, sms, st, &grid);
    else if (cp == 16)
      err = tc::by_np<16>(np, feats, src, g, part, max_parts, n_out, nz, cin,
                          cout, sms, st, &grid);
    else
      err = tc::by_np<32>(np, feats, src, g, part, max_parts, n_out, nz, cin,
                          cout, sms, st, &grid);
  }
  if (err == cudaSuccess) err = reduce(part, out, grid, 27 * cin * cout, st);
  return static_cast<int>(err);
}
