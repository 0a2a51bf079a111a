// K3's fp32 forward past 32 channels (namespace wide_tf32), csrc/
// winfuse_fp32.cu's route at stages 3 and 4 on columns (64 -> 64 at nz 11,
// 128 -> 128 at nz 5: DENSE_TAIL_FROM_STAGE 0, 4 or 5 on fp32 points), and
// d feats there (the same conv over the reversed map).  The wide bf16
// kernel's structure (csrc/winfuse.cu, namespace wide) with the narrow fp32
// kernel's arithmetic (csrc/winfuse_tf32.cuh): 3xTF32 on the tensor cores,
// three mma.sync.m16n8k8 a product (csrc/tf32_mma.cuh), fp32's order of
// error.
//
//   - A block computes every output channel of its tile, in groups of 64
//     (NG of them, one block row of the grid per NG groups), so a tap's
//     source rows cross into shared memory once a tile.  Items run z-major
//     (zo*tile + c: neighbouring columns at one z a fragment); a first
//     kernel (csrc/winfuse_masks.cuh) marks the source rows that are not
//     all zero (-0 counting as zero; up to 32 z, past it every z of a found
//     column is staged), only those are staged, and a fragment none of
//     whose rows is marked at a z tap skips it.
//   - Every tile streams its B, 27 x CP x 64*NG values, from L2, so a tile
//     is as large as the registers allow: 8 warps of 3 m16 fragments, each
//     warp 64 channels (8 n-tiles) of its fragments, 96 fp32 sums a thread
//     (384 items / NG: 34 columns at stage 3, 38 at stage 4 with its two
//     channel groups; one group a block and two block rows measured slower
//     at stage 4 on an H100, 12.7 against 11.4 ms).
//   - Rows of 4-byte values take twice the bf16 bytes, so a tap's rows are
//     staged 32 channels at a time (a row step: tap, 32-channel block;
//     CP/32 a tap), in a ring of two row buffers, and B streams in (row
//     step, z tap) slabs of 16 KB a channel group through a ring of 4.
//     Every thread issues its share of the copies (the slab in 16 KB bulk
//     copies, the marked rows 16 bytes a cp.async), all completing on one
//     mbarrier a ring slot.  No block barrier: each warp arrives on an
//     "empty" mbarrier when done with a substep, and a slot is refilled
//     once every warp is done with it, so the warps run up to kLag - 1
//     substeps apart (a barrier a substep waited for the warp with the most
//     live fragments: 11.8 against 11.1 ms at stage 3 on an H100).
//   - B comes split: the wrapper's wide_tf32_tap_weights stores each value
//     as its TF32 hi and lo, so no warp splits B (the warps of a channel
//     group would split the same values: a fifth of the kernel's time on an
//     H100); a lane's (b0, b1) hi and lo of an n-tile are one 128-bit
//     load.  A is split in registers.
//   - K is permuted as in the narrow kernel at CP 32 (tf32_channels): in
//     k8 step s of a row step, lane (g, t) holds as a0 / a2 the values of
//     channels 4t + s / 16 + 4t + s of its rows, two 16-byte chunks of the
//     row read by 128-bit loads; lanes of even and odd g read the two
//     chunks in opposite order, so a quarter warp's 8 loads fall in 8 bank
//     groups (rows are 128 bytes).  B is laid out in the same order.
//   - The three products of a k8 step (al*bh, ah*bl, then ah*bh) each run
//     over every live fragment and n-tile before the next (24 independent
//     accumulators between two mma on one of them).  At the end of each
//     tap the sums are added into the tile's outputs and start again from
//     zero: the tensor cores truncate every mma's sum, a bias that grows
//     with the sums' length.
// What bounds it on an H100: the products (3 passes at the dense TF32
// peak over the marked rows' dense z, minus the fragments skipped), then
// B's traffic from L2 (27 * CP/32 slabs a tile).
// Included inside an anonymous namespace that defines kTaps and kMaxSmem,
// after winfuse_masks.cuh, winfuse_tc.cuh and winfuse_tf32.cuh.
namespace wide_tf32 {

using rowmask::kMaxMaskZ;
using rowmask::row_live;
using tc::bulk_copy;
using tc::cp_async16;
using tc::cp_async_arrive;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tf32::mma_tf32;
using tf32::split;

constexpr int kWarps = 8;            // every warp copies and multiplies
constexpr int kThreads = 32 * kWarps;
constexpr int kFrags = 3;            // m16 fragments a warp owns in a tile
constexpr int kMaxItems = kWarps * kFrags * 16;
constexpr int kMaxTile = 96;         // columns of a tile
constexpr int kSlots = 4;            // ring of substeps' slabs
// substeps a slot's copies go out ahead of its use; the warps may run
// kSlots - kAhead - 1 substeps apart
constexpr int kAhead = 2;
constexpr int kLag = kSlots - kAhead;
// row buffers B: a row step's rows go out kAhead substeps before its first
// substep, when every warp is done with the substep kLag before that, and
// the row step B back (the buffer's last user) must be done by then:
// 3B >= kAhead + kLag + 2
constexpr int kRowBufs = (kAhead + kLag + 2 + 2) / 3;
constexpr int kKC = 32;              // channels of a row step
constexpr int kRow = 4 * kKC;        // bytes of a staged row
constexpr int kGroupSlab = 4 * 8 * 32 * 16;  // B bytes a substep a group
constexpr int kCopyBytes = 16384;    // bytes of one bulk copy of a slab

template <int NG>
__host__ __device__ constexpr size_t smem_bytes(int tile, int nz) {
  return static_cast<size_t>(kSlots) * NG * kGroupSlab +
         static_cast<size_t>(kRowBufs) * tile * nz * kRow + kRow +
         16 * kSlots +
         4 * (4 * kTaps * kMaxTile + kMaxItems + 2 * kFrags * kThreads);
}

// value i (0..3, a constant once unrolled) of v
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A tile of `tile` columns has n_items = tile*nz items (c, zo), numbered
// z-major, zo*tile + c; warp w owns output channels 64*(w % NG) .. + 63
// (8 n-tiles) of fragments mg, mg + MG, mg + 2*MG (MG = 8 / NG, mg =
// w / NG), each 16 items.  The tile's work is 27 * CP/32 substeps (tap k,
// channel block q, z tap tz; row step (k, q) its three z taps), K = 32
// each: 4 k8 steps.
//
// Shared memory:
//   slabs [kSlots][4 k8 steps][NG*8 n-tiles][32 lanes] uint4: a substep's
//         B, lane l's (b0, b1) of one n-tile split into TF32 hi and lo
//         (the wrapper's wide_tf32_tap_weights, one contiguous slab a
//         substep)
//   rows  [kRowBufs][n_items][32] float: a row step's marked source rows,
//         row c*nz + z holding channels 32q .. 32q + 31 of input z of
//         column c's source, so item (c, zo)'s input z = zo + tz - 1 is row
//         c*nz + z.  A row whose bit is clear (not found, or all zero) is
//         not copied and never read: a lane whose row is clear, or whose z
//         leaves the column, reads the zero row, and a fragment with no
//         set row at a z tap skips it.
//   zero  [32] zeros
//   full  [kSlots] mbarriers: a substep's slab (and at a row step's first
//         substep the row step's rows) have landed; every thread arrives
//         once a use, when its cp.async copies land
//   empty [kSlots] mbarriers: every warp is done with a slot's substep
//   src_s, zm_s [2][9][kMaxTile]: each column's source row of each tap
//         and that row's activity mask (0 where the tap is not taken), of
//         this tile and the next
//   col_s [n_items] int: the column of each staged row
//   fi_s  [kFrags][2][kThreads] int: each lane's items (see fi below)
//
// The ring: at substep s each thread waits for its slab (full) and for
// every warp to be done with substep s - kLag (empty), issues its share of
// substep s + kAhead's copies into that substep's freed slot, works on
// substep s and, a warp at a time, arrives on empty.
template <int CP, int NG>
__global__ void __launch_bounds__(kThreads, 1)
winfuse_kernel(const float* __restrict__ feats, const int* __restrict__ src,
               const uint32_t* __restrict__ masks,
               const uint4* __restrict__ wk, float* __restrict__ out,
               int n_out, int nz, int cout, int tile) {
  constexpr int kMG = kWarps / NG;
  constexpr int kSlab = NG * kGroupSlab;        // B bytes a substep
  constexpr int kBlocks = CP / kKC;             // row steps a tap
  constexpr int kSubsteps = kTaps * kBlocks * 3;  // a tile
  constexpr int kPieces = kKC / 4;              // 16-byte pieces of a row
  extern __shared__ uint4 smem[];
  unsigned char* slabs = reinterpret_cast<unsigned char*>(smem);
  const int n_items = tile * nz;
  const int rows_bytes = n_items * kRow;
  unsigned char* rows = slabs + kSlots * kSlab;
  unsigned char* zero = rows + kRowBufs * rows_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + kRow);
  int* src_s = reinterpret_cast<int*>(full + 2 * kSlots);
  uint32_t* zm_s = reinterpret_cast<uint32_t*>(src_s + 2 * kTaps * kMaxTile);
  int* col_s = reinterpret_cast<int*>(zm_s + 2 * kTaps * kMaxTile);
  int* fi_s = col_s + kMaxItems;
  const uint32_t full_u32 = smem_u32(full);
  const uint32_t empty_u32 = full_u32 + 8 * kSlots;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ng = warp % NG, mg = warp / NG;
  const int g = lane / 4, t = lane % 4;
  const int j0 = 64 * (NG * blockIdx.y + ng);
  const char* wk_chunk = reinterpret_cast<const char*>(wk) +
                         static_cast<size_t>(blockIdx.y) * kSubsteps * kSlab;
  const int n_tiles = (n_out + tile - 1) / tile;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = my_tiles * kSubsteps;
  const bool masked = nz <= kMaxMaskZ;

  for (int e = tid; e < kRow / 16; e += kThreads)
    reinterpret_cast<uint4*>(zero)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < n_items; e += kThreads) col_s[e] = e / nz;
  if (tid < kSlots) {
    mbar_init(full_u32 + 8 * tid, kThreads);
    mbar_init(empty_u32 + 8 * tid, kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // this lane's items of fragment f (rows g and g + 8 of the fragment,
  // items 16*(mg + MG*f) + g + 8h): c << 16 | zo, or -1 past the tile,
  // kept in shared memory (in registers they cost a spill)
  const auto fi = [&](int f, int h) -> int& {
    return fi_s[(2 * f + h) * kThreads + tid];
  };
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int it = 16 * (mg + kMG * f) + g + 8 * h;
      fi(f, h) = it < n_items ? (it % tile) << 16 | (it / tile) : -1;
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
  // substep s's slab into slot s % kSlots and, at its row step's first
  // substep, the row step's marked rows into rows buffer (s / 3) %
  // kRowBufs, both on the slot's mbarrier
  auto issue = [&](int s) {
    if (s >= total) return;
    const int lt = s / kSubsteps, ks = s - lt * kSubsteps;
    const uint32_t bar = full_u32 + 8 * (s % kSlots);
    if (tid < NG) {
      mbar_expect_tx(bar, kCopyBytes);
      // the block's reads of the slot come before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(smem_u32(slabs + (s % kSlots) * kSlab) + tid * kCopyBytes,
                wk_chunk + static_cast<size_t>(ks) * kSlab +
                    tid * kCopyBytes,
                kCopyBytes, bar);
    }
    if (ks % 3 == 0) {
      const int rs = ks / 3, k = rs / kBlocks, q = rs - k * kBlocks;
      const int at = ((lt & 1) * kTaps + k) * kMaxTile;
      const uint32_t buf = smem_u32(rows + ((s / 3) % kRowBufs) * rows_bytes);
      for (int e = tid; e < n_items * kPieces; e += kThreads) {
        const int r = e / kPieces, piece = e - r * kPieces;
        const int c = col_s[r], z = r - c * nz;
        if (row_live(zm_s[at + c], z))
          cp_async16(buf + r * kRow + 16 * piece,
                     feats + (static_cast<size_t>(src_s[at + c]) * nz + z) *
                                 CP + kKC * q + 4 * piece);
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
  for (int s = 0; s < kAhead; ++s) issue(s);
  const unsigned char* zero_row = zero;
  // the chunk of the row this lane reads first (see the top)
  const int odd = g & 1;
  for (int s = 0; s < total; ++s) {
    const int lt = s / kSubsteps, ks = s - lt * kSubsteps;
    const int k = ks / (3 * kBlocks), tz = ks % 3;
    mbar_wait(full_u32 + 8 * (s % kSlots), (s / kSlots) & 1);
    if (s >= kLag) {
      // every warp is done with substep s - kLag: its slot and, two row
      // steps back, its rows buffer are free, and at ks == kLag - 1 the
      // previous tile's source rows
      const int u = s - kLag;
      mbar_wait(empty_u32 + 8 * (u % kSlots), (u / kSlots) & 1);
    }
    if (ks == kLag - 1) load_src(lt + 1);
    issue(s + kAhead);

    const uint32_t* zm = zm_s + ((lt & 1) * kTaps + k) * kMaxTile;
    const unsigned char* base = rows + ((s / 3) % kRowBufs) * rows_bytes;
    const uint4* bw = reinterpret_cast<const uint4*>(
                          slabs + (s % kSlots) * kSlab) +
                      ng * 8 * 32 + lane;
    // this lane's rows g, g + 8 of each fragment at z tap tz (channels
    // 4t .. 4t + 3 in lo, 16 + 4t .. in hi), and the fragments with a set
    // row
    float4 lo[kFrags][2], hi[kFrags][2];
    uint32_t live = 0;
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = fi(f, h);
        const int c = e >> 16, zo = e & 0xffff;
        const int z = zo + tz - 1;  // input z
        const bool ok = e >= 0 && z >= 0 && z < nz && row_live(zm[c], z);
        const float4* r = reinterpret_cast<const float4*>(
                              ok ? base + (c * nz + z) * kRow : zero_row) +
                          t;
        const float4 x = r[4 * odd], y = r[4 * (1 - odd)];
        lo[f][h] = odd ? y : x;
        hi[f][h] = odd ? x : y;
        any |= ok;
      }
      live |= static_cast<uint32_t>(__any_sync(0xffffffffu, any)) << f;
    }
    if (live) {
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t ah[kFrags][4], al[kFrags][4];
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (!((live >> f) & 1)) continue;
          split(part(lo[f][0], st), ah[f][0], al[f][0]);
          split(part(lo[f][1], st), ah[f][1], al[f][1]);
          split(part(hi[f][0], st), ah[f][2], al[f][2]);
          split(part(hi[f][1], st), ah[f][3], al[f][3]);
        }
        // n-tile nt's (b0, b1) hi, then lo
        uint4 b[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) b[nt] = bw[(st * NG * 8 + nt) * 32];
        // 3xTF32, the small terms first, each over every live fragment
        // and n-tile before the next
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (!((live >> f) & 1)) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_tf32(acc[f][nt], al[f], b[nt].x, b[nt].y);
        }
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (!((live >> f) & 1)) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_tf32(acc[f][nt], ah[f], b[nt].z, b[nt].w);
        }
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          if (!((live >> f) & 1)) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_tf32(acc[f][nt], ah[f], b[nt].x, b[nt].y);
        }
      }
    }
    // this warp is done with substep s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_u32 + 8 * (s % kSlots));
    if (ks % (3 * kBlocks) == 3 * kBlocks - 1) {
      // a tap's sums into the tile's outputs, every item: the first tap
      // stores, the later ones add (fp32, rounded to nearest), and the
      // sums start again from zero.  The tensor cores truncate each mma's
      // sum toward zero; over a whole tile (27 * CP/8 k8 steps, three mma
      // each) that bias reached 2.7e-5 of the output's scale at 128 -> 128
      // on an H100, past the 1e-5 bar.  A thread adds only its own
      // outputs, so no other thread's write comes between.
      const bool first = ks < 3 * kBlocks;
      const int v0 = (blockIdx.x + lt * gridDim.x) * tile;
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = fi(f, h);
          const int c = e >> 16, zo = e & 0xffff;
          if (e < 0 || v0 + c >= n_out) continue;
          float* o = out + ((static_cast<size_t>(v0) + c) * nz + zo) * cout;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int jj = j0 + 8 * nt + 2 * t;
            const float x0 = acc[f][nt][2 * h], x1 = acc[f][nt][2 * h + 1];
            if (jj + 1 < cout && cout % 2 == 0) {
              float2* p = reinterpret_cast<float2*>(o + jj);
              if (first) {
                *p = make_float2(x0, x1);
              } else {
                const float2 old = *p;
                *p = make_float2(old.x + x0, old.y + x1);
              }
            } else {
              if (jj < cout) o[jj] = first ? x0 : o[jj] + x0;
              if (jj + 1 < cout) o[jj + 1] = first ? x1 : o[jj + 1] + x1;
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

// columns of a tile: the most (<= kMaxTile) whose items fit the warps'
// fragments and whose buffers fit in shared memory (0 if none).  The CPU
// tests' _tile mirrors this choice.
template <int NG>
int tile_columns(int nz) {
  int tile = kMaxItems / NG / nz;
  if (tile > kMaxTile) tile = kMaxTile;
  while (tile > 0 && smem_bytes<NG>(tile, nz) > kMaxSmem) --tile;
  return tile;
}

template <int CP, int NG>
cudaError_t launch(const float* feats, const int* src, uint32_t* masks,
                   int n_rows, const uint4* wk, float* out, int n_out,
                   int nz, int cout, int sms, cudaStream_t stream) {
  const auto kernel = winfuse_kernel<CP, NG>;
  const int tile = tile_columns<NG>(nz);
  if (tile < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<NG>(tile, nz);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = rowmask::launch_row_masks(feats, masks, n_rows, nz, CP,
                                     stream)) != cudaSuccess)
    return err;
  // one block row a chunk of 64*NG output channels
  const int chunks = (cout + 64 * NG - 1) / (64 * NG);
  const int tiles = (n_out + tile - 1) / tile;
  const int slots = sms * per_sm / chunks > 0 ? sms * per_sm / chunks : 1;
  const int blocks = tiles < slots ? tiles : slots;
  kernel<<<dim3(blocks, chunks), kThreads, smem, stream>>>(
      feats, src, masks, wk, out, n_out, nz, cout, tile);
  return cudaGetLastError();
}

// NG = ng output-channel groups of 64 a block, the count B was laid out
// for (the wrapper's wide_tf32_groups)
template <int CP>
cudaError_t by_groups(const float* feats, const int* src, uint32_t* masks,
                      int n_rows, const uint4* wk, float* out, int n_out,
                      int nz, int cout, int ng, int sms, cudaStream_t stream) {
  if (ng == 2)
    return launch<CP, 2>(feats, src, masks, n_rows, wk, out, n_out, nz, cout,
                         sms, stream);
  return launch<CP, 1>(feats, src, masks, n_rows, wk, out, n_out, nz, cout,
                       sms, stream);
}

}  // namespace wide_tf32
