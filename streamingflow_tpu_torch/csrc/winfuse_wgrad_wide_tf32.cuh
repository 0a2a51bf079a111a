// K3's fp32 d weights past 32 channels (namespace wide_tf32), csrc/
// winfuse_wgrad.cu's fp32 route at stages 3 and 4 on columns (the fp32
// step at DENSE_TAIL_FROM_STAGE 0, 4 or 5).  The wide bf16 design
// (namespace wide) in the narrow fp32 kernel's 3xTF32 (csrc/
// winfuse_wgrad_tf32.cuh; csrc/tf32_mma.cuh says why its error is of
// fp32's order):
//   - the cotangent's nonzero items (-0 counting as zero) are listed once,
//     by wide::wgrad_list on the fp32 rows;
//   - dW is cut into pieces, tap k's rows (tz, i) for one z tap (three
//     where their fp32 sums fit 64 registers of 256 threads: the bf16
//     rule, wgrad_pieces in the wrapper) by every output channel, one
//     block row a piece: 9 pieces at 64 -> 64, 27 at 128 -> 128;
//   - a piece's blocks stage only the listed items' source rows for the
//     piece's tap and z taps and their cotangent rows (cp.async, zeros
//     where a row does not exist: src-size 0), in a ring of 3 steps of 64
//     listed items (32 where those do not fit), and every warp runs
//     its m16n8 tiles of the piece in 3xTF32 k8 steps of 8 listed items;
//   - fragments by 32-bit shared loads (ldmatrix moves 16-bit halves): a
//     staged item's source rows and its cotangent row are each 8 words
//     past a multiple of 32, so a fragment's 4 items x 8 rows or channels
//     fall in 32 banks; every value is split in registers, and the three
//     products of a k8 step run over all of a warp's tiles before the
//     next.
//   - the tensor cores round each mma's fp32 sum toward zero, so sums of
//     many k8 steps drift: a block's accumulators over its whole run
//     landed 2.4e-4 of the scale from the fp64 sums at stage 3 on an H100
//     (the card check's bar is 1e-4).  A block adds them into its partial
//     (fp32 adds, rounded to nearest) every kFlushItems listed items and
//     starts them anew: 5e-6 of the scale.
// The partials add in block order (wgrad_reduce): the same bits every run.
// What bounds it: the listed items' rows from L2, staged once for each of
// the 9 or 27 pieces, and the products in three passes.
// Included inside an anonymous namespace that defines kTaps and kMaxSmem,
// after winfuse_wgrad_tf32.cuh and namespace wide.
namespace wide_tf32 {

using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::smem_u32;
using tf32::mma_tf32;
using tf32::split;
using wide::chunk_columns;
using wide::cp_async16_or_zero;
using wide::kListItems;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // ring of steps
// listed items after which a block adds its sums into its partial and
// starts them anew (see the kernel)
constexpr int kFlushItems = 1024;

// CP, NP -> a piece (TZ z taps), its tiles (8 warps in a WM x WN grid,
// each MTW x NTW m16n8 tiles of the piece's (TZ*CP) x NP) and a step's
// items (64 where 3 steps fit, else 32)
template <int CP, int NP>
struct Geo {
  static constexpr int kTZ = 3 * CP * NP <= 64 * 256 ? 3 : 1;
  static constexpr int kM = kTZ * CP;
  static constexpr int kMT = kM / 16;
  static constexpr int kNT = NP / 8;
  static constexpr int kNTW = 4;
  static constexpr int kWN = kNT / kNTW;
  static constexpr int kWM = kWarps / kWN;
  static constexpr int kMTW = (kMT + kWM - 1) / kWM;
  // words of a staged item's source rows and of its cotangent row, each 8
  // past a multiple of 32
  static constexpr int kAWords = kM + 8;
  static constexpr int kBWords = NP + 8;
  static constexpr int kItemBytes = 4 * (kAWords + kBWords);
  static constexpr int kStepItems =
      kStages * 64 * kItemBytes + 8 * kListItems <= kMaxSmem ? 64 : 32;
  static constexpr int kStep = kStepItems * kItemBytes;
};
template <int CP, int NP>
__host__ __device__ constexpr size_t smem_bytes(int tv) {
  return static_cast<size_t>(kStages) * Geo<CP, NP>::kStep +
         4 * (static_cast<size_t>(kListItems) + tv);
}

// Block (x, y): tap k = y / (3 / TZ), z taps tz0 = TZ * (y % (3 / TZ)) ..
// tz0 + TZ - 1, every output channel; chunks x, x + gridDim.x, ...
//
// Shared memory:
//   ring   [kStages][kStepItems] staged items: a_s [items][kAWords] (source
//          rows zo - 1 + tz0 .. + TZ - 1 of the item's column for tap k,
//          row tz - tz0 at word CP*(tz - tz0); zeros where the tap is not
//          found, z leaves the column or the item is past the list), then
//          b_s [items][kBWords] (the cotangent row; zeros past the list)
//   list_s [kListItems] the chunk's listed items, c << 16 | zo
//   src_s  [tv] the chunk's source row of tap k for each column
//
// A step: every thread stages (cp.async) its share of step st + 2, then
// each warp runs its tiles of dW_k^T += A^T B over the step's items, k8
// step by k8 step.  The tensor cores round each mma's fp32 sum toward zero,
// so a sum of many k8 steps in the accumulators drifts: a block adds its
// accumulators into its rows of part[x] (fp32 adds, rounded to nearest)
// after every chunk that brings its items since the last add to
// kFlushItems, and after its last chunk, then starts them from zero; each
// element has one owner thread and a fixed order, so the bits repeat.
// The partials add in block order (wgrad_reduce).
template <int CP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_mma(const float* __restrict__ feats, const int* __restrict__ src,
          const float* __restrict__ g, const int* __restrict__ lists,
          const int* __restrict__ counts, float* __restrict__ part,
          int n_out, int nz, int cin, int cout, int tv) {
  using G = Geo<CP, NP>;
  constexpr int kRowPieces = CP / 4;            // 16-byte pieces of a z row
  constexpr int kAPieces = G::kTZ * kRowPieces;  // of an item's rows
  constexpr int kBPieces = NP / 4;
  constexpr int kSI = G::kStepItems;
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  int* list_s = reinterpret_cast<int*>(ring + kStages * G::kStep);
  int* src_s = list_s + kListItems;
  const uint32_t ring_u32 = smem_u32(ring);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % G::kWM, wn = warp / G::kWM;
  const int gq = lane >> 2, t = lane & 3;
  const int k = blockIdx.y / (3 / G::kTZ);
  const int tz0 = G::kTZ * (blockIdx.y % (3 / G::kTZ));
  const int n_chunks = (n_out + tv - 1) / tv;

  float acc[G::kMTW][G::kNTW][4];
#pragma unroll
  for (int u = 0; u < G::kMTW; ++u)
#pragma unroll
    for (int w = 0; w < G::kNTW; ++w)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][w][r] = 0.f;

  // the piece's rows of this block's partial: accumulator r of tile
  // (u, w) is dW_k[tz0*CP + m][j], m = 16*mt + lane/4 + 8*(r/2), j =
  // 8*nt + 2*(lane % 4) + r % 2
  float* out = part + static_cast<size_t>(blockIdx.x) * 27 * cin * cout;
  auto flush = [&](bool first) {
#pragma unroll
    for (int u = 0; u < G::kMTW; ++u) {
      const int mt = wm + G::kWM * u;
      if (mt >= G::kMT) continue;
#pragma unroll
      for (int w = 0; w < G::kNTW; ++w)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = 16 * mt + gq + 8 * (r >> 1);
          const int j = 8 * (G::kNTW * wn + w) + 2 * t + (r & 1);
          const int tz = tz0 + m / CP, i = m % CP;
          if (i < cin && j < cout) {
            float* o = out + ((3 * k + tz) * cin + i) * cout + j;
            *o = first ? acc[u][w][r] : *o + acc[u][w][r];
          }
          acc[u][w][r] = 0.f;
        }
    }
  };

  int pending = 0;  // listed items since the last flush
  bool first = true;
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
    const int n_steps = (n_act + kSI - 1) / kSI;

    auto stage = [&](int st) {
      if (st < n_steps) {
        const uint32_t a_u32 = ring_u32 + (st % kStages) * G::kStep;
        const uint32_t b_u32 = a_u32 + kSI * G::kAWords * 4;
        for (int e = tid; e < kSI * (kAPieces + kBPieces); e += kThreads) {
          if (e < kSI * kAPieces) {
            const int il = e / kAPieces, p = e - il * kAPieces;
            const int tt = p / kRowPieces, pc = p - tt * kRowPieces;
            const int a = kSI * st + il;
            const int ent = a < n_act ? list_s[a] : -1;
            const int s = ent >= 0 ? src_s[ent >> 16] : -1;
            const int z = (ent & 0xffff) - 1 + tz0 + tt;
            const bool ok = s >= 0 && z >= 0 && z < nz;
            cp_async16_or_zero(
                a_u32 + 4 * (il * G::kAWords + 4 * p),
                ok ? feats + (static_cast<size_t>(s) * nz + z) * CP + 4 * pc
                   : feats,
                ok);
          } else {
            const int e2 = e - kSI * kAPieces;
            const int il = e2 / kBPieces, pc = e2 - il * kBPieces;
            const int a = kSI * st + il;
            const bool ok = a < n_act;
            const int ent = ok ? list_s[a] : 0;
            cp_async16_or_zero(
                b_u32 + 4 * (il * G::kBWords + 4 * pc),
                g + ((static_cast<size_t>(v0) + (ent >> 16)) * nz +
                     (ent & 0xffff)) * NP + 4 * pc,
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
      const float* a_s =
          reinterpret_cast<const float*>(ring + (st % kStages) * G::kStep);
      const float* b_s = a_s + kSI * G::kAWords;
#pragma unroll 2
      for (int j = 0; j < kSI / 8; ++j) {
        // k8 step j: items 8j .. 8j + 7 of the step; this lane's are
        // 8j + t and 8j + t + 4
        const float* b0 = b_s + (8 * j + t) * G::kBWords +
                          8 * G::kNTW * wn + gq;
        const float* b1 = b0 + 4 * G::kBWords;
        uint32_t bh[G::kNTW][2], bl[G::kNTW][2];
#pragma unroll
        for (int w = 0; w < G::kNTW; ++w) {
          split(b0[8 * w], bh[w][0], bl[w][0]);
          split(b1[8 * w], bh[w][1], bl[w][1]);
        }
        const float* x0 = a_s + (8 * j + t) * G::kAWords + gq;
        const float* x1 = x0 + 4 * G::kAWords;
        uint32_t ah[G::kMTW][4], al[G::kMTW][4];
#pragma unroll
        for (int u = 0; u < G::kMTW; ++u) {
          const int mt = wm + G::kWM * u;
          if (mt >= G::kMT) continue;
          split(x0[16 * mt], ah[u][0], al[u][0]);
          split(x0[16 * mt + 8], ah[u][1], al[u][1]);
          split(x1[16 * mt], ah[u][2], al[u][2]);
          split(x1[16 * mt + 8], ah[u][3], al[u][3]);
        }
        // 3xTF32, the small terms first, each over every tile before the
        // next
#pragma unroll
        for (int u = 0; u < G::kMTW; ++u) {
          if (wm + G::kWM * u >= G::kMT) continue;
#pragma unroll
          for (int w = 0; w < G::kNTW; ++w)
            mma_tf32(acc[u][w], al[u], bh[w][0], bh[w][1]);
        }
#pragma unroll
        for (int u = 0; u < G::kMTW; ++u) {
          if (wm + G::kWM * u >= G::kMT) continue;
#pragma unroll
          for (int w = 0; w < G::kNTW; ++w)
            mma_tf32(acc[u][w], ah[u], bl[w][0], bl[w][1]);
        }
#pragma unroll
        for (int u = 0; u < G::kMTW; ++u) {
          if (wm + G::kWM * u >= G::kMT) continue;
#pragma unroll
          for (int w = 0; w < G::kNTW; ++w)
            mma_tf32(acc[u][w], ah[u], bh[w][0], bh[w][1]);
        }
      }
    }
    cp_async_wait<0>();
    pending += n_act;
    if (pending >= kFlushItems || chunk + gridDim.x >= n_chunks) {
      flush(first);
      first = false;
      pending = 0;
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
cudaError_t launch(const float* feats, const int* src, const float* g,
                   float* part, int max_parts, int* lists, int n_out, int nz,
                   int cin, int cout, int sms, cudaStream_t st,
                   int* grid_out) {
  const int tv = chunk_columns(nz);
  const int n_chunks = (n_out + tv - 1) / tv;
  *grid_out = 0;
  if (n_chunks == 0) return cudaSuccess;
  int* counts = lists + static_cast<size_t>(n_chunks) * tv * nz;
  // one warp a chunk
  wide::wgrad_list<float, NP><<<(n_chunks + 7) / 8, 256, 0, st>>>(
      g, lists, counts, n_out, nz, tv);
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
      feats, src, g, lists, counts, part, n_out, nz, cin, cout, tv);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_np(int np, const float* feats, const int* src, const float* g,
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

}  // namespace wide_tf32
