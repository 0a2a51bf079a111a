// K3's fp32 d weights at the narrow widths (namespace tf32),
// csrc/winfuse_wgrad.cu's fp32 route up to 32 channels: the tensor cores in
// 3xTF32 (csrc/tf32_mma.cuh says why its error is of fp32's order; the
// inputs, the sums and dW stay fp32, and device.pin_tf32 is not touched).
//
// The structure is the bf16 narrow kernel's (csrc/winfuse_wgrad_tc.cuh):
// dW_k = A_k^T B one GEMM a tap, one warp a tap, its depth the chunk's
// listed items (the (column, z) rows whose cotangent is not all zero, -0
// counting as zero, ascending); the chunk's cotangent rows arrive by bulk
// copy while the chunk before is worked; one partial a block, added in
// block order, so dW has the same bits every run.  What differs for 4-byte
// values:
//   - mma.sync.m16n8k8 tf32: a k8 step is 8 listed items.  A warp stages
//     each item's three source z rows zo - 1 .. zo + 1 into its ring slot
//     (cp.async, 16 bytes a copy; zeros, src-size 0, where the item is past
//     the list, its column lacks the tap or z leaves the column), so the
//     staged values are exact and no lane needs a zero row for A.
//   - Fragments by 32-bit shared loads (ldmatrix moves 16-bit halves).  A
//     staged item is kAWords words, 8 more than a multiple of 32, so the 4
//     items x 8 rows (tz, i) of a fragment load fall in 32 banks.  B comes
//     straight from the staged cotangent rows (4 items a load, up to 4-way
//     conflicts at 32 channels; a pad item reads a zero row).
//   - Every value is split in registers (csrc/tf32_mma.cuh), and each
//     product runs as three mma.
// Included inside an anonymous namespace that defines kTaps and kMaxSmem,
// after winfuse_wgrad_tc.cuh.
#include "tf32_mma.cuh"

namespace tf32 {

using tc::bulk_copy;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::mbar_arrive_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;

constexpr int kWarps = kTaps;          // one warp a tap
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;             // a warp's ring of k8 steps
constexpr int kStepItems = 8;          // listed items a k8 step
constexpr int kMaxTv = 64;             // columns a chunk, at most
constexpr int kZeroBytes = 128;        // the zero cotangent row of a pad item
constexpr int kCopyBytes = 16384;      // bytes of one bulk copy, at most
static_assert(kTaps * kMaxTv <= 2 * kThreads, "two map entries a thread");

// 16 bytes from src to shared dst, or 16 zero bytes where !ok (src-size
// 0: nothing is read)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst,
                                                   const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// channel pitch CP of the source rows and NP of the cotangent rows ->
// the GEMM's tiles and a staged item
template <int CP, int NP>
struct Geo {
  static constexpr int kM = 3 * CP;              // rows (tz, i) of dW_k
  static constexpr int kMT = (kM + 15) / 16;     // m16 tiles
  static constexpr int kNT = NP / 8;             // n8 tiles
  static constexpr int kRowPieces = CP / 4;      // 16-byte pieces of a z row
  static constexpr int kPieces = 3 * kRowPieces;  // of an item's 3 rows
  // words of a staged item: at least the m-tiles' 16*kMT, 8 past a
  // multiple of 32 (40, 72, 104 at CP 8, 16, 32; past 3*CP they stay zero)
  static constexpr int kAWords = (16 * kMT - 8 + 31) / 32 * 32 + 8;
  static constexpr int kGRow = 4 * NP;           // bytes of a cotangent row
};

template <int CP, int NP>
__host__ __device__ constexpr size_t ring_floats() {
  return static_cast<size_t>(kWarps) * kStages * kStepItems *
         Geo<CP, NP>::kAWords;
}
template <int CP, int NP>
__host__ __device__ constexpr size_t smem_bytes(int tv, int nz) {
  const size_t items = static_cast<size_t>(tv) * nz;
  const size_t words = (items + 31) / 32;
  return 2 * items * Geo<CP, NP>::kGRow + 4 * ring_floats<CP, NP>() +
         kZeroBytes + 16 + 4 * (items + 2 * words + kTaps * tv + 1);
}

// Shared memory of a chunk of tv columns:
//   g_s    [2][tv * nz][NP] float: the cotangent rows of this chunk and of
//          the next (in flight), item c*nz + zo, as they lie in g
//   a_s    [9 warps][kStages][8 items][kAWords] float: a warp's staged
//          source rows, item slot e holding rows zo - 1 .. zo + 1 of its
//          column's source for the warp's tap, (tz, i) at word tz*CP + i
//   zero_s [kZeroBytes] zeros
//   full_s [2] mbarriers: a g_s buffer's rows have landed
//   item_s [tv * nz] the listed items, c << 16 | zo, ascending
//   mask_s [words] bit l of word w: item 32w + l's row is not all zero
//   base_s [words] listed items before word w
//   src_s  [9][tv] the chunk's source row of each tap, -1 if not taken
//   count_s        the number of listed items
template <int CP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_mma(const float* __restrict__ feats, const int* __restrict__ src,
          const float* __restrict__ g, float* __restrict__ part, int n_out,
          int nz, int cin, int cout, int tv) {
  using G = Geo<CP, NP>;
  extern __shared__ uint4 smem[];
  const int n_items = tv * nz;
  const int n_words = (n_items + 31) / 32;
  const uint32_t g_bytes = static_cast<uint32_t>(n_items) * G::kGRow;
  unsigned char* g_s = reinterpret_cast<unsigned char*>(smem);
  float* a_s =
      reinterpret_cast<float*>(g_s + 2 * static_cast<size_t>(g_bytes));
  float* zero_s = a_s + ring_floats<CP, NP>();
  uint64_t* full_s = reinterpret_cast<uint64_t*>(zero_s + kZeroBytes / 4);
  int* item_s = reinterpret_cast<int*>(full_s + 2);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(item_s + n_items);
  int* base_s = reinterpret_cast<int*>(mask_s + n_words);
  int* src_s = base_s + n_words;
  int* count_s = src_s + kTaps * tv;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k = tid >> 5;  // this warp's in-plane tap
  const uint32_t g_u32 = smem_u32(g_s);
  const uint32_t full_u32 = smem_u32(full_s);
  float* ring = a_s + static_cast<size_t>(k) * kStages * kStepItems *
                          G::kAWords;
  const uint32_t ring_u32 = smem_u32(ring);
  // the rings (their words past 3*CP are never staged) and the zero row
  for (int e = tid; e < static_cast<int>(ring_floats<CP, NP>()) +
                            kZeroBytes / 4;
       e += kThreads)
    a_s[e] = 0.f;
  if (tid < 2) mbar_init(full_u32 + 8 * tid, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // chunk c's cotangent rows (one contiguous run of g) into g_s buffer b by
  // the copy engine, kCopyBytes a copy, one copy a lane of warp 0; and this
  // thread's entries tid, tid + kThreads of its source rows, read into
  // registers
  const int n_chunks = (n_out + tv - 1) / tv;
  auto fetch = [&](int c, int b, int (&nxt)[2]) {
    nxt[0] = nxt[1] = -1;
    if (c >= n_chunks) return;
    const int nc = min(tv, n_out - c * tv);
    if (k == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nc) * nz * G::kGRow;
      const char* from = reinterpret_cast<const char*>(
          g + static_cast<size_t>(c) * tv * nz * NP);
      // the block's reads of this buffer (the chunk before last) come
      // before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) mbar_arrive_tx(full_u32 + 8 * b, bytes);
      __syncwarp();
      for (uint32_t off = lane * kCopyBytes; off < bytes;
           off += 32 * kCopyBytes)
        bulk_copy(g_u32 + b * g_bytes + off, from + off,
                  min(bytes - off, static_cast<uint32_t>(kCopyBytes)),
                  full_u32 + 8 * b);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * kThreads;
      const int kk = e / tv, cc = e - kk * tv;
      if (e < kTaps * tv && cc < nc)
        nxt[r] = __ldg(src + static_cast<size_t>(kk) * n_out + c * tv + cc);
    }
  };

  float acc[G::kMT][G::kNT][4];
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // lane (gq, t) of a k8 step: items t and t + 4 of the step (the k
  // slots), rows (tz, i) 16 mt + gq (+ 8) of A, output channel 8 nt + gq
  // of B
  const int gq = lane >> 2, t = lane & 3;
  const int* my_src = src_s + k * tv;
  int src_next[2];
  fetch(blockIdx.x, 0, src_next);
  for (int chunk = blockIdx.x, li = 0; chunk < n_chunks;
       chunk += gridDim.x, ++li) {
    const int b = li & 1;
    const int nc = min(tv, n_out - chunk * tv);
    const int n_live = nc * nz;
    __syncthreads();  // the previous chunk's rows and lists are read
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (tid + r * kThreads < kTaps * tv)
        src_s[tid + r * kThreads] = src_next[r];
    // the next chunk's rows land while this one is listed and computed
    fetch(chunk + gridDim.x, b ^ 1, src_next);
    mbar_wait(full_u32 + 8 * b, (li >> 1) & 1);
    const unsigned char* gb = g_s + b * g_bytes;
    // the rows that are not all zero, 32 items a word (-0 counts as zero:
    // the masked cotangent is full of it)
    for (int w = k; w < n_words; w += kWarps) {
      const int it = 32 * w + lane;
      bool any = false;
      if (it < n_live) {
        const uint4* r = reinterpret_cast<const uint4*>(gb + it * G::kGRow);
#pragma unroll
        for (int q = 0; q < NP / 4; ++q) {
          const uint4 x = r[q];
          any |= ((x.x | x.y | x.z | x.w) & 0x7fffffffu) != 0u;
        }
      }
      const uint32_t m = __ballot_sync(0xffffffffu, any);
      if (lane == 0) mask_s[w] = m;
    }
    __syncthreads();
    if (k == 0) {
      // listed items before each word: a warp scan of the words' counts
      int run = 0;
      for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        const int cnt = w < n_words ? __popc(mask_s[w]) : 0;
        int inc = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        if (w < n_words) base_s[w] = run + inc - cnt;
        run += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) *count_s = run;
    }
    __syncthreads();
    for (int w = k; w < n_words; w += kWarps) {
      const uint32_t m = mask_s[w];
      if ((m >> lane) & 1u) {
        const int it = 32 * w + lane;
        const int c = it / nz;
        item_s[base_s[w] + __popc(m & ((1u << lane) - 1u))] =
            c << 16 | (it - c * nz);
      }
    }
    __syncthreads();
    const int n_act = *count_s;
    const int n_steps = (n_act + kStepItems - 1) / kStepItems;

    // step st's source rows into ring slot st % kStages: for each of its 8
    // items, the rows zo - 1 .. zo + 1 of its column's source (contiguous
    // in feats), 16 bytes a copy, zeros where there is no such row
    auto stage = [&](int st) {
      if (st < n_steps) {
        const uint32_t buf =
            ring_u32 + (st % kStages) * kStepItems * G::kAWords * 4;
        for (int p = lane; p < kStepItems * G::kPieces; p += 32) {
          const int il = p / G::kPieces;
          const int piece = p - il * G::kPieces;
          const int a = kStepItems * st + il;
          const float* from = feats;
          bool ok = false;
          if (a < n_act) {
            const int e = item_s[a];
            const int s = my_src[e >> 16];
            const int z = (e & 0xffff) - 1 + piece / G::kRowPieces;
            ok = s >= 0 && z >= 0 && z < nz;
            if (ok)
              from = feats + (static_cast<size_t>(s) * nz + z) * CP +
                     (piece % G::kRowPieces) * 4;
          }
          cp_async16_or_zero(buf + (il * G::kAWords + 4 * piece) * 4, from,
                             ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) stage(st);
    for (int st = 0; st < n_steps; ++st) {
      stage(st + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncwarp();  // every lane's copies of step st have landed
      const float* buf = ring + (st % kStages) * kStepItems * G::kAWords;
      const int a0 = kStepItems * st;
      // B: the cotangent rows of items t and t + 4, or the zero row
      const float* brow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a0 + t + 4 * h;
        if (a < n_act) {
          const int e = item_s[a];
          brow[h] = reinterpret_cast<const float*>(gb) +
                    ((e >> 16) * nz + (e & 0xffff)) * NP;
        } else {
          brow[h] = zero_s;
        }
      }
      uint32_t bh[G::kNT][2], bl[G::kNT][2];
#pragma unroll
      for (int nt = 0; nt < G::kNT; ++nt) {
        split(brow[0][8 * nt + gq], bh[nt][0], bl[nt][0]);
        split(brow[1][8 * nt + gq], bh[nt][1], bl[nt][1]);
      }
      const float* x0 = buf + t * G::kAWords;
      const float* x1 = buf + (t + 4) * G::kAWords;
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt) {
        uint32_t ah[4], al[4];
        split(x0[16 * mt + gq], ah[0], al[0]);
        split(x0[16 * mt + gq + 8], ah[1], al[1]);
        split(x1[16 * mt + gq], ah[2], al[2]);
        split(x1[16 * mt + gq + 8], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < G::kNT; ++nt)
          mma3(acc[mt][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0],
               bl[nt][1]);
      }
      __syncwarp();  // slot st % kStages is read before it is staged again
    }
  }
  cp_async_wait<0>();

  // this tap's rows of the block's partial: accumulator r of tile (mt, nt)
  // is dW_k[16 mt + lane/4 + 8 (r / 2), 8 nt + 2 (lane % 4) + r % 2]
  float* out = part + static_cast<size_t>(blockIdx.x) * 27 * cin * cout;
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 16 * mt + gq + 8 * (r >> 1);
        const int j = 8 * nt + 2 * t + (r & 1);
        const int tz = m / CP, i = m % CP;
        if (m < G::kM && i < cin && j < cout)
          out[((3 * k + tz) * cin + i) * cout + j] = acc[mt][nt][r];
      }
}

// columns of a chunk: the most (<= kMaxTv) whose staging fits
template <int CP, int NP>
int chunk_columns(int nz) {
  int tv = kMaxTv;
  while (tv > 1 && smem_bytes<CP, NP>(tv, nz) > kMaxSmem) --tv;
  return tv;
}

template <int CP, int NP>
cudaError_t launch(const float* feats, const int* src, const float* g,
                   float* part, int max_parts, int n_out, int nz, int cin,
                   int cout, int sms, cudaStream_t st, int* grid_out) {
  const int tv = chunk_columns<CP, NP>(nz);
  const size_t smem = smem_bytes<CP, NP>(tv, nz);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma<CP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wgrad_mma<CP, NP>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_chunks = (n_out + tv - 1) / tv;
  int grid = per_sm * sms;
  if (grid > max_parts) grid = max_parts;
  if (grid > n_chunks) grid = n_chunks;
  *grid_out = grid;
  if (grid == 0) return cudaSuccess;
  wgrad_mma<CP, NP><<<grid, kThreads, smem, st>>>(feats, src, g, part, n_out,
                                                  nz, cin, cout, tv);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_np(int np, const float* feats, const int* src, const float* g,
                  float* part, int max_parts, int n_out, int nz, int cin,
                  int cout, int sms, cudaStream_t st, int* grid_out) {
  if (np == 8)
    return launch<CP, 8>(feats, src, g, part, max_parts, n_out, nz, cin,
                         cout, sms, st, grid_out);
  if (np == 16)
    return launch<CP, 16>(feats, src, g, part, max_parts, n_out, nz, cin,
                          cout, sms, st, grid_out);
  return launch<CP, 32>(feats, src, g, part, max_parts, n_out, nz, cin, cout,
                        sms, st, grid_out);
}

}  // namespace tf32
