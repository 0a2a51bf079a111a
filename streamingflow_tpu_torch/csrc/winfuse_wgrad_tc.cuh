// K3's tensor-core d weights at the narrow widths (namespace tc),
// csrc/winfuse_wgrad.cu's bf16 route up to 32 channels.  Included inside an anonymous namespace that defines kTaps and kMaxSmem, after
// <cuda_bf16.h>, <cuda_runtime.h>, <stdint.h> and WINFUSE_WGRAD_PART.
namespace tc {

constexpr int kWarps = kTaps;          // one warp a tap
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;             // a warp's ring of k16 steps
constexpr int kMaxTv = 64;             // columns a chunk, at most
constexpr int kZeroBytes = 256;        // the zeroed row every pad lane reads
constexpr int kCopyBytes = 16384;      // bytes of one bulk copy, at most
static_assert(kTaps * kMaxTv <= 2 * kThreads, "two map entries a thread");

// channel pitch CP of the source rows and NP of the cotangent rows ->
// the GEMM's tiles and a staged item.  An item's 4*(2p + 1) words put the 8
// rows of an ldmatrix on 8 different 16-byte bank groups.
template <int CP, int NP>
struct Geo {
  static constexpr int kM = 3 * CP;              // rows (tz, i) of dW_k
  static constexpr int kMT = (kM + 15) / 16;     // m16 tiles
  static constexpr int kNT = NP / 8;             // n8 tiles
  static constexpr int kRowPieces = CP / 8;      // 16-byte pieces of a z row
  static constexpr int kPieces = 3 * kRowPieces;  // of an item's 3 rows
  static constexpr int kAPitch = 6 * CP + ((6 * CP / 4) % 8 == 0 ? 16 : 0);
  static constexpr int kGRow = 2 * NP;           // bytes of a cotangent row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr,
                                                  uint32_t& r0,
                                                  uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
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

template <int CP, int NP>
__host__ __device__ constexpr size_t smem_bytes(int tv, int nz) {
  using G = Geo<CP, NP>;
  const size_t items = static_cast<size_t>(tv) * nz;
  const size_t words = (items + 31) / 32;
  return 2 * items * G::kGRow + kWarps * kStages * 16 * G::kAPitch +
         kZeroBytes + 16 + 4 * (items + 2 * words + kTaps * tv + 1);
}

// Shared memory of a chunk of tv columns:
//   g_s    [2][tv * nz][2*NP bytes] the cotangent rows of this chunk and of
//          the next (in flight), item c*nz + zo, as they lie in g
//   a_s    [9 warps][kStages][16 items][kAPitch bytes] a warp's staged
//          source rows: item slot e holds rows zo - 1 .. zo + 1 of its
//          column's source for the warp's tap, (tz, i) at byte 2*(tz*CP + i)
//   zero_s [kZeroBytes] zeros
//   full_s [2] mbarriers: a g_s buffer's rows have landed
//   item_s [tv * nz] the listed items, c << 16 | zo, ascending
//   mask_s [words] bit l of word w: item 32w + l's row is not all zero
//   base_s [words] listed items before word w
//   src_s  [9][tv] the chunk's source row of each tap, -1 if not taken
//   count_s        the number of listed items
template <int CP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_mma(const __nv_bfloat16* __restrict__ feats,
          const int* __restrict__ src, const __nv_bfloat16* __restrict__ g,
          float* __restrict__ part, int n_out, int nz, int cin, int cout,
          int tv) {
  using G = Geo<CP, NP>;
  extern __shared__ uint4 smem[];
  const int n_items = tv * nz;
  const int n_words = (n_items + 31) / 32;
  constexpr int grow = G::kGRow;  // bytes of a cotangent row
  const uint32_t g_bytes = static_cast<uint32_t>(n_items) * grow;
  unsigned char* g_s = reinterpret_cast<unsigned char*>(smem);
  unsigned char* a_s = g_s + 2 * static_cast<size_t>(g_bytes);
  unsigned char* zero_s = a_s + kWarps * kStages * 16 * G::kAPitch;
  uint64_t* full_s = reinterpret_cast<uint64_t*>(zero_s + kZeroBytes);
  int* item_s = reinterpret_cast<int*>(full_s + 2);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(item_s + n_items);
  int* base_s = reinterpret_cast<int*>(mask_s + n_words);
  int* src_s = base_s + n_words;
  int* count_s = src_s + kTaps * tv;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k = tid >> 5;  // this warp's in-plane tap
  const uint32_t g_u32 = smem_u32(g_s);
  const uint32_t zero_u32 = smem_u32(zero_s);
  const uint32_t full_u32 = smem_u32(full_s);
  const uint32_t ring_u32 = smem_u32(a_s) + k * kStages * 16 * G::kAPitch;
  for (int e = tid; e < kZeroBytes / 16; e += kThreads)
    reinterpret_cast<uint4*>(zero_s)[e] = make_uint4(0, 0, 0, 0);
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
      const uint32_t bytes = static_cast<uint32_t>(nc) * nz * grow;
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

  // this lane's ldmatrix rows in a k16 step: A's item (matrices 0, 1: items
  // 0-7, 2, 3: items 8-15) and channel half (matrices 1, 3: + 8); B's item
  // (matrices 0, 2: items 0-7, 1, 3: items 8-15) and output-channel half
  // (matrices 2, 3: + 8)
  const int ia = (lane & 7) + ((lane >> 4) << 3);
  const int ca = 8 * ((lane >> 3) & 1);
  const int ib = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int jb = 8 * (lane >> 4);
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
    const uint32_t gb_u32 = g_u32 + b * g_bytes;
    // the rows that are not all zero, 32 items a word.  Values, not bits:
    // -0 (the sign bit alone) is zero, and the masked cotangent is full of
    // it (a negative value times a zero mask)
    for (int w = k; w < n_words; w += kWarps) {
      const int it = 32 * w + lane;
      bool any = false;
      if (it < n_live) {
        const uint4* r =
            reinterpret_cast<const uint4*>(gb + it * grow);
#pragma unroll
        for (int q = 0; q < NP / 8; ++q) {
          const uint4 x = r[q];
          any |= ((x.x | x.y | x.z | x.w) & 0x7fff7fffu) != 0u;
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
    const int n_steps = WINFUSE_WGRAD_PART == 1 ? 0 : (n_act + 15) / 16;

    // step st's source rows into ring slot st % kStages: for each listed
    // item whose column has the tap, its rows zo - 1 .. zo + 1 that lie in
    // the column (contiguous in feats), 16 bytes a copy
    auto stage = [&](int st) {
      if (WINFUSE_WGRAD_PART != 2 && st < n_steps) {
        const uint32_t buf = ring_u32 + (st % kStages) * 16 * G::kAPitch;
        for (int p = lane; p < 16 * G::kPieces; p += 32) {
          const int il = p / G::kPieces;
          const int piece = p - il * G::kPieces;
          const int a = 16 * st + il;
          if (a >= n_act) break;
          const int e = item_s[a];
          const int s = my_src[e >> 16];
          const int z = (e & 0xffff) - 1 + piece / G::kRowPieces;
          if (s < 0 || z < 0 || z >= nz) continue;
          cp_async16(buf + il * G::kAPitch + piece * 16,
                     feats + (static_cast<size_t>(s) * nz + z) * CP +
                         (piece % G::kRowPieces) * 8);
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
      const uint32_t buf = ring_u32 + (st % kStages) * 16 * G::kAPitch;
      const int a0 = 16 * st;
      // A: this lane's item row, or the zero row
      uint32_t arow = zero_u32;
      int zo = 0;
      bool live = false;
      if (a0 + ia < n_act) {
        const int e = item_s[a0 + ia];
        if (my_src[e >> 16] >= 0) {
          live = true;
          zo = e & 0xffff;
          arow = buf + ia * G::kAPitch;
        }
      }
      uint32_t af[G::kMT][4];
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt) {
        const int m0 = 16 * mt + ca;  // (tz, i0) = (m0 / CP, m0 % CP)
        const int z = zo + m0 / CP - 1;
        const bool ok = live && m0 < G::kM && z >= 0 && z < nz;
        ldmatrix_x4_trans(ok ? arow + 2 * m0 : zero_u32, af[mt]);
      }
      // B: this lane's item's cotangent row, or the zero row
      uint32_t brow = zero_u32;
      if (a0 + ib < n_act) {
        const int e = item_s[a0 + ib];
        brow = gb_u32 + ((e >> 16) * nz + (e & 0xffff)) * grow;
      }
      uint32_t bf[G::kNT][2];
      if constexpr (G::kNT == 1) {
        ldmatrix_x2_trans(brow, bf[0][0], bf[0][1]);
      } else {
#pragma unroll
        for (int p = 0; p < G::kNT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(brow + 2 * (16 * p + jb), r);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < G::kNT; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      __syncwarp();  // slot st % kStages is read before it is staged again
    }
  }

  // this tap's rows of the block's partial: accumulator r of tile (mt, nt)
  // is dW_k[16 mt + lane/4 + 8 (r / 2), 8 nt + 2 (lane % 4) + r % 2]
  float* out = part + static_cast<size_t>(blockIdx.x) * 27 * cin * cout;
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 16 * mt + (lane >> 2) + 8 * (r >> 1);
        const int j = 8 * nt + 2 * (lane & 3) + (r & 1);
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
cudaError_t launch(const void* feats, const int* src, const void* g,
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
  wgrad_mma<CP, NP><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(feats), src,
      static_cast<const __nv_bfloat16*>(g), part, n_out, nz, cin, cout, tv);
  return cudaGetLastError();
}

template <int CP>
cudaError_t by_np(int np, const void* feats, const int* src, const void* g,
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

}  // namespace tc
