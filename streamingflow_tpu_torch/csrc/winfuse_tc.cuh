// K3's tensor-core forward kernel at the narrow widths (namespace tc),
// csrc/winfuse.cu's bf16 route up to 32 channels.  Included inside an
// anonymous namespace that defines kTaps and kMaxSmem, after <cuda_bf16.h>,
// <cuda_runtime.h> and <stdint.h>.
namespace tc {

// the products; with the copy warp 9 warps, so a thread may hold more
// registers than 128 (12 warps capped it there and spilled)
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one warp for the copies
constexpr int kStages = 6;     // ring of staged (tile, tap) steps
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
// the wide kernels' copies (csrc/winfuse.cu's namespace wide and
// csrc/winfuse_wide_tf32.cuh): bytes that bulk copies will bring to bar,
// without an arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// this thread's arrival on bar, made when its cp.async copies so far land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
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

template <int CP>
__host__ __device__ constexpr size_t stage_bytes(int tile, int nz) {
  return static_cast<size_t>(tile * (nz + 2) + kTail) * Geo<CP>::kPitch;
}
template <int CP, int NT>
__host__ __device__ constexpr size_t smem_bytes(int tile, int nz) {
  return static_cast<size_t>(kTaps) * Geo<CP>::kPad * 8 * NT * 2 +
         kStages * (stage_bytes<CP>(tile, nz) + 16 + 4) +
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
template <int CP, int NT>
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
  constexpr int kRing = kStages;
  const int tile = 1 << tile_log2;
  extern __shared__ uint4 smem[];
  uint4* w_s = smem;
  const int w_vecs = kTaps * kSteps * (NT / 2) * 32;
  unsigned char* rows = reinterpret_cast<unsigned char*>(w_s + w_vecs);
  const size_t step = stage_bytes<CP>(tile, nz);
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

  // B fragments of every tap, staged once.  Lane l's fragment of n-tile nt
  // and k16 step ks holds b0 = B[k0, k0 + 1][n], b1 = B[k0 + 8, k0 + 9][n]
  // with k0 = 16*ks + 2*(l % 4), n = 8*nt + l/4.  wk is read 16 bytes (8 n
  // values of one K row) a load and each value put in its place.
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
          mbar_arrive_tx(full_u32 + 8 * b, __popc(found) * row_bytes);
        }
        __syncwarp();
        if (from >= 0)
          bulk_copy(base + (lane * (nz + 2) + 1) * kPitch,
                    feats + static_cast<size_t>(from) * nz * CP, row_bytes,
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
        const uint4* wt = w_s + k * kSteps * (NT / 2) * 32 + lane;
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
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int it = 16 * (warp + kConsumerWarps * f) + g + 8 * h;
        if (it >= n_items || v0 + it / nz >= n_out) continue;
        __nv_bfloat16* o = out + (static_cast<size_t>(v0) * nz + it) * cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int jj = 8 * nt + 2 * q;
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
template <int CP, int NT>
int tile_columns(int nz) {
  int tile = kMaxTile;
  while (tile > 1 &&
         ((tile * nz + 15) / 16 > kConsumerWarps * frags_per_warp<NT>() ||
          smem_bytes<CP, NT>(tile, nz) > kMaxSmem))
    tile /= 2;
  return tile;
}

template <int CP, int NT>
cudaError_t launch(const void* feats, const int* src, const void* wk,
                   void* out, int n_out, int nz, int cout, int sms,
                   cudaStream_t stream) {
  const int tile = tile_columns<CP, NT>(nz);
  int tile_log2 = 0;
  while ((1 << tile_log2) < tile) ++tile_log2;
  const size_t smem = smem_bytes<CP, NT>(tile, nz);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      winfuse_kernel<CP, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, winfuse_kernel<CP, NT>, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n_out + tile - 1) / tile;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  winfuse_kernel<CP, NT><<<blocks, kThreads, smem, stream>>>(
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
