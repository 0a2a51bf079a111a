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
// fp32 (the exact check path): TF32 would miss the 1e-4 bar, so fp32 keeps
// the CUDA-core kernel of the first port, below.
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

// ------------------------------------------------------------------ fp32

namespace fp32 {

constexpr int kThreads = 768;          // threads a block, at most
constexpr int kMaxTv = 32;             // columns a chunk, at most
constexpr int kSmemBudget = 96 * 1024;  // bytes of a chunk's staging

// The first design, on the CUDA cores:
//   - A block walks chunks of TV output columns (grid-stride).  It stages
//     the chunk's cotangent rows in shared memory (one contiguous read),
//     marks the (column, z) items whose row is not all zero and lists them
//     in ascending order (one warp, ballots).
//   - Then tap by tap: the source rows of the chunk's columns that have
//     the tap and an active item, between zero z-halo rows, so item
//     (c, zo) of z tap tz reads staged row zo + tz of column c.  A warp
//     stages a column, 16 bytes (4 values) a lane.
//   - Each thread owns one (tz, i, 4 output channels) unit of every tap:
//     36 fp32 sums in registers for the whole run.  Thread groups of
//     larger blocks (narrow widths) take every groups-th item.
//   - At the end the groups' sums are added in a fixed order in shared
//     memory and each block writes one partial (27, Cin, Cout).
//
// Shared memory of a chunk of tv columns (rows = nz + 2):
//   g_s    [tv * nz][cout4] cotangent rows, channels past cout zero
//   x_s    [tv][rows][cin] the current tap's source rows at z + 1 (rows 0
//          and nz + 1 are the z halo)
//   item_s [tv * nz] the active items (c * nz + zo), ascending
//   flag_s [tv * nz] 1 where the item's cotangent row is not all zero
//   src_s  [9][tv] the chunk's source row of each tap, -1 if not taken
//   colf_s [tv] 1 where the column has an active item
//   count_s     the number of active items
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ feats, const int* __restrict__ src,
             const float* __restrict__ g, float* __restrict__ part,
             int n_out, int nz, int cin, int cout, int tv, int groups,
             int vec_f, int vec_g) {
  extern __shared__ float4 smem4[];
  const int cout4 = (cout + 3) & ~3;
  const int j4n = cout4 >> 2;
  const int units = 3 * cin * j4n;
  const int units_pad = (units + 31) & ~31;
  const int rows = nz + 2;
  const int n_items = tv * nz;
  float* g_s = reinterpret_cast<float*>(smem4);
  float* x_s = g_s + n_items * cout4;
  int* item_s = reinterpret_cast<int*>(x_s + tv * rows * cin);
  int* flag_s = item_s + n_items;
  int* src_s = flag_s + n_items;
  int* colf_s = src_s + kTaps * tv;
  int* count_s = colf_s + tv;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int unit = tid % units_pad;
  const int group = tid / units_pad;  // a whole warp is in one group
  const bool mine = unit < units;
  const int tz = unit / (cin * j4n);
  const int ci = (unit / j4n) % cin;
  const int j4 = unit % j4n;
  float acc[kTaps][4];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

  const int seg = rows * cin;  // a staged column: nz rows and the halo
  const int row_in = nz * cin;
  const int row_g = nz * cout;
  const int warp = tid >> 5, lane = tid & 31, n_warps = nthr >> 5;
  // the halo rows stay zero: the staging writes rows 1 .. nz only
  for (int e = tid; e < tv * seg; e += nthr) x_s[e] = 0.f;
  const int n_chunks = (n_out + tv - 1) / tv;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * tv;
    const int nc = min(tv, n_out - v0);
    const float* gc = g + static_cast<long long>(v0) * row_g;
    if (vec_g) {
      // the chunk's rows are one contiguous run of g, 16 bytes a load
      const int n = nc * row_g;
      const float4* gv = reinterpret_cast<const float4*>(gc);
      for (int q = tid; q < n / 4; q += nthr)
        reinterpret_cast<float4*>(g_s)[q] = __ldg(gv + q);
      for (int e = n + tid; e < n_items * cout; e += nthr) g_s[e] = 0.f;
    } else if (cout4 == cout) {
      const int n = nc * nz * cout;
      for (int e = tid; e < n_items * cout; e += nthr)
        g_s[e] = e < n ? gc[e] : 0.f;
    } else {
      for (int e = tid; e < n_items * cout4; e += nthr) {
        const int it = e / cout4;
        const int j = e - it * cout4;
        g_s[e] = it < nc * nz && j < cout
                     ? gc[static_cast<long long>(it) * cout + j]
                     : 0.f;
      }
    }
    for (int e = tid; e < kTaps * tv; e += nthr) {
      const int k = e / tv;
      const int c = e - k * tv;
      src_s[e] = c < nc ? src[static_cast<long long>(k) * n_out + v0 + c]
                        : -1;
    }
    __syncthreads();
    for (int it = tid; it < n_items; it += nthr) {
      const float4* r = reinterpret_cast<const float4*>(g_s + it * cout4);
      bool any = false;
      for (int q = 0; q < j4n; ++q) {
        const float4 a = r[q];
        any |= a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
      }
      flag_s[it] = any;
    }
    __syncthreads();
    if (tid < 32) {
      // ascending order, so every run sums in the same order
      int base = 0;
      for (int s0 = 0; s0 < n_items; s0 += 32) {
        const int it = s0 + tid;
        const bool f = it < n_items && flag_s[it];
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f) item_s[base + __popc(m & ((1u << tid) - 1u))] = it;
        base += __popc(m);
      }
      if (tid == 0) *count_s = base;
    }
    for (int c = tid; c < tv; c += nthr) {
      int f = 0;
      for (int z = 0; z < nz; ++z) f |= flag_s[c * nz + z];
      colf_s[c] = f;
    }
    __syncthreads();
    const int n_act = *count_s;
    if (n_act == 0) continue;  // the same for every thread

#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      // a warp a column, 16 bytes a lane where the rows allow it; columns
      // without the tap or without an active item are left unread
      for (int c = warp; c < nc; c += n_warps) {
        const int s = src_s[k * tv + c];
        if (s < 0 || !colf_s[c]) continue;
        float* xr = x_s + c * seg + cin;
        const float* fr = feats + static_cast<long long>(s) * row_in;
        if (vec_f) {
          const float4* fv = reinterpret_cast<const float4*>(fr);
          for (int q = lane; q < row_in / 4; q += 32)
            reinterpret_cast<float4*>(xr)[q] = __ldg(fv + q);
        } else {
          for (int e = lane; e < row_in; e += 32) xr[e] = fr[e];
        }
      }
      __syncthreads();
      if (mine) {
        for (int a = group; a < n_act; a += groups) {
          const int it = item_s[a];
          const int c = it / nz;
          if (src_s[k * tv + c] < 0) continue;
          const int zo = it - c * nz;
          const float xv = x_s[(c * rows + zo + tz) * cin + ci];
          const float4 gv =
              reinterpret_cast<const float4*>(g_s)[it * j4n + j4];
          acc[k][0] = fmaf(xv, gv.x, acc[k][0]);
          acc[k][1] = fmaf(xv, gv.y, acc[k][1]);
          acc[k][2] = fmaf(xv, gv.z, acc[k][2]);
          acc[k][3] = fmaf(xv, gv.w, acc[k][3]);
        }
      }
      __syncthreads();
    }
  }

  // one partial a block: the groups' sums added in group order
  const int n_w = 27 * cin * cout;
  float* out = part + static_cast<long long>(blockIdx.x) * n_w;
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(smem4);
  if (groups > 1) {
    for (int e = tid; e < n_w; e += nthr) red_s[e] = 0.f;
    __syncthreads();
  }
  for (int q = 0; q < groups; ++q) {
    if (mine && group == q) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 * 4 + jj;
          if (j >= cout) continue;
          const int e = ((3 * k + tz) * cin + ci) * cout + j;
          if (groups == 1)
            out[e] = acc[k][jj];
          else
            red_s[e] += acc[k][jj];
        }
    }
    if (groups > 1) __syncthreads();
  }
  if (groups > 1)
    for (int e = tid; e < n_w; e += nthr) out[e] = red_s[e];
}

// launches wgrad_kernel; *grid gets the number of partials it writes
cudaError_t launch(const float* feats, const int* src, const float* g,
                   float* part, int max_parts, int n_out, int nz, int cin,
                   int cout, int sms, cudaStream_t st, int* grid_out) {
  const int cout4 = (cout + 3) & ~3;
  const int units = 3 * cin * (cout4 / 4);
  const int units_pad = (units + 31) & ~31;
  if (units_pad > kThreads) return cudaErrorInvalidValue;
  const int groups = kThreads / units_pad;
  const int threads = units_pad * groups;
  const int rows = nz + 2;
  const size_t per_col =
      (static_cast<size_t>(nz) * cout4 + static_cast<size_t>(rows) * cin) *
          sizeof(float) +
      (2 * static_cast<size_t>(nz) + kTaps + 1) * sizeof(int);
  const int tv = static_cast<int>(
      per_col >= kSmemBudget ? 1
                             : (kSmemBudget / per_col > kMaxTv
                                    ? kMaxTv
                                    : kSmemBudget / per_col));
  const int n_w = 27 * cin * cout;
  size_t smem = per_col * tv + sizeof(int);
  if (groups > 1 && smem < n_w * sizeof(float)) smem = n_w * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (n_out + tv - 1) / tv;
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  if (grid > max_parts) grid = max_parts;
  if (grid > n_chunks) grid = n_chunks;
  *grid_out = grid;
  if (grid == 0) return cudaSuccess;
  // 16-byte loads where every row starts on 16 bytes (and, for the
  // source rows, each staged column's first row does too)
  const int vec_f = (nz * cin) % 4 == 0 && cin % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int vec_g = cout % 4 == 0 && (nz * cout) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  wgrad_kernel<<<grid, threads, smem, st>>>(feats, src, g, part, n_out, nz,
                                            cin, cout, tv, groups, vec_f,
                                            vec_g);
  return cudaGetLastError();
}

}  // namespace fp32

// ------------------------------------------------------------------ bf16

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
  const uint32_t g_bytes = static_cast<uint32_t>(n_items) * G::kGRow;
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
        const uint4* r = reinterpret_cast<const uint4*>(gb + it * G::kGRow);
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
        brow = gb_u32 + ((e >> 16) * nz + (e & 0xffff)) * G::kGRow;
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

// feats (R, nz*cin) and g (n_out, nz*cout) fp32, src (9, n_out) int32 (-1:
// tap not taken), scratch max_parts x 27*cin*cout fp32 partials, out
// (27, cin, cout) fp32.  1 <= cin, cout <= 32, 1 <= nz <= 256.  Returns a
// cudaError_t (0 = launched).
extern "C" int sf_winfuse_wgrad_fp32(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* out, int n_out,
                                     int nz, int cin, int cout,
                                     void* stream) {
  if (cin < 1 || cin > 32 || cout < 1 || cout > 32 || nz < 1 || nz > 256 ||
      max_parts < 1 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, grid = 0;
  cudaError_t err = sm_count(&sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (err == cudaSuccess)
    err = fp32::launch(static_cast<const float*>(feats), src,
                       static_cast<const float*>(g), part, max_parts, n_out,
                       nz, cin, cout, sms, st, &grid);
  if (err == cudaSuccess) err = reduce(part, out, grid, 27 * cin * cout, st);
  return static_cast<int>(err);
}

// feats (R, nz*cp) bf16 rows at channel pitch cp (8, 16 or 32; channels
// past cin zero) and g (n_out, nz*np) bf16 at pitch np (8, 16 or 32;
// channels past cout zero), both 16-byte aligned; src (9, n_out) int32 as
// above; scratch and out as above, out (27, cin, cout).  1 <= cin <= cp,
// 1 <= cout <= np, 1 <= nz <= 256.
extern "C" int sf_winfuse_wgrad_bf16(const void* feats, const int* src,
                                     const void* g, void* scratch,
                                     int max_parts, void* out, int n_out,
                                     int nz, int cp, int cin, int np,
                                     int cout, void* stream) {
  if ((cp != 8 && cp != 16 && cp != 32) || (np != 8 && np != 16 && np != 32)
      || cin < 1 || cin > cp || cout < 1 || cout > np || nz < 1 || nz > 256
      || max_parts < 1 || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int sms = 0, grid = 0;
  cudaError_t err = sm_count(&sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (err == cudaSuccess) {
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
