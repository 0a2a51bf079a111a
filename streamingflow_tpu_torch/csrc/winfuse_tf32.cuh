// K3's fp32 forward at the narrow widths (namespace tf32),
// csrc/winfuse_fp32.cu's route up to 32 channels: the tensor cores in 3xTF32
// (csrc/tf32_mma.cuh: each operand split into two TF32 pieces, three
// mma.sync.m16n8k8 a product, fp32 accumulators), whose error is of fp32's
// order: the sums land within the fp32 kernel's bars (1e-5 of the plain
// version).  This is not TF32 as a default: the inputs, the sums and the
// result stay fp32, and device.pin_tf32 (matmuls and cuDNN in full fp32) is
// not touched.
//
// The structure is the bf16 narrow kernel's (csrc/winfuse_tc.cuh): one copy
// warp and 8 warps of products, a ring of (tile, tap) steps behind full /
// empty mbarriers, lane c of the copy warp moving column c's whole fused
// row with one bulk copy, items c*nz + zo numbered across columns with a
// zero z-halo row on each side.  What differs for 4-byte rows:
//   - A fragments by 32-bit shared loads.  ldmatrix moves 16-bit halves, and
//     rows of 4*CP bytes (128 at CP 32) put a fragment's 8 rows in one bank
//     group.  K is permuted instead: in k8 step s of z tap tz, lane (g, t)
//     holds as a0 / a2 the values of channels ch(t, s) / ch(t, S + s) of its
//     rows (S = CP / 8 steps a z tap), which lie in one 16-byte chunk of the
//     row (CP 16: chunk t; CP 8: 8 bytes), or in chunks t and t + 4 (CP 32,
//     read in the order that puts rows g and g + 1 in different halves of
//     the banks).  The wrapper's tf32_tap_weights puts B's rows in the
//     same order.
//   - B stays in shared memory as fp32 and is split in registers, a k8
//     step at a time: 9 taps' hi and lo (221 KB at 32 -> 32) would not fit
//     beside the ring; fp32 B alone (111 KB at 32 -> 32) does.
//   - The tile is picked on the host for balance: the fewest fragment
//     rounds a column (each warp owns fragments w, w + 8, ...), the ring as
//     deep as shared memory allows (3 at stage 2's 12 columns).
//   - A warp works its R fragments together, each of the three products
//     over all R*NT accumulators before the next, so two mma on one
//     accumulator have R*NT - 1 others between them; a fragment whose
//     columns lack the tap is computed on zeros unless all R do (a warp
//     skips only such a step).
// What bounds it on an H100: the products, three mma a pair.  Measured at
// stage 2 on an H100 (PERF.md): each pass ~2 ms, ~half the dense TF32 peak,
// over a ~1.3 ms base.  Working one fragment at a time (each skipping a tap
// its columns lack), and z-major items that skip a z tap whose 16 rows are
// zero, both measured slower: the skips are rare on the model's rows and
// their branches break the mma chains apart.
// Included inside an anonymous namespace that defines kTaps and kMaxSmem,
// after winfuse_tc.cuh.
#include "tf32_mma.cuh"

namespace tf32 {

using tc::bulk_copy;
using tc::mbar_arrive;
using tc::mbar_arrive_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one warp for the copies
constexpr int kMaxRing = 6;   // (tile, tap) steps in flight, at most
constexpr int kMaxTile = 32;  // columns of a tile, a lane of the copy warp each
constexpr int kTail = 4;      // zero rows after a step's columns
constexpr int kNoCol = 63;    // column of an item past the tile

// channel pitch CP (8, 16 or 32) -> k8 steps and the staged row
template <int CP>
struct Geo {
  static constexpr int kS = CP / 8;          // k8 steps of a z tap
  static constexpr int kSteps = 3 * kS;      // of K = 3*CP
  static constexpr int kPitch = 4 * CP;      // bytes of a staged row
  static constexpr int kWords = 2 * kS;      // a lane's values of a row
};
// fragments a consumer warp works in a tile, R: at most 12 / NT (48
// accumulators a thread), and one of 1, 2, 3 or 6 (the kernel's
// instantiations; a warp's last fragments may lie past the tile's items)
template <int NT>
__host__ __device__ constexpr int max_rounds() { return 12 / NT; }
inline int padded_rounds(int rounds) { return rounds <= 3 ? rounds : 6; }

template <int CP>
__host__ __device__ constexpr size_t stage_bytes(int tile, int nz) {
  return static_cast<size_t>(tile * (nz + 2) + kTail) * Geo<CP>::kPitch;
}
template <int CP, int NT>
__host__ __device__ constexpr size_t w_bytes() {
  return static_cast<size_t>(kTaps) * Geo<CP>::kSteps * (NT / 2) * 32 * 16;
}
template <int CP, int NT>
__host__ __device__ constexpr size_t smem_bytes(int tile, int nz, int ring,
                                                int rounds) {
  return w_bytes<CP, NT>() + ring * (stage_bytes<CP>(tile, nz) + 16 + 4) +
         4 * kConsumerWarps * rounds * 17;
}

// this lane's kWords values of a staged row (row: its first byte): value w
// is channel ch(t, w) of the row,
//   CP 32: 4t + w % 4 + 16 (w / 4)   CP 16: 4t + w   CP 8: 2t + w
template <int CP>
__device__ __forceinline__ void row_words(const unsigned char* row, int t,
                                          int g, float (&v)[Geo<CP>::kWords]) {
  if constexpr (CP == 32) {
    // lanes of rows g and g + 1 (128 bytes apart) read opposite halves of
    // the row in each load, so a quarter warp's 8 chunks fall in 8 bank
    // groups
    const int odd = g & 1;
    const float4 x =
        *reinterpret_cast<const float4*>(row + 16 * (t + 4 * odd));
    const float4 y =
        *reinterpret_cast<const float4*>(row + 16 * (t + 4 * (1 - odd)));
    const float4 lo = odd ? y : x, hi = odd ? x : y;
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else if constexpr (CP == 16) {
    const float4 x = *reinterpret_cast<const float4*>(row + 16 * t);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + 8 * t);
    v[0] = x.x, v[1] = x.y;
  }
}

// Shared memory:
//   w_s    [9][kSteps][NT/2][32 lanes] float4: a lane's fp32 B values
//          (b0, b1 of n-tile 2p, b0, b1 of n-tile 2p + 1) for one tap and
//          k8 step, as the wrapper's tf32_tap_weights lays them out
//   rows   [ring][tile * (nz + 2) + kTail][CP] float: a step's staged source
//          columns, row c*(nz + 2) + 1 + z for input z of column c; the z
//          halo rows and the tail stay zero (a column whose tap is not
//          found is read as the tail)
//   full_s, empty_s [ring] mbarriers; found_s [ring] uint32: bit c set
//          where column c's tap is found
//   arow_s [kConsumerWarps][R][16] int: item h of a fragment, c << 16 | the
//          staged row of its input z = zo - 1, c*(nz + 2) + zo (past the
//          tile's items: kNoCol << 16 | the tail)
//   fmask_s [kConsumerWarps][R] uint32: the columns a fragment's items lie
//          in
//
// A warp works all R of its fragments together, k8 step by k8 step, each
// of the three products a pair over every fragment and n-tile before the
// next (R*NT independent accumulators between two mma on one of them); it
// skips a step only when none of its fragments' columns has the tap.
template <int CP, int NT, int R>
__global__ void __launch_bounds__(kThreads, 1)
winfuse_kernel(const float* __restrict__ feats, const int* __restrict__ src,
               const float4* __restrict__ wk, float* __restrict__ out,
               int n_out, int nz, int cout, int tile, int ring) {
  using G = Geo<CP>;
  constexpr int kS = G::kS;
  constexpr int kPitch = G::kPitch;
  constexpr int kPairs = NT / 2;
  extern __shared__ uint4 smem[];
  float4* w_s = reinterpret_cast<float4*>(smem);
  constexpr int w_vecs = kTaps * G::kSteps * kPairs * 32;
  unsigned char* rows = reinterpret_cast<unsigned char*>(w_s + w_vecs);
  const size_t stage = stage_bytes<CP>(tile, nz);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + ring * stage);
  uint32_t* found_s = reinterpret_cast<uint32_t*>(bars + 2 * ring);
  int* arow_s = reinterpret_cast<int*>(found_s + ring);
  uint32_t* fmask_s =
      reinterpret_cast<uint32_t*>(arow_s + kConsumerWarps * R * 16);
  const uint32_t rows_u32 = smem_u32(rows);
  const uint32_t full_u32 = smem_u32(bars);
  const uint32_t empty_u32 = full_u32 + 8 * ring;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_items = tile * nz;
  const int n_tiles = (n_out + tile - 1) / tile;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  // items run column-major, item i = c*nz + zo, fragment f of consumer
  // warp w holding items 16*(w + kConsumerWarps*f) .. + 15
  for (int e = tid; e < kConsumerWarps * R * 16; e += kThreads) {
    const int fr = e / 16, h = e % 16;  // fr = w*R + f
    const int w = fr / R, f = fr % R;
    const int first = 16 * (w + kConsumerWarps * f);
    const int it = first + h;
    arow_s[e] = it < n_items
                    ? (it / nz) << 16 | ((it / nz) * (nz + 2) + it % nz)
                    : kNoCol << 16 | (tile * (nz + 2));
    if (h == 0) {
      uint32_t m = 0;
      if (first < n_items)
        for (int c = first / nz; c <= min(first + 15, n_items - 1) / nz; ++c)
          m |= 1u << c;
      fmask_s[fr] = m;
    }
  }
  for (int e = tid; e < w_vecs; e += kThreads) w_s[e] = __ldg(wk + e);
  // every staged row zero, so every column of every step starts zero
  for (int e = tid; e < ring * static_cast<int>(stage / 16); e += kThreads)
    reinterpret_cast<uint4*>(rows)[e] = make_uint4(0, 0, 0, 0);
  if (tid < ring) {
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
        const int b = s % ring;
        mbar_wait(empty_u32 + 8 * b, ((s / ring) & 1) ^ 1);
        const int from = cur[k];
        const uint32_t base = rows_u32 + b * stage;
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
  const int g = lane / 4, t = lane % 4;
  float acc[R][NT][4];
#pragma unroll
  for (int f = 0; f < R; ++f)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0.f;

  int s = 0;
  for (int lt = 0; lt < my_tiles; ++lt) {
    for (int k = 0; k < kTaps; ++k, ++s) {
      const int b = s % ring;
      mbar_wait(full_u32 + 8 * b, (s / ring) & 1);
      const uint32_t bits = found_s[b];
      bool live = false;
#pragma unroll
      for (int f = 0; f < R; ++f) live |= (bits & fmask_s[warp * R + f]) != 0;
      if (live) {
        const unsigned char* base = rows + b * stage;
        const unsigned char* tail = base + tile * (nz + 2) * kPitch;
        // this lane's rows (items g and g + 8) of each fragment at z tap
        // 0: the item's staged rows, or the zero tail where its column has
        // no found tap
        const unsigned char* row[R][2];
#pragma unroll
        for (int f = 0; f < R; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = arow_s[(warp * R + f) * 16 + g + 8 * h];
            const int c = e >> 16;
            row[f][h] = c < kMaxTile && ((bits >> c) & 1)
                            ? base + (e & 0xffff) * kPitch
                            : tail;
          }
        const float4* wt = w_s + k * G::kSteps * kPairs * 32 + lane;
#pragma unroll
        for (int tz = 0; tz < 3; ++tz) {
          float v[R][2][G::kWords];
#pragma unroll
          for (int f = 0; f < R; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              row_words<CP>(row[f][h] + tz * kPitch, t, g, v[f][h]);
#pragma unroll
          for (int st = 0; st < kS; ++st) {
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              const float4 q = wt[((tz * kS + st) * kPairs + p) * 32];
              split(q.x, bh[2 * p][0], bl[2 * p][0]);
              split(q.y, bh[2 * p][1], bl[2 * p][1]);
              split(q.z, bh[2 * p + 1][0], bl[2 * p + 1][0]);
              split(q.w, bh[2 * p + 1][1], bl[2 * p + 1][1]);
            }
            uint32_t ah[R][4], al[R][4];
#pragma unroll
            for (int f = 0; f < R; ++f) {
              split(v[f][0][st], ah[f][0], al[f][0]);
              split(v[f][1][st], ah[f][1], al[f][1]);
              split(v[f][0][kS + st], ah[f][2], al[f][2]);
              split(v[f][1][kS + st], ah[f][3], al[f][3]);
            }
            // 3xTF32, the small terms first
#pragma unroll
            for (int f = 0; f < R; ++f)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_tf32(acc[f][nt], al[f], bh[nt][0], bh[nt][1]);
#pragma unroll
            for (int f = 0; f < R; ++f)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_tf32(acc[f][nt], ah[f], bl[nt][0], bl[nt][1]);
#pragma unroll
            for (int f = 0; f < R; ++f)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_tf32(acc[f][nt], ah[f], bh[nt][0], bh[nt][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_u32 + 8 * b);
    }
    // the tile's outputs, every item
    const int v0 = (blockIdx.x + lt * gridDim.x) * tile;
#pragma unroll
    for (int f = 0; f < R; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int it = 16 * (warp + kConsumerWarps * f) + g + 8 * h;
        if (it >= n_items || v0 + it / nz >= n_out) continue;
        float* o = out + (static_cast<size_t>(v0) * nz + it) * cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int jj = 8 * nt + 2 * t;
          const float x0 = acc[f][nt][2 * h], x1 = acc[f][nt][2 * h + 1];
          if (jj + 1 < cout && cout % 2 == 0) {
            *reinterpret_cast<float2*>(o + jj) = make_float2(x0, x1);
          } else {
            if (jj < cout) o[jj] = x0;
            if (jj + 1 < cout) o[jj + 1] = x1;
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

// the ring a tile of `tile` columns can have: as many steps as shared
// memory holds, up to kMaxRing (0 if fewer than 2)
template <int CP, int NT>
int ring_steps(int tile, int nz) {
  const int rounds = padded_rounds(
      ((tile * nz + 15) / 16 + kConsumerWarps - 1) / kConsumerWarps);
  int ring = kMaxRing;
  while (ring >= 2 && smem_bytes<CP, NT>(tile, nz, ring, rounds) > kMaxSmem)
    --ring;
  return ring >= 2 ? ring : 0;
}

// columns of a tile: the fewest fragment rounds a column (R / tile, R the
// rounds ceil(frags / 8) rounded up to an instantiation), then a ring of at
// least 3 steps where one fits, then the most columns.  The CPU tests'
// _tile mirrors this choice.
template <int CP, int NT>
int tile_columns(int nz) {
  int best = 0, best_rounds = 0, best_ring = 0;
  for (int tile = 1; tile <= kMaxTile; ++tile) {
    const int frags = (tile * nz + 15) / 16;
    if (frags > kConsumerWarps * max_rounds<NT>()) break;
    const int ring = ring_steps<CP, NT>(tile, nz);
    if (ring == 0) break;
    const int rounds =
        padded_rounds((frags + kConsumerWarps - 1) / kConsumerWarps);
    // a deeper ring (to 3) first, then rounds / tile <= best_rounds / best
    const long lhs = static_cast<long>(rounds) * best;
    const long rhs = static_cast<long>(best_rounds) * tile;
    const bool deeper = (ring >= 3) > (best_ring >= 3);
    const bool shallower = (ring >= 3) < (best_ring >= 3);
    if (best == 0 || deeper || (!shallower && lhs <= rhs)) {
      best = tile;
      best_rounds = rounds;
      best_ring = ring;
    }
  }
  return best;
}

template <int CP, int NT, int R>
cudaError_t run(const float* feats, const int* src, const float4* wk,
                float* out, int n_out, int nz, int cout, int tile, int sms,
                cudaStream_t stream) {
  const int ring = ring_steps<CP, NT>(tile, nz);
  const size_t smem = smem_bytes<CP, NT>(tile, nz, ring, R);
  cudaError_t err = cudaFuncSetAttribute(
      winfuse_kernel<CP, NT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, winfuse_kernel<CP, NT, R>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n_out + tile - 1) / tile;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  winfuse_kernel<CP, NT, R><<<blocks, kThreads, smem, stream>>>(
      feats, src, wk, out, n_out, nz, cout, tile, ring);
  return cudaGetLastError();
}

template <int CP, int NT>
cudaError_t launch(const float* feats, const int* src, const float4* wk,
                   float* out, int n_out, int nz, int cout, int sms,
                   cudaStream_t stream) {
  const int tile = tile_columns<CP, NT>(nz);
  if (tile < 1) return cudaErrorInvalidValue;
  const int rounds = padded_rounds(
      ((tile * nz + 15) / 16 + kConsumerWarps - 1) / kConsumerWarps);
  switch (rounds) {
    case 1:
      return run<CP, NT, 1>(feats, src, wk, out, n_out, nz, cout, tile, sms,
                            stream);
    case 2:
      return run<CP, NT, 2>(feats, src, wk, out, n_out, nz, cout, tile, sms,
                            stream);
    case 3:
      return run<CP, NT, 3>(feats, src, wk, out, n_out, nz, cout, tile, sms,
                            stream);
    default:
      if constexpr (max_rounds<NT>() >= 6)
        return run<CP, NT, 6>(feats, src, wk, out, n_out, nz, cout, tile,
                              sms, stream);
      return cudaErrorInvalidValue;
  }
}

template <int CP>
cudaError_t by_cout(const float* feats, const int* src, const float4* wk,
                    float* out, int n_out, int nz, int cout, int sms,
                    cudaStream_t stream) {
  if (cout <= 16)
    return launch<CP, 2>(feats, src, wk, out, n_out, nz, cout, sms, stream);
  return launch<CP, 4>(feats, src, wk, out, n_out, nz, cout, sms, stream);
}

}  // namespace tf32
