// The rows' activity masks that the wide forward kernels read (csrc/
// winfuse.cu's namespace wide, bf16; csrc/winfuse_wide_tf32.cuh, fp32): a
// uint32 a source row, bit z set where z row z holds a value that is not
// +-0, computed by a first kernel; past kMaxMaskZ z no mask is kept and
// every z of a found row counts.  Included inside the anonymous namespace
// of csrc/winfuse.cu and csrc/winfuse_fp32.cu.
namespace rowmask {

constexpr int kMaxMaskZ = 32;  // z of the rows' activity masks

// whether z row z (>= 0) of a tap's source row is staged and read, for
// the row's mask m: 0 where the tap is not taken, all ones where no masks
// are kept (nz past kMaxMaskZ), and then any of its bits stands for every
// z (the shift wraps at kMaxMaskZ = 32, the mask's width)
__device__ __forceinline__ bool row_live(uint32_t m, int z) {
  return (m >> (z & (kMaxMaskZ - 1))) & 1u;
}

// masks[row] of rows (R, nz*cp) of T (bf16 or fp32): bit z where z row z
// has a value that is not +-0 (nz <= kMaxMaskZ)
template <typename T>
__global__ void __launch_bounds__(256)
row_masks(const T* __restrict__ rows, uint32_t* __restrict__ masks,
          int n_rows, int nz, int cp) {
  // every value's magnitude bits of a 32-bit word
  constexpr uint32_t kMagnitude = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a uint4
  const int row = blockIdx.x * 256 + threadIdx.x;
  if (row >= n_rows) return;
  const int pieces = cp / kPer;  // of a z row
  const uint4* p = reinterpret_cast<const uint4*>(rows) +
                   static_cast<size_t>(row) * nz * pieces;
  uint32_t m = 0;
  for (int z = 0; z < nz; ++z) {
    uint32_t any = 0;
    for (int q = 0; q < pieces; ++q) {
      const uint4 x = __ldg(p + z * pieces + q);
      any |= x.x | x.y | x.z | x.w;
    }
    m |= ((any & kMagnitude) != 0u) << z;
  }
  masks[row] = m;
}

// row_masks on the stream, where nz <= kMaxMaskZ
template <typename T>
cudaError_t launch_row_masks(const T* rows, uint32_t* masks, int n_rows,
                             int nz, int cp, cudaStream_t stream) {
  if (nz > kMaxMaskZ || n_rows == 0) return cudaSuccess;
  row_masks<T><<<(n_rows + 255) / 256, 256, 0, stream>>>(rows, masks, n_rows,
                                                         nz, cp);
  return cudaGetLastError();
}

}  // namespace rowmask
