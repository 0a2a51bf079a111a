// 3xTF32 on mma.sync: an fp32 product on the tensor cores whose error is of
// fp32's order.  Each fp32 value x splits into hi = cvt.rna.tf32(x) (x
// rounded to 11 significant bits, ties away from zero) and lo =
// cvt.rna.tf32(x - hi), the next 11; a product runs as lo_a*hi_b +
// hi_a*lo_b + hi_a*hi_b into fp32 accumulators, so the dropped lo_a*lo_b
// and lo's own rounding leave it within ~2^-21 of the fp32 product.
// Shared by csrc/winfuse_tf32.cuh and csrc/winfuse_wgrad_tf32.cuh; included
// inside their anonymous namespaces.
namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace tf32
