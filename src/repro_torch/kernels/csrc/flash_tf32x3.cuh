// What the two flash-attention sources (csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu) share for their f32 bodies: the 3xTF32
// products on mma.sync, the f32 tile layout in shared memory, and the key
// ranges of a split walk.  Included inside each source's anonymous
// namespace; the build hashes it with every source (kernels/build.py).
//
// Fragment layouts (PTX ISA, mma.m16n8k8 TF32): lane = 4 * g + t.  A holds
// rows g and g + 8, columns t and t + 4; B holds column g, rows t and t + 4;
// the accumulator holds rows g and g + 8, columns 2t and 2t + 1.

// An f32 operand as a TF32 big part (x rounded to 10 mantissa bits, ties away
// from zero) and the exact remainder, which the tensor core reads as TF32 by
// ignoring its low 13 bits: |x - big - small| < 2^-21 |x|, in three integer
// and float instructions.  (csrc/rwkv_scan.cu's split, as there.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {  // m16n8k8 A: rows g, g + 8; columns t, t + 4
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit FragA(const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
  }
};

struct FragB {  // m16n8k8 B: column g; rows t, t + 4
  uint32_t big[2], small[2];
  __device__ __forceinline__ FragB(float x0, float x1) {
    split_tf32(x0, big[0], small[0]);
    split_tf32(x1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 into one accumulator: the two cross terms, then
// big * big; small * small dropped.  (The WKV kernel's mma3 keeps the cross
// terms in a second accumulator; here the independent n-tiles of a tile give
// the tensor cores enough chains, and a second accumulator would not fit.)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// f32 tiles of 64 rows x HD (HD a multiple of 32), no padding: column c of
// row r lies at r * HD + (c ^ swz(r)).  The swizzle flips bits 2-4 of the
// column, so a 16-byte chunk stays whole, and both ways the fragments read a
// tile hit 32 distinct banks: rows of 8 distinct r & 7 at columns c0 + t (an
// A fragment, or the B fragment of X^T for X stored [n][k]), and rows r0 + t
// (+ 4) at columns c0 + g (the B fragment of X stored [k][n]).  No padding
// serves both: the first wants a row stride of 4 mod 8 banks, the second 8
// or 24 mod 32.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (((r >> 2) & 1) << 2); }

template <int HD>
__device__ __forceinline__ int at(int r, int c) {
  return r * HD + (c ^ swz(r));
}

// The row of an operand tile that column n of a score n-tile holds: column
// 2t row t, column 2t + 1 row t + 4.  Loading the score product's B fragment
// so makes its accumulator the A fragment, as it stands, of the product that
// contracts over those rows (keys): no shuffle between lanes.
__device__ __forceinline__ int perm8(int n) { return (n >> 1) + ((n & 1) << 2); }

// The key tiles [kt0, kt1) of the block's range blockIdx.z of gridDim.z: its
// n visible tiles cut into runs of ceil(n / ranges), so the last ranges may
// be shorter or empty (an empty one stores zero partials).
__device__ __forceinline__ void key_range(int n, int& kt0, int& kt1) {
  const int per = (n + static_cast<int>(gridDim.z) - 1) / static_cast<int>(gridDim.z);
  kt0 = min(n, static_cast<int>(blockIdx.z) * per);
  kt1 = min(n, kt0 + per);
}
