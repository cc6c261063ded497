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

// ------------------------------------------- the wgmma bodies' split pass
//
// The wgmma bodies (hd 32 and 64) split each streamed f32 tile once, in
// shared memory, by the producer warpgroup's three splitter warps: TMA lands
// the tile raw where its big part goes, and the pass rounds it in place and
// writes the remainder at the same offset of its small part (the two parts
// share one layout).  A tile that a product reads transposed (MN-major as
// stored, and .tf32 has no transpose) gets a copy, big and small, its rows
// as columns: the copy's column 8 j + m holds row 8 j + sigma8(m), sigma8(m)
// = 2 m for m < 4 and 2 m - 7 above (rows 0, 2, 4, 6, 1, 3, 5, 7), so a
// score accumulator taken as it stands (its columns 2c and 2c + 1 in lane c
// of a quad are the TF32 A fragment's c and c + 4) contracts with it
// exactly: no shuffle between lanes, no other tile permuted.

constexpr int kSplitThreads = 96;  // the producer warpgroup's warps 1-3

// Registers a producer thread keeps after the hand-over (the splitters'
// 4 x 4 blocks: 40 spilled); the two consumer warpgroups take the rest, 224
// (hopper_wgmma.cuh).
constexpr int kTf32Producer = 56;

__device__ __forceinline__ float tf32_big(float x) {  // split_tf32's big part, as a float
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ float4 split4(float4 x, float4& small) {
  const float4 b = make_float4(tf32_big(x.x), tf32_big(x.y), tf32_big(x.z), tf32_big(x.w));
  small = make_float4(x.x - b.x, x.y - b.y, x.z - b.z, x.w - b.w);
  return b;
}

// `bytes` of f32 at `raw` rounded into `big` (in place where raw == big),
// the remainders into `small`, at the same offsets; splitter t of
// kSplitThreads.
__device__ __forceinline__ void split_copy(const uint8_t* raw, uint8_t* big, uint8_t* small,
                                           int bytes, int t) {
  for (int i = 16 * t; i < bytes; i += 16 * kSplitThreads) {
    float4 s;
    const float4 b = split4(*reinterpret_cast<const float4*>(raw + i), s);
    *reinterpret_cast<float4*>(big + i) = b;
    *reinterpret_cast<float4*>(small + i) = s;
  }
}

// The transposed copy of a 32-row tile of HD columns (src, 128-byte swizzle)
// into an HD-row tile of 32 columns permuted by sigma8 (dst, one 128-byte
// atom), a block of 4 x 4 a thread at a time.  The eight threads of each
// quarter warp (one 16-byte access each) take dst columns 4 b4, b4 = 0..7,
// and src columns 4 m with m's low bits f(b4) ^ u, f(b4) = b4 / 2 + 4 (b4 %
// 2): both their reads and their writes then fall in eight distinct 16-byte
// bank groups under the swizzle (blocks taken in rows of dst columns put
// eight threads on two, and the split pass waited on the conflicts).
template <int HD>
__device__ __forceinline__ void transpose32(const uint8_t* src, uint8_t* dst, int t) {
  for (int blk = t; blk < 8 * (HD / 4); blk += kSplitThreads) {
    const int u = blk >> 3;
    const int b4 = blk & 7;  // dst columns 4 b4 .. 4 b4 + 3
    const int d0 = 4 * ((((b4 >> 1) + 4 * (b4 & 1)) ^ (u & 7)) + 8 * (u >> 3));  // dst rows
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 8 * (b4 >> 1) + 2 * i + (b4 & 1);
      x[i] = *reinterpret_cast<const float4*>(src + hopper::f32_at<128>(32, row, d0));
    }
    const int c = 4 * b4;
    *reinterpret_cast<float4*>(dst + hopper::f32_at<128>(HD, d0, c)) =
        make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
    *reinterpret_cast<float4*>(dst + hopper::f32_at<128>(HD, d0 + 1, c)) =
        make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
    *reinterpret_cast<float4*>(dst + hopper::f32_at<128>(HD, d0 + 2, c)) =
        make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
    *reinterpret_cast<float4*>(dst + hopper::f32_at<128>(HD, d0 + 3, c)) =
        make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
  }
}

// Each of `n` values as its TF32 big and small parts (split_tf32).
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// A score accumulator's n-tile kk as the TF32 A fragment of k-step kk of the
// product that contracts over its columns with a sigma8-permuted copy, split.
template <int K>
__device__ __forceinline__ void acc_frag_tf32(const float (&d)[K], int kk, uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  const float a[4] = {d[4 * kk + 0], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]};
  split_frag(a, big, small);
}

// The key tiles [kt0, kt1) of the block's range blockIdx.z of gridDim.z: its
// n visible tiles cut into runs of ceil(n / ranges), so the last ranges may
// be shorter or empty (an empty one stores zero partials).
__device__ __forceinline__ void key_range(int n, int& kt0, int& kt1) {
  const int per = (n + static_cast<int>(gridDim.z) - 1) / static_cast<int>(gridDim.z);
  kt0 = min(n, static_cast<int>(blockIdx.z) * per);
  kt1 = min(n, kt0 + per);
}
