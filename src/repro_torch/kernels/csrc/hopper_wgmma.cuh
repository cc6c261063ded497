// Hopper's own route for the flash-attention bodies on wgmma
// (csrc/flash_attention.cu's forward, csrc/flash_attention_bwd.cu's dK/dV and
// dQ; bf16, and f32 in 3xTF32 at hd 32 and 64): warpgroup products (wgmma)
// on tiles that the Tensor Memory Accelerator (TMA) copies into shared
// memory under mbarriers, with a producer warp or warpgroup and consumer
// warpgroups.
// Included at file scope by both sources; the build hashes it with every
// source (kernels/build.py).
//
// What is here:
//   * desc, desc_k, desc_mn: the wgmma shared-memory matrix descriptor for
//     tiles that TMA laid out with a 128-byte (64 bf16 columns an atom) or
//     64-byte (32 columns) swizzle (Atoms<HD>).  A tile of R rows x HD
//     columns is stored as HD / kCols atoms of R rows x kCols columns, each
//     atom's rows kRowBytes apart and the atom 1024-byte aligned, which is
//     where TMA puts a box of (kCols, R).
//     K-major (the contracted dimension contiguous: Q, K of q k^T) advances 32
//     bytes a 16-column k-step inside an atom; MN-major (the operand's N
//     contiguous: V of P V, dO and q of dV and dK, K of dQ) advances 16 rows
//     a k-step and steps across atoms by the leading byte offset;
//   * wgmma.fence / commit_group / wait_group, and Mma<N, kTransB>:
//     m64nNk16 bf16 x bf16 -> f32 with A from shared memory (ss) or from
//     registers (rs), N = 32, 64, 128 or 160, B transposed (MN-major) when
//     kTransB;
//   * for the f32 bodies, MmaTf32<N>: m64nNk8 TF32 x TF32 -> f32, ss and
//     rs, N = 32 or 64, both shared-memory operands K-major, on f32 tiles
//     under a 128- or 64-byte swizzle (f32_at, f32_desc; map_rows_f32);
//   * mbarrier init, arrive, expect_tx and a try_wait loop on a phase parity;
//   * named barriers, and setmaxnreg's register hand-over (below);
//   * cp.async.bulk.tensor loads (4-D, 5-D) completing on an mbarrier;
//   * on the host, encode_tiled: cuTensorMapEncodeTiled, fetched from the
//     driver through the runtime's entry-point query so that no library
//     beyond the runtime is linked; a map that does not encode returns
//     kTmaEncodeError and leaves its reason in tma_error().  Encoded maps
//     are kept in a per-thread table keyed on every argument of the encode
//     (kCacheMaps), so a call on tensors already seen skips the driver.
//
// Register hand-over (setmaxnreg): a block of one producer warpgroup and
// two consumer warpgroups (384 threads) is compiled to 168 registers a
// thread, the most 384 threads can hold (65,536 / 384, rounded down to 8).
// The producer warpgroup lowers itself to p registers and the consumers
// raise themselves to c (HandOver<p>), 128 p + 256 c = 384 * 168, so the
// registers the producer gives back are the ones the consumers take (24 /
// 240, or 40 / 232 where a producer needs more, hd 32's dK/dV, or 56 / 224
// in the f32 bodies, whose producer splits tiles).  All
// four warps of a warpgroup run the instruction, and the roles split in one
// if/else whose paths never meet again (mbarrier init and __syncthreads()
// come before it): otherwise ptxas ignores it (warning C7508) and compiles
// every thread within the launch's 168.  A producer warp is not enough: at
// 288 threads its decrease frees 4,608 registers where the consumers'
// increase asks 18,432, so the increase waits forever.  launch_regs_ok()
// checks on the host, once a kernel, that ptxas compiled the kernel to the
// registers the hand-over counts on, so a build that did not cannot hang
// the card.  So built, ptxas honours it: the 384-thread bodies report 168
// registers, no C7508 and no spill with 128-key tiles at hd 128 and 160
// (scripts/ptxas_report.py), which 168 registers could not hold.
//
// Accumulator layout of m64nNk16 (PTX ISA, "wgmma register fragments"):
// thread t of the warpgroup, warp w = t / 32, lane = 4 g + c, holds rows
// 16 w + g and 16 w + g + 8; d[4 j + e] is row 16 w + g + 8 (e >> 1), column
// 8 j + 2 c + (e & 1).  An A fragment from registers (rs) is the m16n8k16
// A fragment of the warp's 16 rows: a[0] row g, columns 2c, 2c + 1; a[1] row
// g + 8; a[2] row g, columns 2c + 8, 2c + 9; a[3] row g + 8, those columns.
// So the accumulator's n-tiles 2kk and 2kk + 1, packed in pairs, are A of
// k-step kk (acc_as_a).

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <memory>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- descriptors

// A tile's geometry in shared memory, by head dim: 64-column atoms under the
// 128-byte swizzle where HD is a multiple of 64, else 32-column atoms under
// the 64-byte one (hd 32 and 160).
template <int HD>
struct Atoms {
  static constexpr int kCols = HD % 64 == 0 ? 64 : 32;
  static constexpr int kCount = HD / kCols;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr uint64_t kLayout = kCols == 64 ? 1 : 2;  // descriptor: 1 = 128B, 2 = 64B
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
};

// The 64-bit matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// k-step kk (columns 16 kk ..) of a K-major tile of `rows` rows at `base`:
// the k-step's atom, 32 bytes a k-step inside it; 8-row groups 8 rows apart.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int kk) {
  using A = Atoms<HD>;
  const int col = 16 * kk;
  return desc(base + (col / A::kCols) * rows * A::kRowBytes + (col % A::kCols) * 2, 16,
              8 * A::kRowBytes, A::kLayout);
}

// k-step kk (rows 16 kk ..) of an MN-major tile of `rows` rows at `base`
// whose N is the tile's HD columns: atoms along N `rows` rows apart (the
// leading byte offset), 8-row groups along K 8 rows apart (the stride one).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kk) {
  using A = Atoms<HD>;
  return desc(base + 16 * kk * A::kRowBytes, rows * A::kRowBytes, 8 * A::kRowBytes, A::kLayout);
}

// Byte offset of (row r, column c) in a tile of `rows` rows as TMA lays it
// out: the atom, the row, the swizzled 16-byte chunk (its bits 4.. XOR the
// row bits 7.. of the offset; the tile is 1024-byte aligned).
template <int HD>
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  using A = Atoms<HD>;
  const uint32_t off = (c / A::kCols) * rows * A::kRowBytes + r * A::kRowBytes + (c % A::kCols) * 2;
  constexpr uint32_t mask = A::kCols == 64 ? 7 : 3;
  return off ^ (((off >> 7) & mask) << 4);
}

// --------------------------------------------------------------- wgmma

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that own it.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void zero(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) d[i] = 0.f;
}

// 2^x on the special-function unit, subnormal results flushed to zero (the
// softmax's weights below 2^-126 of the row's largest are 0 in f32 anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The accumulator's n-tiles 2kk, 2kk + 1 as the A fragment of k-step kk.
template <int K>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&d)[K], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (64 x N, f32) = or += A (64 x 16) B (16 x N), bf16: `acc` 0 overwrites.
template <int N, int kTransB>
struct Mma;

template <int kTransB>
struct Mma<32, kTransB> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  }
};

template <int kTransB>
struct Mma<64, kTransB> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  }
};

template <int kTransB>
struct Mma<128, kTransB> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  }
};

template <int kTransB>
struct Mma<160, kTransB> {
  static __device__ __forceinline__ void ss(float (&d)[80], uint64_t a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, 0, %83;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79])
        : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
  }
  static __device__ __forceinline__ void rs(float (&d)[80], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
  }
};

// ----------------------------------------------------- wgmma in TF32 (f32)
//
// The f32 bodies' products: m64nNk8 TF32 x TF32 -> f32, the operands f32
// containers of which the tensor core reads the top 19 bits.  The ISA has no
// transpose for .tf32, so both shared-memory operands are K-major (the
// contracted index contiguous): an operand that is MN-major as stored (V of
// P V, dO and q of dV and dK, K of dQ) is read from a transposed copy.
// Tiles are f32 rows of kSwz bytes an atom (128: 32 columns; 64: 16), atoms
// along the columns `rows` rows apart, each 1024- (512-) byte aligned --
// where TMA puts a box of (atom columns, rows) under that swizzle.  A k-step
// is 8 columns, 32 bytes, as bf16's 16.  The accumulator layout is bf16's
// (above); an A fragment from registers (rs) is the m16n8k8 TF32 one of the
// warp's 16 rows: a[0] row g, column c; a[1] row g + 8, column c; a[2] row
// g, column c + 4; a[3] row g + 8, column c + 4.

template <int kSwz>
struct F32Atoms {
  static_assert(kSwz == 128 || kSwz == 64, "128- or 64-byte swizzle");
  static constexpr int kCols = kSwz / 4;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : 2;
  static constexpr uint32_t kMask = kSwz == 128 ? 7 : 3;
};

// Byte offset of (row r, column c) of an f32 tile of `rows` rows (a multiple
// of 8) under the kSwz-byte swizzle.
template <int kSwz>
__device__ __forceinline__ uint32_t f32_at(int rows, int r, int c) {
  using A = F32Atoms<kSwz>;
  const uint32_t off = (c / A::kCols) * rows * kSwz + r * kSwz + (c % A::kCols) * 4;
  return off ^ (((off >> 7) & A::kMask) << 4);
}

// k-step kk (columns 8 kk ..) of a K-major f32 tile of `rows` rows at `base`.
template <int kSwz>
__device__ __forceinline__ uint64_t f32_desc(uint32_t base, int rows, int kk) {
  using A = F32Atoms<kSwz>;
  const int col = 8 * kk;
  return desc(base + (col / A::kCols) * rows * kSwz + (col % A::kCols) * 4, 16, 8 * kSwz,
              A::kLayout);
}

// d (64 x N, f32) = or += A (64 x 8) B (8 x N), TF32: `acc` 0 overwrites.
template <int N>
struct MmaTf32;

template <>
struct MmaTf32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct MmaTf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  A wait that lasts
// kWaitLimitNs (a broken protocol: no tile takes a second) traps, so the
// launch fails with an error instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 10000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kWaitLimitNs) {
      __trap();
    }
  }
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a warpgroup's) on hardware barrier `id` (> 0).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Arrives at barrier `id` of `threads` threads without waiting for it.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ setmaxnreg

// A block of one producer warpgroup and two consumer warpgroups: registers
// a thread at launch, and after the hand-over, kProducer a producer thread
// and what that frees for a consumer thread (p + 2 c = 3 kLaunchRegs).
constexpr int kHandOverThreads = 384;
constexpr int kLaunchRegs = 168;

template <int kProducerRegs>
struct HandOver {
  static constexpr int kProducer = kProducerRegs;
  static constexpr int kConsumer = (3 * kLaunchRegs - kProducer) / 2;
  static_assert(kProducer % 8 == 0 && kConsumer % 8 == 0 && kConsumer <= 256 &&
                    kProducer + 2 * kConsumer == 3 * kLaunchRegs,
                "the consumers take exactly what the producer gives back");
  // Every thread of the calling warpgroup, outside any branch that splits it.
  static __device__ __forceinline__ void producer() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducer));
  }
  static __device__ __forceinline__ void consumer() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumer));
  }
};

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// A pointer into dynamic shared memory rounded up to 1024 bytes (the 128-byte
// swizzle's period), and an offset from it.
__device__ __forceinline__ uint8_t* align1024(void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<uint8_t*>((a + 1023) & ~static_cast<uintptr_t>(1023));
}

// ----------------------------------------------------------------- host

// The launch's error code for a tensor map that did not encode (outside
// cudaError_t's range); tma_error() holds the reason.
constexpr int kTmaEncodeError = 100000;

inline char* tma_error() {
  static char msg[512] = "";
  return msg;
}

// The launch's error code for a hand-over kernel that ptxas compiled to
// fewer registers than kLaunchRegs (its consumers' increase would wait
// forever); tma_error() holds the count.
constexpr int kHandOverError = 100001;

// Whether `kernel` (a hand-over block) was compiled to kLaunchRegs registers
// a thread, asked of the runtime once (`cache`: the caller's, -1 at first).
// 0 or kHandOverError.
inline int launch_regs_ok(const void* kernel, const char* what, int* cache) {
  if (*cache < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *cache = attr.numRegs >= kLaunchRegs ? 0 : kHandOverError;
    if (*cache != 0) {
      snprintf(tma_error(), 512, "%s: compiled to %d registers a thread, below the %d that "
               "setmaxnreg's hand-over counts on", what, attr.numRegs, kLaunchRegs);
    }
  }
  return *cache;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The maps this thread encoded, direct-mapped on a hash of every argument
// of the encode but the name.  A map is a function of those arguments alone
// (an address and a geometry, no context), so a hit is the map the driver
// would make again; PyTorch's caching allocator hands the same addresses to
// the same shapes step after step.
constexpr bool kCacheMaps = true;
constexpr int kMapSlots = 2048;  // 480 KB a thread that launches a bf16 body
constexpr int kMapKeyWords = 14;  // base, kind, dims[5], strides[4], box[5] in pairs

struct MapSlot {
  uint64_t key[kMapKeyWords];
  uint64_t map[sizeof(CUtensorMap) / sizeof(uint64_t)];
};

inline MapSlot* map_slot(const uint64_t* key) {
  thread_local std::unique_ptr<MapSlot[]> slots;
  if (!slots) slots.reset(new MapSlot[kMapSlots]());  // zero keys: base 0 matches nothing
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < kMapKeyWords; ++i) h = (h ^ key[i]) * 1099511628211ull;
  return &slots[(h ^ (h >> 29)) % kMapSlots];
}

// A tiled map over `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..rank-1), no interleave, zero fill past the edges.  Returns 0
// or kTmaEncodeError with the reason in tma_error().
inline int encode_tiled(CUtensorMap* map, const char* what, CUtensorMapDataType dtype, int rank,
                        const void* base, const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box, CUtensorMapSwizzle swizzle) {
  uint64_t key[kMapKeyWords] = {};
  key[0] = reinterpret_cast<uintptr_t>(base);
  key[1] = static_cast<uint64_t>(dtype) | static_cast<uint64_t>(rank) << 16 |
           static_cast<uint64_t>(swizzle) << 32;
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    if (i + 1 < rank) key[7 + i] = strides[i];
    key[11 + i / 2] |= static_cast<uint64_t>(box[i]) << (32 * (i % 2));
  }
  MapSlot* slot = kCacheMaps && base != nullptr ? map_slot(key) : nullptr;
  if (slot != nullptr && memcmp(slot->key, key, sizeof key) == 0) {
    memcpy(map, slot->map, sizeof(CUtensorMap));
    return 0;
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) {
    snprintf(tma_error(), 512, "TMA descriptor for %s: cuTensorMapEncodeTiled is not available "
             "from the driver", what);
    return kTmaEncodeError;
  }
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                        reinterpret_cast<const cuuint64_t*>(dims),
                        reinterpret_cast<const cuuint64_t*>(strides),
                        reinterpret_cast<const cuuint32_t*>(box), ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    int n = snprintf(tma_error(), 512,
                     "TMA descriptor for %s did not encode (CUresult %d): base %p (TMA needs "
                     "16-byte alignment), dims", what, static_cast<int>(r), base);
    for (int i = 0; i < rank && n < 480; ++i) {
      n += snprintf(tma_error() + n, 512 - n, " %llu", static_cast<unsigned long long>(dims[i]));
    }
    n += snprintf(tma_error() + n, 512 - n, ", byte strides (multiples of 16)");
    for (int i = 0; i + 1 < rank && n < 480; ++i) {
      n += snprintf(tma_error() + n, 512 - n, " %llu", static_cast<unsigned long long>(strides[i]));
    }
    return kTmaEncodeError;
  }
  if (slot != nullptr) {
    memcpy(slot->key, key, sizeof key);
    memcpy(slot->map, map, sizeof(CUtensorMap));
  }
  return 0;
}

// A bf16 (B, S, heads, hd) tensor as TMA sees it.  Folded rows: 5-D (hd, G,
// Hk, S, B), box (atom columns, G, 1, P, 1) -- P positions of all G heads of
// one KV head, P * G <= 64 rows; the rows past P * G of a 64-row tile are
// padding that no box fills or stores.  Rows of one head: 4-D (hd, heads, S,
// B), box (atom columns, 1, rows, 1).
template <int HD>
inline int map_folded(CUtensorMap* map, const char* what, const void* base, int B, int S, int Hk,
                      int G, int P) {
  const uint64_t dims[5] = {HD, static_cast<uint64_t>(G), static_cast<uint64_t>(Hk),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t strides[4] = {HD * e, static_cast<uint64_t>(G) * HD * e,
                               static_cast<uint64_t>(Hk) * G * HD * e,
                               static_cast<uint64_t>(S) * Hk * G * HD * e};
  const uint32_t box[5] = {static_cast<uint32_t>(Atoms<HD>::kCols), static_cast<uint32_t>(G), 1,
                           static_cast<uint32_t>(P), 1};
  return encode_tiled(map, what, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box,
                      Atoms<HD>::kCols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int HD>
inline int map_rows(CUtensorMap* map, const char* what, const void* base, int B, int S, int heads,
                    int rows) {
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(heads), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t e = 2;
  const uint64_t strides[3] = {HD * e, static_cast<uint64_t>(heads) * HD * e,
                               static_cast<uint64_t>(S) * heads * HD * e};
  const uint32_t box[4] = {static_cast<uint32_t>(Atoms<HD>::kCols), 1,
                           static_cast<uint32_t>(rows), 1};
  return encode_tiled(map, what, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                      Atoms<HD>::kCols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

// An f32 (B, S, heads, HD) tensor as the TF32 bodies' TMA sees it: rows of
// one head, 4-D (HD, heads, S, B), box (32 columns, 1, rows, 1) under the
// 128-byte swizzle (f32_at<128>).
template <int HD>
inline int map_rows_f32(CUtensorMap* map, const char* what, const void* base, int B, int S,
                        int heads, int rows) {
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(heads), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t e = 4;
  const uint64_t strides[3] = {HD * e, static_cast<uint64_t>(heads) * HD * e,
                               static_cast<uint64_t>(S) * heads * HD * e};
  const uint32_t box[4] = {32, 1, static_cast<uint32_t>(rows), 1};
  return encode_tiled(map, what, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// Positions of a folded 64-row tile: the most whole positions of G heads.
inline int folded_positions(int G) { return 64 / G; }

}  // namespace hopper
