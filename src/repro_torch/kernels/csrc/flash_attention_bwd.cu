// Backward of the GQA flash attention (csrc/flash_attention.cu) for Hopper,
// sm_90a.
//
// The JAX package has no backward kernel: its trainer differentiates the
// chunked attention scan (src/repro/models/attention.py::chunked_attention)
// with XLA's autodiff, and its Pallas kernel
// (src/repro/kernels/flash_attention.py::flash_attention) is forward only.
// The port sends every attention call on the card to the forward kernel, so
// training on the card needs this gradient.  Given q (B, S, H, hd), k and v
// (B, Sk, Hk, hd), the forward's output o, the output's gradient dO and the
// rows' log-sum-exp lse (f32, (B, H, S), from the forward), it computes
//
//     P  = exp(q k^T * scale - lse)        (the forward's softmax, recomputed)
//     D  = rowsum(dO o)                    (f32)
//     dS = P (dO v^T - D)
//     dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO
//
// with the forward's conventions: G = H / Hk query heads share a KV head and
// are folded into the rows, (position, group member) side by side; with
// `causal` a query at position s sees the keys at positions <= s, both
// counted from 0, also when S != Sk; keys past Sk and rows past S * G get no
// weight.  f32 or bf16 in, f32 math throughout, the gradients in the input
// dtype: dk and dv sum over the G heads of their KV head in f32 and are cast
// once, as autograd through the plain version's f32 casts does.
//
// The FlashAttention-2 split, four launches, no atomics, deterministic:
//   1. flash_bwd_dot_kernel: D, one warp a row;
//   2. flash_bwd_dkdv_*kernel: one block per (key tile, batch, query head)
//      walks the 64-position tiles of that head's queries that can see its
//      keys (causal: from the tile holding position k0 on), recomputes P and
//      dS for each and accumulates the head's share of dk and dv in
//      registers, stored in f32 (one block a query head rather than a KV
//      head: G times the blocks, each walking 1/G of the rows, so a
//      training-shape call fills the SMs);
//   3. flash_bwd_dq_*kernel: one block per (64-row tile of folded rows,
//      batch, KV head, key range) walks the key tiles of its range up to its
//      causal limit and accumulates dq.  The wrapper picks the number of
//      ranges (flash_attention.py::dq_splits): 1 where the row tiles fill the
//      card, and the block then writes dq itself; more where a short query
//      sequence leaves SMs idle (whisper's 64 decoder positions against 1500
//      frames), and each block then writes an f32 partial dq;
//   4. flash_bwd_reduce_kernel: dk and dv, each the sum of its KV head's G
//      shares in head order, and dq, the sum of its partials in range order
//      when split, all in f32, scaled and cast once.
// The dK/dV and dQ kernels each recompute q k^T and dO v^T for their tiles,
// so together they do seven tile products where a fused kernel with atomics
// would do five.
//
// What bounds it.  At the training shapes (2 x 512 tokens, 32/4 heads, hd
// 64; 1 x 512, 32/8 heads, hd 128; causal) the five products the gradient
// needs are ~5.4 GFLOP: in bf16 the bytes moved (5.7-6.3 us at 3.35 TB/s)
// and the operations (~5.5 us at 989 TFLOP/s) about equal, bytes by a
// little; in f32 the operations (~33 us at 3xTF32's 495 / 3 TFLOP/s).  Four
// bodies for the dK/dV and dQ kernels, picked at compile time by dtype and
// head dim, all on the tensor cores:
//   * bf16 at hd 32 and 64: mma.sync bf16 tensor-core products, 4 warps, each
//     holding its 16 keys' (rows') operands as fragments in registers;
//     described above flash_bwd_dkdv_mma_kernel below;
//   * bf16 at hd 128 and 160: the same products with 8 warps, a pair of warps
//     sharing 16 keys (rows) and splitting the score products by rows (keys)
//     and the accumulators by columns, P^T and dS^T (dS) passed through
//     shared memory, the streamed tile double-buffered; described above
//     flash_bwd_dkdv_wide_mma_kernel below.  Registers bound its design: the
//     4-warp body would hold ~256 a thread at hd 128;
//   * f32 at hd 32 and 64, and at hd 128 and 160: the same two warp layouts
//     (4 warps; 8 warps in pairs) on mma.sync TF32 in 3xTF32, f32 tiles
//     swizzled in shared memory, the score accumulators permuted so they are
//     the A fragments of the accumulating products as they stand; described
//     above dkdv_tf32x3 below.  (Whisper's encoder and cross-attention train
//     in f32: JAX promotes their f32 frames.)

// Plain C interface, built by nvcc into a shared library and called through
// ctypes from repro_torch/kernels/flash_attention.py.  The launch enqueues on
// the caller's stream, does not synchronise and allocates nothing (D's, the
// f32 shares' and dq's partials' buffers come from the wrapper); it returns
// cudaGetLastError() and reports the body and the dQ key ranges it launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "flash_tf32x3.cuh"

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// The rows of one block: F query heads h0 .. h0 + F - 1 folded side by side,
// row = position * F + (head - h0).  The dq kernel folds a KV head's G heads
// (F = G); the dk/dv kernel takes one head (F = 1).
struct Rows {
  int S, H, F, h0, b;
  int64_t total;  // S * F
  __device__ __forceinline__ int64_t pos(int64_t row) const { return row / F; }
  // Element offset of row `row`'s head vector in a (B, S, H, hd) tensor.
  __device__ __forceinline__ int64_t offset(int64_t row, int hd) const {
    return ((static_cast<int64_t>(b) * S + row / F) * H + h0 + row % F) * hd;
  }
  // Index of row `row` in a (B, H, S) per-row buffer (lse, D).
  __device__ __forceinline__ int64_t stat(int64_t row) const {
    return (static_cast<int64_t>(b) * H + h0 + row % F) * S + row / F;
  }
};

// D[b, h, s] = sum_d dO[b, s, h, d] * o[b, s, h, d], one warp a (b, s, h) row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ D, int64_t n_rows, int S, int H, int hd) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const T* orow = o + r * hd;
  const T* drow = dout + r * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % H);
    const int64_t bs = r / H;  // b * S + s
    const int64_t b = bs / S;
    const int64_t s = bs % S;
    D[(b * H + h) * S + s] = acc;
  }
}

// dk = scale * sum_g dk_share[g], dv = sum_g dv_share[g], in head order;
// then, when the dq kernel's key walk was split into `splits` ranges,
// dq = scale * sum_z dq_part[z] in range order.  f32, cast once.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                        T* __restrict__ dv, int64_t n, int G,
                        const float* __restrict__ dq_part, T* __restrict__ dq, int64_t nq,
                        int splits, float scale) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n + nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n) {
      float sk = 0.f, sv = 0.f;
      for (int g = 0; g < G; ++g) {
        sk += part[g * n + i];
        sv += part[(G + g) * n + i];
      }
      dk[i] = from_f32<T>(sk * scale);
      dv[i] = from_f32<T>(sv);
    } else {
      const int64_t j = i - n;
      float sq = 0.f;
      for (int z = 0; z < splits; ++z) sq += dq_part[z * nq + j];
      dq[j] = from_f32<T>(sq * scale);
    }
  }
}

// Element offset of key range blockIdx.z's partial in the f32 dq_part
// buffer, (ranges, B, S, H, hd), B = gridDim.y / Hk.
__device__ __forceinline__ int64_t dq_part_base(int S, int H, int Hk, int hd) {
  return static_cast<int64_t>(blockIdx.z) * (gridDim.y / Hk) * S * H * hd;
}

// ------------------------------------------------- bf16 bodies, tensor cores
//
// For bf16 the dK/dV and dQ kernels run their products on
// mma.sync.m16n8k16 bf16 with f32 accumulation, in the forward's fragment
// layouts (csrc/flash_attention.cu); P and dS are rounded to bf16 as
// operands of the second products, as FlashAttention-2 does.  Tiles of 64
// rows of hd + 8 bf16 in shared memory (the 8 rows an ldmatrix reads fall in
// distinct banks), copied with 16-byte cp.async (zero-filled past the end).
//
// hd 32 and 64, blocks of 4 warps.  dK/dV: one block per (64-key tile,
// batch, query head), warp w owns keys 16w .. 16w + 15 and keeps their k and
// v rows as A fragments; for each 64-position q tile it forms S^T = k q^T
// and dP^T = v dO^T (16 keys x 64 rows a warp), P^T and dS^T in registers,
// then dV += P^T dO and dK += dS^T q with the accumulators repacked as A
// fragments and dO, q read with ldmatrix.trans as B.  The shares go to an
// f32 buffer, as every body's.  dQ: one block per (64 folded rows,
// batch, KV head, key range), warp w owns rows 16w .. 16w + 15 and keeps
// their q and dO rows as A fragments; for each 64-key tile S = q k^T and
// dP = dO v^T, then dQ += dS k.  At hd 128 and 160 a warp of this design
// would hold its 16 keys' fragments, dK and dV across all hd columns and the
// 16 x 64 S^T and dP^T tiles, ~256 and ~304 registers a thread: the wide
// bodies below split that work between two warps.

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaTile = 64;      // keys (dK/dV) or rows (dQ) a block; the streamed tile

template <int HD>
struct MmaSmem {
  static constexpr int kStride = HD + 8;  // bf16 elements a row
  static constexpr int kTile = kMmaTile * kStride;
  // Four bf16 tiles, then the f32 lse and D of the q tile's rows.
  static constexpr size_t kBytes = sizeof(bf16) * 4 * kTile + sizeof(float) * 2 * kMmaTile;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte global -> shared copy (one f32); zero-fills when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 64 rows of hd bf16 into a tile (rows hd + 8 apart) by a block of kNThreads;
// off(r) is row r's element offset, or -1 for a row past the end
// (zero-filled).
template <int HD, int kNThreads, typename Off>
__device__ __forceinline__ void mma_load_tile(bf16* dst, const bf16* __restrict__ src, Off off) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kMmaTile * kChunks; i += kNThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int64_t o = off(r);
    cp_async16(smem_u32(dst + r * MmaSmem<HD>::kStride + c * 8), src + (o >= 0 ? o + c * 8 : 0),
               o >= 0);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t.  A holds rows
// g and g + 8, columns 2t, 2t + 1 (+ 8); B holds column g, rows 2t, 2t + 1
// (+ 8); the f32 accumulator holds rows g and g + 8, columns 2t and 2t + 1.
// Tiles are bf16 in shared memory with rows kLd elements apart.
// A tile's rows as A fragments (16 rows from `row`, k-step kk):
template <int kLd>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* tile, int row, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(f, smem_u32(tile + (row + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));
}

// B fragments of n-tiles 2np, 2np + 1 of X^T, X a tile stored [n][k] (k-step kk).
template <int kLd>
__device__ __forceinline__ void frag_bt(uint32_t (&f)[4], const bf16* tile, int np, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(f, smem_u32(tile + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                      ((lane >> 3) & 1) * 8));
}

// B fragments of n-tiles 2dp, 2dp + 1 of X, X a tile stored [k][n] (k-step kk).
template <int kLd>
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], const bf16* tile, int kk, int dp) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(f, smem_u32(tile + (kk * 16 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8));
}

// The accumulators of n-tiles 2kk, 2kk + 1 as the A fragment of k-step kk.
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], float (*x)[4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ D,
                          float* __restrict__ part, int B, int S, int Sk, int H, int Hk,
                          float scale_log2) {
  using L = MmaSmem<HD>;
  constexpr int kLd = L::kStride;
  constexpr int kDK = HD / 16;        // k-steps over hd
  constexpr int kDN = HD / 8;         // n-tiles over hd
  constexpr int kRN = kMmaTile / 8;   // n-tiles over the q tile's rows
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;
  bf16* dOs = Qs + L::kTile;
  float* lse_s = reinterpret_cast<float*>(dOs + L::kTile);
  float* D_s = lse_s + kMmaTile;

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int h = kvh * G + static_cast<int>(blockIdx.z);
  const int k0 = blockIdx.x * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wk = (threadIdx.x / 32) * 16;  // the warp's first key in the tile

  const auto kv_off = [&](int j) -> int64_t {
    return k0 + j < Sk ? ((static_cast<int64_t>(b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
  };
  mma_load_tile<HD, kMmaThreads>(Ks, k, kv_off);
  mma_load_tile<HD, kMmaThreads>(Vs, v, kv_off);
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[kDK][4], vf[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    frag_a<kLd>(kf[kk], Ks, wk, kk);
    frag_a<kLd>(vf[kk], Vs, wk, kk);
  }

  float dk[kDN][4], dv[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // Causal: positions below k0 see none of the keys (k0 is a tile multiple).
  for (int row0 = kCausal ? k0 : 0; row0 < S; row0 += kMmaTile) {
    __syncthreads();  // the last tile's q, dO, lse and D are read
    const auto q_off = [&](int r) -> int64_t {
      return row0 + r < S ? ((static_cast<int64_t>(b) * S + row0 + r) * H + h) * HD : -1;
    };
    mma_load_tile<HD, kMmaThreads>(Qs, q, q_off);
    mma_load_tile<HD, kMmaThreads>(dOs, dout, q_off);
    for (int r = threadIdx.x; r < kMmaTile; r += kMmaThreads) {
      const bool ok = row0 + r < S;
      const int64_t i = (static_cast<int64_t>(b) * H + h) * S + row0 + r;
      lse_s[r] = ok ? lse[i] * kLog2e : 0.f;
      D_s[r] = ok ? D[i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T: the warp's 16 keys x 64 rows.
    float st[kRN][4], dpt[kRN][4];
#pragma unroll
    for (int j = 0; j < kRN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int np = 0; np < kRN / 2; ++np) {
        uint32_t bq[4], bo[4];
        frag_bt<kLd>(bq, Qs, np, kk);
        frag_bt<kLd>(bo, dOs, np, kk);
        mma_bf16(st[2 * np], kf[kk], bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], kf[kk], bq[2], bq[3]);
        mma_bf16(dpt[2 * np], vf[kk], bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], vf[kk], bo[2], bo[3]);
      }
    }
    // P^T and dS^T in place.
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t4 + (e & 1);
        const int key = k0 + wk + g + 8 * (e >> 1);
        const int pos = row0 + r;
        const bool ok = pos < S && key < Sk && (!kCausal || key <= pos);
        const float p = ok ? exp2f(st[j][e] * scale_log2 - lse_s[r]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - D_s[r]);
      }
    }
    // dV += P^T dO and dK += dS^T q, k = the tile's rows.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_as_a(ap, st, kk);
      acc_as_a(as, dpt, kk);
#pragma unroll
      for (int dp = 0; dp < kDN / 2; ++dp) {
        uint32_t bo[4], bq[4];
        frag_b<kLd>(bo, dOs, kk, dp);
        frag_b<kLd>(bq, Qs, kk, dp);
        mma_bf16(dv[2 * dp], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * dp + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * dp], as, bq[0], bq[1]);
        mma_bf16(dk[2 * dp + 1], as, bq[2], bq[3]);
      }
    }
  }

  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;  // one share
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k0 + wk + g + 8 * (e >> 1);
    if (key >= Sk) continue;
    const int64_t off = static_cast<int64_t>(blockIdx.z) * n +
                        ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + 2 * t4 + (e & 1);
#pragma unroll
    for (int nn = 0; nn < kDN; ++nn) {
      part[off + 8 * nn] = dk[nn][e];
      part[static_cast<int64_t>(G) * n + off + 8 * nn] = dv[nn][e];
    }
  }
}

// dq's two values at (row, column col) of a warp's accumulator pair: scaled
// and cast into dq when the key walk is whole, else unscaled f32 into the
// block's partial (`part`, already offset to its key range).
__device__ __forceinline__ void store_dq_pair(bf16* __restrict__ dq, float* __restrict__ part,
                                              bool whole, int64_t off, float x0, float x1,
                                              float scale) {
  if (whole) {
    *reinterpret_cast<uint32_t*>(dq + off) = pack_bf16(x0 * scale, x1 * scale);
  } else {
    *reinterpret_cast<float2*>(part + off) = make_float2(x0, x1);
  }
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ D,
                        bf16* __restrict__ dq, float* __restrict__ dq_part, int S, int Sk, int H,
                        int Hk, float scale, float scale_log2) {
  using L = MmaSmem<HD>;
  constexpr int kLd = L::kStride;
  constexpr int kDK = HD / 16;
  constexpr int kDN = HD / 8;
  constexpr int kKN = kMmaTile / 8;  // n-tiles over the key tile
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + L::kTile;
  bf16* Ks = dOs + L::kTile;
  bf16* Vs = Ks + L::kTile;

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const Rows R{S, H, G, kvh * G, static_cast<int>(blockIdx.y / Hk),
               static_cast<int64_t>(S) * G};
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = (threadIdx.x / 32) * 16;

  const auto row_off = [&](int r) -> int64_t {
    return row0 + r < R.total ? R.offset(row0 + r, HD) : -1;
  };
  mma_load_tile<HD, kMmaThreads>(Qs, q, row_off);
  mma_load_tile<HD, kMmaThreads>(dOs, dout, row_off);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kDK][4], of[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    frag_a<kLd>(qf[kk], Qs, wrow, kk);
    frag_a<kLd>(of[kk], dOs, wrow, kk);
  }
  // This thread's rows g and g + 8 of the warp.
  bool row_ok[2];
  int64_t pos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + wrow + g + 8 * i;
    row_ok[i] = row < R.total;
    pos[i] = R.pos(row);
    lse2[i] = row_ok[i] ? lse[R.stat(row)] * kLog2e : 0.f;
    Dr[i] = row_ok[i] ? D[R.stat(row)] : 0.f;
  }

  int n_tiles = (Sk + kMmaTile - 1) / kMmaTile;
  if (kCausal) {
    const int64_t last_row = (row0 + kMmaTile < R.total ? row0 + kMmaTile : R.total) - 1;
    const int limit = static_cast<int>(R.pos(last_row)) / kMmaTile + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);

  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kMmaTile;
    __syncthreads();  // the last tile's k and v are read
    const auto kv_off = [&](int j) -> int64_t {
      return k0 + j < Sk ? ((static_cast<int64_t>(R.b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
    };
    mma_load_tile<HD, kMmaThreads>(Ks, k, kv_off);
    mma_load_tile<HD, kMmaThreads>(Vs, v, kv_off);
    cp_async_wait_all();
    __syncthreads();

    float s[kKN][4], dp[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int np = 0; np < kKN / 2; ++np) {
        uint32_t bk[4], bv[4];
        frag_bt<kLd>(bk, Ks, np, kk);
        frag_bt<kLd>(bv, Vs, np, kk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], of[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], of[kk], bv[2], bv[3]);
      }
    }
    // dS in place of S.
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = row_ok[i] && key < Sk && (!kCausal || key <= pos[i]);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - Dr[i]);
      }
    }
    // dQ += dS k, k = the tile's keys.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int d2 = 0; d2 < kDN / 2; ++d2) {
        uint32_t bk[4];
        frag_b<kLd>(bk, Ks, kk, d2);
        mma_bf16(acc[2 * d2], a, bk[0], bk[1]);
        mma_bf16(acc[2 * d2 + 1], a, bk[2], bk[3]);
      }
    }
  }

  const bool whole = gridDim.z == 1;
  float* part = dq_part + (whole ? 0 : dq_part_base(S, H, Hk, HD));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int64_t off = R.offset(row0 + wrow + g + 8 * i, HD) + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < kDN; ++nn) {
      store_dq_pair(dq, part, whole, off + 8 * nn, acc[nn][2 * i], acc[nn][2 * i + 1], scale);
    }
  }
}

// ------------------------------------------- bf16 at hd 128 and 160, wide
//
// Blocks of 8 warps.  Warps w and w + 4 (w < 4) are a pair that shares 16
// keys (dK/dV) or 16 rows (dQ); `half` = w / 4 says which half of the pair's
// work a warp does: in the score products, rows (keys) 32 half .. 32 half +
// 31 of the streamed tile; in the accumulating products, columns hd/2 half
// .. of dK and dV (dQ), hd/4 floats a thread for each (32 at hd 128, 40 at
// hd 160).  So no product is done twice and the accumulators plus one
// warp's 16 x 32 score and dP tiles fit in a thread's registers.  The A
// operands of the score products (k and v, or q and dO) are read from shared
// memory with ldmatrix for each k-step rather than held.  The pair passes P
// and dS between its halves through shared memory in bf16 (tiles of 64 x 64
// with rows 72 apart: the rounding the hd 64 body does when it repacks its
// accumulators), after which each warp reads the pair's full 16 x 64 tiles
// back as A fragments.  The streamed tile (q, dO, lse and D in dK/dV; k and
// v in dQ) is double-buffered: the copy of tile t + 1 is issued with
// cp.async after the barrier that opens tile t and overlaps its products.
// Shared memory: six 64-row tiles and the bf16 P^T and dS^T (dS) tiles,
// ~121 KB (dK/dV) / ~113 KB (dQ) at hd 128 and ~145 / ~136 KB at hd 160;
// one block an SM.  The dK/dV shares go to the same f32 buffer as the other
// bodies'.

constexpr int kWideThreads = 256;         // 8 warps
constexpr int kXLd = kMmaTile + 8;         // row stride of the bf16 P^T, dS^T, dS tiles
constexpr int kXTile = kMmaTile * kXLd;

template <int HD>
struct WideSmem {
  static constexpr int kTile = MmaSmem<HD>::kTile;
  // k, v, q[2], dO[2], P^T, dS^T, then f32 lse[2] and D[2].
  static constexpr size_t kDkdvBytes =
      sizeof(bf16) * (6 * kTile + 2 * kXTile) + sizeof(float) * 4 * kMmaTile;
  // q, dO, k[2], v[2], dS.
  static constexpr size_t kDqBytes = sizeof(bf16) * (6 * kTile + kXTile);
  static_assert(kDkdvBytes <= 232448 && kDqBytes <= 232448, "over a block's shared memory");
};

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkdv_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ D,
                               float* __restrict__ part, int B, int S, int Sk, int H, int Hk,
                               float scale_log2) {
  using L = WideSmem<HD>;
  constexpr int kLd = MmaSmem<HD>::kStride;
  constexpr int kDK = HD / 16;  // k-steps over hd
  constexpr int kHN = HD / 16;  // n-tiles over half of hd's columns
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;       // two buffers
  bf16* dOs = Qs + 2 * L::kTile;  // two buffers
  bf16* Pt = dOs + 2 * L::kTile;  // P^T, keys x rows
  bf16* dSt = Pt + kXTile;        // dS^T
  float* lse_s = reinterpret_cast<float*>(dSt + kXTile);  // two buffers
  float* D_s = lse_s + 2 * kMmaTile;                      // two buffers

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int h = kvh * G + static_cast<int>(blockIdx.z);
  const int k0 = blockIdx.x * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int warp = threadIdx.x / 32;
  const int wk = (warp & 3) * 16;  // the pair's first key in the tile
  const int half = warp >> 2;
  const int cp0 = half * (HD / 32);  // the warp's first 16-column pair of dK, dV

  const auto kv_off = [&](int j) -> int64_t {
    return k0 + j < Sk ? ((static_cast<int64_t>(b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
  };
  // q, dO, lse and D of the rows from row0 into buffer `buf`.
  const auto load_q = [&](int row0, int buf) {
    const auto q_off = [&](int r) -> int64_t {
      return row0 + r < S ? ((static_cast<int64_t>(b) * S + row0 + r) * H + h) * HD : -1;
    };
    mma_load_tile<HD, kWideThreads>(Qs + buf * L::kTile, q, q_off);
    mma_load_tile<HD, kWideThreads>(dOs + buf * L::kTile, dout, q_off);
    if (threadIdx.x < 2 * kMmaTile) {
      const int r = threadIdx.x % kMmaTile;
      const bool ok = row0 + r < S;
      const int64_t i = ok ? (static_cast<int64_t>(b) * H + h) * S + row0 + r : 0;
      float* dst = (threadIdx.x < kMmaTile ? lse_s : D_s) + buf * kMmaTile + r;
      cp_async4(smem_u32(dst), (threadIdx.x < kMmaTile ? lse : D) + i, ok);
    }
  };

  // Causal: positions below k0 see none of the keys (k0 is a tile multiple).
  const int first = kCausal ? k0 : 0;
  const int n_q = first < S ? (S - first + kMmaTile - 1) / kMmaTile : 0;
  if (n_q > 0) {  // else the keys' shares are zero: no copy is left in flight
    mma_load_tile<HD, kWideThreads>(Ks, k, kv_off);
    mma_load_tile<HD, kWideThreads>(Vs, v, kv_off);
    load_q(first, 0);
    cp_async_commit();
  }

  float dk[kHN][4], dv[kHN][4];
#pragma unroll
  for (int n = 0; n < kHN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int row0 = first + t * kMmaTile;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_q) load_q(row0 + kMmaTile, (t + 1) & 1);
    cp_async_commit();
    const bf16* Qb = Qs + (t & 1) * L::kTile;
    const bf16* dOb = dOs + (t & 1) * L::kTile;
    const float* lse_b = lse_s + (t & 1) * kMmaTile;
    const float* D_b = D_s + (t & 1) * kMmaTile;

    // S^T = k q^T and dP^T = v dO^T: the pair's 16 keys x this warp's 32 rows.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t kf[4], vf[4];
      frag_a<kLd>(kf, Ks, wk, kk);
      frag_a<kLd>(vf, Vs, wk, kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        frag_bt<kLd>(bq, Qb, 2 * half + np, kk);
        frag_bt<kLd>(bo, dOb, 2 * half + np, kk);
        mma_bf16(st[2 * np], kf, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], kf, bq[2], bq[3]);
        mma_bf16(dpt[2 * np], vf, bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], vf, bo[2], bo[3]);
      }
    }
    // P^T and dS^T into shared memory in bf16: rows r, r + 1 of key rows
    // g and g + 8 of the pair.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 32 * half + 8 * j + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + wk + g + 8 * i;
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * i + c;
          const int pos = row0 + r + c;
          const bool ok = pos < S && key < Sk && (!kCausal || key <= pos);
          p[c] = ok ? exp2f(st[j][e] * scale_log2 - lse_b[r + c] * kLog2e) : 0.f;
          ds[c] = p[c] * (dpt[j][e] - D_b[r + c]);
        }
        const int at = (wk + g + 8 * i) * kXLd + r;
        *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();  // the pair's P^T and dS^T are whole
    // dV += P^T dO and dK += dS^T q on this warp's half of the columns,
    // k = the tile's 64 rows.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t ap[4], as[4];
      frag_a<kXLd>(ap, Pt, wk, kk);
      frag_a<kXLd>(as, dSt, wk, kk);
#pragma unroll
      for (int dp = 0; dp < kHN / 2; ++dp) {
        uint32_t bo[4], bq[4];
        frag_b<kLd>(bo, dOb, kk, cp0 + dp);
        frag_b<kLd>(bq, Qb, kk, cp0 + dp);
        mma_bf16(dv[2 * dp], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * dp + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * dp], as, bq[0], bq[1]);
        mma_bf16(dk[2 * dp + 1], as, bq[2], bq[3]);
      }
    }
  }

  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;  // one share
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k0 + wk + g + 8 * (e >> 1);
    if (key >= Sk) continue;
    const int64_t off = static_cast<int64_t>(blockIdx.z) * n +
                        ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + 16 * cp0 +
                        2 * t4 + (e & 1);
#pragma unroll
    for (int nn = 0; nn < kHN; ++nn) {
      part[off + 8 * nn] = dk[nn][e];
      part[static_cast<int64_t>(G) * n + off + 8 * nn] = dv[nn][e];
    }
  }
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ D,
                             bf16* __restrict__ dq, float* __restrict__ dq_part, int S, int Sk,
                             int H, int Hk, float scale, float scale_log2) {
  using L = WideSmem<HD>;
  constexpr int kLd = MmaSmem<HD>::kStride;
  constexpr int kDK = HD / 16;
  constexpr int kHN = HD / 16;  // n-tiles over half of hd's columns
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + L::kTile;
  bf16* Ks = dOs + L::kTile;     // two buffers
  bf16* Vs = Ks + 2 * L::kTile;  // two buffers
  bf16* dSs = Vs + 2 * L::kTile;  // dS, rows x keys

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const Rows R{S, H, G, kvh * G, static_cast<int>(blockIdx.y / Hk),
               static_cast<int64_t>(S) * G};
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int warp = threadIdx.x / 32;
  const int wrow = (warp & 3) * 16;  // the pair's first row in the tile
  const int half = warp >> 2;
  const int cp0 = half * (HD / 32);  // the warp's first 16-column pair of dQ

  int n_tiles = (Sk + kMmaTile - 1) / kMmaTile;
  if (kCausal) {
    const int64_t last_row = (row0 + kMmaTile < R.total ? row0 + kMmaTile : R.total) - 1;
    const int limit = static_cast<int>(R.pos(last_row)) / kMmaTile + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);

  const auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kMmaTile;
    const auto kv_off = [&](int j) -> int64_t {
      return k0 + j < Sk ? ((static_cast<int64_t>(R.b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
    };
    mma_load_tile<HD, kWideThreads>(Ks + buf * L::kTile, k, kv_off);
    mma_load_tile<HD, kWideThreads>(Vs + buf * L::kTile, v, kv_off);
  };
  if (kt0 < kt1) {
    const auto row_off = [&](int r) -> int64_t {
      return row0 + r < R.total ? R.offset(row0 + r, HD) : -1;
    };
    mma_load_tile<HD, kWideThreads>(Qs, q, row_off);
    mma_load_tile<HD, kWideThreads>(dOs, dout, row_off);
    load_kv(kt0, 0);
    cp_async_commit();
  }
  // This thread's rows g and g + 8 of the pair.
  bool row_ok[2];
  int64_t pos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + wrow + g + 8 * i;
    row_ok[i] = row < R.total;
    pos[i] = R.pos(row);
    lse2[i] = row_ok[i] ? lse[R.stat(row)] * kLog2e : 0.f;
    Dr[i] = row_ok[i] ? D[R.stat(row)] : 0.f;
  }

  float acc[kHN][4];
#pragma unroll
  for (int n = 0; n < kHN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kMmaTile;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt1) load_kv(kt + 1, (kt - kt0 + 1) & 1);
    cp_async_commit();
    const bf16* Kb = Ks + ((kt - kt0) & 1) * L::kTile;
    const bf16* Vb = Vs + ((kt - kt0) & 1) * L::kTile;

    // S = q k^T and dP = dO v^T: the pair's 16 rows x this warp's 32 keys.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t qf[4], of[4];
      frag_a<kLd>(qf, Qs, wrow, kk);
      frag_a<kLd>(of, dOs, wrow, kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4], bv[4];
        frag_bt<kLd>(bk, Kb, 2 * half + np, kk);
        frag_bt<kLd>(bv, Vb, 2 * half + np, kk);
        mma_bf16(s[2 * np], qf, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf, bk[2], bk[3]);
        mma_bf16(dp[2 * np], of, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], of, bv[2], bv[3]);
      }
    }
    // dS into shared memory in bf16: keys c, c + 1 of rows g and g + 8.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * half + 8 * j + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * i + e1;
          const int key = k0 + c + e1;
          const bool ok = row_ok[i] && key < Sk && (!kCausal || key <= pos[i]);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[i]) : 0.f;
          ds[e1] = p * (dp[j][e] - Dr[i]);
        }
        *reinterpret_cast<uint32_t*>(dSs + (wrow + g + 8 * i) * kXLd + c) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();  // the pair's dS is whole
    // dQ += dS k on this warp's half of the columns, k = the tile's 64 keys.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t a[4];
      frag_a<kXLd>(a, dSs, wrow, kk);
#pragma unroll
      for (int d2 = 0; d2 < kHN / 2; ++d2) {
        uint32_t bk[4];
        frag_b<kLd>(bk, Kb, kk, cp0 + d2);
        mma_bf16(acc[2 * d2], a, bk[0], bk[1]);
        mma_bf16(acc[2 * d2 + 1], a, bk[2], bk[3]);
      }
    }
  }

  const bool whole = gridDim.z == 1;
  float* part = dq_part + (whole ? 0 : dq_part_base(S, H, Hk, HD));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int64_t off = R.offset(row0 + wrow + g + 8 * i, HD) + 16 * cp0 + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < kHN; ++nn) {
      store_dq_pair(dq, part, whole, off + 8 * nn, acc[nn][2 * i], acc[nn][2 * i + 1], scale);
    }
  }
}

// ------------------------------------------------- f32 bodies, 3xTF32
//
// f32 runs the structure of the bf16 bodies on mma.sync.m16n8k8 TF32 in
// 3xTF32: each operand split once, as it is read, into a TF32 big part and
// the remainder (split_tf32, csrc/rwkv_scan.cu's), and big * big + big *
// small + small * big accumulated in f32, which holds the f32 tolerance (1e-4
// of max |grad|) that one TF32 product does not.  The five products (q k^T,
// dO v^T, dV, dK, dQ) each run so.  dK/dV: one block per (64-key tile, batch,
// query head); dQ: one block per (64 folded rows, batch, KV head, key range),
// as the bf16 bodies.  kHalves = 1 at hd 32 and 64: 4 warps, warp w owns
// keys (rows) 16w .. 16w + 15 and all of the streamed tile and of hd.
// kHalves = 2 at hd 128 and 160: 8 warps, warps w and w + 4 a pair sharing
// those 16 keys (rows), each forming the score products of half the streamed
// tile's rows (keys) and accumulating half of hd's columns, as the wide bf16
// bodies.  What the design does:
//   * f32 tiles of 64 rows x hd, no padding, their 16-byte column chunks
//     XOR-swizzled by row (swz), so the fragment reads of both products,
//     8 rows x 4 columns and 4 rows x 8 columns, fall in 32 distinct banks.
//     The A operands of the score products (k and v, or q and dO) are read
//     from the tiles each k-step, which keeps a thread's registers to the
//     accumulators;
//   * the rows (keys) inside each 8-wide n-tile of the score accumulators
//     are permuted (column 2t holds row t, column 2t + 1 row t + 4), so that
//     P^T and dS^T (dS) in the accumulators are, as they stand, the A
//     fragments of dV += P^T dO and dK += dS^T q (dQ += dS k).  With kHalves
//     = 2 each lane passes its accumulators to the same lane of its pair's
//     other warp through shared memory, in f32, one float4 a lane and n-tile;
//   * the streamed tile (q, dO, lse and D; or k and v) is double-buffered
//     with cp.async where two buffers fit the 227 KB (all but hd 160), and
//     single-buffered otherwise;
//   * the shares and dq's partials go to the f32 buffers of the bf16 bodies.

// 64 rows of HD floats into a swizzled tile by a block of kNThreads; off(r)
// is row r's element offset, or -1 for a row past the end (zero-filled).
template <int HD, int kNThreads, typename Off>
__device__ __forceinline__ void tf32_load_tile(float* dst, const float* __restrict__ src,
                                               Off off) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < kMmaTile * kChunks; i += kNThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const int64_t o = off(r);
    cp_async16(smem_u32(dst + at<HD>(r, c)), src + (o >= 0 ? o + c : 0), o >= 0);
  }
}

// A warp's A fragment of k-step kk over the columns of 16 rows from `row`.
template <int HD>
__device__ __forceinline__ FragA tile_frag_a(const float* tile, int row, int kk) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c = 8 * kk + (lane & 3);
  const float x[4] = {tile[at<HD>(row + g, c)], tile[at<HD>(row + g + 8, c)],
                      tile[at<HD>(row + g, c + 4)], tile[at<HD>(row + g + 8, c + 4)]};
  return FragA(x);
}

// B fragment of X^T, X a tile stored [n][k]: n-tile j (rows permuted by
// perm8), k-step kk.
template <int HD>
__device__ __forceinline__ FragB tile_frag_bt(const float* tile, int j, int kk) {
  const int lane = threadIdx.x % 32;
  const int r = 8 * j + perm8(lane >> 2);
  const int c = 8 * kk + (lane & 3);
  return FragB(tile[at<HD>(r, c)], tile[at<HD>(r, c + 4)]);
}

// B fragment of X, X a tile stored [k][n]: k-step kk, n-tile n.
template <int HD>
__device__ __forceinline__ FragB tile_frag_b(const float* tile, int kk, int n) {
  const int lane = threadIdx.x % 32;
  const int r = 8 * kk + (lane & 3);
  const int c = 8 * n + (lane >> 2);
  return FragB(tile[at<HD>(r, c)], tile[at<HD>(r + 4, c)]);
}

// A score accumulator n-tile as the A fragment of the product that
// contracts over its (permuted) columns.
__device__ __forceinline__ FragA acc_frag(const float (&x)[4]) {
  const float a[4] = {x[0], x[2], x[1], x[3]};
  return FragA(a);
}

// Shared memory, in floats.  An exchange tile holds a pair's 16 x 64 score
// n-tiles, 4 pairs x 8 n-tiles x 32 lanes x 4 floats (kHalves = 2 only).
template <int HD, int kHalves>
struct Tf32Smem {
  static constexpr int kTile = kMmaTile * HD;
  static constexpr int kX = kHalves == 2 ? 4 * 8 * 32 * 4 : 0;
  // dK/dV: k, v, then per buffer q, dO, lse, D; then P^T's and dS^T's exchanges.
  static constexpr size_t dkdv(int bufs) {
    return sizeof(float) * (2 * kTile + bufs * (2 * kTile + 2 * kMmaTile) + 2 * kX);
  }
  static constexpr int kDkdvBufs = dkdv(2) <= 232448 ? 2 : 1;
  static constexpr size_t kDkdvBytes = dkdv(kDkdvBufs);
  // dQ: q, dO, then per buffer k, v; then dS's exchange.
  static constexpr size_t dq(int bufs) {
    return sizeof(float) * (2 * kTile + bufs * 2 * kTile + kX);
  }
  static constexpr int kDqBufs = dq(2) <= 232448 ? 2 : 1;
  static constexpr size_t kDqBytes = dq(kDqBufs);
  static_assert(kDkdvBytes <= 232448 && kDqBytes <= 232448, "over a block's shared memory");
};

// Query head h's share of dk and dv for one (64-key tile, batch, h).  Warp
// (wp, half) = (w % 4, w / 4): keys 16 wp .. of the tile; in S^T and dP^T
// the q tile's n-tiles j0 .. j0 + kRN - 1; in dK and dV the column n-tiles
// c0 .. c0 + kCN - 1.
template <int HD, bool kCausal, int kHalves>
__device__ __forceinline__ void dkdv_tf32x3(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ D,
                                            float* __restrict__ part, int B, int S, int Sk,
                                            int H, int Hk, float scale_log2) {
  using L = Tf32Smem<HD, kHalves>;
  constexpr int kNThreads = 128 * kHalves;
  constexpr int kBufs = L::kDkdvBufs;
  constexpr int kTile = L::kTile;
  constexpr int kDK = HD / 8;           // k-steps over hd
  constexpr int kRN = 8 / kHalves;      // the warp's n-tiles of the q tile's rows
  constexpr int kCN = HD / 8 / kHalves;  // the warp's n-tiles of dK's and dV's columns
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;                    // kBufs buffers
  float* dOs = Qs + kBufs * kTile;           // kBufs buffers
  float* lse_s = dOs + kBufs * kTile;        // kBufs buffers
  float* D_s = lse_s + kBufs * kMmaTile;     // kBufs buffers
  float4* Xp = reinterpret_cast<float4*>(D_s + kBufs * kMmaTile);  // P^T exchange
  float4* Xs = Xp + L::kX / 4;                                     // dS^T exchange

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int h = kvh * G + static_cast<int>(blockIdx.z);
  const int k0 = blockIdx.x * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wp = (threadIdx.x / 32) & 3;
  const int half = threadIdx.x / 128;
  const int wk = 16 * wp;  // the warp's first key in the tile
  const int j0 = half * kRN;
  const int c0 = half * kCN;

  const auto kv_off = [&](int j) -> int64_t {
    return k0 + j < Sk ? ((static_cast<int64_t>(b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
  };
  // q, dO, lse and D of the rows from row0 into buffer `buf`.
  const auto load_q = [&](int row0, int buf) {
    const auto q_off = [&](int r) -> int64_t {
      return row0 + r < S ? ((static_cast<int64_t>(b) * S + row0 + r) * H + h) * HD : -1;
    };
    tf32_load_tile<HD, kNThreads>(Qs + buf * kTile, q, q_off);
    tf32_load_tile<HD, kNThreads>(dOs + buf * kTile, dout, q_off);
    if (threadIdx.x < 2 * kMmaTile) {
      const int r = threadIdx.x % kMmaTile;
      const bool ok = row0 + r < S;
      const int64_t i = ok ? (static_cast<int64_t>(b) * H + h) * S + row0 + r : 0;
      float* dst = (threadIdx.x < kMmaTile ? lse_s : D_s) + buf * kMmaTile + r;
      cp_async4(smem_u32(dst), (threadIdx.x < kMmaTile ? lse : D) + i, ok);
    }
  };

  // Causal: positions below k0 see none of the keys (k0 is a tile multiple).
  const int first = kCausal ? k0 : 0;
  const int n_q = first < S ? (S - first + kMmaTile - 1) / kMmaTile : 0;
  if (n_q > 0) {  // else the keys' shares are zero: no copy is left in flight
    tf32_load_tile<HD, kNThreads>(Ks, k, kv_off);
    tf32_load_tile<HD, kNThreads>(Vs, v, kv_off);
    load_q(first, 0);
    cp_async_commit();
  }

  float dk[kCN][4], dv[kCN][4];
#pragma unroll
  for (int n = 0; n < kCN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int row0 = first + t * kMmaTile;
    const int buf = kBufs == 2 ? (t & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (kBufs == 2 && t + 1 < n_q) load_q(row0 + kMmaTile, buf ^ 1);
    cp_async_commit();
    const float* Qb = Qs + buf * kTile;
    const float* dOb = dOs + buf * kTile;
    const float* lse_b = lse_s + buf * kMmaTile;
    const float* D_b = D_s + buf * kMmaTile;

    // S^T = k q^T and dP^T = v dO^T: the warp's 16 keys x its kRN n-tiles
    // of rows (permuted within each).
    float st[kRN][4], dpt[kRN][4];
#pragma unroll
    for (int j = 0; j < kRN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const FragA ka = tile_frag_a<HD>(Ks, wk, kk);
      const FragA va = tile_frag_a<HD>(Vs, wk, kk);
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        mma3(st[j], ka, tile_frag_bt<HD>(Qb, j0 + j, kk));
        mma3(dpt[j], va, tile_frag_bt<HD>(dOb, j0 + j, kk));
      }
    }
    // P^T and dS^T in place: element e holds key g + 8 (e >> 1) of the
    // warp's and row 8 j + t + 4 (e & 1) of the tile.
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * (j0 + j) + t4 + 4 * (e & 1);
        const int key = k0 + wk + g + 8 * (e >> 1);
        const int pos = row0 + r;
        const bool ok = pos < S && key < Sk && (!kCausal || key <= pos);
        const float p = ok ? exp2f(st[j][e] * scale_log2 - lse_b[r] * kLog2e) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - D_b[r]);
      }
    }
    if constexpr (kHalves == 2) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int at4 = (wp * 8 + j0 + j) * 32 + lane;
        Xp[at4] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
        Xs[at4] = make_float4(dpt[j][0], dpt[j][1], dpt[j][2], dpt[j][3]);
      }
      __syncthreads();  // the pair's P^T and dS^T are whole
    }
    // dV += P^T dO and dK += dS^T q on the warp's columns, k = the tile's rows.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 8; ++kk) {
      float pa[4], sa[4];
      if constexpr (kHalves == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[e] = st[kk][e];
          sa[e] = dpt[kk][e];
        }
      } else {
        const float4 x = Xp[(wp * 8 + kk) * 32 + lane];
        const float4 y = Xs[(wp * 8 + kk) * 32 + lane];
        pa[0] = x.x, pa[1] = x.y, pa[2] = x.z, pa[3] = x.w;
        sa[0] = y.x, sa[1] = y.y, sa[2] = y.z, sa[3] = y.w;
      }
      const FragA ap = acc_frag(pa);
      const FragA as = acc_frag(sa);
#pragma unroll
      for (int n = 0; n < kCN; ++n) {
        mma3(dv[n], ap, tile_frag_b<HD>(dOb, kk, c0 + n));
        mma3(dk[n], as, tile_frag_b<HD>(Qb, kk, c0 + n));
      }
    }
    if constexpr (kBufs == 1) {
      __syncthreads();  // every warp is done with tile t
      if (t + 1 < n_q) load_q(row0 + kMmaTile, 0);
      cp_async_commit();
    }
  }

  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;  // one share
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wk + g + 8 * i;
    if (key >= Sk) continue;
    const int64_t off = static_cast<int64_t>(blockIdx.z) * n +
                        ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + 8 * c0 + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < kCN; ++nn) {
      *reinterpret_cast<float2*>(part + off + 8 * nn) = make_float2(dk[nn][2 * i], dk[nn][2 * i + 1]);
      *reinterpret_cast<float2*>(part + static_cast<int64_t>(G) * n + off + 8 * nn) =
          make_float2(dv[nn][2 * i], dv[nn][2 * i + 1]);
    }
  }
}

// dq of one (64-row tile, batch, KV head, key range).  Warp (wp, half): rows
// 16 wp .. of the tile; in S and dP the key tile's n-tiles j0 .. j0 + kKN -
// 1; in dQ the column n-tiles c0 .. c0 + kCN - 1.
template <int HD, bool kCausal, int kHalves>
__device__ __forceinline__ void dq_tf32x3(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ D, float* __restrict__ dq,
                                          float* __restrict__ dq_part, int S, int Sk, int H,
                                          int Hk, float scale, float scale_log2) {
  using L = Tf32Smem<HD, kHalves>;
  constexpr int kNThreads = 128 * kHalves;
  constexpr int kBufs = L::kDqBufs;
  constexpr int kTile = L::kTile;
  constexpr int kDK = HD / 8;
  constexpr int kKN = 8 / kHalves;       // the warp's n-tiles of the key tile
  constexpr int kCN = HD / 8 / kHalves;  // the warp's n-tiles of dQ's columns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;           // kBufs buffers
  float* Vs = Ks + kBufs * kTile;    // kBufs buffers
  float4* Xd = reinterpret_cast<float4*>(Vs + kBufs * kTile);  // dS exchange

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const Rows R{S, H, G, kvh * G, static_cast<int>(blockIdx.y / Hk),
               static_cast<int64_t>(S) * G};
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kMmaTile;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wp = (threadIdx.x / 32) & 3;
  const int half = threadIdx.x / 128;
  const int wrow = 16 * wp;  // the warp's first row in the tile
  const int j0 = half * kKN;
  const int c0 = half * kCN;

  int n_tiles = (Sk + kMmaTile - 1) / kMmaTile;
  if (kCausal) {
    const int64_t last_row = (row0 + kMmaTile < R.total ? row0 + kMmaTile : R.total) - 1;
    const int limit = static_cast<int>(R.pos(last_row)) / kMmaTile + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);

  const auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kMmaTile;
    const auto kv_off = [&](int j) -> int64_t {
      return k0 + j < Sk ? ((static_cast<int64_t>(R.b) * Sk + k0 + j) * Hk + kvh) * HD : -1;
    };
    tf32_load_tile<HD, kNThreads>(Ks + buf * kTile, k, kv_off);
    tf32_load_tile<HD, kNThreads>(Vs + buf * kTile, v, kv_off);
  };
  if (kt0 < kt1) {
    const auto row_off = [&](int r) -> int64_t {
      return row0 + r < R.total ? R.offset(row0 + r, HD) : -1;
    };
    tf32_load_tile<HD, kNThreads>(Qs, q, row_off);
    tf32_load_tile<HD, kNThreads>(dOs, dout, row_off);
    load_kv(kt0, 0);
    cp_async_commit();
  }
  // This thread's rows g and g + 8 of the warp.
  bool row_ok[2];
  int64_t pos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + wrow + g + 8 * i;
    row_ok[i] = row < R.total;
    pos[i] = R.pos(row);
    lse2[i] = row_ok[i] ? lse[R.stat(row)] * kLog2e : 0.f;
    Dr[i] = row_ok[i] ? D[R.stat(row)] : 0.f;
  }

  float acc[kCN][4];
#pragma unroll
  for (int n = 0; n < kCN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kMmaTile;
    const int buf = kBufs == 2 ? ((kt - kt0) & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kBufs == 2 && kt + 1 < kt1) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    const float* Kb = Ks + buf * kTile;
    const float* Vb = Vs + buf * kTile;

    // S = q k^T and dP = dO v^T: the warp's 16 rows x its kKN n-tiles of
    // keys (permuted within each).
    float s[kKN][4], dp[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const FragA qa = tile_frag_a<HD>(Qs, wrow, kk);
      const FragA oa = tile_frag_a<HD>(dOs, wrow, kk);
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        mma3(s[j], qa, tile_frag_bt<HD>(Kb, j0 + j, kk));
        mma3(dp[j], oa, tile_frag_bt<HD>(Vb, j0 + j, kk));
      }
    }
    // dS in place of S: element e holds row g + 8 (e >> 1) of the warp's and
    // key 8 j + t + 4 (e & 1) of the tile.
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + 8 * (j0 + j) + t4 + 4 * (e & 1);
        const bool ok = row_ok[i] && key < Sk && (!kCausal || key <= pos[i]);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - Dr[i]);
      }
    }
    if constexpr (kHalves == 2) {
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        Xd[(wp * 8 + j0 + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      }
      __syncthreads();  // the pair's dS is whole
    }
    // dQ += dS k on the warp's columns, k = the tile's keys.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 8; ++kk) {
      float da[4];
      if constexpr (kHalves == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) da[e] = s[kk][e];
      } else {
        const float4 x = Xd[(wp * 8 + kk) * 32 + lane];
        da[0] = x.x, da[1] = x.y, da[2] = x.z, da[3] = x.w;
      }
      const FragA a = acc_frag(da);
#pragma unroll
      for (int n = 0; n < kCN; ++n) mma3(acc[n], a, tile_frag_b<HD>(Kb, kk, c0 + n));
    }
    if constexpr (kBufs == 1) {
      __syncthreads();  // every warp is done with tile kt
      if (kt + 1 < kt1) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }

  const bool whole = gridDim.z == 1;
  float* part = dq_part + (whole ? 0 : dq_part_base(S, H, Hk, HD));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int64_t off = R.offset(row0 + wrow + g + 8 * i, HD) + 8 * c0 + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < kCN; ++nn) {
      const float x0 = acc[nn][2 * i], x1 = acc[nn][2 * i + 1];
      *reinterpret_cast<float2*>((whole ? dq : part) + off + 8 * nn) =
          whole ? make_float2(x0 * scale, x1 * scale) : make_float2(x0, x1);
    }
  }
}

// The f32 kernels: 4 warps at hd 32 and 64, 8 (in pairs) at hd 128 and 160.
#define FLASH_BWD_DKDV_ARGS                                                                 \
  const float *__restrict__ q, const float *__restrict__ k, const float *__restrict__ v,    \
      const float *__restrict__ dout, const float *__restrict__ lse,                        \
      const float *__restrict__ D, float *__restrict__ part, int B, int S, int Sk, int H, \
      int Hk, float scale_log2
#define FLASH_BWD_DQ_ARGS                                                                   \
  const float *__restrict__ q, const float *__restrict__ k, const float *__restrict__ v,    \
      const float *__restrict__ dout, const float *__restrict__ lse,                        \
      const float *__restrict__ D, float *__restrict__ dq, float *__restrict__ dq_part,     \
      int S, int Sk, int H, int Hk, float scale, float scale_log2

template <int HD, bool kCausal>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_tf32x3_mma_kernel(FLASH_BWD_DKDV_ARGS) {
  dkdv_tf32x3<HD, kCausal, 1>(q, k, v, dout, lse, D, part, B, S, Sk, H, Hk, scale_log2);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_tf32x3_wide_mma_kernel(FLASH_BWD_DKDV_ARGS) {
  dkdv_tf32x3<HD, kCausal, 2>(q, k, v, dout, lse, D, part, B, S, Sk, H, Hk, scale_log2);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(128) flash_bwd_dq_tf32x3_mma_kernel(FLASH_BWD_DQ_ARGS) {
  dq_tf32x3<HD, kCausal, 1>(q, k, v, dout, lse, D, dq, dq_part, S, Sk, H, Hk, scale,
                            scale_log2);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(256) flash_bwd_dq_tf32x3_wide_mma_kernel(FLASH_BWD_DQ_ARGS) {
  dq_tf32x3<HD, kCausal, 2>(q, k, v, dout, lse, D, dq, dq_part, S, Sk, H, Hk, scale,
                            scale_log2);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What a call launched, for the caller to read back: launched[0] the body of
// its dK/dV and dQ kernels, launched[1] the dQ grid's key ranges.
constexpr int kBodyTf32x3 = 0;
constexpr int kBodyMma = 1;
constexpr int kBodyWideMma = 2;
constexpr int kBodyTf32x3Wide = 3;

template <int HD, bool kCausal, typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* D, float* part,
                         float* dq_part, void* dq, void* dk, void* dv, int B, int S, int Sk,
                         int H, int Hk, int splits, int* launched, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t n_rows = static_cast<int64_t>(B) * S * H;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, D, n_rows, S, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  const unsigned bh = static_cast<unsigned>(B * Hk);
  const int G = H / Hk;
  const int64_t rows = static_cast<int64_t>(S) * G;
  // The dK/dV and dQ kernels of one body: threads a block, shared memory of
  // each, keys a dK/dV block; dQ blocks hold 64 rows.
  const auto run = [&](int body, auto dkdv, auto dqk, int threads, size_t smem_kv,
                       size_t smem_q, int key_tile) -> cudaError_t {
    cudaError_t e;
    if ((e = allow_smem(dkdv, smem_kv)) != cudaSuccess) return e;
    if ((e = allow_smem(dqk, smem_q)) != cudaSuccess) return e;
    const dim3 grid_kv(static_cast<unsigned>((Sk + key_tile - 1) / key_tile), bh,
                       static_cast<unsigned>(G));
    dkdv<<<grid_kv, threads, smem_kv, stream>>>(qt, kt, vt, dot, lse, D, part, B, S, Sk, H,
                                                Hk, scale_log2);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const dim3 grid_q(static_cast<unsigned>((rows + kMmaTile - 1) / kMmaTile), bh,
                      static_cast<unsigned>(splits));
    dqk<<<grid_q, threads, smem_q, stream>>>(qt, kt, vt, dot, lse, D, static_cast<T*>(dq),
                                             dq_part, S, Sk, H, Hk, scale, scale_log2);
    launched[0] = body;
    launched[1] = static_cast<int>(grid_q.z);
    return cudaGetLastError();
  };
  // f32 and bf16 each on their tensor-core bodies: 4 warps at hd 32 and 64,
  // 8 at hd 128 and 160.
  if constexpr (std::is_same<T, float>::value && HD <= 64) {
    using L = Tf32Smem<HD, 1>;
    err = run(kBodyTf32x3, flash_bwd_dkdv_tf32x3_mma_kernel<HD, kCausal>,
              flash_bwd_dq_tf32x3_mma_kernel<HD, kCausal>, 128, L::kDkdvBytes, L::kDqBytes,
              kMmaTile);
  } else if constexpr (std::is_same<T, float>::value) {
    using L = Tf32Smem<HD, 2>;
    err = run(kBodyTf32x3Wide, flash_bwd_dkdv_tf32x3_wide_mma_kernel<HD, kCausal>,
              flash_bwd_dq_tf32x3_wide_mma_kernel<HD, kCausal>, 256, L::kDkdvBytes,
              L::kDqBytes, kMmaTile);
  } else if constexpr (HD <= 64) {
    err = run(kBodyMma, flash_bwd_dkdv_mma_kernel<HD, kCausal>,
              flash_bwd_dq_mma_kernel<HD, kCausal>, kMmaThreads, MmaSmem<HD>::kBytes,
              MmaSmem<HD>::kBytes, kMmaTile);
  } else {
    err = run(kBodyWideMma, flash_bwd_dkdv_wide_mma_kernel<HD, kCausal>,
              flash_bwd_dq_wide_mma_kernel<HD, kCausal>, kWideThreads,
              WideSmem<HD>::kDkdvBytes, WideSmem<HD>::kDqBytes, kMmaTile);
  }
  if (err != cudaSuccess) return err;
  // dk and dv: the G shares of each KV head summed in head order; dq, when
  // split, its partials in range order; each cast once.
  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;
  const int64_t nq = splits > 1 ? n_rows * HD : 0;
  const int64_t red_blocks = (n + nq + 255) / 256 < 4096 ? (n + nq + 255) / 256 : 4096;
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(red_blocks), 256, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), n, G, dq_part, static_cast<T*>(dq), nq,
      splits, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* D, float* part,
                      float* dq_part, void* dq, void* dk, void* dv, int B, int S, int Sk, int H,
                      int Hk, int splits, bool is_bf16, bool causal, int* launched,
                      cudaStream_t stream) {
  if (is_bf16) {
    return causal ? launch_typed<HD, true, bf16>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                 dk, dv, B, S, Sk, H, Hk, splits, launched,
                                                 stream)
                  : launch_typed<HD, false, bf16>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                  dk, dv, B, S, Sk, H, Hk, splits, launched,
                                                  stream);
  }
  return causal ? launch_typed<HD, true, float>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                dk, dv, B, S, Sk, H, Hk, splits, launched,
                                                stream)
                : launch_typed<HD, false, float>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                 dk, dv, B, S, Sk, H, Hk, splits, launched,
                                                 stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  hd: 32, 64, 128 or 160.  q, o, dout and
// dq are (B, S, H, hd), k, v, dk and dv (B, Sk, Hk, hd), all contiguous; lse
// and D are f32 (B, H, S), lse from the forward, D scratch; part is f32
// scratch of 2 * H * B * Sk * hd elements (the heads' dk and dv shares).
// dq_splits: the key ranges of the dq walk (1 <= dq_splits <= 65535); above
// 1, dq_part is f32 scratch of dq_splits * B * S * H * hd elements (the
// ranges' partials), else unused.  H % Hk == 0, B * Hk <= 65535,
// H / Hk <= 65535; the wrapper checks all of it.  On success launched[0]
// holds the body the call ran (0 = 3xTF32 mma, 1 = mma, 2 = wide mma, 3 =
// 3xTF32 wide mma) and
// launched[1] the key ranges of the dQ grid it launched.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* D, float* part,
                               float* dq_part, void* dq, void* dk, void* dv, int B, int S,
                               int Sk, int H, int Hk, int hd, int dtype, int causal,
                               int dq_splits, int* launched, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dq_splits < 1 || dq_splits > 65535 || (dq_splits > 1 && dq_part == nullptr) ||
      launched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool is_bf16 = dtype == 1;
  const bool c = causal != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      err = launch_hd<32>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                          Hk, dq_splits, is_bf16, c, launched, st);
      break;
    case 64:
      err = launch_hd<64>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                          Hk, dq_splits, is_bf16, c, launched, st);
      break;
    case 128:
      err = launch_hd<128>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                           Hk, dq_splits, is_bf16, c, launched, st);
      break;
    case 160:
      err = launch_hd<160>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                           Hk, dq_splits, is_bf16, c, launched, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
