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
// The FlashAttention-2 split, three or four launches, no atomics,
// deterministic:
//   1. flash_bwd_dot_kernel: D, at the bytes of o and dO (16-byte loads,
//      several rows a warp);
//   2. flash_bwd_dkdv_*kernel: one block per (key tile, batch, KV head, head
//      group) walks, head after head of its group, the 64-position tiles of
//      that head's queries that can see its keys (causal: from the tile
//      holding position k0 on), recomputes P and dS for each and
//      accumulates the group's share of dk and dv in registers, stored in f32
//      (the f32 bodies: one head a group, G shares; the bf16 body: as few
//      groups as keep the grid balanced, and where that is one, dk and dv
//      themselves in bf16, no share);
//   3. flash_bwd_dq_*kernel: one block per (64-row tile of folded rows,
//      batch, KV head, key range) walks the key tiles of its range up to its
//      causal limit and accumulates dq.  The wrapper picks the number of
//      ranges (flash_attention.py::dq_splits): 1 where the row tiles fill the
//      card, and the block then writes dq itself; more where a short query
//      sequence leaves SMs idle (whisper's 64 decoder positions against 1500
//      frames), and each block then writes an f32 partial dq;
//   4. flash_bwd_reduce_kernel, where there are shares or partials: dk and
//      dv, each the sum of its KV head's shares in group order, and dq, the
//      sum of its partials in range order when split, all in f32, scaled and
//      cast once.
// The dK/dV and dQ kernels each recompute q k^T and dO v^T for their tiles,
// so together they do seven tile products where a fused kernel with atomics
// would do five.
//
// What bounds it.  At the training shapes (2 x 512 tokens, 32/4 heads, hd
// 64; 1 x 512, 32/8 heads, hd 128; causal) the five products the gradient
// needs are ~5.4 GFLOP: in bf16 the bytes moved (5.7-6.3 us at 3.35 TB/s)
// and the operations (~5.5 us at 989 TFLOP/s) about equal, bytes by a
// little; in f32 the operations (~33 us at 3xTF32's 495 / 3 TFLOP/s).  The
// dK/dV and dQ kernels have two kinds of bodies, picked at compile time by
// dtype and head dim:
//   * bf16 at every head dim: wgmma products on tiles TMA loads under
//     mbarriers, a producer and consumer warpgroups (csrc/hopper_wgmma.cuh);
//     described above flash_bwd_dkdv_wgmma_kernel below;
//   * f32 at hd 32 and 64: wgmma in 3xTF32 on tiles TMA loads and a
//     producer warpgroup splits once into their TF32 parts (and transposes
//     where a product reads them MN-major), bound by shared memory's
//     bandwidth, which the products' operand reads and the split share;
//     described above Tf32DqTile below;
//   * f32 at hd 128 and 160: mma.sync TF32 in 3xTF32, 8 warps in pairs, f32
//     tiles swizzled in shared memory, the score accumulators permuted so
//     they are the A fragments of the accumulating products as they stand;
//     described above dkdv_tf32x3 below.
//     (Whisper's encoder and cross-attention train in f32: JAX promotes
//     their f32 frames.)

// Plain C interface, built by nvcc into a shared library and called through
// ctypes from repro_torch/kernels/flash_attention.py.  The launch encodes
// the bf16 bodies' TMA descriptors on the host, enqueues on the caller's
// stream, does not synchronise and allocates nothing (D's, the f32 shares'
// and dq's partials' buffers come from the wrapper); it returns
// cudaGetLastError() (or hopper::kTmaEncodeError / kHandOverError) and
// reports the body, the dQ key ranges, the grids and the kernels it
// launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_wgmma.cuh"

namespace {

#include "flash_tf32x3.cuh"

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

// A 16-byte chunk of o and of dO: the sum of its elements' products.
__device__ __forceinline__ float dot_chunk(uint4 a, uint4 d, const float*) {
  float acc = __uint_as_float(a.x) * __uint_as_float(d.x);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(d.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(d.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(d.w), acc);
}
__device__ __forceinline__ float dot_chunk(uint4 a, uint4 d, const bf16*) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, dw[4] = {d.x, d.y, d.z, d.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// D[b, h, s] = sum_d dO[b, s, h, d] * o[b, s, h, d].  Bound by the bytes of o
// and dO: each lane reads 16-byte chunks (8 bf16 or 4 f32), kLanes lanes a
// row (the largest power of two up to its chunks, at most 32), 32 / kLanes
// rows a warp, then sums over its row's lanes.
template <typename T, int HD>
struct DotTile {
  static constexpr int kChunks = HD * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLanes = kChunks >= 32 ? 32 : kChunks >= 16 ? 16 : kChunks >= 8 ? 8 : 4;
  static constexpr int kRowsPerWarp = 32 / kLanes;
  static constexpr int kRowsPerBlock = 8 * kRowsPerWarp;  // 256 threads
  static_assert(HD * sizeof(T) % 16 == 0 && kChunks >= 4, "whole 16-byte chunks");
};

template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ D, int64_t n_rows, int S, int H) {
  using L = DotTile<T, HD>;
  const int lane = threadIdx.x % 32;
  const int sub = lane % L::kLanes;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * L::kRowsPerBlock +
                    (threadIdx.x / 32) * L::kRowsPerWarp + lane / L::kLanes;
  float acc = 0.f;
  if (r < n_rows) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + r * HD);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + r * HD);
#pragma unroll
    for (int i = 0; i < (L::kChunks + L::kLanes - 1) / L::kLanes; ++i) {
      const int c = sub + i * L::kLanes;
      if (c < L::kChunks) acc += dot_chunk(__ldg(orow + c), __ldg(drow + c), o);
    }
  }
#pragma unroll
  for (int off = L::kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && r < n_rows) {
    const int h = static_cast<int>(r % H);
    const int64_t bs = r / H;  // b * S + s
    D[(bs / S * H + h) * S + bs % S] = acc;
  }
}

// dk = scale * sum_z dk_share[z], dv = sum_z dv_share[z] over the `shares`
// shares of each KV head (its head groups, in group order); then, when the
// dq kernel's key walk was split into `splits` ranges, dq = scale * sum_z
// dq_part[z] in range order.  f32, cast once.  n = 0 where the dK/dV kernel
// wrote dk and dv itself.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                        T* __restrict__ dv, int64_t n, int shares,
                        const float* __restrict__ dq_part, T* __restrict__ dq, int64_t nq,
                        int splits, float scale) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n + nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < n) {
      float sk = 0.f, sv = 0.f;
      for (int z = 0; z < shares; ++z) {
        sk += part[z * n + i];
        sv += part[(shares + z) * n + i];
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

// ------------------------------------------------- bf16 bodies, wgmma + TMA
//
// For bf16 the dK/dV and dQ kernels are Hopper's own route
// (csrc/hopper_wgmma.cuh): every product a warpgroup wgmma (m64nNk16, f32
// accumulators in registers), operands in shared memory where TMA put them,
// a producer (one thread issuing the copies) keeping a ring of kStages
// streamed tiles full under mbarriers, consumer warpgroups computing.  P and
// dS are rounded to bf16 as the A operands (from registers) of the
// accumulating products, as FlashAttention-2 does.
//
// dK/dV: one block per (64 keys, batch, KV head, head group): two consumer
// warpgroups at hd 32 and 64 (one above, DkdvTile), each reading the keys'
// k and v tiles (TMA, once a block) and holding its own dK and dV
// accumulators (hd / 2 floats a thread each), and a producer warpgroup that
// hands its registers to them (setmaxnreg: 240 a consumer thread at hd 64,
// 232 at hd 32).  The
// query rows of the group's heads, head after head, stream through the
// ring in tiles of kRows (64, or 32 at hd 128 and 160), with their dO tile
// and their lse and D (copied by the producer's first warp's lanes); the
// consumer warpgroups take the streamed tiles in turn, so one's
// elementwise pass runs under the other's products and neither waits on
// the other.  For each: S^T = k q^T and dP^T = v dO^T (ss, q and dO
// K-major), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T q
// (rs, dO and q as the transposed, MN-major operand).  At the end the
// second warpgroup hands its sums to the first through shared memory, which
// adds them in that order.  A causal block starts at the tile holding its
// first key and skips none after it.  A group of several heads writes one
// f32 share for them all, so the shares (and the reduce that sums them)
// shrink by the group's size; where one group holds all G heads, the block
// writes dk and dv in bf16 itself and no share is made.  The wrapper picks
// the groups (flash_attention.py::dkdv_head_groups): as few as keep the
// heaviest block within the grid's average per warpgroup.
//
// dQ: one block per (64 folded rows, batch, KV head, key range): q and dO
// of the tile as the forward's padded boxes (P = 64 / G positions of the G
// heads; padding rows zeroed, never stored), one consumer warpgroup and a
// producer warp, two blocks an SM where the registers allow (hd <= 128), so
// one block's elementwise pass runs under the other's products; the K/V
// tiles of its range stream through the ring in tiles of 64 keys.  For
// each: S = q k^T and dP = dO v^T (ss), dS in registers, dQ += dS k (rs, k
// MN-major).

constexpr int kMmaTile = 64;  // keys (dK/dV) or rows (dQ) a block of the f32 bodies

using hopper::smem_u32;

// dK/dV: kConsumers warpgroups on a block's 64 keys.  Two at hd 32 and 64:
// a producer warpgroup hands them its registers (384 threads, 240 a
// consumer thread), which hold dK and dV beside S^T and dP^T (kRows / 2
// each), one block an SM.  One at hd 128 and 160, where 240 spilled (ptxas:
// 140 and 880 bytes): a producer warp (160 threads, up to 255 registers).  Shared memory: k, v,
// q[kStages], dO[kStages], lse[kStages], D[kStages], the second consumer's
// sums (f32), then the mbarriers; each bf16 tile 1024-byte aligned.  TMA
// copies the bf16 tiles; the producer's lanes copy lse and D (a row's 4
// bytes: TMA wants a box to start 16-byte aligned, which (b, h)'s rows of S
// floats do not when S % 4 != 0).
template <int HD>
struct DkdvTile {
  static constexpr int kConsumers = HD <= 64 ? 2 : 1;
  static constexpr int kThreads = kConsumers == 2 ? hopper::kHandOverThreads : 128 + 32;
  static constexpr int kKeys = 64;
  static constexpr int kRows = HD <= 64 ? 64 : 32;  // query rows a streamed tile
  static constexpr int kStages = HD <= 64 ? 4 : 2;  // two a consumer warpgroup
  static constexpr int kKBytes = kKeys * HD * 2;  // k (or v)
  static constexpr int kQBytes = kRows * HD * 2;  // one streamed q (or dO)
  static constexpr int kStatBytes = kRows * 4;    // its lse (or D)
  static constexpr int kMergeBytes = kConsumers > 1 ? 128 * HD * 4 : 0;
  static constexpr size_t kBytes = 1024 + 2 * kKBytes +
                                   kStages * (2 * kQBytes + 2 * kStatBytes) + kMergeBytes +
                                   8 * (1 + 2 * kStages);
  static_assert(kConsumers == 1 || kConsumers == 2, "one or two consumer warpgroups");
  static_assert(kStages % kConsumers == 0, "each ring slot has one consuming warpgroup");
  static_assert(kQBytes % 1024 == 0, "streamed tiles stay 1024-byte aligned");
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// dQ: one consumer warpgroup and a producer warp, two blocks an SM (up to
// 168 registers a thread, as ptxas counts it) where that holds dQ, S and dP
// (hd <= 128), one at hd 160.
template <int HD>
struct DqTile {
  static constexpr int kThreads = 128 + 32;
  static constexpr int kBlocksPerSm = HD <= 128 ? 2 : 1;
  static constexpr int kKeys = 64;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = 64 * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;
  // q, dO, k[kStages], v[kStages], then the mbarriers.
  static constexpr size_t kBytes = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes +
                                   8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// A dK/dV block's walk: n_heads heads from h0, each over the n_q streamed
// tiles from t_first, as one stream of n_heads * n_q entries (head after
// head), entry i through ring slot i % kStages.
struct DkdvWalk {
  int h0, n_heads, t_first, n_q;
  __device__ __forceinline__ int total() const { return n_heads * n_q; }
};

// A dK/dV consumer warpgroup: keys kw .. kw + 63 (k and v at Kw, Vw), the
// walk's entries wg, wg + kConsumers, ...; then the sums (the second
// warpgroup's added to the first's) stored: dk and dv in bf16 where the grid
// has one head group, else this group's f32 share.
template <int HD, bool kCausal>
__device__ __forceinline__ void dkdv_consumer(const uint8_t* Kw, const uint8_t* Vw,
                                              const uint8_t* Qs, const uint8_t* dOs,
                                              const float* lse_s, const float* D_s, float* merge,
                                              uint64_t* kv_full, uint64_t* full, uint64_t* empty,
                                              float* __restrict__ part, bf16* __restrict__ dk_out,
                                              bf16* __restrict__ dv_out, int B, int S, int Sk,
                                              int Hk, int kw, DkdvWalk walk, float scale,
                                              float scale_log2) {
  using T = DkdvTile<HD>;
  constexpr int kRows = T::kRows;
  constexpr int kStages = T::kStages;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int t = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const uint32_t k_addr = smem_u32(Kw);
  const uint32_t v_addr = smem_u32(Vw);

  float dk[HD / 2], dv[HD / 2];
  hopper::zero(dk);
  hopper::zero(dv);
  if (wg < walk.total()) hopper::mbar_wait(kv_full, 0);
  for (int hh = 0; hh < walk.n_heads; ++hh) {
    for (int i = 0; i < walk.n_q; ++i) {  // entry hh n_q + i: query tile t_first + i
      const int entry = hh * walk.n_q + i;
      if constexpr (T::kConsumers > 1) {
        if (entry % T::kConsumers != wg) continue;
      }
      const int st = entry % kStages;
      const int row0 = (walk.t_first + i) * kRows;
      hopper::mbar_wait(&full[st], (entry / kStages) & 1);
      const uint32_t q_addr = smem_u32(Qs + st * T::kQBytes);
      const uint32_t do_addr = smem_u32(dOs + st * T::kQBytes);
      const float* lse_b = lse_s + st * kRows;
      const float* D_b = D_s + st * kRows;
      // S^T = k q^T and dP^T = v dO^T: 64 keys x kRows rows.
      float s[kRows / 2], dp[kRows / 2];
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        hopper::Mma<kRows, 0>::ss(s, hopper::desc_k<HD>(k_addr, 64, kk),
                                  hopper::desc_k<HD>(q_addr, kRows, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        hopper::Mma<kRows, 0>::ss(dp, hopper::desc_k<HD>(v_addr, 64, kk),
                                  hopper::desc_k<HD>(do_addr, kRows, kk), kk > 0);
      }
      hopper::commit();
      hopper::wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      // P^T and dS^T in place: element e of n-tile j is key 16 warp + g + 8
      // (e >> 1) of the warpgroup's, row 8 j + 2 c4 + (e & 1) of the tile
      // (lse_b in the log2 domain).  Masks only on tiles that straddle a
      // limit.
      const bool edge = (kCausal && row0 < kw + 63) || row0 + kRows > S || kw + 64 > Sk;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * c4 + (e & 1);
          const int key = kw + 16 * warp + g + 8 * (e >> 1);
          const int pos = row0 + r;
          const bool ok = !edge || (pos < S && key < Sk && (!kCausal || key <= pos));
          // ex2 on every element, then the select: no branch per element.
          const float x = hopper::ex2(fmaf(s[4 * j + e], scale_log2, -lse_b[r]));
          const float p = ok ? x : 0.f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - D_b[r]);
        }
      }
      uint32_t ap[kRows / 16][4], as[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        hopper::acc_as_a(ap[kk], s, kk);
        hopper::acc_as_a(as[kk], dp, kk);
      }
      // dV += P^T dO and dK += dS^T q, k = the tile's rows.
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        hopper::Mma<HD, 1>::rs(dv, ap[kk], hopper::desc_mn<HD>(do_addr, kRows, kk), 1);
        hopper::Mma<HD, 1>::rs(dk, as[kk], hopper::desc_mn<HD>(q_addr, kRows, kk), 1);
      }
      hopper::commit();
      hopper::wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
  }

  if constexpr (T::kConsumers == 2) {  // the second warpgroup's sums to the first
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        merge[i * 128 + t] = dk[i];
        merge[(HD / 2 + i) * 128 + t] = dv[i];
      }
      hopper::bar_arrive(3, 256);
      return;
    }
    hopper::bar_sync(3, 256);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk[i] += merge[i * 128 + t];
      dv[i] += merge[(HD / 2 + i) * 128 + t];
    }
  }
  const bool direct = gridDim.z == 1;
  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;  // one share
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + 16 * warp + g + 8 * i;
    if (key >= Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + 2 * c4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * i;
      if (direct) {
        *reinterpret_cast<uint32_t*>(dk_out + off + 8 * j) =
            hopper::pack_bf16(dk[e] * scale, dk[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv_out + off + 8 * j) = hopper::pack_bf16(dv[e], dv[e + 1]);
      } else {
        *reinterpret_cast<float2*>(part + static_cast<int64_t>(blockIdx.z) * n + off + 8 * j) =
            make_float2(dk[e], dk[e + 1]);
        *reinterpret_cast<float2*>(part + static_cast<int64_t>(gridDim.z + blockIdx.z) * n + off +
                                   8 * j) = make_float2(dv[e], dv[e + 1]);
      }
    }
  }
}

// Grid (ceil(Sk / 64), B * Hk, head groups): block (x, y, z) holds keys 64 x
// .. of KV head y % Hk of batch y / Hk and the heads of group z, kvh * G + z
// * per .. (per = ceil(G / groups), the last group the rest).  Consumer
// warpgroups first, the producer last.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(DkdvTile<HD>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ D,
                            float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int B, int S, int Sk, int H, int Hk, float scale, float scale_log2) {
  using T = DkdvTile<HD>;
  using A = hopper::Atoms<HD>;
  // ptxas spilled the consumers at hd 64 with 40 / 232, the producer at hd
  // 32 with 24 / 240.
  using HandOver = hopper::HandOver<HD == 32 ? 40 : 24>;
  constexpr int kRows = T::kRows;
  constexpr int kStages = T::kStages;
  constexpr int kNC = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = hopper::align1024(smem_raw);
  uint8_t* Vs = Ks + T::kKBytes;
  uint8_t* Qs = Vs + T::kKBytes;
  uint8_t* dOs = Qs + kStages * T::kQBytes;
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * T::kQBytes);
  float* D_s = lse_s + kStages * kRows;
  float* merge = D_s + kStages * kRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(merge) +
                                                  T::kMergeBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int per = (G + static_cast<int>(gridDim.z) - 1) / static_cast<int>(gridDim.z);
  const int k0 = blockIdx.x * T::kKeys;
  DkdvWalk walk;
  walk.h0 = kvh * G + static_cast<int>(blockIdx.z) * per;
  walk.n_heads = max(0, min(per, G - static_cast<int>(blockIdx.z) * per));
  // Causal: positions below k0 see none of the keys (k0 is a tile multiple).
  walk.t_first = kCausal ? k0 / kRows : 0;
  walk.n_q = max(0, (S + kRows - 1) / kRows - walk.t_first);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the copies' arrival, each lane's
      hopper::mbar_init(&empty[s], 4);      // the consuming warpgroup's warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kNC * 128) {  // ---- producer: its first warp copies
    if constexpr (kNC == 2) HandOver::producer();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < kNC * 128 + 32 && walk.total() > 0) {
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * T::kKBytes);
        for (int a = 0; a < A::kCount; ++a) {
          const int off = a * T::kKeys * A::kRowBytes;
          hopper::tma_load_4d(Ks + off, &k_map, kv_full, a * A::kCols, kvh, k0, b);
          hopper::tma_load_4d(Vs + off, &v_map, kv_full, a * A::kCols, kvh, k0, b);
        }
      }
      for (int hh = 0; hh < walk.n_heads; ++hh) {
        const int h = walk.h0 + hh;
        const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
        for (int i = 0; i < walk.n_q; ++i) {  // entry hh n_q + i: query tile t_first + i
          const int entry = hh * walk.n_q + i;
          const int st = entry % kStages;
          const int row0 = (walk.t_first + i) * kRows;
          if (entry >= kStages) hopper::mbar_wait(&empty[st], (entry / kStages - 1) & 1);
          if (lane == 0) {
            hopper::mbar_expect_tx(&full[st], 2 * T::kQBytes);
            for (int a = 0; a < A::kCount; ++a) {
              const int off = st * T::kQBytes + a * kRows * A::kRowBytes;
              hopper::tma_load_4d(Qs + off, &q_map, &full[st], a * A::kCols, h, row0, b);
              hopper::tma_load_4d(dOs + off, &do_map, &full[st], a * A::kCols, h, row0, b);
            }
          }
          for (int r = lane; r < kRows; r += 32) {
            const bool ok = row0 + r < S;
            lse_s[st * kRows + r] = ok ? lse[stat0 + row0 + r] * kLog2e : 0.f;
            D_s[st * kRows + r] = ok ? D[stat0 + row0 + r] : 0.f;
          }
          hopper::mbar_arrive(&full[st]);  // releases this lane's lse and D
        }
      }
    }
  } else {  // ---- consumer warpgroups: keys k0 .. k0 + 63
    if constexpr (kNC == 2) HandOver::consumer();
    dkdv_consumer<HD, kCausal>(Ks, Vs, Qs, dOs, lse_s, D_s, merge, kv_full, full, empty, part, dk,
                               dv, B, S, Sk, Hk, k0, walk, scale, scale_log2);
  }
}

// The dQ block's consumer warpgroup: the folded tile from position p0 (q
// at Qs, dO at dOs), key tiles [kt0, kt1) through the ring.
template <int HD, bool kCausal>
__device__ __forceinline__ void dq_consumer(uint8_t* Qs, uint8_t* dOs, const uint8_t* Ks,
                                            const uint8_t* Vs, uint64_t* q_full, uint64_t* full,
                                            uint64_t* empty, const float* __restrict__ lse,
                                            const float* __restrict__ D, bf16* __restrict__ dq,
                                            float* __restrict__ dq_part, int S, int Sk, int H,
                                            int Hk, int P, int p0, int kt0, int kt1, float scale,
                                            float scale_log2) {
  using T = DqTile<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int rows_real = P * G;
  if (rows_real < 64) {  // padding rows no box fills: zero, so they stay finite
    for (int i = t; i < (64 - rows_real) * (HD / 8); i += 128) {
      const int r = rows_real + i / (HD / 8);
      const uint32_t off = hopper::swizzled<HD>(64, r, (i % (HD / 8)) * 8);
      *reinterpret_cast<uint4*>(Qs + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dOs + off) = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async_smem();
  }
  hopper::bar_sync(1, 128);

  int row[2], pos[2];
  bool ok[2];
  float lse2[2], Dr[2];
  int64_t stat[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = 16 * warp + g + 8 * i;
    pos[i] = p0 + row[i] / G;
    ok[i] = row[i] < rows_real && pos[i] < S;
    stat[i] = (static_cast<int64_t>(b) * H + kvh * G + row[i] % G) * S + pos[i];
    lse2[i] = ok[i] ? lse[stat[i]] * kLog2e : 0.f;
    Dr[i] = ok[i] ? D[stat[i]] : 0.f;
  }
  const uint32_t q_addr = smem_u32(Qs);
  const uint32_t do_addr = smem_u32(dOs);

  float acc[HD / 2];
  hopper::zero(acc);
  if (kt0 < kt1) hopper::mbar_wait(q_full, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    const int st = i % kStages;
    const int k0 = kt * kKeys;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    const uint32_t k_addr = smem_u32(Ks + st * T::kKVBytes);
    const uint32_t v_addr = smem_u32(Vs + st * T::kKVBytes);
    // S = q k^T and dP = dO v^T: 64 rows x 64 keys.
    float s[kKeys / 2], dp[kKeys / 2];
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hopper::Mma<kKeys, 0>::ss(s, hopper::desc_k<HD>(q_addr, 64, kk),
                                hopper::desc_k<HD>(k_addr, kKeys, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hopper::Mma<kKeys, 0>::ss(dp, hopper::desc_k<HD>(do_addr, 64, kk),
                                hopper::desc_k<HD>(v_addr, kKeys, kk), kk > 0);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // dS in place of S: element e of n-tile j is row r[e >> 1], key 8 j +
    // 2 c4 + (e & 1) of the tile.  Masks only on tiles that straddle a
    // limit: elsewhere a padding row or one past S has zero q and dO rows,
    // so its dS is 0 (and it is never stored).
    const bool edge = (kCausal && k0 + kKeys - 1 > p0) || k0 + kKeys > Sk;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        const int key = k0 + 8 * j + 2 * c4 + (e & 1);
        const bool live = !edge || (ok[ii] && key < Sk && (!kCausal || key <= pos[ii]));
        const float x = hopper::ex2(fmaf(s[4 * j + e], scale_log2, -lse2[ii]));
        const float p = live ? x : 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - Dr[ii]);
      }
    }
    uint32_t as[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) hopper::acc_as_a(as[kk], s, kk);
    // dQ += dS k, k = the tile's keys (k the transposed operand).
    hopper::fence_regs(acc);
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      hopper::Mma<HD, 1>::rs(acc, as[kk], hopper::desc_mn<HD>(k_addr, kKeys, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  const bool whole = gridDim.z == 1;
  float* part = dq_part + (whole ? 0 : dq_part_base(S, H, Hk, HD));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    const int64_t off = ((static_cast<int64_t>(b) * S + pos[i]) * H + kvh * G + row[i] % G) * HD +
                        2 * c4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i], x1 = acc[4 * j + 2 * i + 1];
      if (whole) {
        *reinterpret_cast<uint32_t*>(dq + off + 8 * j) = hopper::pack_bf16(x0 * scale, x1 * scale);
      } else {
        *reinterpret_cast<float2*>(part + off + 8 * j) = make_float2(x0, x1);
      }
    }
  }
}

// Grid (ceil(S / P), B * Hk, key ranges): block (x, y, z) holds positions
// P x .. of the G heads of KV head y % Hk of batch y / Hk, and walks key
// range z of its visible key tiles (key_range).  Whole walk (gridDim.z ==
// 1): dq scaled and cast; else its unscaled f32 partial into dq_part.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(DqTile<HD>::kThreads, DqTile<HD>::kBlocksPerSm)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ D,
                          bf16* __restrict__ dq, float* __restrict__ dq_part, int S, int Sk, int H,
                          int Hk, int P, float scale, float scale_log2) {
  using T = DqTile<HD>;
  using A = hopper::Atoms<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* dOs = Qs + T::kQBytes;
  uint8_t* Ks = dOs + T::kQBytes;
  uint8_t* Vs = Ks + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * T::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y % Hk);
  const int b = static_cast<int>(blockIdx.y / Hk);
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int p0 = tile * P;
  int n_tiles = (Sk + kKeys - 1) / kKeys;
  if (kCausal) n_tiles = min(n_tiles, (min(p0 + P, S) - 1) / kKeys + 1);
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- producer warp
    if (threadIdx.x == 128 && kt0 < kt1) {
      hopper::mbar_expect_tx(q_full, 2 * HD * G * P * 2);
      for (int a = 0; a < A::kCount; ++a) {
        const int off = a * 64 * A::kRowBytes;
        hopper::tma_load_5d(Qs + off, &q_map, q_full, a * A::kCols, 0, kvh, p0, b);
        hopper::tma_load_5d(dOs + off, &do_map, q_full, a * A::kCols, 0, kvh, p0, b);
      }
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0;
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[st], (i / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[st], 2 * T::kKVBytes);
        for (int a = 0; a < A::kCount; ++a) {
          const int off = st * T::kKVBytes + a * kKeys * A::kRowBytes;
          hopper::tma_load_4d(Ks + off, &k_map, &full[st], a * A::kCols, kvh, kt * kKeys, b);
          hopper::tma_load_4d(Vs + off, &v_map, &full[st], a * A::kCols, kvh, kt * kKeys, b);
        }
      }
    }
  } else {  // ---- consumer warpgroup: folded rows r = 16 warp + g (+ 8)
    dq_consumer<HD, kCausal>(Qs, dOs, Ks, Vs, q_full, full, empty, lse, D, dq, dq_part, S, Sk, H,
                             Hk, P, p0, kt0, kt1, scale, scale_log2);
  }
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

// ------------------------------------------------- f32 bodies, 3xTF32
//
// At hd 128 and 160 f32 runs the structure of the bf16 bodies on
// mma.sync.m16n8k8 TF32 in 3xTF32: each operand split once, as it is read,
// into a TF32 big part and the remainder (split_tf32, csrc/rwkv_scan.cu's),
// and big * big + big * small + small * big accumulated in f32, which holds
// the f32 tolerance (1e-4 of max |grad|) that one TF32 product does not.  The
// five products (q k^T, dO v^T, dV, dK, dQ) each run so.  dK/dV: one block
// per (64-key tile, batch, query head); dQ: one block per (64 folded rows,
// batch, KV head, key range), as the bf16 bodies.  8 warps, warps w and w +
// 4 a pair sharing 16 keys (rows), each forming the score products of half
// the streamed tile's rows (keys) and accumulating half of hd's columns.
// What the design does:
//   * f32 tiles of 64 rows x hd, no padding, their 16-byte column chunks
//     XOR-swizzled by row (swz), so the fragment reads of both products,
//     8 rows x 4 columns and 4 rows x 8 columns, fall in 32 distinct banks.
//     The A operands of the score products (k and v, or q and dO) are read
//     from the tiles each k-step, which keeps a thread's registers to the
//     accumulators;
//   * the rows (keys) inside each 8-wide n-tile of the score accumulators
//     are permuted (column 2t holds row t, column 2t + 1 row t + 4), so that
//     P^T and dS^T (dS) in the accumulators are, as they stand, the A
//     fragments of dV += P^T dO and dK += dS^T q (dQ += dS k).  Each lane
//     passes its accumulators to the same lane of its pair's other warp
//     through shared memory, in f32, one float4 a lane and n-tile;
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
// n-tiles, 4 pairs x 8 n-tiles x 32 lanes x 4 floats.
template <int HD>
struct Tf32Smem {
  static constexpr int kTile = kMmaTile * HD;
  static constexpr int kX = 4 * 8 * 32 * 4;
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
template <int HD, bool kCausal>
__device__ __forceinline__ void dkdv_tf32x3(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ D,
                                            float* __restrict__ part, int B, int S, int Sk,
                                            int H, int Hk, float scale_log2) {
  using L = Tf32Smem<HD>;
  constexpr int kNThreads = 256;
  constexpr int kBufs = L::kDkdvBufs;
  constexpr int kTile = L::kTile;
  constexpr int kDK = HD / 8;           // k-steps over hd
  constexpr int kRN = 4;  // the warp's n-tiles of the q tile's rows
  constexpr int kCN = HD / 16;  // the warp's n-tiles of dK's and dV's columns
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
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int at4 = (wp * 8 + j0 + j) * 32 + lane;
      Xp[at4] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
      Xs[at4] = make_float4(dpt[j][0], dpt[j][1], dpt[j][2], dpt[j][3]);
    }
    __syncthreads();  // the pair's P^T and dS^T are whole
    // dV += P^T dO and dK += dS^T q on the warp's columns, k = the tile's rows.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 8; ++kk) {
      float pa[4], sa[4];
      const float4 x = Xp[(wp * 8 + kk) * 32 + lane];
      const float4 y = Xs[(wp * 8 + kk) * 32 + lane];
      pa[0] = x.x, pa[1] = x.y, pa[2] = x.z, pa[3] = x.w;
      sa[0] = y.x, sa[1] = y.y, sa[2] = y.z, sa[3] = y.w;
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
template <int HD, bool kCausal>
__device__ __forceinline__ void dq_tf32x3(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ D, float* __restrict__ dq,
                                          float* __restrict__ dq_part, int S, int Sk, int H,
                                          int Hk, float scale, float scale_log2) {
  using L = Tf32Smem<HD>;
  constexpr int kNThreads = 256;
  constexpr int kBufs = L::kDqBufs;
  constexpr int kTile = L::kTile;
  constexpr int kDK = HD / 8;
  constexpr int kKN = 4;  // the warp's n-tiles of the key tile
  constexpr int kCN = HD / 16;  // the warp's n-tiles of dQ's columns
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
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
      Xd[(wp * 8 + j0 + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    __syncthreads();  // the pair's dS is whole
    // dQ += dS k on the warp's columns, k = the tile's keys.
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 8; ++kk) {
      float da[4];
      const float4 x = Xd[(wp * 8 + kk) * 32 + lane];
      da[0] = x.x, da[1] = x.y, da[2] = x.z, da[3] = x.w;
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

// The f32 kernels at hd 128 and 160: 8 warps in pairs.
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
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_tf32x3_wide_mma_kernel(FLASH_BWD_DKDV_ARGS) {
  dkdv_tf32x3<HD, kCausal>(q, k, v, dout, lse, D, part, B, S, Sk, H, Hk, scale_log2);
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(256) flash_bwd_dq_tf32x3_wide_mma_kernel(FLASH_BWD_DQ_ARGS) {
  dq_tf32x3<HD, kCausal>(q, k, v, dout, lse, D, dq, dq_part, S, Sk, H, Hk, scale,
                            scale_log2);
}

// ------------------------------------------- f32 bodies on wgmma, 3xTF32
//
// At hd 32 and 64 (whisper's encoder and cross-attention, the f32 training
// shape) the f32 dK/dV and dQ kernels run every product on Hopper's
// warpgroup wgmma in TF32, as three (small x big, big x small, big x big
// into one f32 accumulator), on tiles split once into their TF32 parts in
// shared memory.  The mma.sync bodies above split every operand at every
// warp's read, about two issue slots beside each product.  TMA lands each
// streamed tile raw (dQ: where its big part goes; dK/dV: in a raw ring of
// its own); three splitter warps of the producer warpgroup round it into its
// big part beside its remainder and, for an operand a product reads
// transposed (.tf32 has no transpose), write the transposed copy
// (flash_tf32x3.cuh: split_copy, transpose32, its rows permuted by sigma8
// so each score accumulator is its A fragment as it stands).  A stage is
// "ready" once split: the consumers never wait on raw tiles.  Shared memory
// is the budget (f32 tiles are twice bf16's, and each is held twice, big and
// small), and its bandwidth what bounds them: the products' operand reads
// and the split pass share it, so operands that stay put (k and v in dK/dV,
// q and dO in dQ) hold their big parts in registers:
//   * dK/dV: one block per (64 keys, batch, query head), as the mma.sync
//     bodies' grid: k and v split once (64 KB at hd 64), then the head's
//     query rows streamed in tiles of 32 -- q, dO and their transposed
//     copies, 64 KB a stage at hd 64, two stages, beside a raw ring of two
//     where TMA lands q and dO (2 x 16 KB), so no copy waits on the
//     consumer -- into one consumer warpgroup: S^T = k q^T and dP^T = v
//     dO^T (ss), P^T and dS^T in registers, dV += P^T dO and dK += dS^T q
//     (rs, dO^T and q^T).  k's and v's big parts are held as the A
//     fragments of the score products in registers (rs), so only small x
//     big reads its A from shared memory.  256 threads, up to 255 registers
//     each; one block an SM.  At one query head a KV head (G = 1: whisper)
//     the block writes dk and dv itself; else the G shares and their reduce
//     are the mma.sync bodies';
//   * dQ: one block per (128 folded rows, batch, KV head, key range): two
//     consumer warpgroups, each with its 64 rows' q and dO split once (their
//     big parts as A fragments in registers, the small parts in shared
//     memory, 32 KB at hd 64), take the same 32-key tiles of k, v and k^T
//     (48 KB a stage, three stages at hd 64): S = q k^T and dP = dO v^T
//     (rs, and ss for small x big), dS in registers, dQ += dS k (rs, k^T);
//     the producer hands them its registers (setmaxnreg).  Where all the
//     folded rows of a (batch, KV head) fit one warpgroup (whisper's 64
//     decoder positions) the two share them and take the tiles in turn.
//     The key ranges and partials are the mma.sync bodies'.
// At hd 128 and 160 the f32 backward keeps the 8-warp mma.sync bodies: one
// dK/dV stage of 32 rows is 8 x 16 KB = 128 KB beside k and v's parts (128
// KB, or 64 KB with their big parts in 128 registers a thread), and dQ's
// q and dO big parts would take 128 registers a thread, their small parts
// 64 KB a consumer beside a 96 KB stage: no ring of two stages fits.

template <int HD>
struct Tf32DqTile {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = hopper::kHandOverThreads;  // two consumers, the producer
  static constexpr int kRows = 64 * kConsumers;  // folded rows a block
  static constexpr int kKeys = 32;
  static constexpr int kRowPart = 64 * HD * 4;   // a consumer's q or dO, one part
  static constexpr int kOwn = 2 * kRowPart;      // q small, dO small (the big parts in registers)
  static constexpr int kPart = kKeys * HD * 4;   // k, v or k^T, one part
  static constexpr int kStageBytes = 6 * kPart;  // k, v, k^T: big and small
  static constexpr int kMaxStages = 4;
  static constexpr int kBarBytes = 8 * 3 * kMaxStages;
  static constexpr int kFit =
      (232448 - 1024 - kBarBytes - kConsumers * kOwn) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = 1024 + static_cast<size_t>(kConsumers) * kOwn +
                                   static_cast<size_t>(kStages) * kStageBytes + kBarBytes;
  static_assert(HD == 32 || HD == 64, "the wgmma f32 bodies serve hd 32 and 64");
  static_assert(kStages >= 2, "a stage splits while the consumers read the other");
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

template <int HD>
struct Tf32DkdvTile {
  static constexpr int kConsumers = 1;
  static constexpr int kThreads = 256;  // the consumer warpgroup, the producer warpgroup
  static constexpr int kKeys = 64;
  static constexpr int kRows = 32;  // query rows a streamed tile
  static constexpr int kKVPart = kKeys * HD * 4;
  static constexpr int kOwn = 4 * kKVPart;       // k big, k small, v big, v small
  static constexpr int kPart = kRows * HD * 4;   // q, dO, q^T or dO^T, one part
  static constexpr int kStageBytes = 8 * kPart;  // q, dO, q^T, dO^T: big and small
  static constexpr int kRawStages = 2;           // q and dO as TMA lands them
  static constexpr int kRawBytes = 2 * kPart;
  static constexpr int kMaxStages = 4;
  static constexpr int kStatBytes = (kMaxStages + kRawStages) * 2 * kRows * 4;  // lse and D
  static constexpr int kBarBytes = 8 * (2 + 2 * kRawStages + 2 * kMaxStages);
  static constexpr int kFit =
      (232448 - 1024 - kOwn - kRawStages * kRawBytes - kStatBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = 1024 + kOwn + static_cast<size_t>(kStages) * kStageBytes +
                                   kRawStages * kRawBytes + kStatBytes + kBarBytes;
  static_assert(HD == 32 || HD == 64, "the wgmma f32 bodies serve hd 32 and 64");
  static_assert(kRows == 32, "a transposed copy is one 128-byte atom of 32 rows");
  static_assert(kStages >= 2, "a stage splits while the consumer reads the other");
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// The dQ consumer warpgroup wg: folded rows row0 .. row0 + 63, its q and dO
// split, their big parts the A fragments of S and dP in registers (rs), their
// small parts K-major in `own` (ss); the block's 32-key tiles j = 0 .. n - 1
// (tile t0 + j, ring slot j % kStages), those past its rows' causal limit
// only released.
template <int HD, bool kCausal>
__device__ __forceinline__ void tf32_dq_consumer(uint8_t* own, const uint8_t* ring,
                                                 uint64_t* ready, uint64_t* empty,
                                                 const float* __restrict__ q,
                                                 const float* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ D,
                                                 float* __restrict__ dq,
                                                 float* __restrict__ dq_part, int S, int Sk,
                                                 int H, int Hk, int64_t row0, int t0, int n,
                                                 bool share, float scale, float scale_log2) {
  using T = Tf32DqTile<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  const int t = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int G = H / Hk;
  const int b = static_cast<int>(blockIdx.y) / Hk;
  const int kvh = static_cast<int>(blockIdx.y) % Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const auto offset = [&](int64_t row) {  // folded row -> element of q, dO, dq
    return ((static_cast<int64_t>(b) * S + row / G) * H + kvh * G + row % G) * HD;
  };
  // q and dO of the 64 rows split (rows past the end zero): k-step kk of a
  // fragment holds rows 16 warp + g (+ 8), columns 8 kk + c4 (+ 4).
  uint32_t qa[HD / 8][4], da[HD / 8][4];
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1);
      const int c = 8 * kk + c4 + 4 * (i >> 1);
      const bool ok = row0 + r < rows_total;
      const float xq = ok ? __ldg(q + offset(row0 + r) + c) : 0.f;
      const float xd = ok ? __ldg(dout + offset(row0 + r) + c) : 0.f;
      const uint32_t at = hopper::f32_at<128>(64, r, c);
      qa[kk][i] = __float_as_uint(tf32_big(xq));
      da[kk][i] = __float_as_uint(tf32_big(xd));
      *reinterpret_cast<float*>(own + at) = xq - tf32_big(xq);
      *reinterpret_cast<float*>(own + T::kRowPart + at) = xd - tf32_big(xd);
    }
  }
  hopper::fence_async_smem();
  hopper::bar_sync(1 + wg, 128);

  int64_t row[2];
  int pos[2];
  bool ok[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + 16 * warp + g + 8 * i;
    ok[i] = row[i] < rows_total;
    pos[i] = static_cast<int>(row[i] / G);
    const int64_t st = (static_cast<int64_t>(b) * H + kvh * G + row[i] % G) * S + pos[i];
    lse2[i] = ok[i] ? lse[st] * kLog2e : 0.f;
    Dr[i] = ok[i] ? D[st] : 0.f;
  }
  int n_mine = row0 < rows_total ? n : 0;
  if (kCausal && n_mine > 0) {
    const int64_t last = (row0 + 64 < rows_total ? row0 + 64 : rows_total) - 1;
    n_mine = max(0, min(n, static_cast<int>(last / G) / kKeys + 1 - t0));
  }
  const int first_pos = static_cast<int>(row0 / G);
  const uint32_t qs = smem_u32(own), ds = qs + T::kRowPart;

  float acc[HD / 2];
  hopper::zero(acc);
  const int step = share ? 2 : 1;
  for (int j = share ? wg : 0; j < n_mine; j += step) {
    const int st = j % kStages;
    const int k0 = (t0 + j) * kKeys;
    hopper::mbar_wait(&ready[st], (j / kStages) & 1);
    const uint32_t kb = smem_u32(ring + st * T::kStageBytes);
    const uint32_t ks = kb + T::kPart, vb = kb + 2 * T::kPart, vs = kb + 3 * T::kPart;
    const uint32_t ktb = kb + 4 * T::kPart, kts = kb + 5 * T::kPart;
    // S = q k^T and dP = dO v^T: 64 rows x 32 keys, 3xTF32.
    float s[kKeys / 2], dp[kKeys / 2];
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      using M = hopper::MmaTf32<kKeys>;
      M::ss(s, hopper::f32_desc<128>(qs, 64, kk), hopper::f32_desc<128>(kb, kKeys, kk), kk > 0);
      M::rs(s, qa[kk], hopper::f32_desc<128>(ks, kKeys, kk), 1);
      M::rs(s, qa[kk], hopper::f32_desc<128>(kb, kKeys, kk), 1);
      M::ss(dp, hopper::f32_desc<128>(ds, 64, kk), hopper::f32_desc<128>(vb, kKeys, kk), kk > 0);
      M::rs(dp, da[kk], hopper::f32_desc<128>(vs, kKeys, kk), 1);
      M::rs(dp, da[kk], hopper::f32_desc<128>(vb, kKeys, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // dS in place of S: element e of n-tile jj is row r[e >> 1], key 8 jj +
    // 2 c4 + (e & 1).  Masks only on straddling tiles: elsewhere a row past
    // the end has zero q and dO, so its dS is 0 (and it is never stored).
    const bool edge = (kCausal && k0 + kKeys - 1 > first_pos) || k0 + kKeys > Sk;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        const int key = k0 + 8 * jj + 2 * c4 + (e & 1);
        const bool live = !edge || (ok[ii] && key < Sk && (!kCausal || key <= pos[ii]));
        const float x = hopper::ex2(fmaf(s[4 * jj + e], scale_log2, -lse2[ii]));
        s[4 * jj + e] = (live ? x : 0.f) * (dp[4 * jj + e] - Dr[ii]);
      }
    }
    uint32_t sb[kKeys / 8][4], sm[kKeys / 8][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) acc_frag_tf32(s, kk, sb[kk], sm[kk]);
    // dQ += dS k against k^T, 3xTF32.
    hopper::fence_regs(acc);
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      hopper::MmaTf32<HD>::rs(acc, sm[kk], hopper::f32_desc<128>(ktb, HD, kk), 1);
      hopper::MmaTf32<HD>::rs(acc, sb[kk], hopper::f32_desc<128>(kts, HD, kk), 1);
      hopper::MmaTf32<HD>::rs(acc, sb[kk], hopper::f32_desc<128>(ktb, HD, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }
  for (int j = n_mine; j < n; ++j) {  // tiles past this warpgroup's limit
    if (share && j % 2 != wg) continue;
    const int st = j % kStages;
    hopper::mbar_wait(&ready[st], (j / kStages) & 1);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }
  if (share) {  // the second warpgroup's sums to the first, through its q's small part
    float* merge = reinterpret_cast<float*>(own);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) merge[i * 128 + t] = acc[i];
      hopper::bar_arrive(4, 256);
      return;
    }
    hopper::bar_sync(4, 256);
    merge += T::kOwn / 4;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] += merge[i * 128 + t];
  }

  const bool whole = gridDim.z == 1;
  float* out = whole ? dq : dq_part + dq_part_base(S, H, Hk, HD);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    float* orow = out + offset(row[i]) + 2 * c4;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const float x0 = acc[4 * jj + 2 * i], x1 = acc[4 * jj + 2 * i + 1];
      *reinterpret_cast<float2*>(orow + 8 * jj) =
          whole ? make_float2(x0 * scale, x1 * scale) : make_float2(x0, x1);
    }
  }
}

// Grid (row tiles of 128 folded rows, B * Hk, key ranges), causal tiles
// heaviest first; block (x, y, z) walks key range z (key_range, in 64-key
// units as the other bodies, walked in 32-key tiles).  Whole walk: dq
// scaled; else its unscaled f32 partial into dq_part.  Threads: two
// consumer warpgroups, then the producer's (warp 0's first lane issues the
// copies, warps 1-3 split), which hands them its registers (setmaxnreg).
template <int HD, bool kCausal>
__global__ void __launch_bounds__(Tf32DqTile<HD>::kThreads, 1)
flash_bwd_dq_tf32x3_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const float* __restrict__ q, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ D,
                                 float* __restrict__ dq, float* __restrict__ dq_part, int S,
                                 int Sk, int H, int Hk, int share, float scale,
                                 float scale_log2) {
  using T = Tf32DqTile<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  constexpr int kNC = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = hopper::align1024(smem_raw);
  uint8_t* ring = own + kNC * T::kOwn;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * T::kStageBytes);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;

  const int G = H / Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const int rows = share ? 64 : T::kRows;  // folded rows of the block
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * rows;
  const int b = static_cast<int>(blockIdx.y) / Hk;
  const int kvh = static_cast<int>(blockIdx.y) % Hk;
  int n64 = (Sk + 63) / 64;
  int n32 = (Sk + kKeys - 1) / kKeys;
  if (kCausal) {
    const int64_t last = (row0 + rows < rows_total ? row0 + rows : rows_total) - 1;
    const int lp = static_cast<int>(last / G);
    n64 = min(n64, lp / 64 + 1);
    n32 = min(n32, lp / kKeys + 1);
  }
  int kt0, kt1;
  key_range(n64, kt0, kt1);
  const int t0 = 2 * kt0;
  const int n = max(0, min(2 * kt1, n32) - t0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], kSplitThreads);
      hopper::mbar_init(&empty[s], (share ? 1 : kNC) * 4);  // lane 0 of each consuming warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kNC * 128) {  // ---- producer warpgroup
    hopper::HandOver<kTf32Producer>::producer();
    const int t = threadIdx.x - kNC * 128;
    if (t == 0) {  // the copies: k and v raw into their big parts
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[st], 2 * T::kPart);
        const int k0 = (t0 + j) * kKeys;
        uint8_t* base = ring + st * T::kStageBytes;
        for (int a = 0; a < HD / 32; ++a) {
          hopper::tma_load_4d(base + a * kKeys * 128, &k_map, &full[st], 32 * a, kvh, k0, b);
          hopper::tma_load_4d(base + 2 * T::kPart + a * kKeys * 128, &v_map, &full[st], 32 * a,
                              kvh, k0, b);
        }
      }
    } else if (t >= 32) {  // the splitters: k, v in place, then k^T
      const int sp = t - 32;
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        hopper::mbar_wait(&full[st], (j / kStages) & 1);
        uint8_t* base = ring + st * T::kStageBytes;
        split_copy(base, base, base + T::kPart, T::kPart, sp);
        split_copy(base + 2 * T::kPart, base + 2 * T::kPart, base + 3 * T::kPart, T::kPart, sp);
        hopper::bar_sync(3, kSplitThreads);  // k's parts are whole
        transpose32<HD>(base, base + 4 * T::kPart, sp);
        transpose32<HD>(base + T::kPart, base + 5 * T::kPart, sp);
        hopper::fence_async_smem();
        hopper::mbar_arrive(&ready[st]);
      }
    }
  } else {  // ---- consumer warpgroups
    hopper::HandOver<kTf32Producer>::consumer();
    const int wg = threadIdx.x / 128;
    tf32_dq_consumer<HD, kCausal>(own + wg * T::kOwn, ring, ready, empty, q, dout, lse, D, dq,
                                  dq_part, S, Sk, H, Hk, row0 + (share ? 0 : 64 * wg), t0, n,
                                  share != 0, scale, scale_log2);
  }
}

// Grid (ceil(Sk / 64), B * Hk, G): block (x, y, z) holds keys 64 x .. of KV
// head y % Hk of batch y / Hk and writes query head kvh * G + z's f32 share
// of dk and dv.  Threads: the consumer warpgroup, then the producer's (warp
// 0 issues the copies and copies lse and D, warps 1-3 split).  The streamed
// q and dO land in a raw ring of their own, so a copy waits only for the
// splitters to have read its slot, never for the consumer.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(Tf32DkdvTile<HD>::kThreads, 1)
flash_bwd_dkdv_tf32x3_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map,
                                   const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap do_map,
                                   const float* __restrict__ lse, const float* __restrict__ D,
                                   float* __restrict__ part, float* __restrict__ dk_out,
                                   float* __restrict__ dv_out, int B, int S, int Sk, int H,
                                   int Hk, float scale, float scale_log2) {
  using T = Tf32DkdvTile<HD>;
  constexpr int kRows = T::kRows;
  constexpr int kStages = T::kStages;
  constexpr int kRaw = T::kRawStages;
  constexpr int kDK = HD / 8;  // k-steps over hd
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = hopper::align1024(smem_raw);  // k big, k small, v big, v small
  uint8_t* ring = own + T::kOwn;  // split stages: q, q small, dO, dO small, q^T (2), dO^T (2)
  uint8_t* raw = ring + kStages * T::kStageBytes;  // raw stages: q, dO
  float* stat = reinterpret_cast<float*>(raw + kRaw * T::kRawBytes);  // [stage][lse, D][row]
  float* raw_stat = stat + kStages * 2 * kRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(stat) +
                                                  T::kStatBytes);
  uint64_t* kv_ready = kv_full + 1;
  uint64_t* raw_full = kv_ready + 1;
  uint64_t* raw_empty = raw_full + kRaw;
  uint64_t* ready = raw_empty + kRaw;
  uint64_t* empty = ready + kStages;

  const int G = H / Hk;
  const int kvh = static_cast<int>(blockIdx.y) % Hk;
  const int b = static_cast<int>(blockIdx.y) / Hk;
  const int h = kvh * G + static_cast<int>(blockIdx.z);
  const int k0 = blockIdx.x * T::kKeys;
  // Causal: positions below k0 see none of the keys (k0 is a tile multiple).
  const int t_first = kCausal ? k0 / kRows : 0;
  const int n_q = max(0, (S + kRows - 1) / kRows - t_first);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_ready, kSplitThreads);
    for (int s = 0; s < kRaw; ++s) {
      hopper::mbar_init(&raw_full[s], 1 + 32);  // the copies' arrival, each lane's lse and D
      hopper::mbar_init(&raw_empty[s], kSplitThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ready[s], kSplitThreads);
      hopper::mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ---- producer warpgroup
    const int t = threadIdx.x - 128;
    if (t < 32 && n_q > 0) {  // the copies, and the streamed tiles' lse and D
      if (t == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * T::kKVPart);
        for (int a = 0; a < HD / 32; ++a) {
          hopper::tma_load_4d(own + a * T::kKeys * 128, &k_map, kv_full, 32 * a, kvh, k0, b);
          hopper::tma_load_4d(own + 2 * T::kKVPart + a * T::kKeys * 128, &v_map, kv_full,
                              32 * a, kvh, k0, b);
        }
      }
      const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * S;
      for (int e = 0; e < n_q; ++e) {
        const int rs = e % kRaw;
        const int row0 = (t_first + e) * kRows;
        if (e >= kRaw) hopper::mbar_wait(&raw_empty[rs], ((e / kRaw) - 1) & 1);
        if (t == 0) {
          hopper::mbar_expect_tx(&raw_full[rs], 2 * T::kPart);
          uint8_t* base = raw + rs * T::kRawBytes;
          for (int a = 0; a < HD / 32; ++a) {
            hopper::tma_load_4d(base + a * kRows * 128, &q_map, &raw_full[rs], 32 * a, h, row0,
                                b);
            hopper::tma_load_4d(base + T::kPart + a * kRows * 128, &do_map, &raw_full[rs],
                                32 * a, h, row0, b);
          }
        }
        const bool ok = row0 + t < S;
        raw_stat[(2 * rs) * kRows + t] = ok ? lse[stat0 + row0 + t] * kLog2e : 0.f;
        raw_stat[(2 * rs + 1) * kRows + t] = ok ? D[stat0 + row0 + t] : 0.f;
        hopper::mbar_arrive(&raw_full[rs]);  // releases this lane's lse and D
      }
    } else if (t >= 32 && n_q > 0) {  // the splitters
      const int sp = t - 32;
      hopper::mbar_wait(kv_full, 0);
      split_copy(own, own, own + T::kKVPart, T::kKVPart, sp);
      split_copy(own + 2 * T::kKVPart, own + 2 * T::kKVPart, own + 3 * T::kKVPart, T::kKVPart,
                 sp);
      hopper::fence_async_smem();
      hopper::mbar_arrive(kv_ready);
      for (int e = 0; e < n_q; ++e) {
        const int st = e % kStages;
        const int rs = e % kRaw;
        hopper::mbar_wait(&raw_full[rs], (e / kRaw) & 1);
        if (e >= kStages) hopper::mbar_wait(&empty[st], ((e / kStages) - 1) & 1);
        const uint8_t* in = raw + rs * T::kRawBytes;
        uint8_t* base = ring + st * T::kStageBytes;
        split_copy(in, base, base + T::kPart, T::kPart, sp);
        split_copy(in + T::kPart, base + 2 * T::kPart, base + 3 * T::kPart, T::kPart, sp);
        if (sp < 2 * kRows) {
          stat[(2 * st) * kRows + sp] = raw_stat[(2 * rs) * kRows + sp];
        }
        hopper::bar_sync(3, kSplitThreads);  // q's and dO's parts are whole; the raw slot read
        hopper::mbar_arrive(&raw_empty[rs]);
        transpose32<HD>(base, base + 4 * T::kPart, sp);
        transpose32<HD>(base + T::kPart, base + 5 * T::kPart, sp);
        transpose32<HD>(base + 2 * T::kPart, base + 6 * T::kPart, sp);
        transpose32<HD>(base + 3 * T::kPart, base + 7 * T::kPart, sp);
        hopper::fence_async_smem();
        hopper::mbar_arrive(&ready[st]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: keys k0 + 16 warp + g (+ 8)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const uint32_t ks = smem_u32(own) + T::kKVPart, vs = smem_u32(own) + 3 * T::kKVPart;
  float dk[HD / 2], dv[HD / 2];
  hopper::zero(dk);
  hopper::zero(dv);
  // k's and v's big parts as the A fragments of S^T and dP^T in registers
  // (rs): the big x big and big x small products read no A from shared
  // memory, whose bandwidth the products and the split pass share.
  uint32_t ka[kDK][4], va[kDK][4];
  if (n_q > 0) {
    hopper::mbar_wait(kv_ready, 0);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t at = hopper::f32_at<128>(64, 16 * warp + g + 8 * (i & 1),
                                                8 * kk + c4 + 4 * (i >> 1));
        ka[kk][i] = *reinterpret_cast<const uint32_t*>(own + at);
        va[kk][i] = *reinterpret_cast<const uint32_t*>(own + 2 * T::kKVPart + at);
      }
    }
  }
  for (int e = 0; e < n_q; ++e) {
    const int st = e % kStages;
    const int row0 = (t_first + e) * kRows;
    hopper::mbar_wait(&ready[st], (e / kStages) & 1);
    const uint32_t qb = smem_u32(ring + st * T::kStageBytes);
    const uint32_t qs = qb + T::kPart, db = qb + 2 * T::kPart, ds = qb + 3 * T::kPart;
    const uint32_t qtb = qb + 4 * T::kPart, qts = qb + 5 * T::kPart;
    const uint32_t dtb = qb + 6 * T::kPart, dts = qb + 7 * T::kPart;
    const float* lse_b = stat + (2 * st) * kRows;
    const float* D_b = stat + (2 * st + 1) * kRows;
    // S^T = k q^T and dP^T = v dO^T: 64 keys x 32 rows, 3xTF32.
    float s[kRows / 2], dp[kRows / 2];
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      using M = hopper::MmaTf32<kRows>;
      M::ss(s, hopper::f32_desc<128>(ks, 64, kk), hopper::f32_desc<128>(qb, kRows, kk), kk > 0);
      M::rs(s, ka[kk], hopper::f32_desc<128>(qs, kRows, kk), 1);
      M::rs(s, ka[kk], hopper::f32_desc<128>(qb, kRows, kk), 1);
      M::ss(dp, hopper::f32_desc<128>(vs, 64, kk), hopper::f32_desc<128>(db, kRows, kk), kk > 0);
      M::rs(dp, va[kk], hopper::f32_desc<128>(ds, kRows, kk), 1);
      M::rs(dp, va[kk], hopper::f32_desc<128>(db, kRows, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // P^T and dS^T in place: element e of n-tile j is key 16 warp + g + 8
    // (e >> 1) of the block's, row 8 j + 2 c4 + (e & 1) of the tile (lse_b
    // in the log2 domain).  Masks only on tiles that straddle a limit.
    const bool edge = (kCausal && row0 < k0 + 63) || row0 + kRows > S || k0 + 64 > Sk;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * c4 + (e & 1);
        const int key = k0 + 16 * warp + g + 8 * (e >> 1);
        const int pos = row0 + r;
        const bool ok = !edge || (pos < S && key < Sk && (!kCausal || key <= pos));
        const float x = hopper::ex2(fmaf(s[4 * j + e], scale_log2, -lse_b[r]));
        const float p = ok ? x : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - D_b[r]);
      }
    }
    uint32_t pb[kRows / 8][4], ps[kRows / 8][4], sb[kRows / 8][4], sm[kRows / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      acc_frag_tf32(s, kk, pb[kk], ps[kk]);
      acc_frag_tf32(dp, kk, sb[kk], sm[kk]);
    }
    // dV += P^T dO and dK += dS^T q against dO^T and q^T, 3xTF32.
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      using M = hopper::MmaTf32<HD>;
      M::rs(dv, ps[kk], hopper::f32_desc<128>(dtb, HD, kk), 1);
      M::rs(dv, pb[kk], hopper::f32_desc<128>(dts, HD, kk), 1);
      M::rs(dv, pb[kk], hopper::f32_desc<128>(dtb, HD, kk), 1);
      M::rs(dk, sm[kk], hopper::f32_desc<128>(qtb, HD, kk), 1);
      M::rs(dk, sb[kk], hopper::f32_desc<128>(qts, HD, kk), 1);
      M::rs(dk, sb[kk], hopper::f32_desc<128>(qtb, HD, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // One query head a KV head (gridDim.z == 1): dk (scaled) and dv
  // themselves, no share; else head z's f32 share.
  const bool direct = gridDim.z == 1;
  const int64_t n = static_cast<int64_t>(B) * Sk * Hk * HD;  // one share
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    if (key >= Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + 2 * c4;
    float* dk_row = direct ? dk_out + off : part + static_cast<int64_t>(blockIdx.z) * n + off;
    float* dv_row = direct ? dv_out + off : part + (G + static_cast<int64_t>(blockIdx.z)) * n + off;
    const float sk = direct ? scale : 1.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(dk_row + 8 * j) = make_float2(dk[e] * sk, dk[e + 1] * sk);
      *reinterpret_cast<float2*>(dv_row + 8 * j) = make_float2(dv[e], dv[e + 1]);
    }
  }
}

// What a call launched, for the caller to read back: launched[0] the body of
// its dK/dV and dQ kernels (named by flash_attention_bwd_body_name),
// launched[1] the dQ grid's key ranges, launched[2..4] the dK/dV grid (its z
// the head groups), launched[5..6] the dQ grid's x and y, launched[7] the
// kernels the call launched (3, or 4 with the reduce).
constexpr int kBodyTf32x3Wgmma = 0;
constexpr int kBodyWgmma = 1;
constexpr int kBodyTf32x3Wide = 2;
constexpr const char* kBodyNames[] = {"tf32x3_wgmma", "wgmma", "tf32x3_wide_mma"};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The bf16 dK/dV and dQ kernels: their TMA maps, then the launches; dk and
// dv written by the dK/dV kernel where it has one head group.
template <int HD, bool kCausal>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                 const float* D, float* part, float* dq_part, bf16* dq, bf16* dk, bf16* dv, int B,
                 int S, int Sk, int H, int Hk, int splits, int groups, int* launched,
                 cudaStream_t stream) {
  using TK = DkdvTile<HD>;
  using TQ = DqTile<HD>;
  const int G = H / Hk;
  const int P = hopper::folded_positions(G);
  CUtensorMap q_rows, do_rows, k_map, v_map, q_folded, do_folded;
  int e;
  if ((e = hopper::map_rows<HD>(&q_rows, "q", q, B, S, H, TK::kRows)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&do_rows, "dout", dout, B, S, H, TK::kRows)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&k_map, "k", k, B, Sk, Hk, 64)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&v_map, "v", v, B, Sk, Hk, 64)) != 0) return e;
  if ((e = hopper::map_folded<HD>(&q_folded, "q", q, B, S, Hk, G, P)) != 0) return e;
  if ((e = hopper::map_folded<HD>(&do_folded, "dout", dout, B, S, Hk, G, P)) != 0) return e;
  static_assert(TQ::kKeys == 64 && TK::kKeys == 64, "dQ's K/V boxes are dK/dV's: 64 keys");

  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD, kCausal>;
  auto dqk = flash_bwd_dq_wgmma_kernel<HD, kCausal>;
  if constexpr (TK::kConsumers == 2) {
    static int regs = -1;
    if ((e = hopper::launch_regs_ok(reinterpret_cast<const void*>(dkdv),
                                    "flash_bwd_dkdv_wgmma_kernel", &regs)) != 0) {
      return e;
    }
  }
  cudaError_t err;
  if ((err = allow_smem(dkdv, TK::kBytes)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(dqk, TQ::kBytes)) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((Sk + TK::kKeys - 1) / TK::kKeys),
                     static_cast<unsigned>(B * Hk), static_cast<unsigned>(groups));
  dkdv<<<grid_kv, TK::kThreads, TK::kBytes, stream>>>(q_rows, k_map, v_map, do_rows, lse, D,
                                                      part, dk, dv, B, S, Sk, H, Hk, scale,
                                                      scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((S + P - 1) / P), static_cast<unsigned>(B * Hk),
                    static_cast<unsigned>(splits));
  dqk<<<grid_q, TQ::kThreads, TQ::kBytes, stream>>>(q_folded, k_map, v_map, do_folded, lse, D, dq,
                                                    dq_part, S, Sk, H, Hk, P, scale, scale_log2);
  launched[0] = kBodyWgmma;
  launched[1] = static_cast<int>(grid_q.z);
  launched[2] = static_cast<int>(grid_kv.x);
  launched[3] = static_cast<int>(grid_kv.y);
  launched[4] = static_cast<int>(grid_kv.z);
  launched[5] = static_cast<int>(grid_q.x);
  launched[6] = static_cast<int>(grid_q.y);
  return static_cast<int>(cudaGetLastError());
}

// The f32 wgmma dK/dV and dQ kernels (hd 32 and 64): their TMA maps, then
// the launches; the shares (one a query head) and dq's partials to the
// reduce.
template <int HD, bool kCausal>
int launch_tf32_wgmma(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* D, float* part, float* dq_part, float* dq,
                      float* dk, float* dv, int B, int S, int Sk, int H, int Hk, int splits,
                      int groups, int* launched, cudaStream_t stream) {
  using TK = Tf32DkdvTile<HD>;
  using TQ = Tf32DqTile<HD>;
  CUtensorMap q_rows, do_rows, k_keys, v_keys, k_tiles, v_tiles;
  int e;
  if ((e = hopper::map_rows_f32<HD>(&q_rows, "q", q, B, S, H, TK::kRows)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&do_rows, "dout", dout, B, S, H, TK::kRows)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&k_keys, "k", k, B, Sk, Hk, TK::kKeys)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&v_keys, "v", v, B, Sk, Hk, TK::kKeys)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&k_tiles, "k", k, B, Sk, Hk, TQ::kKeys)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&v_tiles, "v", v, B, Sk, Hk, TQ::kKeys)) != 0) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  auto dkdv = flash_bwd_dkdv_tf32x3_wgmma_kernel<HD, kCausal>;
  auto dqk = flash_bwd_dq_tf32x3_wgmma_kernel<HD, kCausal>;
  static int regs = -1;
  if ((e = hopper::launch_regs_ok(reinterpret_cast<const void*>(dqk),
                                  "flash_bwd_dq_tf32x3_wgmma_kernel", &regs)) != 0) {
    return e;
  }
  cudaError_t err;
  if ((err = allow_smem(dkdv, TK::kBytes)) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(dqk, TQ::kBytes)) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((Sk + TK::kKeys - 1) / TK::kKeys),
                     static_cast<unsigned>(B * Hk), static_cast<unsigned>(groups));
  dkdv<<<grid_kv, TK::kThreads, TK::kBytes, stream>>>(k_keys, v_keys, q_rows, do_rows, lse, D,
                                                      part, dk, dv, B, S, Sk, H, Hk, scale,
                                                      scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const int share = rows <= 64 ? 1 : 0;  // one warpgroup's rows: the two share them
  const int per_block = share ? 64 : TQ::kRows;
  const dim3 grid_q(static_cast<unsigned>((rows + per_block - 1) / per_block),
                    static_cast<unsigned>(B * Hk), static_cast<unsigned>(splits));
  dqk<<<grid_q, TQ::kThreads, TQ::kBytes, stream>>>(k_tiles, v_tiles, q, dout, lse, D, dq,
                                                    dq_part, S, Sk, H, Hk, share, scale,
                                                    scale_log2);
  launched[0] = kBodyTf32x3Wgmma;
  launched[1] = static_cast<int>(grid_q.z);
  launched[2] = static_cast<int>(grid_kv.x);
  launched[3] = static_cast<int>(grid_kv.y);
  launched[4] = static_cast<int>(grid_kv.z);
  launched[5] = static_cast<int>(grid_q.x);
  launched[6] = static_cast<int>(grid_q.y);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kCausal, typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, float* D, float* part, float* dq_part, void* dq, void* dk,
                 void* dv, int B, int S, int Sk, int H, int Hk, int splits, int groups,
                 int* launched, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t n_rows = static_cast<int64_t>(B) * S * H;
  using L = DotTile<T, HD>;
  flash_bwd_dot_kernel<T, HD>
      <<<static_cast<unsigned>((n_rows + L::kRowsPerBlock - 1) / L::kRowsPerBlock), 256, 0,
         stream>>>(static_cast<const T*>(o), dot, D, n_rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  const unsigned bh = static_cast<unsigned>(B * Hk);
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  // The f32 dK/dV and dQ kernels of one body: threads a block, shared memory
  // of each; 64 keys a dK/dV block (one query head: groups == G), 64 rows a
  // dQ block.
  const auto run = [&](int body, auto dkdv, auto dqk, int threads, size_t smem_kv,
                       size_t smem_q) -> cudaError_t {
    cudaError_t e;
    if ((e = allow_smem(dkdv, smem_kv)) != cudaSuccess) return e;
    if ((e = allow_smem(dqk, smem_q)) != cudaSuccess) return e;
    const dim3 grid_kv(static_cast<unsigned>((Sk + kMmaTile - 1) / kMmaTile), bh,
                       static_cast<unsigned>(groups));
    dkdv<<<grid_kv, threads, smem_kv, stream>>>(qt, kt, vt, dot, lse, D, part, B, S, Sk, H,
                                                Hk, scale_log2);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const dim3 grid_q(static_cast<unsigned>((rows + kMmaTile - 1) / kMmaTile), bh,
                      static_cast<unsigned>(splits));
    dqk<<<grid_q, threads, smem_q, stream>>>(qt, kt, vt, dot, lse, D, static_cast<T*>(dq),
                                             dq_part, S, Sk, H, Hk, scale, scale_log2);
    launched[0] = body;
    launched[1] = static_cast<int>(grid_q.z);
    launched[2] = static_cast<int>(grid_kv.x);
    launched[3] = static_cast<int>(grid_kv.y);
    launched[4] = static_cast<int>(grid_kv.z);
    launched[5] = static_cast<int>(grid_q.x);
    launched[6] = static_cast<int>(grid_q.y);
    return cudaGetLastError();
  };
  // bf16 on wgmma at every head dim; f32 on wgmma in 3xTF32 at hd 32 and
  // 64, on 3xTF32 mma.sync (8 warps) at hd 128 and 160.
  int rc;
  if constexpr (std::is_same<T, bf16>::value) {
    rc = launch_wgmma<HD, kCausal>(qt, kt, vt, dot, lse, D, part, dq_part, static_cast<bf16*>(dq),
                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Sk, H,
                                   Hk, splits, groups, launched, stream);
  } else if constexpr (HD <= 64) {
    rc = launch_tf32_wgmma<HD, kCausal>(qt, kt, vt, dot, lse, D, part, dq_part,
                                        static_cast<float*>(dq), static_cast<float*>(dk),
                                        static_cast<float*>(dv), B, S, Sk, H, Hk, splits, groups,
                                        launched, stream);
  } else {
    using M = Tf32Smem<HD>;
    rc = static_cast<int>(run(kBodyTf32x3Wide, flash_bwd_dkdv_tf32x3_wide_mma_kernel<HD, kCausal>,
                              flash_bwd_dq_tf32x3_wide_mma_kernel<HD, kCausal>, 256,
                              M::kDkdvBytes, M::kDqBytes));
  }
  if (rc != 0) return rc;
  // dk and dv: each KV head's shares (one a head group) summed in group
  // order, unless the dK/dV kernel's one group wrote them itself (the bf16
  // body, and the f32 wgmma body at one query head a KV head); dq, when
  // split, its partials in range order; each cast once.
  const bool shared = groups > 1 || (!std::is_same<T, bf16>::value && HD > 64);
  const int64_t n = shared ? static_cast<int64_t>(B) * Sk * Hk * HD : 0;
  const int64_t nq = splits > 1 ? n_rows * HD : 0;
  launched[7] = n + nq > 0 ? 4 : 3;
  if (n + nq == 0) return 0;
  const int64_t red_blocks = (n + nq + 255) / 256 < 4096 ? (n + nq + 255) / 256 : 4096;
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(red_blocks), 256, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), n, groups, dq_part, static_cast<T*>(dq), nq,
      splits, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* D, float* part, float* dq_part, void* dq, void* dk,
              void* dv, int B, int S, int Sk, int H, int Hk, int splits, int groups, bool is_bf16,
              bool causal, int* launched, cudaStream_t stream) {
  if (is_bf16) {
    return causal ? launch_typed<HD, true, bf16>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                 dk, dv, B, S, Sk, H, Hk, splits, groups,
                                                 launched, stream)
                  : launch_typed<HD, false, bf16>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                  dk, dv, B, S, Sk, H, Hk, splits, groups,
                                                  launched, stream);
  }
  return causal ? launch_typed<HD, true, float>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                dk, dv, B, S, Sk, H, Hk, splits, groups, launched,
                                                stream)
                : launch_typed<HD, false, float>(q, k, v, o, dout, lse, D, part, dq_part, dq,
                                                 dk, dv, B, S, Sk, H, Hk, splits, groups,
                                                 launched, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  hd: 32, 64, 128 or 160.  q, o, dout and
// dq are (B, S, H, hd), k, v, dk and dv (B, Sk, Hk, hd), all contiguous and
// 16-byte aligned (TMA's rule for a tensor's base); lse and D are f32 (B, H,
// S), lse from the forward, D scratch.  head_groups: the dK/dV grid's head
// groups (f32: G, one head a block; bf16: 1 <= head_groups <= G); part is
// f32 scratch of 2 * head_groups * B * Sk * Hk * hd elements (each group's dk
// and dv shares), unused at one group for bf16 and for f32 at hd 32 and 64
// (the dK/dV kernel writes dk and dv).
// dq_splits: the key ranges of the dq walk (1 <= dq_splits <= 65535); above
// 1, dq_part is f32 scratch of dq_splits * B * S * H * hd elements (the
// ranges' partials), else unused.  H % Hk == 0, B * Hk <= 65535, H / Hk <=
// 64 (bf16: a folded tile holds at least one position); the wrapper checks
// all of it.  On success launched (int[8]) holds the body the call ran
// (flash_attention_bwd_body_name), the key ranges of the dQ grid, the dK/dV
// grid, the dQ grid's x and y and the kernels launched.  A TMA descriptor
// that does not encode returns hopper::kTmaEncodeError, a dK/dV build that
// setmaxnreg's hand-over cannot count on hopper::kHandOverError, and the
// error string gives why.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* D, float* part,
                               float* dq_part, void* dq, void* dk, void* dv, int B, int S,
                               int Sk, int H, int Hk, int hd, int dtype, int causal,
                               int dq_splits, int head_groups, int* launched, int device,
                               void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((dtype != 0 && dtype != 1) || (dtype == 1 && H / Hk > 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dq_splits < 1 || dq_splits > 65535 || (dq_splits > 1 && dq_part == nullptr) ||
      launched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_groups < 1 || head_groups > H / Hk || (dtype == 0 && head_groups != H / Hk) ||
      ((head_groups > 1 || (dtype == 0 && hd > 64)) && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool is_bf16 = dtype == 1;
  const bool c = causal != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H, Hk,
                           dq_splits, head_groups, is_bf16, c, launched, st);
    case 64:
      return launch_hd<64>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H, Hk,
                           dq_splits, head_groups, is_bf16, c, launched, st);
    case 128:
      return launch_hd<128>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                            Hk, dq_splits, head_groups, is_bf16, c, launched, st);
    case 160:
      return launch_hd<160>(q, k, v, o, dout, lse, D, part, dq_part, dq, dk, dv, B, S, Sk, H,
                            Hk, dq_splits, head_groups, is_bf16, c, launched, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int err) {
  if (err == hopper::kTmaEncodeError || err == hopper::kHandOverError) return hopper::tma_error();
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The name of the body launched[0] reports.
const char* flash_attention_bwd_body_name(int code) {
  return code >= 0 && code < 3 ? kBodyNames[code] : "unknown";
}

}  // extern "C"
