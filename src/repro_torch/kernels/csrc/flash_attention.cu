// Forward GQA flash attention (online softmax) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel):
//
//     out[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h / G] / sqrt(hd)) v[b, k, h / G]
//
// q (B, S, H, hd), k and v (B, Sk, Hk, hd), G = H / Hk, f32 or bf16 in, f32
// math, the output in the input dtype.  With `causal` a query at position s
// sees the keys at positions <= s, both counted from 0 (the reference's
// alignment, also when S != Sk); masked scores are -1e30 as in the reference,
// and the row sum is floored at 1e-30 before the division.
//
// What bounds it on the card: operations.  A causal prefill does
// 4 * B * H * hd * S(S+1)/2 flops on 2 * (B*S*H + B*Sk*Hk) * hd elements, far
// above the H100's ops-per-byte balance once S reaches a few hundred, so the
// tensor cores are the resource.  Two bodies, picked by dtype, both on the
// tensor cores:
//
// bf16 (flash_fwd_bf16_wgmma_kernel, the serving and training path): Hopper's
// own route (csrc/hopper_wgmma.cuh), warpgroup products (wgmma) on tiles
// that TMA copies into shared memory, which mma.sync on ldmatrix fragments
// (the body before, Ampere's route) cannot reach: each of its warps re-read
// its B fragments from shared memory for every 16 x 16 product.  What the
// design does:
//   * one block per (batch, KV head, 2 x P positions): two consumer
//     warpgroups of 64 folded rows each and a producer warp.  A folded row
//     is (position, group member), the G query heads of one KV head side by
//     side as the TPU kernel folds them, so each K/V tile is read once for
//     all G heads;
//   * TMA cannot gather rows one by one, so a warpgroup's Q tile is one box
//     of a 5-D view (hd, G, Hk, S, B) of q, box (atom columns, G, 1, P, 1)
//     with P = 64 / G whole positions: for G = 5 and 7 a tile holds 60 and 63
//     real rows, and the padding rows, which no box fills, are zeroed once,
//     get no weight and are never stored; the output goes back through the
//     same box, which clips positions past S;
//   * K and V tiles of kKeys keys (a 4-D view (hd, Hk, Sk, B)) stream
//     through a ring of three stages that the producer warp keeps full under
//     mbarriers (full: the copy's bytes arrived; empty: every consumer warp
//     is done); TMA's zero fill past Sk replaces the copies' zero fill;
//   * tiles are laid out by TMA's 128-byte swizzle in atoms of 64 columns
//     (64-byte swizzle and 32 columns at hd 32 and 160): hd 128 is two atoms
//     along K.  S = Q K^T is an ss wgmma (both K-major); O += P V an rs
//     wgmma, P from registers in bf16 and V the transposed (MN-major)
//     operand, read through the descriptor, not ldmatrix.trans;
//   * the online softmax runs on the wgmma accumulator layout in f32
//     registers (row max and sum over quads, exp2 with the scale folded);
//     tile kt's Q K^T is issued with tile kt-1's P V, and the softmax of kt
//     runs while P V is in flight;
//   * each warpgroup stops at its own causal limit; causal blocks run
//     heaviest first; masks only on tiles that straddle a limit.
// f32 (flash_fwd_tf32x3_mma_kernel; whisper's encoder and cross-attention,
// whose f32 frames JAX promotes): FlashAttention-2 on mma.sync.m16n8k8 TF32
// in 3xTF32, one block per (batch, KV head, 64 folded rows), 4 warps of 16
// rows, K/V tiles of 64 keys double-buffered with 16-byte cp.async copies
// (zero-filled past Sk).  One TF32 product keeps 11 bits of each operand,
// short of the f32 tolerance of 2e-5 (tests/test_kernels.py:43); each
// operand is split once into a TF32 big part and the remainder
// (csrc/rwkv_scan.cu's split_tf32), and big * big + big * small + small *
// big, accumulated in f32, keeps about 21 bits: three tensor-core products
// at 495 TFLOP/s beat one f32 FMA at 67.  What the design does:
//   * f32 tiles of 64 rows x hd with no padding; the 16-byte column chunks of
//     row r are XOR-swizzled by swz(r), so both ways the fragments read a
//     tile (8 rows x 4 columns, and 4 rows x 8 columns) fall in 32 distinct
//     banks.  Q, K[2], V[2] and P take 1280 * hd + 16384 bytes (96 KB at
//     hd 64);
//   * the key order inside each 8-key n-tile of the score tile is permuted
//     (column 2t holds key t, column 2t + 1 key t + 4), so each lane's S
//     accumulator is already its own part of P's A fragment for P V: no
//     shuffle between lanes;
//   * Q's fragments are read and split from shared memory each k-step, the
//     k-steps of Q K^T are a loop rather than unrolled, and each lane parks
//     its P in a warp-private slot of shared memory and reads it back a
//     k-step at a time (its own values, no barrier), so the k-steps of P V
//     are a loop too.  Fully unrolled, or with Q's split fragments held in
//     registers (hd of them), ptxas hoisted the fragment loads ahead of the
//     products and spilled at hd 64-160 at its 255-register cap
//     (scripts/ptxas_report.py);
//   * where the row tiles leave the grid below one wave (whisper's 64 decoder
//     positions against 1500 frames: 48 blocks on 132 SMs), the wrapper cuts
//     each block's key walk into ranges (flash_attention.py::dq_splits, the
//     backward's rule), a third grid dimension.  Each block then stores its
//     rows' unnormalised f32 output, running max and sum; a range that holds
//     no key a row may see stores a sum and output of 0.  flash_fwd_merge_kernel
//     combines the ranges in range order, no atomics: m = max m_z,
//     l = sum l_z 2^(m_z - m), o = sum o_z 2^(m_z - m) / l, lse = m + log l.
// Both bodies: masked scores are -1e30 as in the reference, keys past Sk get
// no weight, the row sum is floored at 1e-30 before the division, and ragged
// tails (S or Sk not a multiple of a tile) are masked in the kernel, so any
// S and Sk work (the Pallas wrapper needs exact blocks).
//
// With an `lse` buffer (f32, (B, H, S)) both bodies also store each row's
// log-sum-exp, m + log l in natural-log units, for the backward kernels
// (csrc/flash_attention_bwd.cu); with a null one they store nothing more, so
// serving does exactly the work it did without it.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/flash_attention.py.  The launch encodes
// the bf16 body's TMA descriptors on the host (hopper::encode_tiled), passes
// them as __grid_constant__ parameters, enqueues on the caller's stream, does
// not synchronise and allocates nothing (the split walk's partials come from
// the wrapper); the return value is cudaGetLastError() right after the
// launches, or hopper::kTmaEncodeError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

#include "flash_tf32x3.cuh"

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 body

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

using hopper::smem_u32;

// The bf16 body's tiles: kConsumers warpgroups of 64 folded rows each (one Q
// box of P positions x G heads), K/V tiles of kKeys keys in a ring of
// kStages, a producer warp.  Three stages: a stage is released only once
// the P V that overlaps the next tile's softmax is done, so two would leave
// the next load no time.  Shared memory, each tile 1024-byte aligned:
// Q[kConsumers], K[kStages], V[kStages], then the mbarriers.  ptxas gives
// this block 168 registers a thread (with setmaxnreg too, measured), which
// hold S, P and O for 128 keys at hd 32 and 64, and for 64 keys above.
template <int HD>
struct FwdTile {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kKeys = HD <= 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = 64 * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;
  static constexpr size_t kBytes =
      1024 + kConsumers * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// One consumer warpgroup's walk: 64 folded rows from position p0 (rows r <
// P * G real), key tiles [0, n_mine) of the block's n_tiles computed, the
// rest only released.  The products of one tile overlap the softmax of the
// next: tile kt's S = Q K^T is issued with tile kt-1's O += P V, and the
// softmax of S runs while P V is in flight.
template <int HD, bool kCausal>
__device__ __forceinline__ void fwd_consumer(uint8_t* Qw, const uint8_t* Ks, const uint8_t* Vs,
                                             uint64_t* q_full, uint64_t* full, uint64_t* empty,
                                             const CUtensorMap* o_map, float* lse, int b,
                                             int kvh, int p0, int n_tiles, int S, int Sk,
                                             int H, int G, int P, float scale_log2) {
  using T = FwdTile<HD>;
  using A = hopper::Atoms<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  const int t = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int rows_real = P * G;
  if (rows_real < 64) {  // padding rows no box fills: zero, so they stay finite
    for (int i = t; i < (64 - rows_real) * (HD / 8); i += 128) {
      const int r = rows_real + i / (HD / 8);
      *reinterpret_cast<uint4*>(Qw + hopper::swizzled<HD>(64, r, (i % (HD / 8)) * 8)) =
          make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async_smem();
  }
  hopper::bar_sync(1 + wg, 128);

  // This thread's rows r0 = 16 warp + g and r0 + 8.
  int row[2], pos[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = 16 * warp + g + 8 * i;
    pos[i] = p0 + row[i] / G;
    ok[i] = row[i] < rows_real && pos[i] < S;
  }
  int n_mine = p0 < S ? n_tiles : 0;
  if (kCausal && p0 < S) n_mine = min(n_tiles, (min(p0 + P, S) - 1) / kKeys + 1);

  float o[HD / 2];
  hopper::zero(o);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];
  const uint32_t q_addr = smem_u32(Qw);
  const auto k_addr = [&](int kt) { return smem_u32(Ks + (kt % kStages) * T::kKVBytes); };
  const auto v_addr = [&](int kt) { return smem_u32(Vs + (kt % kStages) * T::kKVBytes); };
  const auto issue_s = [&](int kt) {  // S = Q K^T of tile kt, one commit group
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hopper::Mma<kKeys, 0>::ss(s, hopper::desc_k<HD>(q_addr, 64, kk),
                                hopper::desc_k<HD>(k_addr(kt), kKeys, kk), kk > 0);
    }
    hopper::commit();
  };
  const auto issue_pv = [&](int kt) {  // O += P V of tile kt, one commit group
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      hopper::Mma<HD, 1>::rs(o, pa[kk], hopper::desc_mn<HD>(v_addr(kt), kKeys, kk), 1);
    }
    hopper::commit();
  };
  // Online softmax of tile kt's S in the log2 domain, in place (P in f32);
  // masks only on straddling tiles.  The row max is taken on the raw scores
  // (the scale is positive) and the scale folded into one FFMA before the
  // exp2.  Returns each row's rescale of O in corr.
  const auto softmax = [&](int kt, float (&corr)[2]) {
    const int k0 = kt * kKeys;
    if ((kCausal && k0 + kKeys - 1 > p0) || k0 + kKeys > Sk) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * c4 + (e & 1);
          if (key >= Sk) {
            s[4 * j + e] = -INFINITY;  // past the end: no weight at all
          } else if (kCausal && key > pos[e >> 1]) {
            s[4 * j + e] = kNegInf / scale_log2;  // -1e30 once scaled
          }
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
    float sum[2] = {0.f, 0.f};
    float shift[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      corr[i] = hopper::ex2(m[i] - m_new);
      m[i] = m_new;
      shift[i] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hopper::ex2(fmaf(s[4 * j + e], scale_log2, shift[e >> 1]));
        s[4 * j + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
  };
  const auto release = [&](int kt) {  // this warp is done with tile kt's stage
    if (lane == 0) hopper::mbar_arrive(&empty[kt % kStages]);
  };

  hopper::mbar_wait(q_full, 0);
  if (n_mine > 0) {
    float corr[2];
    hopper::mbar_wait(&full[0], 0);
    hopper::fence();
    issue_s(0);
    hopper::wait<0>();
    hopper::fence_regs(s);
    softmax(0, corr);  // O is zero: nothing to rescale
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) hopper::acc_as_a(pa[kk], s, kk);
    for (int kt = 1; kt < n_mine; ++kt) {
      hopper::mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
      hopper::fence_regs(o);
      hopper::fence();
      issue_s(kt);
      issue_pv(kt - 1);
      hopper::wait<1>();  // S of tile kt (committed first) is complete
      hopper::fence_regs(s);
      softmax(kt, corr);
      hopper::wait<0>();  // P V of tile kt - 1
      hopper::fence_regs(o);
      release(kt - 1);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) hopper::acc_as_a(pa[kk], s, kk);
    }
    hopper::fence_regs(o);
    hopper::fence();
    issue_pv(n_mine - 1);
    hopper::wait<0>();
    hopper::fence_regs(o);
    release(n_mine - 1);
  }
  for (int kt = n_mine; kt < n_tiles; ++kt) {  // tiles past this warpgroup's limit
    hopper::mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
    release(kt);
  }
  if (p0 >= S) return;

  // Normalise; the LSE from registers; the output staged in the warpgroup's
  // Q tile in TMA's swizzled layout and stored by TMA with the Q box, which
  // skips the padding rows and clips positions past S.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && c4 == 0 && ok[i]) {  // m and l are the same in the row's quad
      // m is in the log2 domain of the scaled scores.
      lse[(static_cast<int64_t>(b) * H + kvh * G + row[i] % G) * S + pos[i]] =
          (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
    }
  }
  hopper::bar_sync(1 + wg, 128);  // every warp's products have read Q
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint32_t*>(Qw + hopper::swizzled<HD>(64, row[i], 8 * j + 2 * c4)) =
          hopper::pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  hopper::fence_async_smem();
  hopper::bar_sync(1 + wg, 128);
  if (t == 0) {
    for (int a = 0; a < A::kCount; ++a) {
      hopper::tma_store_5d(o_map, Qw + a * 64 * A::kRowBytes, a * A::kCols, 0, kvh, p0, b);
    }
    hopper::tma_store_commit();
    hopper::tma_store_wait();
  }
}

// Grid: (row tiles of kConsumers * P positions, B * Hk); a causal grid runs
// its heaviest tiles first.  Folded row r of a warpgroup's tile is position
// p0 + r / G, head kvh * G + r % G; rows r >= P * G are padding.  Warpgroups
// 0 .. kConsumers - 1 compute, the last warp loads.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(FwdTile<HD>::kThreads, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                            int S, int Sk, int H, int Hk, int P, float scale_log2) {
  using T = FwdTile<HD>;
  using A = hopper::Atoms<HD>;
  constexpr int kNC = T::kConsumers;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + kNC * T::kQBytes;
  uint8_t* Vs = Ks + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * T::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int G = H / Hk;
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int cta_p0 = tile * kNC * P;  // the block's first position
  int n_tiles = (Sk + kKeys - 1) / kKeys;
  if (kCausal) n_tiles = min(n_tiles, (min(cta_p0 + kNC * P, S) - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kNC * 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNC) {  // ---- producer warp: one thread keeps the ring full
    if (threadIdx.x == kNC * 128) {
      uint32_t q_bytes = 0;
      for (int w = 0; w < kNC; ++w) q_bytes += cta_p0 + w * P < S ? HD * G * P * 2 : 0;
      hopper::mbar_expect_tx(q_full, q_bytes);
      for (int w = 0; w < kNC; ++w) {
        if (cta_p0 + w * P >= S) continue;
        for (int a = 0; a < A::kCount; ++a) {
          hopper::tma_load_5d(Qs + w * T::kQBytes + a * 64 * A::kRowBytes, &q_map, q_full,
                              a * A::kCols, 0, kvh, cta_p0 + w * P, b);
        }
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&empty[st], (kt / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[st], 2 * T::kKVBytes);
        for (int a = 0; a < A::kCount; ++a) {
          const int off = st * T::kKVBytes + a * kKeys * A::kRowBytes;
          hopper::tma_load_4d(Ks + off, &k_map, &full[st], a * A::kCols, kvh, kt * kKeys, b);
          hopper::tma_load_4d(Vs + off, &v_map, &full[st], a * A::kCols, kvh, kt * kKeys, b);
        }
      }
    }
  } else {  // ---- consumer warpgroup wg
    fwd_consumer<HD, kCausal>(Qs + wg * T::kQBytes, Ks, Vs, q_full, full, empty, &o_map, lse, b,
                              kvh, cta_p0 + wg * P, n_tiles, S, Sk, H, G, P, scale_log2);
  }
}

// What a call launched, for the caller to read back: launched[0] the body
// (kBodyTf32x3 or kBodyBf16Wgmma, named by flash_attention_body_name),
// launched[1] the key ranges of its grid, launched[2] and [3] its row tiles
// and (batch, KV head) blocks, each launcher filling them from the grid it
// launched.
constexpr int kBodyTf32x3 = 0;
constexpr int kBodyBf16Wgmma = 1;
constexpr const char* kBodyNames[] = {"tf32x3_mma", "bf16_wgmma"};

template <int HD, bool kCausal>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                 int Sk, int H, int Hk, int* launched, cudaStream_t stream) {
  using T = FwdTile<HD>;
  const int G = H / Hk;
  if (G > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int P = hopper::folded_positions(G);
  CUtensorMap qm, km, vm, om;
  int e;
  if ((e = hopper::map_folded<HD>(&qm, "q", q, B, S, Hk, G, P)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&km, "k", k, B, Sk, Hk, T::kKeys)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&vm, "v", v, B, Sk, Hk, T::kKeys)) != 0) return e;
  if ((e = hopper::map_folded<HD>(&om, "out", out, B, S, Hk, G, P)) != 0) return e;
  auto kernel = flash_fwd_bf16_wgmma_kernel<HD, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_tile = T::kConsumers * P;
  const dim3 grid(static_cast<unsigned>((S + per_tile - 1) / per_tile),
                  static_cast<unsigned>(B * Hk));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, T::kThreads, T::kBytes, stream>>>(qm, km, vm, om, lse, S, Sk, H, Hk, P,
                                                   scale_log2);
  launched[0] = kBodyBf16Wgmma;
  launched[1] = 1;
  launched[2] = static_cast<int>(grid.x);
  launched[3] = static_cast<int>(grid.y);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ------------------------------------------------------ f32 body, 3xTF32

constexpr int kTcThreads = 128;  // 4 warps of 16 folded rows
constexpr int kTcRows = 64;      // folded query rows per block
constexpr int kTcKeys = 64;      // keys per KV tile
static_assert(kTcRows == kTcKeys, "Q, K and V tiles share one shape");

template <int HD>
struct TcSmem {
  static constexpr int kTile = kTcRows * HD;  // floats
  static constexpr int kP = kTcRows * kTcKeys;  // each warp's P, one float4 a lane and n-tile
  static constexpr size_t kBytes = sizeof(float) * (5 * kTile + kP);  // Q, K[2], V[2], P
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// Fragment layouts as csrc/flash_tf32x3.cuh gives them.  Whole walk
// (gridDim.z == 1): out and lse, normalised, as the bf16 body stores them.
// Split walk: range z stores its rows' unnormalised output into
// o_part[z] (B, S, H, hd), and their running max (log2 domain of the scaled
// scores) and sum into stat_part[z] and stat_part[ranges + z] (B, H, S).
template <int HD, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tf32x3_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ lse, float* __restrict__ o_part,
                            float* __restrict__ stat_part, int S, int Sk, int H, int Hk,
                            float scale_log2) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTile = TcSmem<HD>::kTile;
  constexpr int kDK = HD / 8;          // k-steps of Q K^T
  constexpr int kDN = HD / 8;          // n-tiles of the output
  constexpr int kKN = kTcKeys / 8;     // n-tiles of the score tile
  constexpr int kChunks = HD / 4;      // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile;      // two buffers
  float* Vs = Ks + 2 * kTile;  // two buffers

  const int G = H / Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kTcRows;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = (tid / 32) * 16;  // the warp's first row in the block
  // The warp's P: lane l's accumulator of n-tile j at Pw[j * 32 + l].
  float4* Pw = reinterpret_cast<float4*>(Vs + 2 * kTile) + (tid / 32) * kKN * 32;

  auto row_offset = [&](int64_t row) -> int64_t {  // folded row -> element of q / out
    const int64_t s = row / G;
    const int gg = static_cast<int>(row % G);
    return ((static_cast<int64_t>(b) * S + s) * H + kvh * G + gg) * HD;
  };
  auto load_kv = [&](int kt, int buf) {
    float* kd = Ks + buf * kTile;
    float* vd = Vs + buf * kTile;
    for (int i = tid; i < kTcKeys * kChunks; i += kTcThreads) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * 4;
      const int key = kt * kTcKeys + j;
      const bool ok = key < Sk;
      const int64_t off = ok ? ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + c : 0;
      cp_async16(smem_u32(kd + at<HD>(j, c)), k + off, ok);
      cp_async16(smem_u32(vd + at<HD>(j, c)), v + off, ok);
    }
  };

  int n_tiles = (Sk + kTcKeys - 1) / kTcKeys;
  if (kCausal) {
    const int64_t last_row = (row0 + kTcRows < rows_total ? row0 + kTcRows : rows_total) - 1;
    const int limit = static_cast<int>(last_row / G) / kTcKeys + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);

  if (kt0 < kt1) {
    for (int i = tid; i < kTcRows * kChunks; i += kTcThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 4;
      const int64_t row = row0 + r;
      const bool ok = row < rows_total;
      cp_async16(smem_u32(Qs + at<HD>(r, c)), q + (ok ? row_offset(row) + c : 0), ok);
    }
    load_kv(kt0, 0);
    cp_async_commit();
  }

  const int first_pos = static_cast<int>(row0 / G);
  const int pos0 = static_cast<int>((row0 + wrow + g) / G);  // rows g and g + 8
  const int pos1 = static_cast<int>((row0 + wrow + g + 8) / G);
  // Q's A fragment of k-step kk, from the Q tile.
  auto q_frag = [&](int kk) {
    const float x[4] = {Qs[at<HD>(wrow + g, 8 * kk + t4)], Qs[at<HD>(wrow + g + 8, 8 * kk + t4)],
                        Qs[at<HD>(wrow + g, 8 * kk + t4 + 4)],
                        Qs[at<HD>(wrow + g + 8, 8 * kk + t4 + 4)]};
    return FragA(x);
  };

  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt1) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    const float* kb = Ks + buf * kTile;
    const float* vb = Vs + buf * kTile;

    // S = Q K^T for the warp's 16 rows x 64 keys, keys permuted in n-tiles.
    // The k-steps are a loop, not unrolled, and Q's fragments are read each
    // step: held or unrolled, they and the K fragments hoisted ahead of the
    // products spill past 255 registers.
    float s[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kDK; ++kk) {
      const FragA a = q_frag(kk);
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const int key = 8 * j + perm8(g);
        const FragB bk(kb[at<HD>(key, 8 * kk + t4)], kb[at<HD>(key, 8 * kk + t4 + 4)]);
        mma3(s[j], a, bk);
      }
    }

    // Online softmax in the log2 domain; masks only on straddling tiles.
    // Element e of n-tile j: row g + 8 (e >> 1), key 8 j + t + 4 (e & 1).
    const int k0 = kt * kTcKeys;
    const bool edge = (kCausal && k0 + kTcKeys - 1 > first_pos) || k0 + kTcKeys > Sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + t4 + 4 * (e & 1);
          if (key >= Sk) {
            x = -INFINITY;  // past the end: no weight at all
          } else if (kCausal && key > (e < 2 ? pos0 : pos1)) {
            x = kNegInf;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V over the 8-key k-steps: n-tile kk's accumulator, keys kk + t
    // and kk + t + 4 in columns 2t and 2t + 1, is the A fragment as it is.
    // Each lane parks its P in the warp's slot and reads it back a k-step at
    // a time (its own values: no barrier), so the k-steps too are a loop.
#pragma unroll
    for (int j = 0; j < kKN; ++j) Pw[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
#pragma unroll 1
    for (int kk = 0; kk < kKN; ++kk) {
      const float4 x = Pw[kk * 32 + lane];
      const float pa[4] = {x.x, x.z, x.y, x.w};
      const FragA a(pa);
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        const FragB bv(vb[at<HD>(8 * kk + t4, 8 * n + g)], vb[at<HD>(8 * kk + t4 + 4, 8 * n + g)]);
        mma3(o[n], a, bv);
      }
    }
  }

  if (gridDim.z == 1) {
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row = row0 + wrow + g + 8 * i;
      if (row >= rows_total) continue;
      const float inv = i == 0 ? inv0 : inv1;
      float* orow = out + row_offset(row) + 2 * t4;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
      if (lse != nullptr && t4 == 0) {  // m and l are the same in the row's quad
        const int64_t s = row / G;
        const int gg = static_cast<int>(row % G);
        lse[(static_cast<int64_t>(b) * H + kvh * G + gg) * S + s] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
      }
    }
    return;
  }
  // A range with no key a row may see has m at -1e30 (causal masks only) and
  // counted each masked key in l and o: it stores l = 0 and o = 0, so the
  // merge gives it no weight.
  const int64_t n_stat = static_cast<int64_t>(gridDim.y / Hk) * H * S;  // B * H * S
  float* op = o_part + static_cast<int64_t>(blockIdx.z) * n_stat * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + wrow + g + 8 * i;
    if (row >= rows_total) continue;
    const bool none = m[i] <= kNegInf;
    float* orow = op + row_offset(row) + 2 * t4;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) =
          none ? make_float2(0.f, 0.f) : make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
    if (t4 == 0) {
      const int64_t s = row / G;
      const int gg = static_cast<int>(row % G);
      const int64_t st = (static_cast<int64_t>(b) * H + kvh * G + gg) * S + s;
      stat_part[static_cast<int64_t>(blockIdx.z) * n_stat + st] = m[i];
      stat_part[static_cast<int64_t>(gridDim.z + blockIdx.z) * n_stat + st] = none ? 0.f : l[i];
    }
  }
}

// The split walk's ranges combined, one warp a (b, s, h) row, in range order:
// m = max m_z, l = sum l_z 2^(m_z - m), out = sum o_z 2^(m_z - m) / max(l,
// 1e-30), lse = (m + log2 max(l, 1e-30)) ln 2.  Range 0 holds key 0, which
// every row sees, so m is finite.
__global__ void __launch_bounds__(256)
flash_fwd_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ stat_part,
                       float* __restrict__ out, float* __restrict__ lse, int64_t n_rows, int S,
                       int H, int hd, int ranges) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const int h = static_cast<int>(r % H);
  const int64_t bs = r / H;  // b * S + s
  const int64_t st = (bs / S * H + h) * S + bs % S;
  float m = -INFINITY;
  for (int z = 0; z < ranges; ++z) m = fmaxf(m, stat_part[z * n_rows + st]);
  float l = 0.f;
  for (int z = 0; z < ranges; ++z) {
    l += stat_part[(ranges + z) * n_rows + st] * exp2f(stat_part[z * n_rows + st] - m);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int z = 0; z < ranges; ++z) {
      acc += o_part[(z * n_rows + r) * hd + d] * exp2f(stat_part[z * n_rows + st] - m);
    }
    out[r * hd + d] = acc * inv;
  }
  if (lse != nullptr && lane == 0) lse[st] = (m + log2f(fmaxf(l, 1e-30f))) * kLn2;
}

template <int HD, bool kCausal>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* out, float* lse,
                          float* o_part, float* stat_part, int B, int S, int Sk, int H, int Hk,
                          int ranges, int* launched, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_mma_kernel<HD, kCausal>;
  const size_t smem = TcSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const dim3 grid(static_cast<unsigned>((rows + kTcRows - 1) / kTcRows),
                  static_cast<unsigned>(B * Hk), static_cast<unsigned>(ranges));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, o_part, stat_part, S, Sk, H, Hk, scale_log2);
  launched[0] = kBodyTf32x3;
  launched[1] = static_cast<int>(grid.z);
  launched[2] = static_cast<int>(grid.x);
  launched[3] = static_cast<int>(grid.y);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const int64_t n_rows = static_cast<int64_t>(B) * S * H;
  flash_fwd_merge_kernel<<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(
      o_part, stat_part, static_cast<float*>(out), lse, n_rows, S, H, HD, ranges);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- launchers

// bf16: the wgmma body, whole walk; f32: the 3xTF32 one, its key walk cut
// into `ranges`.
template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, float* o_part,
              float* stat_part, int B, int S, int Sk, int H, int Hk, bool bf16, bool causal,
              int ranges, int* launched, cudaStream_t stream) {
  if (bf16) {
    return causal ? launch_wgmma<HD, true>(q, k, v, out, lse, B, S, Sk, H, Hk, launched, stream)
                  : launch_wgmma<HD, false>(q, k, v, out, lse, B, S, Sk, H, Hk, launched, stream);
  }
  return static_cast<int>(
      causal ? launch_tf32x3<HD, true>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                       ranges, launched, stream)
             : launch_tf32x3<HD, false>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                        ranges, launched, stream));
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, float* o_part,
           float* stat_part, int B, int S, int Sk, int H, int Hk, int hd, bool bf16, bool causal,
           int ranges, int* launched, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, bf16, causal,
                           ranges, launched, stream);
    case 64:
      return launch_hd<64>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, bf16, causal,
                           ranges, launched, stream);
    case 128:
      return launch_hd<128>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, bf16, causal,
                            ranges, launched, stream);
    case 160:
      return launch_hd<160>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, bf16, causal,
                            ranges, launched, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 body), 1 = bfloat16 (wgmma body).  hd: 32, 64,
// 128 or 160.  q, k, v and out are contiguous and 16-byte aligned (TMA's
// rule for a tensor's base; its byte strides are multiples of 16 at these
// head dims); H % Hk == 0, B * Hk <= 65535, H / Hk <= 64 for bf16 (a
// folded tile holds at least one position); the wrapper checks all of it.
// lse is null or an f32 (B, H, S) buffer for the rows' log-sum-exp.
// key_ranges: the ranges of the f32 body's key walk (1 for bf16, 1 <=
// key_ranges <= 65535); above 1, o_part is f32 scratch of key_ranges * B * S
// * H * hd elements and stat_part of 2 * key_ranges * B * H * S.  On success
// launched (int[4]) holds the body the call ran (flash_attention_body_name),
// the key ranges it launched and its grid's x and y.  A TMA descriptor that does not
// encode returns hopper::kTmaEncodeError, and the error string gives why.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, float* o_part, float* stat_part, int B, int S, int Sk,
                           int H, int Hk, int hd, int dtype, int causal, int key_ranges,
                           int* launched, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((dtype != 0 && dtype != 1) || (dtype == 1 && H / Hk > 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (key_ranges < 1 || key_ranges > 65535 || (dtype == 1 && key_ranges != 1) ||
      (key_ranges > 1 && (o_part == nullptr || stat_part == nullptr)) || launched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, hd, dtype == 1,
                causal != 0, key_ranges, launched, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  if (err == hopper::kTmaEncodeError) return hopper::tma_error();
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The name of the body launched[0] reports.
const char* flash_attention_body_name(int code) {
  return code >= 0 && code < 2 ? kBodyNames[code] : "unknown";
}

}  // extern "C"
