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
//   * a row tile is (batch, KV head, 2 x P positions): two consumer
//     warpgroups of 64 folded rows each.  A folded row is (position, group
//     member), the G query heads of one KV head side by side as the TPU
//     kernel folds them, so each K/V tile is read once for all G heads;
//   * the grid is persistent: one block an SM walks the row tiles, heaviest
//     first (causal), dealt to the blocks back and forth so their sums of
//     work even out, so one tile's last products, softmax and stores run
//     under the next tile's Q and first K/V loads, and no block pays a
//     launch and an empty ring;
//   * a producer warpgroup, one thread of which issues every copy, lowers
//     itself to 24 registers a thread with setmaxnreg and the consumers rise
//     to 240 (hopper_wgmma.cuh), which hold S, P and O for 128-key tiles at
//     every head dim (the 168 of the whole block held 64 at hd 128 and
//     160); the tiles are 128 keys at hd 32 and 64, 64 above, which
//     measured faster there;
//   * TMA cannot gather rows one by one, so a warpgroup's Q tile is one box
//     of a 5-D view (hd, G, Hk, S, B) of q, box (atom columns, G, 1, P, 1)
//     with P = 64 / G whole positions: for G = 5 and 7 a tile holds 60 and 63
//     real rows, and the padding rows, which no box fills, are zeroed once,
//     get no weight and are never stored.  A warpgroup's Q is released once
//     its last S = Q K^T is done, and the output goes from registers to
//     global memory, so the next tile's Q loads under this tile's end;
//   * K and V tiles (a 4-D view (hd, Hk, Sk, B)) stream through a ring of
//     three stages that runs on across row tiles,
//     under mbarriers (full: the copy's bytes arrived; empty: every consumer
//     warp is done); TMA's zero fill past Sk replaces the copies' zero fill;
//   * tiles are laid out by TMA's 128-byte swizzle in atoms of 64 columns
//     (64-byte swizzle and 32 columns at hd 32 and 160): hd 128 is two atoms
//     along K.  S = Q K^T is an ss wgmma (both K-major); O += P V an rs
//     wgmma, P from registers in bf16 and V the transposed (MN-major)
//     operand, read through the descriptor, not ldmatrix.trans;
//   * the online softmax runs on the wgmma accumulator layout in f32
//     registers (row max and sum over quads, exp2 with the scale folded);
//     tile kt's Q K^T is issued with tile kt-1's P V, and the softmax of kt
//     runs while P V is in flight, and the other warpgroup's products run
//     under it;
//   * each warpgroup stops at its own causal limit; masks only on tiles
//     that straddle a limit.
// f32 (whisper's encoder and cross-attention, whose f32 frames JAX
// promotes), in 3xTF32 on the tensor cores: at hd 32 and 64
// flash_fwd_tf32x3_wgmma_kernel on wgmma, each operand split once into its
// TF32 parts in shared memory (described above it, below); at hd 128 and
// 160 flash_fwd_tf32x3_mma_kernel: FlashAttention-2 on mma.sync.m16n8k8 TF32
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
//     banks.  Q, K[2], V[2] and P take 1280 * hd + 16384 bytes (176 KB at
//     hd 128);
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
//     positions against 1500 frames: 48 blocks on 132 SMs), in both f32
//     bodies, the wrapper cuts
//     each block's key walk into ranges (flash_attention.py::dq_splits, the
//     backward's rule), a third grid dimension.  Each block then stores its
//     rows' unnormalised f32 output, running max and sum; a range that holds
//     no key a row may see stores a sum and output of 0.  flash_fwd_merge_kernel
//     combines the ranges in range order, no atomics: m = max m_z,
//     l = sum l_z 2^(m_z - m), o = sum o_z 2^(m_z - m) / l, lse = m + log l.
// Every body: masked scores are -1e30 as in the reference, keys past Sk get
// no weight, the row sum is floored at 1e-30 before the division, and ragged
// tails (S or Sk not a multiple of a tile) are masked in the kernel, so any
// S and Sk work (the Pallas wrapper needs exact blocks).
//
// With an `lse` buffer (f32, (B, H, S)) every body also stores each row's
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
// launches, hopper::kTmaEncodeError, or hopper::kHandOverError (a build whose
// registers setmaxnreg's hand-over cannot count on).

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
// kStages, a producer warpgroup that hands its registers to the consumers
// (hopper_wgmma.cuh: 168 a thread at launch, 240 a consumer thread after),
// which hold S, P and O for 128 keys at every head dim; at hd 128 and 160
// 64-key tiles measured faster all the same (scripts/kernel_compare.py
// --variant fwd_keys_128).  Three stages where they fit (a stage is
// released only once the P V that overlaps the next tile's softmax is
// done, so two leave the next load less time), else two.  Shared memory, each tile 1024-byte aligned: Q[kConsumers],
// K[kStages], V[kStages], then the mbarriers.
template <int HD>
struct FwdTile {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = hopper::kHandOverThreads;
  static constexpr int kKeys = HD <= 64 ? 128 : 64;
  static constexpr int kQBytes = 64 * HD * 2;
  static constexpr int kKVBytes = kKeys * HD * 2;
  static constexpr int kBarBytes = 8 * (2 * kConsumers + 2 * 3);
  static constexpr int kStages =
      1024 + kConsumers * kQBytes + 2 * 3 * kKVBytes + kBarBytes <= 232448 ? 3 : 2;
  static constexpr size_t kBytes = 1024 + kConsumers * kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static_assert(kThreads == 128 * (kConsumers + 1), "a producer warpgroup and the consumers");
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// A row tile of the grid (kConsumers * P positions of one (batch, KV head)):
// item j of the causal order is row tile row_tiles - 1 - j / n_bh (heaviest
// first), (batch, KV head) j % n_bh; the full order runs the tiles upwards.
struct FwdItem {
  int b, kvh, p0, n_tiles;
};

// The item of round k of block x's walk, the rounds dealt back and forth
// (x, then gridDim.x - 1 - x, ...) so each block's heavy and light tiles
// even out; >= items when the walk is over.
__device__ __forceinline__ int fwd_walk(int k) {
  const int n = static_cast<int>(gridDim.x);
  const int x = static_cast<int>(blockIdx.x);
  return k * n + ((k & 1) ? n - 1 - x : x);
}

template <int HD, bool kCausal>
__device__ __forceinline__ FwdItem fwd_item(int j, int n_bh, int Hk, int row_tiles, int per_tile,
                                            int S, int Sk) {
  constexpr int kKeys = FwdTile<HD>::kKeys;
  const int t = j / n_bh;
  const int bh = j % n_bh;
  FwdItem it;
  it.b = bh / Hk;
  it.kvh = bh % Hk;
  it.p0 = (kCausal ? row_tiles - 1 - t : t) * per_tile;
  it.n_tiles = (Sk + kKeys - 1) / kKeys;
  if (kCausal) it.n_tiles = min(it.n_tiles, (min(it.p0 + per_tile, S) - 1) / kKeys + 1);
  return it;
}

// One consumer warpgroup's walk over the block's items: for each, 64 folded
// rows from position p0 (rows r < P * G real), key tiles [0, n_mine) of the
// item's n_tiles computed, the rest only released.  The products of one
// tile overlap the softmax of the next: tile kt's S = Q K^T is issued with
// tile kt-1's O += P V, and the softmax of S runs while P V is in flight.
// Q is released as soon as its last S product is done, so the producer
// loads the next item's Q under this item's last softmax, P V and stores;
// the output goes from registers straight to global memory.
template <int HD, bool kCausal>
__device__ __forceinline__ void fwd_consumer(uint8_t* Qw, const uint8_t* Ks, const uint8_t* Vs,
                                             uint64_t* q_full, uint64_t* q_empty, uint64_t* full,
                                             uint64_t* empty, bf16* __restrict__ out,
                                             float* __restrict__ lse, int S, int Sk, int H, int Hk,
                                             int n_bh, int row_tiles, int P, float scale_log2) {
  using T = FwdTile<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  const int t = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int G = H / Hk;
  const int rows_real = P * G;
  const int per_tile = T::kConsumers * P;
  if (rows_real < 64) {  // padding rows no box fills: zero once, so they stay finite
    for (int i = t; i < (64 - rows_real) * (HD / 8); i += 128) {
      const int r = rows_real + i / (HD / 8);
      *reinterpret_cast<uint4*>(Qw + hopper::swizzled<HD>(64, r, (i % (HD / 8)) * 8)) =
          make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async_smem();
  }
  hopper::bar_sync(1 + wg, 128);

  float o[HD / 2];
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];
  float m[2], l[2];
  const uint32_t q_addr = smem_u32(Qw);
  int kv = 0;  // ring slots this warpgroup consumed before the item
  for (int li = 0, j = fwd_walk(0); j < row_tiles * n_bh; j = fwd_walk(++li)) {
    const FwdItem it = fwd_item<HD, kCausal>(j, n_bh, Hk, row_tiles, per_tile, S, Sk);
    const int p0 = it.p0 + wg * P;
    // This thread's rows r0 = 16 warp + g and r0 + 8.
    int row[2], pos[2];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = 16 * warp + g + 8 * i;
      pos[i] = p0 + row[i] / G;
      ok[i] = row[i] < rows_real && pos[i] < S;
    }
    int n_mine = p0 < S ? it.n_tiles : 0;
    if (kCausal && p0 < S) n_mine = min(it.n_tiles, (min(p0 + P, S) - 1) / kKeys + 1);

    const auto slot = [&](int kt) { return (kv + kt) % kStages; };
    const auto parity = [&](int kt) { return static_cast<uint32_t>(((kv + kt) / kStages) & 1); };
    const auto k_addr = [&](int kt) { return smem_u32(Ks + slot(kt) * T::kKVBytes); };
    const auto v_addr = [&](int kt) { return smem_u32(Vs + slot(kt) * T::kKVBytes); };
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
    // masks only on straddling tiles.  The row max is taken on the raw
    // scores (the scale is positive) and the scale folded into one FFMA
    // before the exp2.  Returns each row's rescale of O in corr.
    const auto softmax = [&](int kt, float (&corr)[2]) {
      const int k0 = kt * kKeys;
      if ((kCausal && k0 + kKeys - 1 > p0) || k0 + kKeys > Sk) {
#pragma unroll
        for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * jj + 2 * c4 + (e & 1);
            if (key >= Sk) {
              s[4 * jj + e] = -INFINITY;  // past the end: no weight at all
            } else if (kCausal && key > pos[e >> 1]) {
              s[4 * jj + e] = kNegInf / scale_log2;  // -1e30 once scaled
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
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
      for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hopper::ex2(fmaf(s[4 * jj + e], scale_log2, shift[e >> 1]));
          s[4 * jj + e] = p;
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
    const auto release = [&](int kt) {  // this warp is done with tile kt's slot
      if (lane == 0) hopper::mbar_arrive(&empty[slot(kt)]);
    };
    const auto release_q = [&]() {  // every warp's products have read Q
      if (lane == 0) hopper::mbar_arrive(&q_empty[wg]);
    };

    hopper::zero(o);
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    hopper::mbar_wait(&q_full[wg], li & 1);
    if (n_mine > 0) {
      float corr[2];
      hopper::mbar_wait(&full[slot(0)], parity(0));
      hopper::fence();
      issue_s(0);
      hopper::wait<0>();
      hopper::fence_regs(s);
      if (n_mine == 1) release_q();
      softmax(0, corr);  // O is zero: nothing to rescale
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) hopper::acc_as_a(pa[kk], s, kk);
      for (int kt = 1; kt < n_mine; ++kt) {
        hopper::mbar_wait(&full[slot(kt)], parity(kt));
        hopper::fence_regs(o);
        hopper::fence();
        issue_s(kt);
        issue_pv(kt - 1);
        hopper::wait<1>();  // S of tile kt (committed first) is complete
        hopper::fence_regs(s);
        if (kt == n_mine - 1) release_q();
        softmax(kt, corr);
        hopper::wait<0>();  // P V of tile kt - 1
        hopper::fence_regs(o);
        release(kt - 1);
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          o[4 * jj + 0] *= corr[0];
          o[4 * jj + 1] *= corr[0];
          o[4 * jj + 2] *= corr[1];
          o[4 * jj + 3] *= corr[1];
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
    } else {
      release_q();
    }
    for (int kt = n_mine; kt < it.n_tiles; ++kt) {  // tiles past this warpgroup's limit
      hopper::mbar_wait(&full[slot(kt)], parity(kt));
      release(kt);
    }
    kv += it.n_tiles;
    if (p0 >= S) continue;

    // Normalise; the LSE and the output from registers (the output's rows
    // are the folded rows' (position, head) vectors of q's layout).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!ok[i]) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      const int h = it.kvh * G + row[i] % G;
      if (lse != nullptr && c4 == 0) {  // m and l are the same in the row's quad
        // m is in the log2 domain of the scaled scores.
        lse[(static_cast<int64_t>(it.b) * H + h) * S + pos[i]] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
      }
      bf16* orow = out + ((static_cast<int64_t>(it.b) * S + pos[i]) * H + h) * HD + 2 * c4;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
            hopper::pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
      }
    }
  }
}

// Grid: min(items, SMs) blocks, block x walking items x, 2 gridDim.x - 1 -
// x, 2 gridDim.x + x, ... of fwd_item's order (fwd_walk).  An item is a
// row tile of kConsumers * P positions of one (batch, KV head): folded row r
// of consumer warpgroup w's tile is position p0 + w P + r / G, head kvh * G
// + r % G; rows r >= P * G are padding.  Warpgroups 0 .. kConsumers - 1
// compute, the last loads: its first thread issues every copy, for each item
// the consumers' Q tiles (each once that warpgroup released the previous
// one) and the item's K/V tiles through the ring, which runs on across
// items, so the next item's first tiles load under this one's last.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(FwdTile<HD>::kThreads, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                            float* __restrict__ lse, int S, int Sk, int H, int Hk, int n_bh, int P,
                            int row_tiles, float scale_log2) {
  using T = FwdTile<HD>;
  using A = hopper::Atoms<HD>;
  using HandOver = hopper::HandOver<24>;  // a producer thread issues copies only
  constexpr int kNC = T::kConsumers;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + kNC * T::kQBytes;
  uint8_t* Vs = Ks + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * T::kKVBytes);
  uint64_t* q_empty = q_full + kNC;
  uint64_t* full = q_empty + kNC;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kNC; ++w) {
      hopper::mbar_init(&q_full[w], 1);
      hopper::mbar_init(&q_empty[w], 4);  // lane 0 of each warp of the warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kNC * 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kNC * 128) {  // ---- producer warpgroup
    HandOver::producer();
    if (threadIdx.x == kNC * 128) {
      const int G = H / Hk;
      const int per_tile = kNC * P;
      int kv = 0;
      for (int li = 0, j = fwd_walk(0); j < row_tiles * n_bh; j = fwd_walk(++li)) {
        const FwdItem it = fwd_item<HD, kCausal>(j, n_bh, Hk, row_tiles, per_tile, S, Sk);
        for (int w = 0; w < kNC; ++w) {
          const int p0 = it.p0 + w * P;
          if (li > 0) hopper::mbar_wait(&q_empty[w], (li - 1) & 1);
          hopper::mbar_expect_tx(&q_full[w], p0 < S ? HD * G * P * 2 : 0);
          if (p0 >= S) continue;
          for (int a = 0; a < A::kCount; ++a) {
            hopper::tma_load_5d(Qs + w * T::kQBytes + a * 64 * A::kRowBytes, &q_map, &q_full[w],
                                a * A::kCols, 0, it.kvh, p0, it.b);
          }
        }
        for (int kt = 0; kt < it.n_tiles; ++kt, ++kv) {
          const int st = kv % kStages;
          if (kv >= kStages) hopper::mbar_wait(&empty[st], (kv / kStages - 1) & 1);
          hopper::mbar_expect_tx(&full[st], 2 * T::kKVBytes);
          for (int a = 0; a < A::kCount; ++a) {
            const int off = st * T::kKVBytes + a * kKeys * A::kRowBytes;
            hopper::tma_load_4d(Ks + off, &k_map, &full[st], a * A::kCols, it.kvh, kt * kKeys,
                                it.b);
            hopper::tma_load_4d(Vs + off, &v_map, &full[st], a * A::kCols, it.kvh, kt * kKeys,
                                it.b);
          }
        }
      }
    }
  } else {  // ---- consumer warpgroup
    HandOver::consumer();
    fwd_consumer<HD, kCausal>(Qs + (threadIdx.x / 128) * T::kQBytes, Ks, Vs, q_full, q_empty, full,
                              empty, out, lse, S, Sk, H, Hk, n_bh, row_tiles, P, scale_log2);
  }
}

// What a call launched, for the caller to read back: launched[0] the body
// (kBodyTf32x3 or kBodyBf16Wgmma, named by flash_attention_body_name),
// launched[1] the key ranges of its grid, launched[2] and [3] its row tiles
// and (batch, KV head) blocks, launched[4] the blocks it launched (bf16:
// the persistent blocks; f32: row tiles x (batch, KV head) x ranges), each
// launcher filling them from the grid it launched.
constexpr int kBodyTf32x3 = 0;
constexpr int kBodyBf16Wgmma = 1;
constexpr int kBodyTf32x3Wgmma = 2;
constexpr const char* kBodyNames[] = {"tf32x3_mma", "bf16_wgmma", "tf32x3_wgmma"};

// The card's SMs, asked of the runtime once a device.
inline int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0) {
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  }
  return counts[device];
}

template <int HD, bool kCausal>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                 int Sk, int H, int Hk, int device, int* launched, cudaStream_t stream) {
  using T = FwdTile<HD>;
  const int G = H / Hk;
  if (G > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int P = hopper::folded_positions(G);
  CUtensorMap qm, km, vm;
  int e;
  if ((e = hopper::map_folded<HD>(&qm, "q", q, B, S, Hk, G, P)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&km, "k", k, B, Sk, Hk, T::kKeys)) != 0) return e;
  if ((e = hopper::map_rows<HD>(&vm, "v", v, B, Sk, Hk, T::kKeys)) != 0) return e;
  auto kernel = flash_fwd_bf16_wgmma_kernel<HD, kCausal>;
  static int regs = -1;
  if ((e = hopper::launch_regs_ok(reinterpret_cast<const void*>(kernel),
                                  "flash_fwd_bf16_wgmma_kernel", &regs)) != 0) {
    return e;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_tile = T::kConsumers * P;
  const int row_tiles = (S + per_tile - 1) / per_tile;
  const int items = row_tiles * B * Hk;
  const int sms = sm_count(device);
  const int blocks = sms > 0 && sms < items ? sms : items;  // persistent
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<blocks, T::kThreads, T::kBytes, stream>>>(qm, km, vm, static_cast<bf16*>(out), lse, S,
                                                     Sk, H, Hk, B * Hk, P, row_tiles, scale_log2);
  launched[0] = kBodyBf16Wgmma;
  launched[1] = 1;
  launched[2] = row_tiles;
  launched[3] = B * Hk;
  launched[4] = blocks;
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

// ------------------------------------------- f32 body on wgmma, 3xTF32
//
// flash_fwd_tf32x3_wgmma_kernel, hd 32 and 64 (whisper's encoder and
// cross-attention): the products on Hopper's warpgroup wgmma in TF32, each
// as three (small x big, big x small, big x big into one f32 accumulator),
// on K and V tiles split once into their TF32 parts in shared memory.  The
// mma.sync body above split every operand at every warp's read (each K and
// V value once by each of its 4 warps, Q again for each key tile), about
// two issue slots beside each product, so its products waited on issue; and
// mma.sync does not reach wgmma's rate.  What the design does:
//   * a block is 128 folded rows (two consumer warpgroups of 64) of one
//     (batch, KV head) and one key range, as the mma.sync body's grid with
//     twice its rows, so each K/V tile is loaded and split once for 128
//     rows.  Q is loaded once and split: its big part held as the A
//     fragments of S = Q K^T in registers (rs), its small part K-major in
//     shared memory (ss);
//   * a producer warpgroup: one thread issues TMA copies of K (64 keys x hd)
//     and of V (four quarters of 16 keys) into a ring of stages (three at hd
//     64: 3 x 64 KB beside Q's small parts, 2 x 16 KB), and three splitter
//     warps round K in place beside its remainder and transpose V's
//     quarters into V^T's big and small parts (over V's raw quarters, each
//     read whole before any is written), which P V reads K-major, its keys
//     permuted by sigma8 (flash_tf32x3.cuh) so the S accumulator is P's A
//     fragment as it stands; a stage is "ready" once split, so the consumers
//     never wait on raw tiles.  The producer gives its registers to the
//     consumers (setmaxnreg, HandOver<kTf32Producer>);
//   * each consumer runs a tile through S, its softmax, O's rescale and P V
//     (in two halves of 32 keys), waiting on each product, and the other
//     warpgroup's products run under its softmax.  The bf16 body's overlap
//     (tile j's S issued with tile j - 1's P V) held S, P's split
//     fragments, O and Q's at once, and ptxas spilled and serialized the
//     products (C7512);
//   * where all the folded rows of a (batch, KV head) fit one warpgroup
//     (whisper's 64 decoder positions), the two consumers share them and
//     take the tiles in turn, the second handing its output, running max and
//     sum to the first through shared memory at the end;
//   * the split walk, its partials and flash_fwd_merge_kernel are the
//     mma.sync body's.
// At hd 128 and 160 the f32 forward keeps the mma.sync body: Q's big part
// (hd 128: 64 registers) beside O (64) and S, P's fragments and a 64-key
// stage of 128 KB beside Q's small parts (2 x 32 KB) leave no ring of two
// stages in the 227 KB.

template <int HD>
struct Tf32FwdTile {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = hopper::kHandOverThreads;
  static constexpr int kRows = 64 * kConsumers;  // folded rows a block
  static constexpr int kKeys = 64;
  static constexpr int kQSmall = 64 * HD * 4;  // a consumer's Q, small part
  static constexpr int kPart = kKeys * HD * 4;  // one part (big or small) of K or of V^T
  static constexpr int kStageBytes = 4 * kPart;  // K big, K small, V^T big, V^T small
  static constexpr int kMaxStages = 4;
  static constexpr int kBarBytes = 8 * 3 * kMaxStages;
  static constexpr int kMergeBytes = 64 * 2 * 4;  // a shared row tile's running max and sum
  static constexpr int kFit =
      (232448 - 1024 - kBarBytes - kMergeBytes - kConsumers * kQSmall) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = 1024 + static_cast<size_t>(kConsumers) * kQSmall +
                                   static_cast<size_t>(kStages) * kStageBytes + kBarBytes +
                                   kMergeBytes;
  static_assert(HD == 32 || HD == 64, "the wgmma f32 body serves hd 32 and 64");
  static_assert(kStages >= 2, "a stage splits while the consumers read the other");
  static_assert(kQSmall == 128 * (HD / 2) * 4, "a consumer's O fits its Q small part");
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// The online softmax of a 64-key S tile in the log2 domain, in place (P in
// f32), as the bf16 body's: masks only on a straddling tile, the row max on
// the raw scores and the scale folded into one FFMA before the exp2.
template <bool kCausal>
__device__ __forceinline__ void tf32_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&pos)[2], int k0,
                                             bool edge, int Sk, float scale_log2) {
  const int c4 = (threadIdx.x % 32) & 3;
  if (edge) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * jj + 2 * c4 + (e & 1);
        if (key >= Sk) {
          s[4 * jj + e] = -INFINITY;  // past the end: no weight at all
        } else if (kCausal && key > pos[e >> 1]) {
          s[4 * jj + e] = kNegInf / scale_log2;  // -1e30 once scaled
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
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
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::ex2(fmaf(s[4 * jj + e], scale_log2, shift[e >> 1]));
      s[4 * jj + e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * corr[i] + sum[i];
  }
}

// One consumer warpgroup: folded rows row0 .. row0 + 63, the block's key
// tiles j = 0 .. n - 1 (key tile kt0 + j, ring slot j % kStages), those past
// its rows' causal limit only released; with `share`, the two warpgroups
// hold the same rows and take the tiles in turn (j % 2 == wg), and the
// second hands its output, running max and sum to the first through shared
// memory (merge_o, merge_ml), which combines them.  Whole walk (gridDim.z
// == 1): out and lse normalised; split: the unnormalised output, running max
// and sum of range blockIdx.z, as the mma.sync body stores them.
template <int HD, bool kCausal>
__device__ __forceinline__ void tf32_fwd_consumer(uint8_t* q_small, const uint8_t* ring,
                                                  uint64_t* ready, uint64_t* empty,
                                                  float* merge_ml, const float* __restrict__ q,
                                                  float* __restrict__ out, float* __restrict__ lse,
                                                  float* __restrict__ o_part,
                                                  float* __restrict__ stat_part, int S, int Sk,
                                                  int H, int Hk, int64_t row0, int kt0, int n,
                                                  bool share, float scale_log2) {
  using T = Tf32FwdTile<HD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  constexpr int kDK = HD / 8;  // k-steps of Q K^T
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
  // This thread's rows 16 warp + g and + 8: (position, head) and q's offset.
  int64_t row[2], off[2];
  int pos[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + 16 * warp + g + 8 * i;
    ok[i] = row[i] < rows_total;
    pos[i] = static_cast<int>(row[i] / G);
    off[i] = ((static_cast<int64_t>(b) * S + pos[i]) * H + kvh * G + row[i] % G) * HD;
  }
  // Q split once: its big part as the A fragments of S = Q K^T in registers
  // (k-step kk: rows g and g + 8, columns 8 kk + c4 and + 4), its small part
  // K-major in shared memory (registers for both spilled: ptxas C7512).
  uint32_t qb[kDK][4];
#pragma unroll
  for (int kk = 0; kk < kDK; ++kk) {
    const int c = 8 * kk + c4;
    const float x[4] = {ok[0] ? __ldg(q + off[0] + c) : 0.f, ok[1] ? __ldg(q + off[1] + c) : 0.f,
                        ok[0] ? __ldg(q + off[0] + c + 4) : 0.f,
                        ok[1] ? __ldg(q + off[1] + c + 4) : 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qb[kk][i] = __float_as_uint(tf32_big(x[i]));
      const int r = 16 * warp + g + 8 * (i & 1);
      *reinterpret_cast<float*>(q_small + hopper::f32_at<128>(64, r, c + 4 * (i >> 1))) =
          x[i] - tf32_big(x[i]);
    }
  }
  hopper::fence_async_smem();
  hopper::bar_sync(1 + wg, 128);
  const uint32_t qs_addr = smem_u32(q_small);
  int n_mine = row0 < rows_total ? n : 0;
  if (kCausal && n_mine > 0) {
    const int64_t last = (row0 + 64 < rows_total ? row0 + 64 : rows_total) - 1;
    n_mine = max(0, min(n, static_cast<int>(last / G) / kKeys + 1 - kt0));
  }
  const int first_pos = static_cast<int>(row0 / G);

  const auto slot = [&](int j) { return j % kStages; };
  const auto part = [&](int j, int p) {
    return smem_u32(ring + slot(j) * T::kStageBytes + p * T::kPart);
  };
  float o[HD / 2];
  float s[kKeys / 2];
  uint32_t pb[kKeys / 16][4], ps[kKeys / 16][4];  // half of P's split fragments
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  hopper::zero(o);
  // Tile by tile: S = Q K^T, its softmax, O rescaled, O += P V, each a wait
  // on the products; the other warpgroup's products run under this one's
  // softmax.  (Tile j's S issued with tile j - 1's P V, as the bf16 body
  // does, kept S, P's fragments and O live at once: ptxas spilled and
  // serialized the products, C7512.)
  for (int j = share ? wg : 0; j < n; j += share ? 2 : 1) {
    hopper::mbar_wait(&ready[slot(j)], static_cast<uint32_t>((j / kStages) & 1));
    if (j < n_mine) {
      const uint32_t kb = part(j, 0), ks = part(j, 1), vb = part(j, 2), vs = part(j, 3);
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {  // S = Q K^T, 3xTF32
        hopper::MmaTf32<kKeys>::ss(s, hopper::f32_desc<128>(qs_addr, 64, kk),
                                   hopper::f32_desc<128>(kb, kKeys, kk), kk > 0);
        hopper::MmaTf32<kKeys>::rs(s, qb[kk], hopper::f32_desc<128>(ks, kKeys, kk), 1);
        hopper::MmaTf32<kKeys>::rs(s, qb[kk], hopper::f32_desc<128>(kb, kKeys, kk), 1);
      }
      hopper::commit();
      hopper::wait<0>();
      hopper::fence_regs(s);
      const int k0 = (kt0 + j) * kKeys;
      const bool edge = (kCausal && k0 + kKeys - 1 > first_pos) || k0 + kKeys > Sk;
      float corr[2];
      tf32_softmax<kCausal>(s, m, l, corr, pos, k0, edge, Sk, scale_log2);
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        o[4 * jj + 0] *= corr[0];
        o[4 * jj + 1] *= corr[0];
        o[4 * jj + 2] *= corr[1];
        o[4 * jj + 3] *= corr[1];
      }
      // O += P V against V^T, 3xTF32, in two halves of 32 keys, so half of
      // P's split fragments are live at a time (all of them beside S, O and
      // Q's fragments made ptxas serialize the products, C7512).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) acc_frag_tf32(s, 4 * h + kk, pb[kk], ps[kk]);
        hopper::fence_regs(o);
        hopper::fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const int k8 = 4 * h + kk;
          hopper::MmaTf32<HD>::rs(o, ps[kk], hopper::f32_desc<64>(vb, HD, k8), 1);
          hopper::MmaTf32<HD>::rs(o, pb[kk], hopper::f32_desc<64>(vs, HD, k8), 1);
          hopper::MmaTf32<HD>::rs(o, pb[kk], hopper::f32_desc<64>(vb, HD, k8), 1);
        }
        hopper::commit();
        hopper::wait<0>();
        hopper::fence_regs(o);
      }
    }
    if (lane == 0) hopper::mbar_arrive(&empty[slot(j)]);
  }

  if (share) {  // the second warpgroup's sums to the first (same thread, same rows)
    float* merge_o = reinterpret_cast<float*>(q_small);  // the second's Q, read no more
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) merge_o[i * 128 + t] = o[i];
      if (c4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          merge_ml[2 * (16 * warp + g + 8 * i)] = m[i];
          merge_ml[2 * (16 * warp + g + 8 * i) + 1] = l[i];
        }
      }
      hopper::bar_arrive(4, 256);
      return;
    }
    hopper::bar_sync(4, 256);
    merge_o += T::kQSmall / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = merge_ml[2 * (16 * warp + g + 8 * i)];
      const float l1 = merge_ml[2 * (16 * warp + g + 8 * i) + 1];
      const float mx = fmaxf(m[i], m1);
      const float a0 = hopper::ex2(m[i] - mx), a1 = hopper::ex2(m1 - mx);
      m[i] = mx;
      l[i] = l[i] * a0 + l1 * a1;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * jj + 2 * i + e;
          o[r] = o[r] * a0 + merge_o[r * 128 + t] * a1;
        }
      }
    }
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!ok[i]) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      float* orow = out + off[i] + 2 * c4;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        *reinterpret_cast<float2*>(orow + 8 * jj) =
            make_float2(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
      }
      if (lse != nullptr && c4 == 0) {  // m and l are the same in the row's quad
        lse[(static_cast<int64_t>(b) * H + kvh * G + row[i] % G) * S + pos[i]] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
      }
    }
    return;
  }
  // A range with no key a row may see stores l = 0 and o = 0 (its m stays
  // near -1e30: its tiles were skipped or all masked), so the merge gives it
  // no weight.
  const int64_t n_stat = static_cast<int64_t>(gridDim.y / Hk) * H * S;  // B * H * S
  float* op = o_part + static_cast<int64_t>(blockIdx.z) * n_stat * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    const bool none = m[i] < 0.5f * kNegInf;
    float* orow = op + off[i] + 2 * c4;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<float2*>(orow + 8 * jj) =
          none ? make_float2(0.f, 0.f) : make_float2(o[4 * jj + 2 * i], o[4 * jj + 2 * i + 1]);
    }
    if (c4 == 0) {
      const int64_t st = (static_cast<int64_t>(b) * H + kvh * G + row[i] % G) * S + pos[i];
      stat_part[static_cast<int64_t>(blockIdx.z) * n_stat + st] = m[i];
      stat_part[static_cast<int64_t>(gridDim.z + blockIdx.z) * n_stat + st] = none ? 0.f : l[i];
    }
  }
}

// Grid (row tiles of 128 folded rows, or of 64 with `share`, B * Hk, key
// ranges), causal tiles heaviest first; block (x, y, z) walks key range z
// (key_range) of the 64-key tiles its rows see.  Threads: two consumer
// warpgroups, then the producer warpgroup (warp 0's first lane issues the
// copies, warps 1-3 split).  `share` (the launcher's choice where all the
// folded rows of a (batch, KV head) fit one warpgroup, as whisper's 64
// decoder positions): both consumers on the same 64 rows, each tile to one
// of them in turn, so neither idles.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(Tf32FwdTile<HD>::kThreads, 1)
flash_fwd_tf32x3_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ q, float* __restrict__ out,
                              float* __restrict__ lse, float* __restrict__ o_part,
                              float* __restrict__ stat_part, int S, int Sk, int H, int Hk,
                              int share, float scale_log2) {
  using T = Tf32FwdTile<HD>;
  using HandOver = hopper::HandOver<kTf32Producer>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  constexpr int kNC = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint8_t* q_small = ring + kStages * T::kStageBytes;  // [kConsumers] Q small parts
  uint64_t* full = reinterpret_cast<uint64_t*>(q_small + kNC * T::kQSmall);
  uint64_t* ready = full + kStages;
  uint64_t* empty = ready + kStages;
  float* merge_ml = reinterpret_cast<float*>(full + 3 * T::kMaxStages);

  const int G = H / Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const int rows = share ? 64 : T::kRows;  // folded rows of the block
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * rows;
  const int b = static_cast<int>(blockIdx.y) / Hk;
  const int kvh = static_cast<int>(blockIdx.y) % Hk;
  int n_tiles = (Sk + kKeys - 1) / kKeys;
  if (kCausal) {
    const int64_t last = (row0 + rows < rows_total ? row0 + rows : rows_total) - 1;
    n_tiles = min(n_tiles, static_cast<int>(last / G) / kKeys + 1);
  }
  int kt0, kt1;
  key_range(n_tiles, kt0, kt1);
  const int n = kt1 - kt0;

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
    HandOver::producer();
    const int t = threadIdx.x - kNC * 128;
    if (t == 0) {  // the copies: K raw into K's big part, V's quarters into V^T's small
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&full[st], 2 * T::kPart);
        const int k0 = (kt0 + j) * kKeys;
        uint8_t* base = ring + st * T::kStageBytes;
        for (int a = 0; a < HD / 32; ++a) {
          hopper::tma_load_4d(base + a * kKeys * 128, &k_map, &full[st], 32 * a, kvh, k0, b);
          for (int qq = 0; qq < 4; ++qq) {
            hopper::tma_load_4d(base + 3 * T::kPart + qq * HD * 64 + a * 16 * 128, &v_map,
                                &full[st], 32 * a, kvh, k0 + 16 * qq, b);
          }
        }
      }
    } else if (t >= 32) {  // the splitters
      const int sp = t - 32;
      // This splitter's 4 x 4 block of a V quarter: V^T rows d0 .. d0 + 3,
      // columns 4 b4 .. 4 b4 + 3 of the quarter (keys 8 (b4 / 2) + 2 i + b4 % 2).
      const bool mine = sp < HD;
      const int d0 = 4 * (sp % (HD / 4));
      const int b4 = sp / (HD / 4);
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        hopper::mbar_wait(&full[st], (j / kStages) & 1);
        uint8_t* kb = ring + st * T::kStageBytes;
        uint8_t* vb = kb + 2 * T::kPart;
        uint8_t* vs = kb + 3 * T::kPart;
        split_copy(kb, kb, kb + T::kPart, T::kPart, sp);
        for (int qq = 0; qq < 4; ++qq) {
          uint8_t* raw = vs + qq * HD * 64;
          float4 x[4];
          if (mine) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = 8 * (b4 >> 1) + 2 * i + (b4 & 1);
              x[i] = *reinterpret_cast<const float4*>(raw + hopper::f32_at<128>(16, key, d0));
            }
          }
          hopper::bar_sync(3, kSplitThreads);  // every raw key of the quarter is read
          if (mine) {
            const float4 y[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                                 make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                                 make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                                 make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float4 small;
              const float4 big = split4(y[jj], small);
              const uint32_t o = hopper::f32_at<64>(HD, d0 + jj, 16 * qq + 4 * b4);
              *reinterpret_cast<float4*>(vb + o) = big;
              *reinterpret_cast<float4*>(vs + o) = small;
            }
          }
        }
        hopper::fence_async_smem();
        hopper::mbar_arrive(&ready[st]);
      }
    }
  } else {  // ---- consumer warpgroups
    HandOver::consumer();
    const int wg = static_cast<int>(threadIdx.x / 128);
    tf32_fwd_consumer<HD, kCausal>(q_small + wg * T::kQSmall, ring, ready, empty, merge_ml, q,
                                   out, lse, o_part, stat_part, S, Sk, H, Hk,
                                   row0 + (share ? 0 : 64 * wg), kt0, n, share != 0, scale_log2);
  }
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
  launched[4] = static_cast<int>(grid.x * grid.y * grid.z);
  return cudaGetLastError();
}

template <int HD, bool kCausal>
int launch_tf32x3_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                        float* o_part, float* stat_part, int B, int S, int Sk, int H, int Hk,
                        int ranges, int* launched, cudaStream_t stream) {
  using T = Tf32FwdTile<HD>;
  CUtensorMap km, vm;
  int e;
  if ((e = hopper::map_rows_f32<HD>(&km, "k", k, B, Sk, Hk, T::kKeys)) != 0) return e;
  if ((e = hopper::map_rows_f32<HD>(&vm, "v", v, B, Sk, Hk, 16)) != 0) return e;
  auto kernel = flash_fwd_tf32x3_wgmma_kernel<HD, kCausal>;
  static int regs = -1;
  if ((e = hopper::launch_regs_ok(reinterpret_cast<const void*>(kernel),
                                  "flash_fwd_tf32x3_wgmma_kernel", &regs)) != 0) {
    return e;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const int share = rows <= 64 ? 1 : 0;  // one warpgroup's rows: the two share them
  const int per_block = share ? 64 : T::kRows;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block),
                  static_cast<unsigned>(B * Hk), static_cast<unsigned>(ranges));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, T::kThreads, T::kBytes, stream>>>(km, vm, static_cast<const float*>(q),
                                                   static_cast<float*>(out), lse, o_part,
                                                   stat_part, S, Sk, H, Hk, share, scale_log2);
  launched[0] = kBodyTf32x3Wgmma;
  launched[1] = static_cast<int>(grid.z);
  launched[2] = static_cast<int>(grid.x);
  launched[3] = static_cast<int>(grid.y);
  launched[4] = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(cudaGetLastError());
}

// f32: the wgmma body at hd 32 and 64, the mma.sync one above; then, where
// the walk is split, the merge.
template <int HD, bool kCausal>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, float* o_part,
               float* stat_part, int B, int S, int Sk, int H, int Hk, int ranges, int* launched,
               cudaStream_t stream) {
  int err;
  if constexpr (HD <= 64) {
    err = launch_tf32x3_wgmma<HD, kCausal>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                           ranges, launched, stream);
  } else {
    err = static_cast<int>(launch_tf32x3<HD, kCausal>(q, k, v, out, lse, o_part, stat_part, B,
                                                      S, Sk, H, Hk, ranges, launched, stream));
  }
  if (err != 0 || ranges == 1) return err;
  const int64_t n_rows = static_cast<int64_t>(B) * S * H;
  flash_fwd_merge_kernel<<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(
      o_part, stat_part, static_cast<float*>(out), lse, n_rows, S, H, HD, ranges);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- launchers

// bf16: the wgmma body, whole walk; f32: the 3xTF32 one, its key walk cut
// into `ranges`.
template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, float* o_part,
              float* stat_part, int B, int S, int Sk, int H, int Hk, bool is_bf16, bool causal,
              int ranges, int device, int* launched, cudaStream_t stream) {
  if (is_bf16) {
    return causal ? launch_wgmma<HD, true>(q, k, v, out, lse, B, S, Sk, H, Hk, device, launched,
                                           stream)
                  : launch_wgmma<HD, false>(q, k, v, out, lse, B, S, Sk, H, Hk, device, launched,
                                            stream);
  }
  return causal ? launch_f32<HD, true>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                       ranges, launched, stream)
                : launch_f32<HD, false>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                        ranges, launched, stream);
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, float* o_part,
           float* stat_part, int B, int S, int Sk, int H, int Hk, int hd, bool is_bf16,
           bool causal, int ranges, int device, int* launched, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, is_bf16, causal,
                           ranges, device, launched, stream);
    case 64:
      return launch_hd<64>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, is_bf16, causal,
                           ranges, device, launched, stream);
    case 128:
      return launch_hd<128>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, is_bf16,
                            causal, ranges, device, launched, stream);
    case 160:
      return launch_hd<160>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, is_bf16,
                            causal, ranges, device, launched, stream);
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
// launched (int[5]) holds the body the call ran (flash_attention_body_name),
// the key ranges it launched, its row tiles and (batch, KV head) count, and
// the blocks it launched.  A TMA descriptor that does not
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
                causal != 0, key_ranges, device, launched, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  if (err == hopper::kTmaEncodeError || err == hopper::kHandOverError) return hopper::tma_error();
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The name of the body launched[0] reports.
const char* flash_attention_body_name(int code) {
  return code >= 0 && code < 3 ? kBodyNames[code] : "unknown";
}

}  // extern "C"
