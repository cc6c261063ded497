// Chunked RWKV-6 WKV recurrence (forward) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/rwkv_scan.py::rwkv_scan (_rwkv_kernel).  Per
// (batch, head), with the (N, N) f32 state S (rows: key dim n, columns:
// value dim m) and per-token decays w in (0, 1):
//
//     y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//
// r, k, v, w are (B, S, H, N), read in place (no fold to (B*H, S, N)): all
// f32, all bf16, or r/k/v bf16 with w f32; u is (H, N) f32; y is written in
// r's dtype.  The initial state
// (B, H, N, N) f32 is read when given (zeros otherwise, as the Pallas kernel's
// _init) and the final state is always written: it is the decode cache of the
// ssm family, which the Pallas kernel drops.
//
// The arithmetic is the Pallas kernel's chunk form, without its clamp.
// Tokens are walked in chunks of `chunk` and, inside a chunk, sub-chunks of
// `sub` = min(16, chunk) tokens; for a sub-chunk of c tokens with the log
// decays lw = min(log(max(w, 1e-30)), 0) and their inclusive cumulative sum La
// (La_{t-1} = La - lw, the sum up to t - 1; La_c the sub-chunk's total):
//
//     y_t = r_t exp(La_{t-1}) S + sum_{s<t} P_ts v_s + (r_t u k_t) v_t
//     P_ts = sum_n r_tn k_sn exp(La_{t-1,n} - La_{s,n})
//     S   <- exp(La_c) S + sum_s (k_s exp(La_c - La_s))^T v_s
//
// Every exponent there is a difference La_a - La_b with a >= b, so it is
// <= 0 and every factor lies in [0, 1], for any decay.  The score tile P is
// a product of two factors, r_dec = r exp(La_{t-1}) and k_inv = k exp(-La_s),
// when the sub-chunk's total log decay in every column is >= -75
// (kMinFactorLogDecay): then exp(-La) <= e^75 stays in f32's range and
// r_dec's smallest factor e^-75 stays a normal number.  That covers every
// trained decay (a step of w < e^-4.69 on all 16 tokens of a column is needed
// to leave it), and runs on the tensor cores.  A sub-chunk with a column
// below -75 forms the 16 x 16 tile pairwise instead, one exp per (t, s, n)
// term, which is exact for any decay.  The block takes one branch for the
// whole sub-chunk: the decay pass raises the sub-chunk's flag in shared
// memory for a column below the bound, and every thread reads it after the
// sub-chunk's barrier.  Decays below 1e-30 are taken as 1e-30
// (log 0 is -inf): the state they keep, below 1e-30 of S, is what is lost.
// A ragged sub-chunk (S not a multiple of the chunk, or of 16) is padded
// with r = k = v = 0 and lw = 0, which leaves every valid row and the state
// unchanged; padded rows are never stored.
//
// What bounds it on the card.  By the work alone, bytes: a call reads r, k,
// v, w once and writes y once, about 20 k flops per token and head at N = 64
// against 20 bytes in f32 (12 with bf16 r/k/v/y and f32 w), below the H100's
// ops-per-byte balance even on the FMA units.  In practice the sequential
// walk bounds it: a block does ~3 us of dependent work per sub-chunk (H100),
// so a call takes about S / 16 of those whatever its bytes, 4x the byte
// bound at the LM shape.  No one part dominates that work: dropping the
// exp/log terms, the score products, r_dec S or the state update one at a
// time saves 18-23%, 13%, 6-7% and 11% of the call (scripts/wkv_variants.py
// on an H100).  What the design does:
//   * one block per (batch, head): the decays, their cumulative sum, the exp
//     terms and the 16 x 16 score tile are computed once per sub-chunk (a
//     column split would repeat them for every block of a head).  256 blocks
//     at the LM shape: one wave at two blocks an SM;
//   * the two N x N-sized products, y += r_dec S and the state update
//     S <- diag(exp(La_c)) S + k_s^T v, and the small ones (the scores
//     r_dec k_inv^T and P v) run on the tensor cores, mma.sync m16n8k8 TF32
//     in 3xTF32 form: each f32 operand is split into a TF32 big part and a
//     TF32 remainder, and big*big + big*small + small*big keeps about 21 bits
//     (single-pass TF32 keeps 11, against a tolerance of 1e-4);
//   * warp w holds columns [w N/W, (w+1) N/W) of the f32 state in accumulator
//     registers for the whole call; one shared-memory copy a sub-chunk, which
//     only the warp itself reads, gives r_dec S its B operand;
//   * one block barrier a sub-chunk: after it, the threads run the decay pass
//     of the next sub-chunk (into the other of two buffers of derived tiles)
//     and then the products of this one, so the exp/log work and the mma
//     chains interleave; each 3xTF32 product keeps its cross terms in a
//     second accumulator, which halves the length of the mma chains;
//   * the factorised branch costs the walk a compare a column and a flag
//     read a sub-chunk (a shared-memory ring of three, cleared two
//     sub-chunks ahead, so the barrier stays a plain one): a pairwise
//     sub-chunk forms La again (into the k_inv tile) and k_s directly rather
//     than every sub-chunk doing so, and the products of a sub-chunk are
//     compiled twice, once a branch, each with the next decay pass, so that
//     the factorised walk holds none of the pairwise code and its decay
//     pass and products stay one stretch of code to interleave (a run-time
//     branch inside the products, or between the decay pass and the
//     products, cost 7-20% of the call);
//   * a sub-chunk on the pairwise branch spreads its 120 scores over all the
//     block's threads (a 64-term exp sum each, into a 16 x 17 tile), with
//     two more barriers; the rest of its products are the factorised
//     branch's;
//   * the r/k/v/w tiles come through a ring of three cp.async stages (16-byte
//     copies, zero-filled past the sequence), one iteration ahead of the
//     decay pass that first reads them;
//   * the decay pass gives each column of the head kTPC threads, which scan
//     their partial sums with shuffles, so it needs no barrier of its own;
//   * token-major f32 tiles have a row stride of N + 4 and the state copy of
//     N + 8, and the token operands of P v and of the state update are taken
//     in the order (2t, 2t + 1) on both sides of the product, so the
//     fragment reads of a warp fall in distinct banks;
//   * r, k, v (and y) are read and written in their own dtype: f32, or bf16
//     with f32 decays (the model's projections are bf16; the decays are
//     exp(-exp(.)) in f32 and not bf16-representable), converted to f32
//     exactly on the way in.
// `expf` and `logf` (not the fast intrinsics) and f32 accumulation keep the
// 1e-4 tolerance of the reference tests.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/rwkv_scan.py.  The launch enqueues on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 16;       // tokens per tile: the Pallas kernel's _SUB
constexpr int kStages = 3;   // r/k/v/w tiles in the cp.async ring
// The least total log decay of a column in a sub-chunk for which the score
// tile is formed from the factors r exp(La_{t-1}) and k exp(-La_s).
constexpr float kMinFactorLogDecay = -75.f;

// Thread and tile geometry for head size N.
template <int N>
struct Geo {
  static constexpr int kWarps = N / 8 < 4 ? N / 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMW = N / kWarps;      // state columns per warp
  static constexpr int kNT = kMW / 8;         // their n-tiles of 8
  static constexpr int kMT = N / 16;          // m-tiles of 16 state rows
  static constexpr int kTPC = kThreads / N;   // threads per column, decay pass
  static constexpr int kTPT = kT / kTPC;      // tokens per thread there
  static_assert(N % 16 == 0 && kMW % 8 == 0 && kThreads % N == 0, "N is 16, 32 or 64");
};

// Shared memory, in bytes.  A ring of kStages raw tiles (r, k, v in TR, w in
// TW, rows padded by 16 bytes); two buffers of derived f32 tiles [t][n] of
// row stride N + 4 (r_dec, k_inv, k_s, r u k) with exp(La_c); the state
// copy [n][m] of row stride N + 8; the pairwise branch's 16 x 16 scores; a
// ring of three pairwise flags, one a sub-chunk.
template <typename TR, typename TW, int N>
struct Smem {
  static constexpr int kRS = N + 16 / static_cast<int>(sizeof(TR));  // raw row stride
  static constexpr int kWS = N + 16 / static_cast<int>(sizeof(TW));
  static constexpr int kDS = N + 4;                                   // f32 tiles
  static constexpr int kSS = N + 8;                                   // state copy
  static constexpr int kRawR = kT * kRS * static_cast<int>(sizeof(TR));
  static constexpr int kRawW = kT * kWS * static_cast<int>(sizeof(TW));
  static constexpr int kStage = 3 * kRawR + kRawW;
  static constexpr int kTile = kT * kDS * 4;
  static constexpr int kDer0 = kStages * kStage;  // derived buffer 0, then 1
  static constexpr int kDer = 4 * kTile + N * 4;  // r_dec, k_inv, k_s, r u k, exp(La_c)
  static constexpr int kSt = kDer0 + 2 * kDer;
  static constexpr int kP = kSt + N * kSS * 4;    // scores [t][s], row stride kT + 1
  static constexpr int kFlags = kP + kT * (kT + 1) * 4;  // 3 pairwise flags
  static constexpr size_t kBytes = kFlags + 16;
  static_assert(kRawR % 16 == 0 && kRawW % 16 == 0 && kDer % 16 == 0, "16-byte tiles");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// An f32 operand as a TF32 big part (x rounded to 10 mantissa bits, ties away
// from zero) and the exact remainder, which the tensor core reads as TF32 by
// ignoring its low 13 bits: |x - big - small| < 2^-21 |x|, in three integer
// and float instructions (two cvt.rna.tf32 make the call a quarter slower at
// the LM shape).
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
  __device__ __forceinline__ FragB() {}
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

// hi + lo += a b in 3xTF32: big * big into hi, the cross terms into lo (two
// short dependency chains instead of one long one), small * small dropped.
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(lo, a.small, b.big);
  mma_tf32(hi, a.big, b.big);
  mma_tf32(lo, a.big, b.small);
}

struct SubChunk {
  int t0, len;
};

// Sub-chunk `idx` of the walk: chunks of `chunk` tokens, each cut into
// sub-chunks of `sub` (the last of a chunk, and the last chunk, may be short).
__device__ __forceinline__ SubChunk sub_chunk(int idx, int S, int chunk, int sub,
                                              int per_chunk) {
  const int c0 = (idx / per_chunk) * chunk;
  const int t0 = c0 + (idx % per_chunk) * sub;
  const int c_end = S - c0 < chunk ? S : c0 + chunk;
  return {t0, c_end - t0 < sub ? c_end - t0 : sub};
}

// Fragment layouts (PTX ISA, mma.m16n8k8 TF32): lane = 4 * g + t.  A holds
// rows g and g + 8, columns t and t + 4; B holds column g, rows t and t + 4;
// the accumulator holds rows g and g + 8, columns 2t and 2t + 1.
template <typename TR, typename TW, int N>
__global__ void __launch_bounds__(Geo<N>::kThreads)
rwkv_scan_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                 const TR* __restrict__ v, const TW* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ state_in,
                 TR* __restrict__ y, float* __restrict__ state_out, int S, int H,
                 int chunk, int sub) {
  using Gm = Geo<N>;
  using L = Smem<TR, TW, N>;
  constexpr int kThreads = Gm::kThreads;
  constexpr int kNT = Gm::kNT;
  constexpr int kMT = Gm::kMT;
  constexpr int kTPC = Gm::kTPC;
  constexpr int kTPT = Gm::kTPT;
  constexpr int kRS = L::kRS;
  constexpr int kWS = L::kWS;
  constexpr int kDS = L::kDS;
  constexpr int kSS = L::kSS;
  constexpr int kCR = N * static_cast<int>(sizeof(TR)) / 16;  // 16-byte chunks a row
  constexpr int kCW = N * static_cast<int>(sizeof(TW)) / 16;
  constexpr int kTF = kT * kDS;  // floats of a derived tile
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* St = reinterpret_cast<float*>(smem + L::kSt);
  float* Pt = reinterpret_cast<float*>(smem + L::kP);
  int* Wide = reinterpret_cast<int*>(smem + L::kFlags);
  auto derived = [&](int idx) {  // r_dec of sub-chunk idx; k_inv, k_s, r u k, exp(La_c) follow
    return reinterpret_cast<float*>(smem + L::kDer0 + (idx & 1) * L::kDer);
  };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = warp * Gm::kMW;  // the warp's first state column
  const int64_t tok_stride = static_cast<int64_t>(H) * N;          // between tokens
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;  // (b, 0, h, 0)
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;
  const int per_chunk = (chunk + sub - 1) / sub;
  const int n_sub = (S / chunk) * per_chunk + (S % chunk + sub - 1) / sub;

  // Raw tiles of sub-chunk `idx` into its stage of the ring (one commit group
  // per call, empty past the end).
  auto issue = [&](int idx) {
    if (idx < n_sub) {
      const SubChunk sc = sub_chunk(idx, S, chunk, sub, per_chunk);
      char* st = smem + (idx % kStages) * L::kStage;
      const TR* srcs[3] = {r, k, v};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const char* src0 = reinterpret_cast<const char*>(srcs[a]);
        for (int i = tid; i < kT * kCR; i += kThreads) {
          const int t = i / kCR;
          const int c = i % kCR;
          const bool ok = t < sc.len;
          const int64_t off = ok ? (base + (sc.t0 + t) * tok_stride) * sizeof(TR) + c * 16 : 0;
          cp_async16(smem_u32(st + a * L::kRawR + t * kRS * sizeof(TR) + c * 16), src0 + off,
                     ok);
        }
      }
      const char* wsrc = reinterpret_cast<const char*>(w);
      for (int i = tid; i < kT * kCW; i += kThreads) {
        const int t = i / kCW;
        const int c = i % kCW;
        const bool ok = t < sc.len;
        const int64_t off = ok ? (base + (sc.t0 + t) * tok_stride) * sizeof(TW) + c * 16 : 0;
        cp_async16(smem_u32(st + 3 * L::kRawR + t * kWS * sizeof(TW) + c * 16), wsrc + off,
                   ok);
      }
    }
    cp_async_commit();
  };

  // The warp's state columns, in accumulator layout, for the whole call.
  float sacc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = 16 * mt + g;
      const int m = m0 + 8 * nt + 2 * t4;
      float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
      if (state_in != nullptr) {
        lo = *reinterpret_cast<const float2*>(state_in + sbase + n * N + m);
        hi = *reinterpret_cast<const float2*>(state_in + sbase + (n + 8) * N + m);
      }
      sacc[mt][nt][0] = lo.x;
      sacc[mt][nt][1] = lo.y;
      sacc[mt][nt][2] = hi.x;
      sacc[mt][nt][3] = hi.y;
    }
  }
  float slo[kMT][kNT][4];  // the cross terms of the last state update
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) slo[mt][nt][e] = 0.f;
  const int col = tid / kTPC;   // decay pass: column n and
  const int part = tid % kTPC;  // tokens part * kTPT .. + kTPT - 1
  const float u_col = u[h * N + col];

  // The log decays of this thread's tokens of sub-chunk idx and their
  // inclusive cumulative sum La: cum[j] is the sum over this part's tokens up
  // to j, `excl` the column's sum before this part (a scan over the kTPC
  // threads of the column), `total` the column's sum over the sub-chunk.
  // Padded tokens have log decay 0.
  auto log_decays = [&](int idx, float (&cum)[kTPT], float& excl, float& total) {
    const SubChunk sc = sub_chunk(idx, S, chunk, sub, per_chunk);
    const TW* Wr = reinterpret_cast<const TW*>(smem + (idx % kStages) * L::kStage +
                                               3 * L::kRawR);
    float la = 0.f;
#pragma unroll
    for (int j = 0; j < kTPT; ++j) {
      const int t = part * kTPT + j;
      float lw = 0.f;
      if (t < sc.len) lw = fminf(logf(fmaxf(to_f32(Wr[t * kWS + col]), 1e-30f)), 0.f);
      la += lw;
      cum[j] = la;
    }
    float incl = la;
#pragma unroll
    for (int off = 1; off < kTPC; off <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, incl, off, kTPC);
      if (part >= off) incl += x;
    }
    excl = incl - la;
    total = __shfl_sync(0xffffffffu, incl, kTPC - 1, kTPC);
  };

  // Decay pass of sub-chunk idx: the decay-weighted r and k into derived
  // buffer idx & 1 (padded tokens have r = k = v = 0).  A column whose total
  // log decay is below kMinFactorLogDecay, where k_inv overflows, raises the
  // sub-chunk's pairwise flag; that branch then forms the scores pairwise
  // and k_s as k exp(La_c - La) instead of k_inv exp(La_c).
  auto decay = [&](int idx) {
    const char* st = smem + (idx % kStages) * L::kStage;
    const TR* Rr = reinterpret_cast<const TR*>(st);
    const TR* Kr = reinterpret_cast<const TR*>(st + L::kRawR);
    float* Rd = derived(idx);
    float* Ki = Rd + kTF;
    float* Ks = Ki + kTF;
    float* Ru = Ks + kTF;
    float* Adec = Ru + kTF;
    float cum[kTPT], excl, total;
    log_decays(idx, cum, excl, total);
    const float a = expf(total);
    if (part == kTPC - 1) {
      Adec[col] = a;
      if (total < kMinFactorLogDecay) Wide[idx % 3] = 1;
    }
#pragma unroll
    for (int j = 0; j < kTPT; ++j) {
      const int t = part * kTPT + j;
      const float la_prev = j > 0 ? excl + cum[j - 1] : excl;  // La - lw
      const float rv = to_f32(Rr[t * kRS + col]);
      const float kv = to_f32(Kr[t * kRS + col]);
      const float ki = kv * expf(-(excl + cum[j]));  // inf past the bound: unread then
      Rd[t * kDS + col] = rv * expf(la_prev);
      Ki[t * kDS + col] = ki;
      Ks[t * kDS + col] = ki * a;
      Ru[t * kDS + col] = rv * u_col * kv;
    }
  };

  // The ring: sub-chunk idx's tiles land two iterations ahead of its
  // products and one ahead of its decay pass.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  if (tid < 3) Wide[tid] = 0;
  cp_async_wait<kStages - 2>();
  __syncthreads();
  decay(0);

  for (int idx = 0; idx < n_sub; ++idx) {
    cp_async_wait<kStages - 3>();
    // Tile idx + 1 landed, derived buffer idx and the flag of sub-chunk idx
    // are complete, and every warp is done with sub-chunk idx - 1 (its ring
    // stage, derived buffer and flag): that flag is cleared for sub-chunk
    // idx + 2, whose decay pass runs after the next barrier.
    __syncthreads();
    const bool pairwise = Wide[idx % 3] != 0;
    if (tid == 0) Wide[(idx + 2) % 3] = 0;
    issue(idx + kStages - 1);

    // The decay pass of the next sub-chunk and the products of this one, one
    // version a branch (kPair: pairwise): each is one stretch of code, in
    // which the exp/log work and the mma chains interleave, and the
    // factorised walk carries none of the pairwise code.
    auto products = [&](auto pair) {
      constexpr bool kPair = decltype(pair)::value;
      if (idx + 1 < n_sub) decay(idx + 1);
      const SubChunk sc = sub_chunk(idx, S, chunk, sub, per_chunk);
      const char* stage = smem + (idx % kStages) * L::kStage;
      const TR* Vr = reinterpret_cast<const TR*>(stage + 2 * L::kRawR);
      float* Rd = derived(idx);
      float* Ki = Rd + kTF;
      float* Ks = Ki + kTF;
      const float* Ru = Ks + kTF;
      const float* Adec = Ru + kTF;

      // The state before this sub-chunk, the B operand of r_dec S: the warp's
      // own columns, so the copy is warp-local.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[mt][nt][e] += slo[mt][nt][e];
            slo[mt][nt][e] = 0.f;
          }
          float* p = St + (16 * mt + g) * kSS + m0 + 8 * nt + 2 * t4;
          store2(p, sacc[mt][nt][0], sacc[mt][nt][1]);
          store2(p + 8 * kSS, sacc[mt][nt][2], sacc[mt][nt][3]);
        }
      }
      __syncwarp();

      // Scores P = r_dec k_inv^T (every warp, all 16 x 16) and y = r_dec S
      // (the warp's columns), one pass over the N columns of r_dec.
      float pacc[2][4], plo[2][4], yacc[kNT][4], ylo[kNT][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pacc[0][e] = pacc[1][e] = plo[0][e] = plo[1][e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) yacc[nt][e] = ylo[nt][e] = 0.f;
      }
      if constexpr (kPair) {
        // P_ts = sum_n r_tn k_sn exp(La_{t-1,n} - La_{s,n}) for s < t.  La is
        // formed again, as the decay pass forms it, into the k_inv tile (which
        // this version does not read), and k_s = k exp(La_c - La);
        // each score is one thread's, into Pt.  La_{t-1} is row t - 1 of La,
        // so the exponent of s = t - 1 is exactly 0.
        const TR* Rr = reinterpret_cast<const TR*>(stage);
        const TR* Kr = reinterpret_cast<const TR*>(stage + L::kRawR);
        {
          float cum[kTPT], excl, total;
          log_decays(idx, cum, excl, total);
#pragma unroll
          for (int j = 0; j < kTPT; ++j) {
            const int t = part * kTPT + j;
            const float la_t = excl + cum[j];
            Ki[t * kDS + col] = la_t;
            Ks[t * kDS + col] = to_f32(Kr[t * kRS + col]) * expf(total - la_t);
          }
        }
        __syncthreads();
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int t = e / kT;
          const int s_ = e % kT;
          float acc = 0.f;
          if (s_ < t) {
            const float* lt = Ki + (t - 1) * kDS;
            const float* ls = Ki + s_ * kDS;
#pragma unroll 8
            for (int n = 0; n < N; ++n) {
              acc += to_f32(Rr[t * kRS + n]) * to_f32(Kr[s_ * kRS + n]) * expf(lt[n] - ls[n]);
            }
          }
          Pt[t * (kT + 1) + s_] = acc;
        }
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const int n0 = 8 * kk;
        const float ax[4] = {Rd[g * kDS + n0 + t4], Rd[(g + 8) * kDS + n0 + t4],
                             Rd[g * kDS + n0 + t4 + 4], Rd[(g + 8) * kDS + n0 + t4 + 4]};
        const FragA a(ax);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          if constexpr (!kPair) {  // the pairwise version reads its scores from Pt
            const float* kr = Ki + (8 * jt + g) * kDS + n0 + t4;
            mma3(pacc[jt], plo[jt], a, FragB(kr[0], kr[4]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* sr = St + (n0 + t4) * kSS + m0 + 8 * nt + g;
          mma3(yacc[nt], ylo[nt], a, FragB(sr[0], sr[4 * kSS]));
        }
      }
      if constexpr (kPair) {
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pacc[jt][e] = Pt[(g + (e >= 2 ? 8 : 0)) * (kT + 1) + 8 * jt + 2 * t4 + (e & 1)];
            plo[jt][e] = 0.f;
          }
        }
      }
      // The diagonal P[i][i] = sum_n r u k: lanes 2i and 2i + 1 take half a row.
      float dg = 0.f;
      {
        const float* ru = Ru + (lane >> 1) * kDS + (lane & 1) * (N / 2);
#pragma unroll
        for (int n = 0; n < N / 2; ++n) dg += ru[n];
        dg += __shfl_xor_sync(0xffffffffu, dg, 1);
      }
      const float dg_lo = __shfl_sync(0xffffffffu, dg, 2 * g);
      const float dg_hi = __shfl_sync(0xffffffffu, dg, 2 * (g + 8));
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + (e >= 2 ? 8 : 0);
          const int j = 8 * jt + 2 * t4 + (e & 1);
          const float pv = pacc[jt][e] + plo[jt][e];
          pacc[jt][e] = j < i ? pv : (j == i ? (e >= 2 ? dg_hi : dg_lo) : 0.f);
        }
      }

      // y += P v.  The token (k) index runs in the order (2t, 2t + 1) on both
      // sides, so P's accumulator is its A fragment as it stands.
      FragB vb[2][kNT];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float px[4] = {pacc[kk][0], pacc[kk][2], pacc[kk][1], pacc[kk][3]};
        const FragA a(px);
        const int t = 8 * kk + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int m = m0 + 8 * nt + g;
          vb[kk][nt] = FragB(to_f32(Vr[t * kRS + m]), to_f32(Vr[(t + 1) * kRS + m]));
          mma3(yacc[nt], ylo[nt], a, vb[kk][nt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int m = m0 + 8 * nt + 2 * t4;
        if (g < sc.len) {
          store2(y + base + (sc.t0 + g) * tok_stride + m, yacc[nt][0] + ylo[nt][0],
                 yacc[nt][1] + ylo[nt][1]);
        }
        if (g + 8 < sc.len) {
          store2(y + base + (sc.t0 + g + 8) * tok_stride + m, yacc[nt][2] + ylo[nt][2],
                 yacc[nt][3] + ylo[nt][3]);
        }
      }

      // S <- diag(exp(La_c)) S + k_s^T v, same token order.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int n = 16 * mt + g;
        const float a_lo = Adec[n];
        const float a_hi = Adec[n + 8];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          sacc[mt][nt][0] *= a_lo;
          sacc[mt][nt][1] *= a_lo;
          sacc[mt][nt][2] *= a_hi;
          sacc[mt][nt][3] *= a_hi;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* k0 = Ks + (8 * kk + 2 * t4) * kDS + n;
          const float ax[4] = {k0[0], k0[8], k0[kDS], k0[kDS + 8]};
          const FragA a(ax);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma3(sacc[mt][nt], slo[mt][nt], a, vb[kk][nt]);
        }
      }
      __syncwarp();  // the state copy is read; the next iteration rewrites it
    };
    if (pairwise) {
      products(std::true_type{});
    } else {
      products(std::false_type{});
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mt][nt][e] += slo[mt][nt][e];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = 16 * mt + g;
      const int m = m0 + 8 * nt + 2 * t4;
      store2(state_out + sbase + n * N + m, sacc[mt][nt][0], sacc[mt][nt][1]);
      store2(state_out + sbase + (n + 8) * N + m, sacc[mt][nt][2], sacc[mt][nt][3]);
    }
  }
}

template <typename TR, typename TW, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const void* w,
                     const float* u, const float* state_in, void* y, float* state_out,
                     int B, int S, int H, int chunk, int sub, cudaStream_t stream) {
  auto kernel = rwkv_scan_kernel<TR, TW, N>;
  const size_t smem = Smem<TR, TW, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(static_cast<int64_t>(B) * H), Geo<N>::kThreads, smem,
           stream>>>(static_cast<const TR*>(r), static_cast<const TR*>(k),
                     static_cast<const TR*>(v), static_cast<const TW*>(w), u, state_in,
                     static_cast<TR*>(y), state_out, S, H, chunk, sub);
  return cudaGetLastError();
}

template <typename TR, typename TW>
cudaError_t launch_dtype(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* state_in, void* y,
                         float* state_out, int B, int S, int H, int N, int chunk, int sub,
                         cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_n<TR, TW, 16>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk,
                                  sub, stream);
    case 32:
      return launch_n<TR, TW, 32>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk,
                                  sub, stream);
    case 64:
      return launch_n<TR, TW, 64>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk,
                                  sub, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (r, k, v, w, y), 1 = bfloat16 (r, k, v, w, y), 2 = r, k,
// v and y bfloat16 with w float32.  N: 16, 32 or 64.  u (H, N), state_in
// (B, H, N, N) or null, state_out (B, H, N, N): float32.  All contiguous and
// 16-byte aligned; 1 <= sub <= 16, sub <= chunk <= S; B * H < 2^31.  The
// wrapper checks all of it.
int rwkv_scan_launch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* state_in, void* y, void* state_out,
                     int B, int S, int H, int N, int chunk, int sub, int dtype,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0 || sub < 1 || sub > kT || chunk < sub) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s_in = static_cast<const float*>(state_in);
  float* s_out = static_cast<float*>(state_out);
  switch (dtype) {
    case 0:
      err = launch_dtype<float, float>(r, k, v, w, uf, s_in, y, s_out, B, S, H, N, chunk,
                                       sub, s);
      break;
    case 1:
      err = launch_dtype<bf16, bf16>(r, k, v, w, uf, s_in, y, s_out, B, S, H, N, chunk,
                                     sub, s);
      break;
    case 2:
      err = launch_dtype<bf16, float>(r, k, v, w, uf, s_in, y, s_out, B, S, H, N, chunk,
                                      sub, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* rwkv_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
