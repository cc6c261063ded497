// RWKV-6 WKV recurrence, backward, for Hopper, sm_90a.
//
// The gradient of csrc/rwkv_scan.cu, which replaces
// src/repro/kernels/rwkv_scan.py::rwkv_scan; the JAX package takes this
// gradient from XLA's autodiff of its scan (src/repro/models/rwkv.py).  Per
// (batch, head), with S_{t-1} the (N, N) f32 state before token t (rows: key
// dim n, columns: value dim m) and G_t the adjoint of the state after it
// (G_T = the final-state gradient, zeros when none is given):
//
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//     dk_t = u r_t (v_t . dy_t) + G_t v_t
//     dv_t = (r_t . (u k_t)) dy_t + G_t^T k_t
//     dw_t = rowsum(G_t * S_{t-1})
//     du  += r_t k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_0
//
// ref.reference_rwkv_backward is the same recurrence in plain torch.  r, k, v,
// dy are (B, S, H, N) in one dtype (f32 or bf16), w is f32 or bf16 (all f32,
// all bf16, or bf16 r/k/v with f32 w, as the forward); dr, dk, dv are written
// in r's dtype and dw in w's.  u (H, N), the initial state and the
// final-state gradient (B, H, N, N, both optional) are f32; du is written as
// one f32 partial per (batch, head, range), summed by the caller in a fixed
// order (no float atomics: repeated runs are bit-equal), and the
// initial-state gradient, when asked for, in f32.
//
// The chunk form.  Tokens are cut into sub-chunks of kT = 16 and each (b, h)
// sequence into ranges of L = 16, 32 or 64 tokens (the caller's range plan
// picks L so that B * H * ceil(S / L) blocks fill the card).  In a sub-chunk,
// with lw = log max(w, 1e-30) and La its inclusive cumulative sum (La_{-1} =
// 0, La_c the sub-chunk's total), S_0 the state before it and G_c the adjoint
// after it:
//
//     S_end   = diag(e^{La_c}) S_0 + sum_s (k_s e^{La_c - La_s})^T v_s
//     G_start = diag(e^{La_c}) G_c + sum_t (r_t e^{La_{t-1}})^T dy_t
//     dr_t = e^{La_{t-1}} (S_0 dy_t) + sum_{s<t} Q_ts e^{La_{t-1} - La_s} k_s + u k_t Q_tt
//     dk_t = e^{La_c - La_t} (G_c v_t) + sum_{s>t} Q_st e^{La_{s-1} - La_t} r_s + u r_t Q_tt
//     dv_t = G_c^T (k_t e^{La_c - La_t}) + sum_{s>t} P_st dy_s + (r_t . (u k_t)) dy_t
//
// with Q_ts = dy_t . v_s and P_st = sum_n r_sn k_tn e^{La_{s-1,n} - La_{t,n}},
// the forward's score tile.  Every exponent is <= 0, so this is exact for any
// decay.  The decay-weighted sums over s follow the forward's rule: when every
// column's total log decay in the sub-chunk is >= -75 they are products of the
// factors r e^{La_{t-1}} and k e^{-La_s} on the tensor cores; otherwise they
// are formed pairwise, one exp a term.
//
// dw needs S_{t-1} and G_t of every token.  Recovering S_{t-1} from S_t by
// dividing by w_t is unstable, and so is the d(log w) form of the public
// RWKV-6 kernels (dw = d log w / w, or a reverse cumulative sum of d log w,
// loses everything as w -> 0, and the forward is exact down to w = 1e-30).
// So dw stays rowsum(G_t * S_{t-1}), from the sub-chunk's states and
// adjoints, which are walked token by token from S_0 and G_c multiplying only
// by decays <= 1, on the FMA units; the walk of G also gives G_start.
//
// Two launches a call:
//   * rwkv_scan_bwd_bounds_kernel (when S > 16), B H blocks walking the
//     state forward from the initial one and storing it before every
//     sub-chunk, and (when there is more than one range) B H more walking
//     the adjoint backward from the final-state gradient and storing it at
//     every range end: S_end and G_start above, a sub-chunk a step on
//     mma.sync 3xTF32, the next step's tiles read into registers during
//     this one's;
//   * rwkv_scan_bwd_range_kernel, B H ceil(S / L) blocks, two an SM: a
//     range's block takes its sub-chunks last to first, the next one's tiles
//     and state landing in a cp.async stage meanwhile.  A sub-chunk's Q =
//     dy v^T and P on the tensor cores (or P and the two decay-weighted sums
//     of Q pairwise); dr, dk and dv, a 16 x 8 column tile of each a warp
//     with the three products' k-steps interleaved, written from the
//     accumulators; then the token walk of the FMA units for dw and
//     G_start, a slab of state rows at a time (16 at N = 64), each thread
//     holding its 4 columns' 16 states in registers.  The block of range 0
//     writes the initial-state gradient.
// The scratch is the states before the sub-chunks, B H ceil(S / 16) N^2 4
// bytes, and the adjoints at the range ends, B H ceil(S / L) N^2 4 bytes
// (33.5 and 8.4 MB at one rwkv6-7b layer of a 1 x 512 micro-batch).
//
// What bounds it on the card.  By the work, bytes: 22 an element (bf16 r, k,
// v, dy, dr, dk, dv with f32 w and dw) against per token and head about
// 14 N^2 f32 flops (the reverse recurrence's count), which the card does
// in f32-exact form at its 3xTF32 rate in less time than the bytes take
// (on an H100 SXM at the training shape 13.78 against 11.57 us; 28.48 us
// at the f32 FMA rate, which would make it operations).  The design moves
// dr, dk and dv onto the tensor cores (mma.sync m16n8k8 TF32 in 3xTF32
// form, as the forward: about 21 bits kept), leaves the FMA units the walk
// for dw (five f32 operations an element and token), and cuts the
// token-serial chain to the boundary walkers' S / 16 sub-chunk steps.  The
// range kernel's shared memory (no list of states: the walker stores one
// before every sub-chunk) and its 128 registers a thread let two blocks
// share an SM, so one block's walk overlaps another's products.  On an H100
// at the training shape (scripts/kernel_compare.py --kernel wkv_bwd) a call
// splits into the boundary walk's ~52 us, a chain of 31 sub-chunk steps
// that neither splitting its rows over blocks, pipelining it with one
// barrier a step, batching four sub-chunks a step nor an L2 prefetch made
// shorter, and the range kernel's ~140 us, ~59 of them the token walk; one
// block an SM would take the range kernel to ~180 us.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/rwkv_scan.py.  The launches enqueue on the
// caller's stream, do not synchronise and allocate nothing; the return value
// is cudaGetLastError() right after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 16;        // tokens of a sub-chunk
constexpr int kMaxSubs = 4;   // sub-chunks of a range at most: L <= 64
// The least total log decay of a column in a sub-chunk for which the
// decay-weighted sums are formed from factors (csrc/rwkv_scan.cu's rule).
constexpr float kMinFactorLogDecay = -75.f;

template <int N>
struct Geo {
  static constexpr int kWarps = N == 16 ? 2 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kDS = N + 4;             // row stride of the f32 tiles
  static constexpr int kTile = kT * kDS;        // floats of a token tile
  static constexpr int kMat = N * kDS;          // floats of an N x N matrix
  static constexpr int kNT = N / 8;             // n-tiles of 8 across N
  static constexpr int kTPC = kThreads / N;     // decay pass: threads a column
  static constexpr int kTPT = kT / kTPC;        // and tokens a thread
  static constexpr int kCG = N / 4;             // token walk: threads a state row
  static constexpr int kRows = kThreads / kCG;  // rows a slab
  static constexpr int kSlabs = N / kRows;
  // State update: (16-row, 8-column) tiles of the N x N state a warp holds.
  static constexpr int kStTiles = (N / 16) * kNT / kWarps;
  static_assert(N % 16 == 0 && kT % kTPC == 0 && N % kRows == 0 && kStTiles >= 1,
                "N is 16, 32 or 64");
};

// Shared memory of the range kernel: in floats, the f32 tiles r, k, v, w, dy
// (padded tokens r = k = v = dy = 0, w = 1), the derived La, r e^{La_{t-1}}
// (Rd), k e^{-La} (Ki), k e^{La_c - La} (Ks); Q and P [16][17]; r . (u k)
// [16]; u [N]; the pairwise flag; the adjoint G; two buffers of the state
// before a sub-chunk; then, in bytes, the stage the next sub-chunk's r, k, v,
// dy (TR) and w (TW) land in.
template <typename TR, typename TW, int N>
struct RangeSmem {
  using Gm = Geo<N>;
  static constexpr int kR = 0, kK = kR + Gm::kTile, kV = kK + Gm::kTile,
                       kW = kV + Gm::kTile, kDY = kW + Gm::kTile;
  static constexpr int kLa = kDY + Gm::kTile, kRd = kLa + Gm::kTile, kKi = kRd + Gm::kTile,
                       kKs = kKi + Gm::kTile;
  static constexpr int kQ = kKs + Gm::kTile, kP = kQ + kT * (kT + 1);
  static constexpr int kRuk = kP + kT * (kT + 1), kU = kRuk + kT, kFlag = kU + N;
  static constexpr int kG = (kFlag + 4 + 3) / 4 * 4;
  static constexpr int kS0 = kG + Gm::kMat;                 // two buffers
  static constexpr int kStage = (kS0 + 2 * Gm::kMat) * 4;   // bytes from here on
  static constexpr int kRawR = kT * N * static_cast<int>(sizeof(TR));  // r, k, v, dy
  static constexpr int kRawW = kT * N * static_cast<int>(sizeof(TW));
  static constexpr size_t kBytes = static_cast<size_t>(kStage + 4 * kRawR + kRawW);
  static_assert(kStage % 16 == 0 && kRawR % 16 == 0, "16-byte pieces");
};

// Shared memory of the bounds kernel, in floats: the f32 tiles x (k or r), y
// (v or dy), w, the weighted x, and e^{La_c} [N].
template <int N>
struct BoundsSmem {
  using Gm = Geo<N>;
  static constexpr int kX = 0, kY = kX + Gm::kTile, kW = kY + Gm::kTile,
                       kXd = kW + Gm::kTile, kA = kXd + Gm::kTile;
  static constexpr size_t kBytes = static_cast<size_t>(kA + N) * sizeof(float);
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes of T widened to f32 (bf16 -> f32 exactly, by a shift).
__device__ __forceinline__ void unpack16(const uint4& x, float* d, float) {
  d[0] = __uint_as_float(x.x);
  d[1] = __uint_as_float(x.y);
  d[2] = __uint_as_float(x.z);
  d[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack16(const uint4& x, float* d, bf16) {
  const uint32_t q[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = __uint_as_float(q[i] << 16);
    d[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

// A token tile [kT][N] of one (batch, head) in T, through registers: load()
// reads tokens t0 .. t0 + c - 1 in 16-byte pieces, store() writes them to a
// shared f32 tile of row stride N + 4, padded rows set to `pad`.
template <typename T, int N, int kThreads>
struct TileLoad {
  static constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements a piece
  static constexpr int kPerRow = N / kE;
  static constexpr int kPieces = kT * kPerRow;
  static constexpr int kPer = (kPieces + kThreads - 1) / kThreads;
  uint4 x[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t base,
                                       int64_t tok_stride, int t0, int c, int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kPerRow;
      if (i < kPieces && t < c) {
        x[j] = *reinterpret_cast<const uint4*>(src + base + (t0 + t) * tok_stride +
                                               (i % kPerRow) * kE);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int c, float pad, int tid) const {
    constexpr int kDS = N + 4;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < kPieces) {
        const int t = i / kPerRow;
        float* d = dst + t * kDS + (i % kPerRow) * kE;
        if (t < c) {
          unpack16(x[j], d, T());
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) d[e] = pad;
        }
      }
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tokens t0 .. t0 + c - 1 of a (batch, head) into a raw stage tile [kT][N]
// (rows past c zero-filled).
template <typename T, int N, int kThreads>
__device__ __forceinline__ void stage_tile(char* dst, const T* __restrict__ src, int64_t base,
                                           int64_t tok_stride, int t0, int c, int tid) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = N / kE;
  for (int i = tid; i < kT * kPerRow; i += kThreads) {
    const int t = i / kPerRow;
    const int e = (i % kPerRow) * kE;
    const bool ok = t < c;
    cp_async16(dst + (t * N + e) * sizeof(T), src + (ok ? base + (t0 + t) * tok_stride + e : 0),
               ok);
  }
}

// Four elements of a raw stage tile widened to f32 (bf16 exactly, by a shift).
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const bf16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
}

// A raw stage tile into an f32 tile of row stride N + 4, rows past c set to pad.
template <typename T, int N, int kThreads>
__device__ __forceinline__ void widen_tile(float* dst, const char* raw, int c, float pad,
                                           int tid) {
  const T* src = reinterpret_cast<const T*>(raw);
  for (int i = tid; i < kT * N / 4; i += kThreads) {
    const int t = 4 * i / N;
    const int n = 4 * i % N;
    *reinterpret_cast<float4*>(dst + t * (N + 4) + n) =
        t < c ? widen4(src + t * N + n) : make_float4(pad, pad, pad, pad);
  }
}

// An f32 operand as a TF32 big part and the exact remainder (csrc/rwkv_scan.cu).
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
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi + lo += a b in 3xTF32: big * big into hi, the cross terms into lo.
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(lo, a.small, b.big);
  mma_tf32(hi, a.big, b.big);
  mma_tf32(lo, a.big, b.small);
}

// hi + lo += A B over k0 .. k0 + 7 for the 16 x 8 output tile of columns
// n0 .. n0 + 7, with A[i][kk] = a(i, kk) and B[kk][j] = b(kk, j).  Fragment
// layouts (PTX ISA, mma.m16n8k8 TF32): lane = 4 g + t4; the accumulator holds
// rows g and g + 8, columns n0 + 2 t4 and n0 + 2 t4 + 1.
template <typename FA, typename FB>
__device__ __forceinline__ void mma_step(float (&hi)[4], float (&lo)[4], const FA& a,
                                         const FB& b, int k0, int n0, int g, int t4) {
  const float ax[4] = {a(g, k0 + t4), a(g + 8, k0 + t4), a(g, k0 + t4 + 4),
                       a(g + 8, k0 + t4 + 4)};
  mma3(hi, lo, FragA(ax), FragB(b(k0 + t4, n0 + g), b(k0 + t4 + 4, n0 + g)));
}

// The same over kK (a multiple of 8).
template <int kK, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&hi)[4], float (&lo)[4], const FA& a,
                                         const FB& b, int n0, int g, int t4) {
#pragma unroll
  for (int k0 = 0; k0 < kK; k0 += 8) mma_step(hi, lo, a, b, k0, n0, g, t4);
}

__device__ __forceinline__ void zero4(float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = 0.f;
}

// The log decays of this thread's tokens (column `col`, tokens part * kTPT
// ..) of the w tile and their inclusive cumulative sum: cum[j] up to token j
// of this part, `excl` the column's sum before the part, `total` the
// sub-chunk's.  Padded tokens have w = 1, log decay 0.
template <int N>
__device__ __forceinline__ void log_decays(const float* W, int col, int part,
                                           float (&cum)[Geo<N>::kTPT], float& excl,
                                           float& total) {
  using Gm = Geo<N>;
  float la = 0.f;
#pragma unroll
  for (int j = 0; j < Gm::kTPT; ++j) {
    const int t = part * Gm::kTPT + j;
    la += fminf(logf(fmaxf(W[t * Gm::kDS + col], 1e-30f)), 0.f);
    cum[j] = la;
  }
  float incl = la;
#pragma unroll
  for (int off = 1; off < Gm::kTPC; off <<= 1) {
    const float x = __shfl_up_sync(0xffffffffu, incl, off, Gm::kTPC);
    if (part >= off) incl += x;
  }
  excl = incl - la;
  total = __shfl_sync(0xffffffffu, incl, Gm::kTPC - 1, Gm::kTPC);
}

// The (16-row, 8-column) tiles of an N x N matrix a warp holds: its q-th is
// rows 16 mt .., columns 8 nt .. with mt * kNT + nt = warp + q W.
template <int N>
__device__ __forceinline__ void tile_of(int q, int warp, int& r0, int& n0) {
  using Gm = Geo<N>;
  const int idx = warp + q * Gm::kWarps;
  r0 = 16 * (idx / Gm::kNT);
  n0 = 8 * (idx % Gm::kNT);
}

// The state update of one sub-chunk on a warp's tiles of an N x N matrix:
// M <- diag(A) M + Xd^T Y, Xd and Y token tiles [kT][kDS].
template <int N>
__device__ __forceinline__ void state_update(float (&acc)[Geo<N>::kStTiles][4],
                                             const float* Xd, const float* Y, const float* A,
                                             int warp, int g, int t4) {
  using Gm = Geo<N>;
  constexpr int kDS = Gm::kDS;
#pragma unroll
  for (int q = 0; q < Gm::kStTiles; ++q) {
    int r0, n0;
    tile_of<N>(q, warp, r0, n0);
    const float a_lo = A[r0 + g];
    const float a_hi = A[r0 + g + 8];
    float lo[4];
    zero4(lo);
    acc[q][0] *= a_lo;
    acc[q][1] *= a_lo;
    acc[q][2] *= a_hi;
    acc[q][3] *= a_hi;
    mma_tile<kT>(
        acc[q], lo, [&](int i, int kk) { return Xd[kk * kDS + r0 + i]; },
        [&](int kk, int jx) { return Y[kk * kDS + jx]; }, n0, g, t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] += lo[e];
  }
}

// A warp's tiles of an N x N f32 matrix from / to memory of row stride ld.
template <int N>
__device__ __forceinline__ void tiles_load(float (&acc)[Geo<N>::kStTiles][4], const float* src,
                                           int ld, int warp, int g, int t4) {
#pragma unroll
  for (int q = 0; q < Geo<N>::kStTiles; ++q) {
    int r0, n0;
    tile_of<N>(q, warp, r0, n0);
    const float* p = src + (r0 + g) * ld + n0 + 2 * t4;
    acc[q][0] = p[0];
    acc[q][1] = p[1];
    acc[q][2] = p[8 * ld];
    acc[q][3] = p[8 * ld + 1];
  }
}

template <int N>
__device__ __forceinline__ void tiles_store(const float (&acc)[Geo<N>::kStTiles][4], float* dst,
                                            int ld, int warp, int g, int t4) {
#pragma unroll
  for (int q = 0; q < Geo<N>::kStTiles; ++q) {
    int r0, n0;
    tile_of<N>(q, warp, r0, n0);
    float* p = dst + (r0 + g) * ld + n0 + 2 * t4;
    store2(p, acc[q][0], acc[q][1]);
    store2(p + 8 * ld, acc[q][2], acc[q][3]);
  }
}

// The boundaries.  blockIdx.y = 0: the state, from the initial one, forward
// over sub-chunks 0 .. n_sub - 2, stored at the start of sub-chunks 1 ..
// n_sub - 1 (s_sub: B H x n_sub states, the first unused).  blockIdx.y = 1
// (when there is more than one range): the adjoint, from the final-state
// gradient, backward over sub-chunks n_sub - 1 .. subs, stored at the end of
// ranges R - 2 .. 0 (g_bound: B H x R adjoints, the last unused).  Each
// walks one sub-chunk a step; the tiles of the next step are read into
// registers while this one's products run.
template <typename TR, typename TW, int N>
__global__ void __launch_bounds__(Geo<N>::kThreads)
rwkv_scan_bwd_bounds_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                            const TR* __restrict__ v, const TW* __restrict__ w,
                            const float* __restrict__ state_in, const TR* __restrict__ dy,
                            const float* __restrict__ dstate, float* __restrict__ s_sub,
                            float* __restrict__ g_bound, int S, int H, int subs, int R) {
  using Gm = Geo<N>;
  using L = BoundsSmem<N>;
  constexpr int kThreads = Gm::kThreads;
  constexpr int kDS = Gm::kDS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* X = smem + L::kX;
  float* Y = smem + L::kY;
  float* W = smem + L::kW;
  float* Xd = smem + L::kXd;
  float* A = smem + L::kA;

  const int bh = blockIdx.x;
  const bool fwd = blockIdx.y == 0;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int64_t tok_stride = static_cast<int64_t>(H) * N;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;
  const int n_sub = (S + kT - 1) / kT;
  const int steps = fwd ? n_sub - 1 : n_sub - subs;
  const TR* xs = fwd ? k : r;
  const TR* ys = fwd ? v : dy;
  const float* init = fwd ? state_in : dstate;
  float* out = fwd ? s_sub + static_cast<int64_t>(bh) * n_sub * N * N
                   : g_bound + static_cast<int64_t>(bh) * R * N * N;

  float acc[Gm::kStTiles][4];
  if (init != nullptr) {
    tiles_load<N>(acc, init + sbase, N, warp, g, t4);
  } else {
#pragma unroll
    for (int q = 0; q < Gm::kStTiles; ++q) zero4(acc[q]);
  }

  auto sub_of = [&](int step) { return fwd ? step : n_sub - 1 - step; };
  TileLoad<TR, N, kThreads> lx, ly;
  TileLoad<TW, N, kThreads> lw;
  {
    const int t0 = sub_of(0) * kT;
    const int c = min(kT, S - t0);
    lx.load(xs, base, tok_stride, t0, c, tid);
    ly.load(ys, base, tok_stride, t0, c, tid);
    lw.load(w, base, tok_stride, t0, c, tid);
  }
  const int col = tid / Gm::kTPC;
  const int part = tid % Gm::kTPC;
  for (int step = 0; step < steps; ++step) {
    const int j = sub_of(step);
    const int c = min(kT, S - j * kT);
    __syncthreads();  // the last step's products have read Xd and Y
    lx.store(X, c, 0.f, tid);
    ly.store(Y, c, 0.f, tid);
    lw.store(W, c, 1.f, tid);
    if (step + 1 < steps) {
      const int t1 = sub_of(step + 1) * kT;
      const int c1 = min(kT, S - t1);
      lx.load(xs, base, tok_stride, t1, c1, tid);
      ly.load(ys, base, tok_stride, t1, c1, tid);
      lw.load(w, base, tok_stride, t1, c1, tid);
    }
    __syncthreads();
    {
      float cum[Gm::kTPT], excl, total;
      log_decays<N>(W, col, part, cum, excl, total);
#pragma unroll
      for (int jj = 0; jj < Gm::kTPT; ++jj) {
        const int t = part * Gm::kTPT + jj;
        // State: k e^{La_c - La_t}; adjoint: r e^{La_{t-1}}.
        const float ex = fwd ? total - (excl + cum[jj]) : (jj > 0 ? excl + cum[jj - 1] : excl);
        Xd[t * kDS + col] = X[t * kDS + col] * expf(ex);
      }
      if (part == 0) A[col] = expf(total);
    }
    __syncthreads();
    state_update<N>(acc, Xd, Y, A, warp, g, t4);
    // The state after sub-chunk j is the one before j + 1; the adjoint
    // before sub-chunk j is the end of range j / subs - 1.
    const int at = fwd ? j + 1 : (j % subs == 0 ? j / subs - 1 : -1);
    if (at >= 0) tiles_store<N>(acc, out + static_cast<int64_t>(at) * N * N, N, warp, g, t4);
  }
}

// One step of a reduce-scatter over the lanes of a state row (lane bit
// `Mask`): a lane keeps half of its Cnt partials and adds its partner's half,
// so each sum is formed once, in a fixed order.
template <int Cnt, int Mask>
__device__ __forceinline__ void reduce_step(float (&p)[kT], int lane, int& first) {
  constexpr int kHalf = Cnt / 2;
  const bool hi = (lane & Mask) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float keep = hi ? p[j + kHalf] : p[j];
    const float send = hi ? p[j] : p[j + kHalf];
    p[j] = keep + __shfl_xor_sync(0xffffffffu, send, Mask);
  }
  if (hi) first += kHalf;
}

// The row's kCG lanes sum their kT partials: lane ends with tokens first ..
// first + kT / kCG - 1 in p[0 ..].
template <int kCG>
__device__ __forceinline__ void row_reduce(float (&p)[kT], int lane, int& first) {
  first = 0;
  if constexpr (kCG >= 16) reduce_step<16, 8>(p, lane, first);
  if constexpr (kCG >= 8) reduce_step<(kCG >= 16 ? 8 : 16), 4>(p, lane, first);
  reduce_step<(kCG >= 16 ? 4 : kCG >= 8 ? 8 : 16), 2>(p, lane, first);
  reduce_step<(kCG >= 16 ? 2 : kCG >= 8 ? 4 : 8), 1>(p, lane, first);
}

// The gradient of one range of one (batch, head), its sub-chunks last to
// first.  The next sub-chunk's tiles and state land in the stage (cp.async)
// while this one's products and walk run.
template <typename TR, typename TW, int N>
__global__ void __launch_bounds__(Geo<N>::kThreads, 2)
rwkv_scan_bwd_range_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                           const TR* __restrict__ v, const TW* __restrict__ w,
                           const float* __restrict__ u, const float* __restrict__ state_in,
                           const TR* __restrict__ dy, const float* __restrict__ dstate,
                           TR* __restrict__ dr, TR* __restrict__ dk, TR* __restrict__ dv,
                           TW* __restrict__ dw, float* __restrict__ du_part,
                           float* __restrict__ dstate0, const float* __restrict__ s_sub,
                           const float* __restrict__ g_bound, int S, int H, int subs, int R) {
  using Gm = Geo<N>;
  using L = RangeSmem<TR, TW, N>;
  constexpr int kThreads = Gm::kThreads;
  constexpr int kDS = Gm::kDS;
  constexpr int kNT = Gm::kNT;
  constexpr int kQS = kT + 1;  // row stride of Q and P
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  char* stage = reinterpret_cast<char*>(smem4) + L::kStage;
  float* R_ = smem + L::kR;
  float* K_ = smem + L::kK;
  float* V_ = smem + L::kV;
  float* W_ = smem + L::kW;
  float* DY = smem + L::kDY;
  float* La = smem + L::kLa;
  float* Rd = smem + L::kRd;
  float* Ki = smem + L::kKi;
  float* Ks = smem + L::kKs;
  float* Qs = smem + L::kQ;
  float* Ps = smem + L::kP;
  float* Ruk = smem + L::kRuk;
  float* U = smem + L::kU;
  int* flag = reinterpret_cast<int*>(smem + L::kFlag);
  float* G = smem + L::kG;

  const int bh = blockIdx.x / R;
  const int rg = blockIdx.x % R;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int64_t tok_stride = static_cast<int64_t>(H) * N;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;
  const int n_sub = (S + kT - 1) / kT;
  const int j0 = rg * subs;
  const int nsr = min(subs, n_sub - j0);
  const int col = tid / Gm::kTPC;
  const int part = tid % Gm::kTPC;

  // Sub-chunk j0 + j's r, k, v, w, dy into the stage, and the state before
  // it into state buffer j & 1 (the initial state, or zeros, before the
  // sequence's first sub-chunk).
  auto stage_next = [&](int j) {
    const int js = j0 + j;
    const int t0 = js * kT;
    const int c = min(kT, S - t0);
    stage_tile<TR, N, kThreads>(stage, r, base, tok_stride, t0, c, tid);
    stage_tile<TR, N, kThreads>(stage + L::kRawR, k, base, tok_stride, t0, c, tid);
    stage_tile<TR, N, kThreads>(stage + 2 * L::kRawR, v, base, tok_stride, t0, c, tid);
    stage_tile<TR, N, kThreads>(stage + 3 * L::kRawR, dy, base, tok_stride, t0, c, tid);
    stage_tile<TW, N, kThreads>(stage + 4 * L::kRawR, w, base, tok_stride, t0, c, tid);
    const float* src = js > 0 ? s_sub + (static_cast<int64_t>(bh) * n_sub + js) * N * N
                              : (state_in != nullptr ? state_in + sbase : nullptr);
    float* dst = smem + L::kS0 + (j & 1) * Gm::kMat;
    for (int i = tid; i < N * N / 4; i += kThreads) {
      const int n = i / (N / 4);
      const int m = 4 * (i % (N / 4));
      cp_async16(dst + n * kDS + m, src != nullptr ? src + n * N + m : u, src != nullptr);
    }
    cp_async_commit();
  };

  // The adjoint at the range's end, and u.
  {
    const float* g_src = rg < R - 1 ? g_bound + (static_cast<int64_t>(bh) * R + rg) * N * N
                                    : (dstate != nullptr ? dstate + sbase : nullptr);
    for (int i = tid; i < N * N; i += kThreads) {
      G[(i / N) * kDS + i % N] = g_src != nullptr ? g_src[i] : 0.f;
    }
    for (int i = tid; i < N; i += kThreads) U[i] = u[h * N + i];
  }
  stage_next(nsr - 1);

  float du_acc = 0.f;  // thread n < N: du's partial of column n
  for (int j = nsr - 1; j >= 0; --j) {
    const int t0 = (j0 + j) * kT;
    const int c = min(kT, S - t0);
    const float* S0 = smem + L::kS0 + (j & 1) * Gm::kMat;
    cp_async_wait_all();
    __syncthreads();  // the stage landed; the last sub-chunk's walk and writes are done
    widen_tile<TR, N, kThreads>(R_, stage, c, 0.f, tid);
    widen_tile<TR, N, kThreads>(K_, stage + L::kRawR, c, 0.f, tid);
    widen_tile<TR, N, kThreads>(V_, stage + 2 * L::kRawR, c, 0.f, tid);
    widen_tile<TR, N, kThreads>(DY, stage + 3 * L::kRawR, c, 0.f, tid);
    widen_tile<TW, N, kThreads>(W_, stage + 4 * L::kRawR, c, 1.f, tid);
    if (tid == 0) *flag = 0;
    __syncthreads();  // the stage is free for the next sub-chunk
    if (j > 0) stage_next(j - 1);

    // Decay pass: La, r e^{La_{t-1}}, k e^{-La} (inf past the factor bound:
    // unread then), k e^{La_c - La}; a column below the bound raises the
    // pairwise flag.  Warp 0 then forms r . (u k) per token.
    {
      float cum[Gm::kTPT], excl, total;
      log_decays<N>(W_, col, part, cum, excl, total);
#pragma unroll
      for (int jj = 0; jj < Gm::kTPT; ++jj) {
        const int t = part * Gm::kTPT + jj;
        const float la_t = excl + cum[jj];
        const float la_prev = jj > 0 ? excl + cum[jj - 1] : excl;
        const float kv = K_[t * kDS + col];
        La[t * kDS + col] = la_t;
        Rd[t * kDS + col] = R_[t * kDS + col] * expf(la_prev);
        Ki[t * kDS + col] = kv * expf(-la_t);
        Ks[t * kDS + col] = kv * expf(total - la_t);
      }
      if (part == 0 && total < kMinFactorLogDecay) *flag = 1;
    }
    if (warp == 0) {
      const int t = lane >> 1;
      const int n0 = (lane & 1) * (N / 2);
      float acc = 0.f;
#pragma unroll 8
      for (int n = n0; n < n0 + N / 2; ++n) {
        acc = fmaf(R_[t * kDS + n] * U[n], K_[t * kDS + n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((lane & 1) == 0) Ruk[t] = acc;
    }
    __syncthreads();
    const bool pairwise = *flag != 0;

    // Q = dy v^T, and P = (r e^{La_{t-1}}) (k e^{-La})^T when factorised.
    for (int tile = warp; tile < (pairwise ? 2 : 4); tile += Gm::kWarps) {
      float hi[4], lo[4];
      zero4(hi);
      zero4(lo);
      const int n0 = 8 * (tile & 1);
      if (tile < 2) {
        mma_tile<N>(
            hi, lo, [&](int i, int kk) { return DY[i * kDS + kk]; },
            [&](int kk, int jx) { return V_[jx * kDS + kk]; }, n0, g, t4);
      } else {
        mma_tile<N>(
            hi, lo, [&](int i, int kk) { return Rd[i * kDS + kk]; },
            [&](int kk, int jx) { return Ki[jx * kDS + kk]; }, n0, g, t4);
      }
      float* dst = tile < 2 ? Qs : Ps;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[(g + (e >= 2 ? 8 : 0)) * kQS + n0 + 2 * t4 + (e & 1)] = hi[e] + lo[e];
      }
    }
    __syncthreads();

    if (pairwise) {
      // P_ts (s < t) and the decay-weighted sums of Q pairwise, one exp a
      // term: sum_{s<t} Q_ts e^{La_{t-1} - La_s} k_s into Ki (dr's), and
      // sum_{s>t} Q_st e^{La_{s-1} - La_t} r_s into Rd (dk's).  La_{t-1} is
      // row t - 1 of La, so the exponent of s = t - 1 is exactly 0.
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int t = e / kT;
        const int s_ = e % kT;
        float acc = 0.f;
        if (s_ < t) {
#pragma unroll 8
          for (int n = 0; n < N; ++n) {
            acc += R_[t * kDS + n] * K_[s_ * kDS + n] *
                   expf(La[(t - 1) * kDS + n] - La[s_ * kDS + n]);
          }
        }
        Ps[t * kQS + s_] = acc;
      }
      for (int e = tid; e < kT * N; e += kThreads) {
        const int t = e / N;
        const int n = e % N;
        float a_r = 0.f, a_k = 0.f;
        for (int s_ = 0; s_ < t; ++s_) {
          a_r += Qs[t * kQS + s_] * K_[s_ * kDS + n] *
                 expf(La[(t - 1) * kDS + n] - La[s_ * kDS + n]);
        }
        for (int s_ = t + 1; s_ < kT; ++s_) {
          a_k += Qs[s_ * kQS + t] * R_[s_ * kDS + n] *
                 expf(La[(s_ - 1) * kDS + n] - La[t * kDS + n]);
        }
        Ki[t * kDS + n] = a_r;
        Rd[t * kDS + n] = a_k;
      }
      __syncthreads();
    }

    // dr, dk, dv of a 16 x 8 column tile a warp, the three products' k-steps
    // interleaved, written from the accumulators:
    //   dr = e^{La_{t-1}} (dy S_0^T + [factorised] Q_low (k e^{-La})) + [pairwise] Ki + u k Q_tt
    //   dk = e^{La_c - La_t} (v G_c^T) + [factorised] e^{-La_t} (Q_up^T (r e^{La_{t-1}}))
    //        + [pairwise] Rd + u r Q_tt
    //   dv = (k e^{La_c - La}) G_c + P'^T dy, P' the strictly lower P with r . (u k)
    //        on its diagonal
    for (int nt = warp; nt < kNT; nt += Gm::kWarps) {
      const int n0 = 8 * nt;
      float hr[4], lr[4], hk[4], lk[4], hk2[4], lk2[4], hv[4], lv[4];
      zero4(hr);
      zero4(lr);
      zero4(hk);
      zero4(lk);
      zero4(hk2);
      zero4(lk2);
      zero4(hv);
      zero4(lv);
      auto a_dy = [&](int i, int kk) { return DY[i * kDS + kk]; };
      auto a_v = [&](int i, int kk) { return V_[i * kDS + kk]; };
      auto a_ks = [&](int i, int kk) { return Ks[i * kDS + kk]; };
      auto b_s0t = [&](int kk, int jx) { return S0[jx * kDS + kk]; };
      auto b_gt = [&](int kk, int jx) { return G[jx * kDS + kk]; };
      auto b_g = [&](int kk, int jx) { return G[kk * kDS + jx]; };
      auto b_dy = [&](int kk, int jx) { return DY[kk * kDS + jx]; };
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 8) {
        mma_step(hr, lr, a_dy, b_s0t, k0, n0, g, t4);
        mma_step(hk, lk, a_v, b_gt, k0, n0, g, t4);
        mma_step(hv, lv, a_ks, b_g, k0, n0, g, t4);
      }
      auto a_p = [&](int i, int kk) {
        return kk > i ? Ps[kk * kQS + i] : (kk == i ? Ruk[i] : 0.f);
      };
      if (!pairwise) {
        auto a_qlow = [&](int i, int kk) { return kk < i ? Qs[i * kQS + kk] : 0.f; };
        auto a_qup = [&](int i, int kk) { return kk > i ? Qs[kk * kQS + i] : 0.f; };
        auto b_ki = [&](int kk, int jx) { return Ki[kk * kDS + jx]; };
        auto b_rd = [&](int kk, int jx) { return Rd[kk * kDS + jx]; };
#pragma unroll
        for (int k0 = 0; k0 < kT; k0 += 8) {
          mma_step(hr, lr, a_qlow, b_ki, k0, n0, g, t4);
          mma_step(hk2, lk2, a_qup, b_rd, k0, n0, g, t4);
          mma_step(hv, lv, a_p, b_dy, k0, n0, g, t4);
        }
      } else {
#pragma unroll
        for (int k0 = 0; k0 < kT; k0 += 8) mma_step(hv, lv, a_p, b_dy, k0, n0, g, t4);
      }
      float o_r[4], o_k[4], o_v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + (e >= 2 ? 8 : 0);
        const int jx = n0 + 2 * t4 + (e & 1);
        const float qd = Qs[i * kQS + i];
        const float la_i = La[i * kDS + jx];
        const float dec = i > 0 ? expf(La[(i - 1) * kDS + jx]) : 1.f;
        o_r[e] = fmaf(U[jx] * K_[i * kDS + jx], qd,
                      dec * (hr[e] + lr[e]) + (pairwise ? Ki[i * kDS + jx] : 0.f));
        const float rest = pairwise ? Rd[i * kDS + jx] : expf(-la_i) * (hk2[e] + lk2[e]);
        o_k[e] = fmaf(U[jx] * R_[i * kDS + jx], qd,
                      expf(La[(kT - 1) * kDS + jx] - la_i) * (hk[e] + lk[e]) + rest);
        o_v[e] = hv[e] + lv[e];
      }
      const int64_t o0 = base + (t0 + g) * tok_stride + n0 + 2 * t4;
      const int64_t o8 = o0 + 8 * tok_stride;
      if (g < c) {
        store2(dr + o0, o_r[0], o_r[1]);
        store2(dk + o0, o_k[0], o_k[1]);
        store2(dv + o0, o_v[0], o_v[1]);
      }
      if (g + 8 < c) {
        store2(dr + o8, o_r[2], o_r[3]);
        store2(dk + o8, o_k[2], o_k[3]);
        store2(dv + o8, o_v[2], o_v[3]);
      }
    }
    if (tid < N) {
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        du_acc = fmaf(R_[t * kDS + tid] * K_[t * kDS + tid], Qs[t * kQS + t], du_acc);
      }
    }
    __syncthreads();  // the products have read G, S_0 and La

    // The token walk for dw: a slab of kRows state rows at a time, kCG
    // threads a row, 4 columns a thread.  S_{t-1} forward from S_0 into
    // registers, then G_t backward from G_c: dw_t = rowsum(G_t * S_{t-1}),
    // summed over the row's lanes in a fixed order, staged in La; G ends as
    // the adjoint before the sub-chunk.
    {
      constexpr int kCG = Gm::kCG;
      const int cg = tid % kCG;
      const int m0 = 4 * cg;
#pragma unroll 1
      for (int sl = 0; sl < Gm::kSlabs; ++sl) {
        const int n = sl * Gm::kRows + tid / kCG;
        float hist[kT][4];
        float s[4];
        {
          const float4 x = *reinterpret_cast<const float4*>(S0 + n * kDS + m0);
          s[0] = x.x;
          s[1] = x.y;
          s[2] = x.z;
          s[3] = x.w;
        }
#pragma unroll
        for (int t = 0; t < kT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) hist[t][e] = s[e];
          if (t + 1 < kT) {
            const float kn = K_[t * kDS + n];
            const float wn = W_[t * kDS + n];
            const float4 v4 = *reinterpret_cast<const float4*>(V_ + t * kDS + m0);
            s[0] = fmaf(wn, s[0], kn * v4.x);
            s[1] = fmaf(wn, s[1], kn * v4.y);
            s[2] = fmaf(wn, s[2], kn * v4.z);
            s[3] = fmaf(wn, s[3], kn * v4.w);
          }
        }
        float gg[4];
        {
          const float4 x = *reinterpret_cast<const float4*>(G + n * kDS + m0);
          gg[0] = x.x;
          gg[1] = x.y;
          gg[2] = x.z;
          gg[3] = x.w;
        }
        float p[kT];
#pragma unroll
        for (int t = kT - 1; t >= 0; --t) {
          float d = gg[0] * hist[t][0];
          d = fmaf(gg[1], hist[t][1], d);
          d = fmaf(gg[2], hist[t][2], d);
          d = fmaf(gg[3], hist[t][3], d);
          p[t] = d;
          const float rn = R_[t * kDS + n];
          const float wn = W_[t * kDS + n];
          const float4 d4 = *reinterpret_cast<const float4*>(DY + t * kDS + m0);
          gg[0] = fmaf(wn, gg[0], rn * d4.x);
          gg[1] = fmaf(wn, gg[1], rn * d4.y);
          gg[2] = fmaf(wn, gg[2], rn * d4.z);
          gg[3] = fmaf(wn, gg[3], rn * d4.w);
        }
        *reinterpret_cast<float4*>(G + n * kDS + m0) = make_float4(gg[0], gg[1], gg[2], gg[3]);
        int first;
        row_reduce<kCG>(p, lane, first);
#pragma unroll
        for (int q = 0; q < kT / kCG; ++q) La[(first + q) * kDS + n] = p[q];
      }
    }
    __syncthreads();
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N;
      const int n = i % N;
      dw[base + (t0 + t) * tok_stride + n] = from_f32<TW>(La[t * kDS + n]);
    }
  }

  if (rg == 0 && dstate0 != nullptr) {
    // G is the adjoint at the start of the sequence (its last writes were
    // fenced by the loop's final barrier).
    for (int i = tid; i < N * N; i += kThreads) {
      dstate0[sbase + i] = G[(i / N) * kDS + i % N];
    }
  }
  if (tid < N) du_part[(static_cast<int64_t>(bh) * R + rg) * N + tid] = du_acc;
}

template <typename TR, typename TW, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const void* w,
                     const float* u, const float* state_in, const void* dy,
                     const float* dstate, void* dr, void* dk, void* dv, void* dw,
                     float* du_part, float* dstate0, float* s_sub, float* g_bound, int B,
                     int S, int H, int subs, int R, cudaStream_t stream, int* seen) {
  using Gm = Geo<N>;
  const int64_t heads = static_cast<int64_t>(B) * H;
  if (S > kT) {
    auto kernel = rwkv_scan_bwd_bounds_kernel<TR, TW, N>;
    constexpr size_t smem = BoundsSmem<N>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(heads), R > 1 ? 2 : 1);
    kernel<<<grid, Gm::kThreads, smem, stream>>>(
        static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
        static_cast<const TW*>(w), state_in, static_cast<const TR*>(dy), dstate, s_sub,
        g_bound, S, H, subs, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    seen[2] = static_cast<int>(grid.x * grid.y);
  }
  auto kernel = rwkv_scan_bwd_range_kernel<TR, TW, N>;
  constexpr size_t smem = RangeSmem<TR, TW, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(heads * R));
  kernel<<<grid, Gm::kThreads, smem, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), u, state_in, static_cast<const TR*>(dy), dstate,
      static_cast<TR*>(dr), static_cast<TR*>(dk), static_cast<TR*>(dv), static_cast<TW*>(dw),
      du_part, dstate0, s_sub, g_bound, S, H, subs, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seen[0] = static_cast<int>(grid.x);
  seen[1] = subs;
  return cudaSuccess;
}

template <typename TR, typename TW>
cudaError_t launch_dtype(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* state_in, const void* dy,
                         const float* dstate, void* dr, void* dk, void* dv, void* dw,
                         float* du_part, float* dstate0, float* s_sub, float* g_bound, int B,
                         int S, int H, int N, int subs, int R, cudaStream_t stream,
                         int* seen) {
  switch (N) {
    case 16:
      return launch_n<TR, TW, 16>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, s_sub, g_bound, B, S, H, subs, R,
                                  stream, seen);
    case 32:
      return launch_n<TR, TW, 32>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, s_sub, g_bound, B, S, H, subs, R,
                                  stream, seen);
    case 64:
      return launch_n<TR, TW, 64>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, s_sub, g_bound, B, S, H, subs, R,
                                  stream, seen);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (r, k, v, w, dy and the gradients), 1 = bfloat16, 2 = r,
// k, v, dy, dr, dk, dv bfloat16 with w and dw float32.  N: 16, 32 or 64.  u
// (H, N), state_in and dstate (B, H, N, N, or null), dstate0 (B, H, N, N, or
// null): float32.  range_len: tokens of a range, 16, 32 or 64; with R =
// ceil(S / range_len) ranges and n_sub = ceil(S / 16) sub-chunks, du_part is
// (B, H, R, N) float32, and the float32 scratch s_sub (B, H, n_sub, N, N;
// null when n_sub = 1) and g_bound (B, H, R, N, N; null when R = 1) receive
// the states before the sub-chunks and the adjoints at the range ends.  All
// contiguous and 16-byte aligned; B * H * R < 2^31.  `launched` (3 ints, or
// null) receives what was launched: the range kernel's blocks and the
// sub-chunks a range it was given, and the boundary kernel's blocks (0 when
// it was not launched).  The wrapper checks the rest.
int rwkv_scan_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* state_in, const void* dy,
                         const void* dstate, void* dr, void* dk, void* dv, void* dw,
                         void* du_part, void* dstate0, void* s_sub, void* g_bound, int B,
                         int S, int H, int N, int range_len, int dtype, int device,
                         void* stream, int* launched) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0 || range_len < kT || range_len > kMaxSubs * kT ||
      range_len % kT != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R = (S + range_len - 1) / range_len;
  if ((S > kT && s_sub == nullptr) || (R > 1 && g_bound == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int subs = range_len / kT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s_in = static_cast<const float*>(state_in);
  const float* ds = static_cast<const float*>(dstate);
  float* dup = static_cast<float*>(du_part);
  float* ds0 = static_cast<float*>(dstate0);
  float* sb = static_cast<float*>(s_sub);
  float* gb = static_cast<float*>(g_bound);
  int seen[3] = {0, 0, 0};
  switch (dtype) {
    case 0:
      err = launch_dtype<float, float>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup, ds0,
                                       sb, gb, B, S, H, N, subs, R, s, seen);
      break;
    case 1:
      err = launch_dtype<bf16, bf16>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup, ds0,
                                     sb, gb, B, S, H, N, subs, R, s, seen);
      break;
    case 2:
      err = launch_dtype<bf16, float>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup, ds0,
                                      sb, gb, B, S, H, N, subs, R, s, seen);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess && launched != nullptr) {
    for (int i = 0; i < 3; ++i) launched[i] = seen[i];
  }
  return static_cast<int>(err);
}

const char* rwkv_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
