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
// tensor cores are the resource.  Two bodies, picked by dtype:
//
// bf16 (flash_fwd_bf16_mma_kernel, the serving path): FlashAttention-2 on
// mma.sync.m16n8k16 bf16 with f32 accumulation.  What the design does:
//   * one block per (batch, KV head, 64 folded query rows), 4 warps of 16
//     rows.  A folded row is (position, group member) with the G query heads
//     of one KV head side by side, as the TPU kernel folds them, so each K/V
//     tile is read into shared memory once and used by all G heads;
//   * the Q tile is copied once; its A fragments (ldmatrix) stay in registers
//     for the whole KV loop;
//   * K/V tiles of 64 keys are double-buffered with 16-byte cp.async copies
//     (zero-filled past Sk), issued right after the barrier that frees the
//     buffer, so the next tile's load overlaps this tile's products: one
//     block barrier a tile;
//   * rows of every tile are hd + 8 bf16 apart, so the 8 rows an ldmatrix
//     reads fall in distinct banks; K is read plain as the B operand of
//     Q K^T, V with .trans as the B operand of P V;
//   * the S accumulator is repacked in registers (f32 -> bf16 pairs) as the A
//     operand of P V; the row max and row sum are quad shuffles, the running
//     max, sum and output stay in f32 registers, exp2 with the scale folded;
//   * the loop stops at the causal limit of the block's last row; causal
//     tiles are issued heaviest first; the per-row causal mask (row / G) and
//     the Sk tail mask are applied only on tiles that straddle them;
//   * the output is staged through the warp's own Q rows and stored as
//     16-byte rows.
//
// f32 (flash_fwd_kernel): scalar f32 FMAs from shared memory, as first
// written.  Neither bf16 nor TF32 tensor cores hold the f32 tolerance of 2e-5
// (tests/test_kernels.py:43): a bf16 or TF32 operand keeps 8 or 11 bits.  3xTF32
// would, at three times the products; no path runs f32 attention on the card
// (serving is bf16), so the f32 body stays the simple one:
//   * one block per (batch, KV head, 64 folded query rows); each thread owns
//     8 rows x (4 keys of the score tile, hd/16 columns of the output), so a
//     row's scores live in one half-warp and its max and sum are shuffles;
//   * conflict-free layouts: Q transposed (float4 reads of 8 rows), K
//     row-major with an odd row stride, P transposed.
// Both bodies: masked scores are -1e30 as in the reference, keys past Sk get
// no weight, the row sum is floored at 1e-30 before the division, and ragged
// tails (S * G or Sk not a multiple of 64) are masked in the kernel, so any
// S and Sk work (the Pallas wrapper needs exact blocks).  `expf` (not __expf)
// keeps the f32 body's tolerance.
//
// With an `lse` buffer (f32, (B, H, S)) both bodies also store each row's
// log-sum-exp, m + log l in natural-log units, for the backward kernels
// (csrc/flash_attention_bwd.cu); with a null one they store nothing more, so
// serving does exactly the work it did without it.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/flash_attention.py.  The launch enqueues on
// the caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps; thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kRows = 64;       // folded query rows per block
constexpr int kKeys = 64;       // keys per KV tile
constexpr int kRowsPer = 8;     // rows ty*8 .. ty*8+7 of each thread
constexpr int kKeysPer = 4;     // keys tx + 16*c of each thread's score tile
constexpr int kStride = kRows + 4;  // row stride of Qt and Pt (floats), 16-byte aligned
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout, in floats.
template <int HD>
struct Smem {
  static constexpr int kQt = 0;                       // Qt[d][row], stride kStride
  static constexpr int kK = kQt + HD * kStride;       // K[key][d], stride HD + 1
  static constexpr int kV = kK + kKeys * (HD + 1);    // V[key][d], stride HD
  static constexpr int kPt = kV + kKeys * HD;         // Pt[key][row], stride kStride
  static constexpr int kFloats = kPt + kKeys * kStride;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int Sk, int H, int Hk, float scale) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kCols = HD / 16;  // output columns tx + 16*j of each thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem + Smem<HD>::kQt;
  float* Ks = smem + Smem<HD>::kK;
  float* Vs = smem + Smem<HD>::kV;
  float* Pt = smem + Smem<HD>::kPt;

  const int G = H / Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kRows;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  // Q tile, transposed, in f32; rows past S * G are zero and never stored.
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int64_t row = row0 + r;
    float val = 0.f;
    if (row < rows_total) {
      const int64_t s = row / G;
      const int g = static_cast<int>(row % G);
      val = q[((static_cast<int64_t>(b) * S + s) * H + kvh * G + g) * HD + d];
    }
    Qt[d * kStride + r] = val;
  }

  int qpos[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    qpos[i] = static_cast<int>((row0 + ty * kRowsPer + i) / G);
  }
  int n_tiles = (Sk + kKeys - 1) / kKeys;
  if (kCausal) {
    const int64_t last_row = (row0 + kRows < rows_total ? row0 + kRows : rows_total) - 1;
    const int last_pos = static_cast<int>(last_row / G);
    const int limit = last_pos / kKeys + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // Q is stored; the last tile's K, V and P are read
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int j = i / HD;
      const int d = i % HD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        const int64_t idx = ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + d;
        kv = k[idx];
        vv = v[idx];
      }
      Ks[j * (HD + 1) + d] = kv;
      Vs[j * HD + d] = vv;
    }
    __syncthreads();

    // Scores of 8 rows x 4 keys.
    float sc[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kStride + ty * kRowsPer);
      const float4 qb = *reinterpret_cast<const float4*>(Qt + d * kStride + ty * kRowsPer + 4);
      const float qr[kRowsPer] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kr[kKeysPer];
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) kr[c] = Ks[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPer; ++c) sc[i][c] = fmaf(qr[i], kr[c], sc[i][c]);
    }

    // Online softmax; a row's 64 keys lie in the 16 lanes of one half-warp.
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int key = k0 + tx + 16 * c;
        float x = sc[i][c] * scale;
        if (key >= Sk) {
          x = -INFINITY;  // past the end: no weight at all
        } else if (kCausal && key > qpos[i]) {
          x = kNegInf;
        }
        sc[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int key = k0 + tx + 16 * c;
        const float p = key < Sk ? expf(sc[i][c] - m_new) : 0.f;
        sc[i][c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        Pt[(tx + 16 * c) * kStride + ty * kRowsPer + i] = sc[i][c];
      }
    }
    __syncthreads();

    // acc += P V.
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + kk * kStride + ty * kRowsPer);
      const float4 pb = *reinterpret_cast<const float4*>(Pt + kk * kStride + ty * kRowsPer + 4);
      const float pr[kRowsPer] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vr = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) acc[i][j] = fmaf(pr[i], vr, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int64_t row = row0 + ty * kRowsPer + i;
    if (row >= rows_total) continue;
    const int64_t s = row / G;
    const int g = static_cast<int>(row % G);
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<int64_t>(b) * S + s) * H + kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[tx + 16 * j] = acc[i][j] / denom;
    // m and l are the same in all 16 lanes of the row's half-warp.
    if (lse != nullptr && tx == 0) {
      lse[(static_cast<int64_t>(b) * H + kvh * G + g) * S + s] = m[i] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------- bf16 body

constexpr int kMmaThreads = 128;  // 4 warps of 16 folded rows
constexpr int kMmaRows = 64;      // folded query rows per block
constexpr int kMmaKeys = 64;      // keys per KV tile
static_assert(kMmaRows == kMmaKeys, "Q, K and V tiles share one shape");
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Shared memory, in bf16: Q, K[2], V[2], each 64 rows of hd + 8.
template <int HD>
struct MmaSmem {
  static constexpr int kStride = HD + 8;
  static constexpr int kTile = kMmaRows * kStride;
  static constexpr size_t kBytes = sizeof(bf16) * 5 * kTile;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t.  A holds rows
// g and g + 8, columns 2t, 2t + 1 (+ 8); B holds column g, rows 2t, 2t + 1
// (+ 8); the f32 accumulator holds rows g and g + 8, columns 2t and 2t + 1.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, int S, int Sk, int H, int Hk,
                          float scale_log2) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using L = MmaSmem<HD>;
  constexpr int kStride = L::kStride;
  constexpr int kDK = HD / 16;     // k-steps of Q K^T
  constexpr int kDN = HD / 8;      // n-tiles of the output
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kKN = kMmaKeys / 8;  // n-tiles of the score tile
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + L::kTile;
  bf16* Vs = Ks + 2 * L::kTile;

  const int G = H / Hk;
  const int64_t rows_total = static_cast<int64_t>(S) * G;
  const int tile = kCausal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(tile) * kMmaRows;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the block

  auto row_offset = [&](int64_t row) -> int64_t {  // folded row -> element of q / out
    const int64_t s = row / G;
    const int gg = static_cast<int>(row % G);
    return ((static_cast<int64_t>(b) * S + s) * H + kvh * G + gg) * HD;
  };
  auto load_kv = [&](int kt, int buf) {
    bf16* kd = Ks + buf * L::kTile;
    bf16* vd = Vs + buf * L::kTile;
    for (int i = tid; i < kMmaKeys * kChunks; i += kMmaThreads) {
      const int j = i / kChunks;
      const int c = i % kChunks;
      const int key = kt * kMmaKeys + j;
      const bool ok = key < Sk;
      const int64_t off =
          ok ? ((static_cast<int64_t>(b) * Sk + key) * Hk + kvh) * HD + c * 8 : 0;
      cp_async16(smem_u32(kd + j * kStride + c * 8), k + off, ok);
      cp_async16(smem_u32(vd + j * kStride + c * 8), v + off, ok);
    }
  };

  for (int i = tid; i < kMmaRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int64_t row = row0 + r;
    const bool ok = row < rows_total;
    cp_async16(smem_u32(Qs + r * kStride + c * 8), q + (ok ? row_offset(row) + c * 8 : 0),
               ok);
  }
  load_kv(0, 0);
  cp_async_commit();

  const int first_pos = static_cast<int>(row0 / G);
  const int pos0 = static_cast<int>((row0 + wrow + g) / G);      // rows g and g + 8
  const int pos1 = static_cast<int>((row0 + wrow + g + 8) / G);
  int n_tiles = (Sk + kMmaKeys - 1) / kMmaKeys;
  if (kCausal) {
    const int64_t last_row =
        (row0 + kMmaRows < rows_total ? row0 + kMmaRows : rows_total) - 1;
    const int limit = static_cast<int>(last_row / G) / kMmaKeys + 1;
    n_tiles = n_tiles < limit ? n_tiles : limit;
  }

  uint32_t qf[kDK][4];
  float o[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        ldsm_x4(qf[kk], smem_u32(Qs + (wrow + (lane & 15)) * kStride + kk * 16 +
                                 (lane >> 4) * 8));
      }
    }
    if (kt + 1 < n_tiles) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const bf16* kb = Ks + (kt & 1) * L::kTile;
    const bf16* vb = Vs + (kt & 1) * L::kTile;

    // S = Q K^T for the warp's 16 rows x 64 keys.
    float s[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int np = 0; np < kKN / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                             kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // Online softmax in the log2 domain; masks only on straddling tiles.
    const int k0 = kt * kMmaKeys;
    const bool edge = (kCausal && k0 + kMmaKeys - 1 > first_pos) || k0 + kMmaKeys > Sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
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

    // O += P V: the accumulator of key n-tiles 2kk, 2kk + 1 is the A fragment.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDN / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(vb + (kk * 16 + (lane & 15)) * kStride + dp * 16 +
                                   (lane >> 4) * 8));
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // Normalise, stage in the warp's own Q rows, store 16 bytes a lane.
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (lse != nullptr && t4 == 0) {  // m and l are the same in the row's quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row = row0 + wrow + g + 8 * i;
      if (row < rows_total) {
        const int64_t s = row / G;
        const int gg = static_cast<int>(row % G);
        // m is in the log2 domain of the scaled scores.
        lse[(static_cast<int64_t>(b) * H + kvh * G + gg) * S + s] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
      }
    }
  }
  bf16* ow = Qs + wrow * kStride;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
    *reinterpret_cast<uint32_t*>(ow + g * kStride + 8 * n + 2 * t4) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * kStride + 8 * n + 2 * t4) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int64_t row = row0 + wrow + r;
    if (row < rows_total) {
      *reinterpret_cast<uint4*>(out + row_offset(row) + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * kStride + c * 8);
    }
  }
}

template <int HD, bool kCausal>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int S, int Sk, int H, int Hk, cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_mma_kernel<HD, kCausal>;
  const size_t smem = MmaSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const dim3 grid(static_cast<unsigned>((rows + kMmaRows - 1) / kMmaRows),
                  static_cast<unsigned>(B * Hk));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, S, Sk, H, Hk, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- launchers

template <int HD, bool kCausal>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int S, int Sk, int H, int Hk, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<HD, kCausal>;
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(B * Hk));
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Sk, H, Hk, scale);
  return cudaGetLastError();
}

// bf16: the tensor-core body; f32: the FMA body.
template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                      int B, int S, int Sk, int H, int Hk, bool bf16, bool causal,
                      cudaStream_t stream) {
  if (bf16) {
    return causal ? launch_mma<HD, true>(q, k, v, out, lse, B, S, Sk, H, Hk, stream)
                  : launch_mma<HD, false>(q, k, v, out, lse, B, S, Sk, H, Hk, stream);
  }
  return causal ? launch_fma<HD, true>(q, k, v, out, lse, B, S, Sk, H, Hk, stream)
                : launch_fma<HD, false>(q, k, v, out, lse, B, S, Sk, H, Hk, stream);
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int S, int Sk, int H, int Hk, int hd, bool bf16, bool causal,
                   cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32>(q, k, v, out, lse, B, S, Sk, H, Hk, bf16, causal, stream);
    case 64: return launch_hd<64>(q, k, v, out, lse, B, S, Sk, H, Hk, bf16, causal, stream);
    case 128:
      return launch_hd<128>(q, k, v, out, lse, B, S, Sk, H, Hk, bf16, causal, stream);
    case 160:
      return launch_hd<160>(q, k, v, out, lse, B, S, Sk, H, Hk, bf16, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA body), 1 = bfloat16 (tensor-core body).  hd: 32, 64,
// 128 or 160.  q, k, v and out are contiguous, and 16-byte aligned for bf16;
// H % Hk == 0, B * Hk <= 65535; the wrapper checks all of it.  lse is null or
// an f32 (B, H, S) buffer for the rows' log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, int B, int S, int Sk, int H, int Hk, int hd,
                           int dtype, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  err = launch(q, k, v, out, lse, B, S, Sk, H, Hk, hd, dtype == 1, causal != 0,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
