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
// f32 (flash_fwd_tf32x3_mma_kernel; whisper's encoder and cross-attention,
// whose f32 frames JAX promotes): the same structure on mma.sync.m16n8k8 TF32
// in 3xTF32.  One TF32 product keeps 11 bits of each operand, short of the
// f32 tolerance of 2e-5 (tests/test_kernels.py:43); each operand is split
// once into a TF32 big part and the remainder (csrc/rwkv_scan.cu's
// split_tf32), and big * big + big * small + small * big, accumulated in f32,
// keeps about 21 bits: three tensor-core products at 495 TFLOP/s beat one
// f32 FMA at 67.  What differs from the bf16 body:
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
// tails (S * G or Sk not a multiple of 64) are masked in the kernel, so any
// S and Sk work (the Pallas wrapper needs exact blocks).
//
// With an `lse` buffer (f32, (B, H, S)) both bodies also store each row's
// log-sum-exp, m + log l in natural-log units, for the backward kernels
// (csrc/flash_attention_bwd.cu); with a null one they store nothing more, so
// serving does exactly the work it did without it.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/flash_attention.py.  The launch enqueues on
// the caller's stream, does not synchronise and allocates nothing (the split
// walk's partials come from the wrapper); the return value is
// cudaGetLastError() right after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "flash_tf32x3.cuh"

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Fragment layouts as csrc/flash_tf32x3.cuh gives them.  Whole walk (gridDim.z == 1): out and lse as the bf16 body stores them.
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
                          int ranges, cudaStream_t stream) {
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
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const int64_t n_rows = static_cast<int64_t>(B) * S * H;
  flash_fwd_merge_kernel<<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, stream>>>(
      o_part, stat_part, static_cast<float*>(out), lse, n_rows, S, H, HD, ranges);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- launchers

// What a call launched, for the caller to read back: launched[0] the body
// (kBodyTf32x3 or kBodyBf16), launched[1] the key ranges of its grid.
constexpr int kBodyTf32x3 = 0;
constexpr int kBodyBf16 = 1;

// bf16: the bf16 tensor-core body; f32: the 3xTF32 one, its key walk cut into
// `ranges`.
template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                      float* o_part, float* stat_part, int B, int S, int Sk, int H, int Hk,
                      bool bf16, bool causal, int ranges, int* launched, cudaStream_t stream) {
  if (bf16) {
    launched[0] = kBodyBf16;
    launched[1] = 1;
    return causal ? launch_mma<HD, true>(q, k, v, out, lse, B, S, Sk, H, Hk, stream)
                  : launch_mma<HD, false>(q, k, v, out, lse, B, S, Sk, H, Hk, stream);
  }
  launched[0] = kBodyTf32x3;
  launched[1] = ranges;
  return causal ? launch_tf32x3<HD, true>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk,
                                          ranges, stream)
                : launch_tf32x3<HD, false>(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H,
                                           Hk, ranges, stream);
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   float* o_part, float* stat_part, int B, int S, int Sk, int H, int Hk, int hd,
                   bool bf16, bool causal, int ranges, int* launched, cudaStream_t stream) {
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 body), 1 = bfloat16 (bf16 tensor-core body).
// hd: 32, 64, 128 or 160.  q, k, v and out are contiguous and 16-byte
// aligned; H % Hk == 0, B * Hk <= 65535; the wrapper checks all of it.  lse
// is null or an f32 (B, H, S) buffer for the rows' log-sum-exp.  key_ranges:
// the ranges of the f32 body's key walk (1 for bf16, 1 <= key_ranges <=
// 65535); above 1, o_part is f32 scratch of key_ranges * B * S * H * hd
// elements and stat_part of 2 * key_ranges * B * H * S.  On success
// launched[0] holds the body the call ran (0 = 3xTF32, 1 = bf16) and
// launched[1] the key ranges it launched.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           float* lse, float* o_part, float* stat_part, int B, int S, int Sk,
                           int H, int Hk, int hd, int dtype, int causal, int key_ranges,
                           int* launched, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (key_ranges < 1 || key_ranges > 65535 || (dtype == 1 && key_ranges != 1) ||
      (key_ranges > 1 && (o_part == nullptr || stat_part == nullptr)) || launched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch(q, k, v, out, lse, o_part, stat_part, B, S, Sk, H, Hk, hd, dtype == 1,
               causal != 0, key_ranges, launched, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
