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
// above the H100's ops-per-byte balance once S reaches a few hundred.  This
// first version does them on the f32 FMA units (no tensor cores: mma.sync or
// wgmma with TMA are later work), so it is bound by those units and by
// shared-memory reads, not by HBM.  What the design does about it:
//   * one block per (batch, KV head, tile of 64 folded query rows).  A folded
//     row is (position, group member) with the G query heads of one KV head
//     side by side, as the TPU kernel folds them, so each K/V tile is read
//     from HBM into shared memory once and used by all G heads;
//   * a loop inside the block walks the KV tiles of 64 keys and stops at the
//     causal limit of the tile's last position (the TPU grid skipped the
//     future blocks; here they are never visited).  Causal tiles are issued
//     heaviest first, so the short ones fill the tail of the grid;
//   * the running max, sum and output of each row stay in f32 registers:
//     each thread owns 8 rows x (4 keys of the score tile, hd/16 columns of
//     the output), so a row's scores live in one half-warp and its max and
//     sum are warp shuffles; the output is written once;
//   * shared-memory layouts are chosen so the hot loops read without bank
//     conflicts: Q transposed (float4 reads of 8 rows), K row-major with an
//     odd row stride, P transposed (float4 reads of 8 rows);
//   * ragged tails (S * G or Sk not a multiple of 64) are masked inside the
//     kernel, so any S and Sk work (the Pallas wrapper needs exact blocks).
// `expf` (not __expf) keeps the f32 tolerance of the reference tests.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Sk,
                 int H, int Hk, float scale) {
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
      val = to_f32(q[((static_cast<int64_t>(b) * S + s) * H + kvh * G + g) * HD + d]);
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
        kv = to_f32(k[idx]);
        vv = to_f32(v[idx]);
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
    T* o = out + ((static_cast<int64_t>(b) * S + s) * H + kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD, bool kCausal>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int Sk, int H, int Hk, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD, kCausal>;
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(S) * (H / Hk);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(B * Hk));
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Sk, H, Hk, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int B,
                      int S, int Sk, int H, int Hk, bool causal, cudaStream_t stream) {
  return causal ? launch_one<T, HD, true>(q, k, v, out, B, S, Sk, H, Hk, stream)
                : launch_one<T, HD, false>(q, k, v, out, B, S, Sk, H, Hk, stream);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out, int B,
                         int S, int Sk, int H, int Hk, int hd, bool causal,
                         cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, k, v, out, B, S, Sk, H, Hk, causal, stream);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, S, Sk, H, Hk, causal, stream);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, S, Sk, H, Hk, causal, stream);
    case 160: return launch_hd<T, 160>(q, k, v, out, B, S, Sk, H, Hk, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  hd: 32, 64, 128 or 160.  q, k, v and out
// are contiguous; H % Hk == 0, B * Hk <= 65535; the wrapper checks all of it.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int B, int S, int Sk, int H, int Hk, int hd, int dtype,
                           int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || Sk <= 0 || Hk <= 0 || H % Hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_dtype<float>(q, k, v, out, B, S, Sk, H, Hk, hd, causal != 0, s);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(q, k, v, out, B, S, Sk, H, Hk, hd, causal != 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
