// Chunked RWKV-6 WKV recurrence (forward) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/rwkv_scan.py::rwkv_scan (_rwkv_kernel).  Per
// (batch, head), with the (N, N) f32 state S (rows: key dim n, columns:
// value dim m) and per-token decays w in (0, 1):
//
//     y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//
// r, k, v, w are (B, S, H, N), read in place (no fold to (B*H, S, N)), f32 or
// bf16; u is (H, N) f32; y is written in the input dtype.  The initial state
// (B, H, N, N) f32 is read when given (zeros otherwise, as the Pallas kernel's
// _init) and the final state is always written: it is the decode cache of the
// ssm family, which the Pallas kernel drops.
//
// The arithmetic is the Pallas kernel's chunk form.  Tokens are walked in
// chunks of `chunk` and, inside a chunk, sub-chunks of `sub` = min(16, chunk)
// tokens; for a sub-chunk of c tokens with the clamped log decays
// lw = clip(log(max(w, 1e-30)), -75 / sub, 0) (the wrapper's clamp, fused into
// the loads here) and their inclusive cumulative sum La:
//
//     r_dec = r exp(La - lw)      k_inv = k exp(-La)     (La - lw: the sum up to t - 1)
//     y     = r_dec S + tril(r_dec k_inv^T, -1) v + (r u k) v
//     S     = exp(La_c) S + (k_inv exp(La_c))^T v
//
// The sub-chunk bounds the exponent range of exp(+La) exp(-La) pairs to
// e^75, which f32 holds; decays stronger than e^(-75/sub) a step are clamped,
// exactly as in the Pallas wrapper.  A ragged sub-chunk (S not a multiple of
// the chunk, or of 16) is padded with r = k = v = 0 and lw = 0, which leaves
// every valid row and the state unchanged; padded rows are never stored.
//
// What bounds it on the card: bytes.  A call reads r, k, v, w once and writes
// y once, about 20 k flops per token and head at N = 64 against 20 bytes in
// f32, below the H100's f32 ops-per-byte balance.  This first version does its
// products on the f32 FMA units from shared memory (no tensor cores) and is
// bound by them and by shared-memory reads, not by HBM.  What the design does:
//   * the state's columns evolve independently, so a block owns one
//     (batch, head) and 16 of its N state columns: N / 16 blocks per head keep
//     the card busy at small B * H; they are launched side by side and read
//     the same r, k, w rows, so L2 can serve those after the first;
//   * a loop inside the block walks the sub-chunks in order (the Pallas grid's
//     sequential axis), the 16 x N state tile in shared memory, transposed so
//     a thread reads its column as float4;
//   * per sub-chunk, 256 threads take one entry each of the 16 x 16 score
//     tile, then one entry each of the 16 x 16 output tile, then N / 16
//     state entries each; token-major tiles have a row stride of N + 4 floats,
//     so the float4 reads of 8 different rows fall in different banks.
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

namespace {

constexpr int kThreads = 256;
constexpr int kT = 16;   // tokens per tile: the Pallas kernel's _SUB
constexpr int kMB = 16;  // state columns per block
static_assert(kThreads == kT * kT && kThreads == kT * kMB, "one thread per tile entry");

// Shared-memory layout, in floats.  Token-major tiles are [t][n] with row
// stride kRow; the state tile is St[m][n], also with row stride kRow.
template <int N>
struct Smem {
  static constexpr int kRow = N + 4;
  static constexpr int kTok = kT * kRow;
  static constexpr int kR = 0;              // r, then r * u (the diagonal's left side)
  static constexpr int kK = kR + kTok;      // k
  static constexpr int kLa = kK + kTok;     // clamped log decay, then its inclusive cumsum
  static constexpr int kRd = kLa + kTok;    // r_dec
  static constexpr int kKi = kRd + kTok;    // k_inv
  static constexpr int kKs = kKi + kTok;    // k_inv * exp(La_c)
  static constexpr int kV = kKs + kTok;     // v[t][m], stride kMB
  static constexpr int kP = kV + kT * kMB;  // P[i][j], stride kT
  static constexpr int kS = kP + kT * kT;   // St[m][n]
  static constexpr int kU = kS + kMB * kRow;
  static constexpr int kA = kU + N;         // exp(La_c)[n]
  static constexpr int kFloats = kA + N;
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

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ state_in,
                 T* __restrict__ y, float* __restrict__ state_out, int S, int H,
                 int chunk, int sub, float lw_bound) {
  static_assert(N % kMB == 0 && N <= kThreads, "N must be 16, 32 or 64");
  using L = Smem<N>;
  constexpr int kRow = L::kRow;
  constexpr int kTiles = N / kMB;
  constexpr int kMPer = kMB * N / kThreads;  // state entries per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* R = smem + L::kR;
  float* K = smem + L::kK;
  float* La = smem + L::kLa;
  float* Rd = smem + L::kRd;
  float* Ki = smem + L::kKi;
  float* Ks = smem + L::kKs;
  float* V = smem + L::kV;
  float* P = smem + L::kP;
  float* St = smem + L::kS;
  float* U = smem + L::kU;
  float* A = smem + L::kA;

  const int bh = blockIdx.x / kTiles;
  const int m0 = (blockIdx.x % kTiles) * kMB;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int64_t tok_stride = static_cast<int64_t>(H) * N;  // between tokens
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;  // (b, 0, h, 0)
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;

  for (int n = tid; n < N; n += kThreads) U[n] = u[h * N + n];
  for (int e = tid; e < N * kMB; e += kThreads) {
    const int n = e / kMB;
    const int m = e % kMB;
    St[m * kRow + n] = state_in != nullptr ? state_in[sbase + n * N + m0 + m] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int c_end = S - c0 < chunk ? S : c0 + chunk;
    for (int t0 = c0; t0 < c_end; t0 += sub) {
      const int len = c_end - t0 < sub ? c_end - t0 : sub;
      __syncthreads();  // the last sub-chunk's V, Ks and St are read

      // Loads, in f32, with the clamp fused; rows past `len` are zero.
      for (int e = tid; e < kT * N; e += kThreads) {
        const int t = e / N;
        const int n = e % N;
        float rv = 0.f, kv = 0.f, lw = 0.f;
        if (t < len) {
          const int64_t idx = base + (t0 + t) * tok_stride + n;
          rv = to_f32(r[idx]);
          kv = to_f32(k[idx]);
          lw = fminf(fmaxf(logf(fmaxf(to_f32(w[idx]), 1e-30f)), -lw_bound), 0.f);
        }
        R[t * kRow + n] = rv;
        K[t * kRow + n] = kv;
        La[t * kRow + n] = lw;
      }
      for (int e = tid; e < kT * kMB; e += kThreads) {
        const int t = e / kMB;
        V[e] = t < len ? to_f32(v[base + (t0 + t) * tok_stride + m0 + e % kMB]) : 0.f;
      }
      __syncthreads();

      // Inclusive cumulative log decay, one column per thread.
      if (tid < N) {
        float la = 0.f;
        for (int t = 0; t < kT; ++t) {
          la += La[t * kRow + tid];
          La[t * kRow + tid] = la;
        }
        A[tid] = expf(la);
      }
      __syncthreads();

      // Decay-weighted r and k; r * u for the diagonal.
      for (int e = tid; e < kT * N; e += kThreads) {
        const int t = e / N;
        const int n = e % N;
        const int o = t * kRow + n;
        const float la = La[o];
        const float rv = R[o];
        const float ki = K[o] * expf(-la);
        Rd[o] = rv * expf(t > 0 ? La[o - kRow] : 0.f);  // La - lw: the exclusive sum
        Ki[o] = ki;
        Ks[o] = ki * A[n];
        R[o] = rv * U[n];
      }
      __syncthreads();

      // P[i][j]: scores below the diagonal, the u bonus on it, 0 above.
      {
        const int i = tid / kT;
        const int j = tid % kT;
        const float* a = (j == i ? R : Rd) + i * kRow;
        const float* c = (j == i ? K : Ki) + j * kRow;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          acc = dot4(*reinterpret_cast<const float4*>(a + n),
                     *reinterpret_cast<const float4*>(c + n), acc);
        }
        P[tid] = j <= i ? acc : 0.f;
      }
      __syncthreads();

      // y[i][m] = r_dec[i] . S[:, m] + sum_{j <= i} P[i][j] v[j][m].
      {
        const int i = tid / kMB;
        const int m = tid % kMB;
        const float* a = Rd + i * kRow;
        const float* s = St + m * kRow;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          acc = dot4(*reinterpret_cast<const float4*>(a + n),
                     *reinterpret_cast<const float4*>(s + n), acc);
        }
#pragma unroll
        for (int j = 0; j < kT; ++j) acc = fmaf(P[i * kT + j], V[j * kMB + m], acc);
        if (i < len) y[base + (t0 + i) * tok_stride + m0 + m] = from_f32<T>(acc);
      }
      __syncthreads();

      // S <- diag(exp(La_c)) S + Ks^T V; each thread owns kMPer entries of row n.
      {
        const int n = tid % N;
        const int mb = (tid / N) * kMPer;
        const float a = A[n];
        float acc[kMPer];
#pragma unroll
        for (int q = 0; q < kMPer; ++q) acc[q] = a * St[(mb + q) * kRow + n];
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          const float ks = Ks[j * kRow + n];
#pragma unroll
          for (int q = 0; q < kMPer; ++q) acc[q] = fmaf(ks, V[j * kMB + mb + q], acc[q]);
        }
#pragma unroll
        for (int q = 0; q < kMPer; ++q) St[(mb + q) * kRow + n] = acc[q];
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * kMB; e += kThreads) {
    const int n = e / kMB;
    const int m = e % kMB;
    state_out[sbase + n * N + m0 + m] = St[m * kRow + n];
  }
}

template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const void* w,
                     const float* u, const float* state_in, void* y, float* state_out,
                     int B, int S, int H, int chunk, int sub, float lw_bound,
                     cudaStream_t stream) {
  auto kernel = rwkv_scan_kernel<T, N>;
  const size_t smem = Smem<N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(B) * H * (N / kMB);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, state_in, static_cast<T*>(y), state_out, S, H, chunk,
      sub, lw_bound);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* state_in, void* y,
                         float* state_out, int B, int S, int H, int N, int chunk, int sub,
                         float lw_bound, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_n<T, 16>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk, sub,
                             lw_bound, stream);
    case 32:
      return launch_n<T, 32>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk, sub,
                             lw_bound, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, w, u, state_in, y, state_out, B, S, H, chunk, sub,
                             lw_bound, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y).  N: 16, 32 or 64.
// u (H, N), state_in (B, H, N, N) or null, state_out (B, H, N, N): float32.
// All contiguous; 1 <= sub <= 16, sub <= chunk; B * H * N / 16 < 2^31.  The
// wrapper checks all of it.
int rwkv_scan_launch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* state_in, void* y, void* state_out,
                     int B, int S, int H, int N, int chunk, int sub, float lw_bound,
                     int dtype, int device, void* stream) {
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
      err = launch_dtype<float>(r, k, v, w, uf, s_in, y, s_out, B, S, H, N, chunk, sub,
                                lw_bound, s);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(r, k, v, w, uf, s_in, y, s_out, B, S, H, N, chunk,
                                        sub, lw_bound, s);
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
