// Fused NetMax consensus update (gossip mix) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/gossip_mix.py::gossip_mix_rows (_mix_rows_kernel)
// and ::gossip_mix (_mix_kernel), the latter launched here as one row:
//
//     out[r] = (1 - w[r]) * (x[r] + u[r]) + w[r] * p[r]
//
// Math is f32; the result is cast back to the input dtype (f32, bf16, f16).
//
// What bounds it: HBM bytes.  Every element is read three times (x, u, p) and
// written once -- 4 * R * n * itemsize bytes for five flops an element, far
// below the card's ops-per-byte balance.  The design only has to keep the
// memory system busy:
//   * one block per (tile, row); the block reads w[row] once from global memory;
//   * each thread moves 16-byte vectors (4 f32 or 8 bf16/f16 values) with
//     neighbouring threads on neighbouring addresses, and issues all of its
//     loads for a tile before the first store;
//   * the ragged tail is masked inside the kernel, so no padded copies are made
//     (the Pallas wrapper pads and slices);
//   * rows whose start is not 16-byte aligned (n not a multiple of the vector
//     width, or an unaligned base pointer) take the scalar path.
// Every step rounds like the plain torch version (__fadd_rn / __fmul_rn keep
// nvcc from contracting into FMAs), so the kernel is bit-equal to it.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/gossip_mix.py.  The launch enqueues on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors per thread per tile
constexpr int kMaxGridY = 65535;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float load(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half store(float v) { return __float2half_rn(v); }
};

template <typename T>
__device__ __forceinline__ T mix1(T x, T u, T p, float w, float omw) {
  const float h = __fadd_rn(Cvt<T>::load(x), Cvt<T>::load(u));
  return Cvt<T>::store(__fadd_rn(__fmul_rn(omw, h), __fmul_rn(w, Cvt<T>::load(p))));
}

template <typename T>
__device__ __forceinline__ int4 mix_vec(int4 a, int4 b, int4 c, float w, float omw) {
  constexpr int kVecElems = 16 / sizeof(T);
  const T* ta = reinterpret_cast<const T*>(&a);
  const T* tb = reinterpret_cast<const T*>(&b);
  const T* tc = reinterpret_cast<const T*>(&c);
  int4 o;
  T* to = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int j = 0; j < kVecElems; ++j) to[j] = mix1(ta[j], tb[j], tc[j], w, omw);
  return o;
}

// Elements one block covers in one row; a multiple of every vector width.
template <typename T>
__host__ __device__ constexpr int64_t tile_elems() {
  return static_cast<int64_t>(kThreads) * kUnroll * (16 / sizeof(T));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
mix_rows_kernel(const T* __restrict__ x, const T* __restrict__ u,
                const T* __restrict__ p, const float* __restrict__ w_rows,
                float w_scalar, T* __restrict__ out, int64_t R, int64_t n) {
  constexpr int kVecElems = 16 / sizeof(T);
  constexpr int64_t kTile = tile_elems<T>();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int64_t row = blockIdx.y; row < R; row += gridDim.y) {
    const float w = w_rows != nullptr ? w_rows[row] : w_scalar;
    const float omw = __fsub_rn(1.0f, w);
    const int64_t base = row * n;
    if constexpr (kVec) {
      const int64_t nvec = n / kVecElems;  // whole vectors in this row
      const int4* xv = reinterpret_cast<const int4*>(x + base);
      const int4* uv = reinterpret_cast<const int4*>(u + base);
      const int4* pv = reinterpret_cast<const int4*>(p + base);
      int4* ov = reinterpret_cast<int4*>(out + base);
      const int64_t v0 = start / kVecElems + threadIdx.x;
      int4 a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t v = v0 + static_cast<int64_t>(k) * kThreads;
        if (v < nvec) {
          a[k] = xv[v];
          b[k] = uv[v];
          c[k] = pv[v];
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t v = v0 + static_cast<int64_t>(k) * kThreads;
        if (v < nvec) ov[v] = mix_vec<T>(a[k], b[k], c[k], w, omw);
      }
      // Fewer than kVecElems trailing elements (only when R == 1): the block
      // whose tile holds them finishes them element by element.
      const int64_t tail0 = nvec * kVecElems;
      if (tail0 < n && tail0 >= start && tail0 < start + kTile) {
        const int64_t e = tail0 + threadIdx.x;
        if (e < n) out[base + e] = mix1(x[base + e], u[base + e], p[base + e], w, omw);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kUnroll * kVecElems; ++k) {
        const int64_t e = start + static_cast<int64_t>(k) * kThreads + threadIdx.x;
        if (e < n) out[base + e] = mix1(x[base + e], u[base + e], p[base + e], w, omw);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* u, const void* p, const float* w_rows,
                   float w_scalar, void* out, int64_t R, int64_t n, bool vec,
                   cudaStream_t stream) {
  const int64_t tiles = (n + tile_elems<T>() - 1) / tile_elems<T>();
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(R < kMaxGridY ? R : kMaxGridY));
  const T* xt = static_cast<const T*>(x);
  const T* ut = static_cast<const T*>(u);
  const T* pt = static_cast<const T*>(p);
  T* ot = static_cast<T*>(out);
  if (vec) {
    mix_rows_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, ut, pt, w_rows,
                                                             w_scalar, ot, R, n);
  } else {
    mix_rows_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, ut, pt, w_rows,
                                                              w_scalar, ot, R, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  w_rows == NULL selects the
// scalar weight w_scalar for every row (the gossip_mix entry point).  vec != 0
// asserts that x, u, p and out start 16-byte aligned and that every row does
// too (R == 1 or n a multiple of 16 / itemsize); the wrapper checks that.
int gossip_mix_rows_launch(const void* x, const void* u, const void* p,
                           const float* w_rows, float w_scalar, void* out,
                           long long R, long long n, int dtype, int vec,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(x, u, p, w_rows, w_scalar, out, R, n, vec != 0, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(x, u, p, w_rows, w_scalar, out, R, n, vec != 0, s);
      break;
    case 2:
      err = launch<__half>(x, u, p, w_rows, w_scalar, out, R, n, vec != 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
