// Fused NetMax consensus update (gossip mix) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/gossip_mix.py::gossip_mix_rows (_mix_rows_kernel)
// and ::gossip_mix (_mix_kernel), the latter launched here as one row:
//
//     out[r] = (1 - w[r]) * (x[r] + u[r]) + w[r] * p[r]
//
// Math is f32; the result is cast back to the input dtype (f32, bf16, f16).
// One launch mixes a whole parameter tree: a table of up to kMaxLeaves leaves
// (each an (R, n) block, all sharing the (R,) f32 weights) is passed by value
// as a __grid_constant__ kernel parameter, so no host-to-device copy is made.
//
// What bounds it.  At large shapes, HBM bytes: each element is read three
// times (x, u, p; twice without u) and written once, five flops an element,
// far below the card's ops-per-byte balance.  At the simulator's shapes (six
// leaves of 320 to 262,144 elements, 420,160 in all) the launches: each costs
// ~1.2 us on the device, mostly fixed, and tens of us on the host.  So:
//   * one launch per tree (per dtype group of at most kMaxLeaves leaves), not
//     one per leaf; a block finds its leaf by counting the leaves whose first
//     block is at or below its own (independent loads, no dependent search);
//   * each leaf is R * n contiguous elements cut into chunks of
//     kThreads * kUnroll 16-byte vectors; the wrapper takes the largest
//     kUnroll (4, 2, 1) that still gives every SM four blocks, so the
//     simulator's tree spreads over 821 blocks and a large leaf keeps four
//     vectors of each operand in flight per thread (all loads before the
//     first store);
//   * the row of an element is found without a division per element: the
//     block divides its chunk's start by n once (in 32 bits when it can, not
//     at all in a leaf's first row), and an offset inside the chunk adds a
//     compare (n > chunk) or a multiply-high by ceil(2^32 / n), which the
//     wrapper precomputes;
//   * a vector that crosses a row boundary (n = 10, n = 1) takes each lane's
//     weight from that lane's own row, so such leaves still move in 16-byte
//     vectors; only a leaf whose base is not 16-byte aligned goes element by
//     element; the < 8 trailing elements of a leaf are loaded with its
//     vectors, so a small leaf waits on memory once;
//   * "u is zero" is a template flag: u is not read (three operands' bytes
//     instead of four), and x + 0.0f is still computed so -0.0 becomes +0.0
//     exactly as the plain version's x + zeros does.
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
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLeaves = 48;

// One leaf, eight 64-bit words as the wrapper writes them.
struct Leaf {
  const void* x;
  const void* u;  // null when the launch has no u
  const void* p;
  void* out;
  long long size;         // R * n elements
  long long n;            // elements a row
  long long first_block;  // the leaf's first block in the launch
  unsigned vec;           // 1: x, u, p and out start on 16-byte boundaries
  unsigned magic;         // ceil(2^32 / n) when 2 <= n <= the chunk, else 0
};
static_assert(sizeof(Leaf) == 64, "a leaf is eight 64-bit words");

// The header first, so that it shares its cache line with the first leaf.
struct Table {
  const float* w;  // (R,) f32 shared by every leaf; null: w_scalar
  float w_scalar;
  int count;
  Leaf leaf[kMaxLeaves];
};
// Within the 4 KB of classic kernel parameters.
static_assert(sizeof(Table) <= 4096, "leaf table exceeds the kernel parameters");

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

template <typename T, bool kHasU>
__device__ __forceinline__ T mix1(T x, T u, T p, float w) {
  const float h = __fadd_rn(Cvt<T>::load(x), kHasU ? Cvt<T>::load(u) : 0.0f);
  const float omw = __fsub_rn(1.0f, w);
  return Cvt<T>::store(__fadd_rn(__fmul_rn(omw, h), __fmul_rn(w, Cvt<T>::load(p))));
}

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T, int kUnroll>
__host__ __device__ constexpr long long chunk_elems() {
  return static_cast<long long>(kThreads) * kUnroll * vec_elems<T>();
}

// Rows of the elements of one chunk: element c0 + l (0 <= l < chunk) lies in
// row r0 + q, q = (rem0 + l) / n, with rem0 = c0 - r0 * n < n.  The block
// divides once, in 32 bits when it can, and not at all in the leaf's first
// row (every block of a one-row leaf).
struct Rows {
  long long r0, rem0, n;
  unsigned magic;  // the leaf's ceil(2^32 / n), or 0
  bool small;      // n <= chunk

  __device__ __forceinline__ Rows(long long c0, long long n_, unsigned magic_,
                                  long long chunk)
      : n(n_), magic(magic_), small(n_ <= chunk) {
    if (c0 < n_) {
      r0 = 0;
    } else if (((c0 | n_) >> 32) == 0) {
      r0 = static_cast<unsigned>(c0) / static_cast<unsigned>(n_);
    } else {
      r0 = c0 / n_;
    }
    rem0 = c0 - r0 * n_;
  }

  __device__ __forceinline__ long long operator()(unsigned l) const {
    if (small) {
      // x < 2 * chunk <= 2^13 and ceil(2^32 / n) * n - 2^32 < n <= 2^12, so
      // the multiply-high is exact: x * (that excess) < 2^32.
      const unsigned x = static_cast<unsigned>(rem0) + l;
      return r0 + (magic != 0u ? __umulhi(x, magic) : x);  // magic 0: n == 1
    }
    return r0 + (rem0 + l >= n ? 1 : 0);  // n > chunk: at most one boundary
  }
};

__device__ __forceinline__ float weight(const Table& t, long long row) {
  return t.w != nullptr ? __ldg(t.w + row) : t.w_scalar;
}

// Block b's part of one leaf: its chunk of the leaf's R * n elements.
template <typename T, bool kHasU, int kUnroll>
__device__ __forceinline__ void mix_chunk(const Table& t, const Leaf& leaf, long long b) {
  constexpr int kVec = vec_elems<T>();
  constexpr long long kChunk = chunk_elems<T, kUnroll>();
  const T* __restrict__ x = static_cast<const T*>(leaf.x);
  const T* __restrict__ u = static_cast<const T*>(leaf.u);
  const T* __restrict__ p = static_cast<const T*>(leaf.p);
  T* __restrict__ out = static_cast<T*>(leaf.out);
  const long long size = leaf.size;
  const long long c0 = (b - leaf.first_block) * kChunk;
  const Rows rows(c0, leaf.n, leaf.magic, kChunk);

  if (leaf.vec != 0) {
    const long long nvec = size / kVec;  // whole vectors in the leaf
    const int4* xv = reinterpret_cast<const int4*>(x);
    const int4* uv = reinterpret_cast<const int4*>(u);
    const int4* pv = reinterpret_cast<const int4*>(p);
    int4* ov = reinterpret_cast<int4*>(out);
    const long long v0 = c0 / kVec + threadIdx.x;
    // Fewer than kVec trailing elements: the block whose chunk holds them
    // loads them with its vectors and finishes them element by element.
    const long long tail0 = nvec * kVec;
    const long long te = tail0 + threadIdx.x;
    const bool tail = te < size && tail0 >= c0 && tail0 < c0 + kChunk;
    T tx = T(), tu = T(), tp = T();
    if (tail) {
      tx = x[te];
      if constexpr (kHasU) tu = u[te];
      tp = p[te];
    }
    int4 a[kUnroll], c[kUnroll], d[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + static_cast<long long>(k) * kThreads;
      if (v < nvec) {
        a[k] = xv[v];
        if constexpr (kHasU) {
          c[k] = uv[v];
        } else {
          c[k] = make_int4(0, 0, 0, 0);  // not read by mix1
        }
        d[k] = pv[v];
      }
    }
    // A vector lies in one row when n is a multiple of the vector width.
    const bool one_row = rows.n % kVec == 0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + static_cast<long long>(k) * kThreads;
      if (v < nvec) {
        const unsigned l = static_cast<unsigned>((k * kThreads + threadIdx.x) * kVec);
        const T* ta = reinterpret_cast<const T*>(&a[k]);
        const T* tc = reinterpret_cast<const T*>(&c[k]);
        const T* td = reinterpret_cast<const T*>(&d[k]);
        int4 o;
        T* to = reinterpret_cast<T*>(&o);
        if (one_row) {
          const float w = weight(t, rows(l));
#pragma unroll
          for (int j = 0; j < kVec; ++j) to[j] = mix1<T, kHasU>(ta[j], tc[j], td[j], w);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            to[j] = mix1<T, kHasU>(ta[j], tc[j], td[j], weight(t, rows(l + j)));
          }
        }
        ov[v] = o;
      }
    }
    if (tail) {
      out[te] = mix1<T, kHasU>(tx, tu, tp, weight(t, rows(static_cast<unsigned>(te - c0))));
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kUnroll * kVec; ++k) {
      const unsigned l = static_cast<unsigned>(k * kThreads + threadIdx.x);
      const long long e = c0 + l;
      if (e < size) {
        out[e] = mix1<T, kHasU>(x[e], kHasU ? u[e] : T(), p[e], weight(t, rows(l)));
      }
    }
  }
}

template <typename T, bool kHasU, int kUnroll>
__global__ void __launch_bounds__(kThreads)
mix_tree_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  if (t.count == 1) {  // one leaf: its fields are constants, no search
    mix_chunk<T, kHasU, kUnroll>(t, t.leaf[0], b);
    return;
  }
  // This block's leaf: the last whose first block is <= b, counted with
  // independent loads rather than searched with dependent ones.
  int lo = 0;
  for (int i = 1; i < t.count; ++i) lo += t.leaf[i].first_block <= b ? 1 : 0;
  mix_chunk<T, kHasU, kUnroll>(t, t.leaf[lo], b);
}

// The table must be what the kernel assumes: leaves in prefix order with
// their blocks' count, each a whole number of rows, vector leaves aligned.
template <typename T, int kUnroll>
bool table_ok(const Table& t, bool has_u, long long blocks) {
  long long next = 0;
  for (int i = 0; i < t.count; ++i) {
    const Leaf& l = t.leaf[i];
    if (l.size <= 0 || l.n <= 0 || l.size % l.n != 0 || l.first_block != next) return false;
    const long long chunk = chunk_elems<T, kUnroll>();
    const unsigned magic =
        l.n >= 2 && l.n <= chunk ? 0xFFFFFFFFu / static_cast<unsigned>(l.n) + 1u : 0u;
    if (l.magic != magic || l.vec > 1) return false;
    if ((l.u != nullptr) != has_u) return false;
    if (l.vec != 0) {
      const uintptr_t any = reinterpret_cast<uintptr_t>(l.x) | reinterpret_cast<uintptr_t>(l.u) |
                            reinterpret_cast<uintptr_t>(l.p) | reinterpret_cast<uintptr_t>(l.out);
      if (any % 16 != 0) return false;
    }
    next += (l.size + chunk - 1) / chunk;
  }
  return next == blocks && blocks <= 0x7FFFFFFFLL;
}

template <typename T, bool kHasU, int kUnroll>
cudaError_t launch(const Table& t, long long blocks, cudaStream_t stream) {
  if (!table_ok<T, kUnroll>(t, kHasU, blocks)) return cudaErrorInvalidValue;
  mix_tree_kernel<T, kHasU, kUnroll>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

template <typename T, bool kHasU>
cudaError_t launch_unroll(const Table& t, int unroll, long long blocks, cudaStream_t s) {
  switch (unroll) {
    case 1:
      return launch<T, kHasU, 1>(t, blocks, s);
    case 2:
      return launch<T, kHasU, 2>(t, blocks, s);
    case 4:
      return launch<T, kHasU, 4>(t, blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dtype(const Table& t, bool has_u, int unroll, long long blocks,
                         cudaStream_t s) {
  return has_u ? launch_unroll<T, true>(t, unroll, blocks, s)
               : launch_unroll<T, false>(t, unroll, blocks, s);
}

}  // namespace

extern "C" {

// leaves: count * 8 64-bit words, one Leaf each (see struct Leaf).  w == NULL
// selects the scalar weight w_scalar for every row (the gossip_mix entry
// point).  dtype: 0 = float32, 1 = bfloat16, 2 = float16.  unroll: 1, 2 or 4
// vectors a thread; blocks: the grid, the sum of every leaf's blocks.
int gossip_mix_tree_launch(const long long* leaves, int count, const float* w,
                           float w_scalar, int dtype, int has_u, int unroll,
                           long long blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count <= 0 || count > kMaxLeaves || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  memset(&t, 0, sizeof(t));
  memcpy(t.leaf, leaves, sizeof(Leaf) * count);
  t.w = w;
  t.w_scalar = w_scalar;
  t.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_dtype<float>(t, has_u != 0, unroll, blocks, s);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(t, has_u != 0, unroll, blocks, s);
      break;
    case 2:
      err = launch_dtype<__half>(t, has_u != 0, unroll, blocks, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The table's limits, for the wrapper to check against its own constants.
void gossip_mix_tree_limits(int* max_leaves, int* threads, int* leaf_bytes) {
  *max_leaves = kMaxLeaves;
  *threads = kThreads;
  *leaf_bytes = static_cast<int>(sizeof(Leaf));
}

const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
