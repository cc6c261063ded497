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
// one f32 partial per (batch, head), summed over the batch by the caller in a
// fixed order (no float atomics: repeated runs are bit-equal), and the
// initial-state gradient, when asked for, in f32.
//
// dw needs S_{t-1} while G walks backward.  Recovering S_{t-1} from S_t by
// dividing by w_t is unstable, and so is the d(log w) form of the public
// RWKV-6 kernels (dw = d log w / w loses everything as w -> 0, and the
// forward is exact down to w = 1e-30).  So the kernel multiplies only by
// decays <= 1: a first pass walks the state forward from the initial state
// and stores it at the start of every sub-chunk of kC tokens (the
// checkpoints, (B*H, ceil(S / kC), N, N) f32 of scratch the caller gives: 64
// MB for 64 heads of N = 64 at S = 512); the backward then takes the
// sub-chunks last to first, recomputes each one's kC states from its
// checkpoint into shared memory, and walks its tokens back.  Any S works: the
// last sub-chunk may be short.
//
// What bounds it on the card.  By the work, operations: per token and head
// about 14 N^2 f32 flops (recomputing the state, the three reductions over
// the state, dw and the adjoint's update) against 22 bytes an element
// (bf16 r, k, v, dy, dr, dk, dv with f32 w and dw), above the H100's f32
// ops-per-byte balance on the FMA units.  In practice the token-serial walk
// bounds it: a block walks S tokens one after another.  What the design does:
//   * one block per (batch, head), 4N threads; thread (row n, lane q of the
//     row's four) owns N / 4 elements of row n of S and of G, in columns
//     16 j + 4 q + e (e < 4), so its reads of the token's dy and v are
//     float4s that the row's lanes take from one 64-byte span, and its
//     history is a float4 column of shared memory no other thread touches;
//   * G lives in registers for the whole call; S at a checkpoint is read back
//     by the thread that wrote it, so neither needs a barrier;
//   * the three row sums (dr, dk, dw) are in-thread sums of N / 4 terms and
//     two shuffles over the row's four lanes; the column sum (dv) runs over
//     the warp's eight rows as a reduce-scatter (each of three shuffle steps
//     sends half of what is left: 14 shuffles for N / 4 = 16 partials), and
//     over the warps in shared memory once a sub-chunk, in a fixed order;
//   * v . dy and r . (u k) are summed once a token by one warp, not by every
//     row; a sub-chunk's outputs are staged in shared memory and written out
//     coalesced, three barriers a sub-chunk;
//   * every operation is an f32 FMA-unit operation (no tensor cores): the
//     chunk form on the tensor cores, and a grid wider than B * H (64 blocks
//     for 132 SMs at B = 1), are left for a later design.
//
// Plain C interface: built with nvcc into a shared library and called through
// ctypes from repro_torch/kernels/rwkv_scan.py.  The launch enqueues on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 8;    // tokens a sub-chunk: the checkpoint interval
constexpr int kTPR = 4;  // threads a state row

template <int N>
struct Geo {
  static constexpr int kThreads = kTPR * N;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kE = N / kTPR;  // state elements a thread owns
  static constexpr int kE4 = kE / 4;   // as float4 groups
  // What the warp's column reduce-scatter leaves each lane.
  static constexpr int kLeft = kE >= 8 ? kE / 8 : 1;
  static_assert(N % 16 == 0 && kThreads % 32 == 0, "N is 16, 32 or 64");
};

// Shared memory, in floats: the sub-chunk's states [kC][kE4][kThreads]
// (float4), its r, k, v, w, dy tiles [kC][N], the staged dr, dk, dw [kC][N],
// the warps' dv partials [kC][kWarps][N], and v . dy, r . (u k) [kC] each.
template <int N>
struct Smem {
  static constexpr int kHist = 0;
  static constexpr int kTiles = kHist + kC * N * N;
  static constexpr int kOut = kTiles + 5 * kC * N;
  static constexpr int kDv = kOut + 3 * kC * N;
  static constexpr int kDots = kDv + kC * Geo<N>::kWarps * N;
  static constexpr size_t kBytes = static_cast<size_t>(kDots + 2 * kC) * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// One step of the reduce-scatter over the warp's rows (lane bit `Mask`): a
// lane keeps half of its Cnt partials and adds its partner's half, so each
// sum is formed once, by one lane.  With one partial left, the two lanes
// sum it and the one with the bit set stops owning it.
template <int Cnt, int Mask, int E>
__device__ __forceinline__ void rows_reduce_step(float (&p)[E], int lane, int& base,
                                                 bool& owner) {
  const bool hi = (lane & Mask) != 0;
  if constexpr (Cnt >= 2) {
    constexpr int kHalf = Cnt / 2;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float keep = hi ? p[j + kHalf] : p[j];
      const float send = hi ? p[j] : p[j + kHalf];
      p[j] = keep + __shfl_xor_sync(0xffffffffu, send, Mask);
    }
    if (hi) base += kHalf;
  } else {
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], Mask);
    if (hi) owner = false;
  }
}

// Tiles of tokens t0 .. t0 + c - 1 of one (batch, head), widened to f32.
template <typename T, int N, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t base, int64_t tok_stride, int t0, int c,
                                          int tid) {
  for (int i = tid; i < c * N; i += kThreads) {
    const int t = i / N;
    const int n = i % N;
    dst[i] = to_f32(src[base + (t0 + t) * tok_stride + n]);
  }
}

template <typename TR, typename TW, int N>
__global__ void __launch_bounds__(Geo<N>::kThreads)
rwkv_scan_bwd_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
                     const TR* __restrict__ v, const TW* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ state_in,
                     const TR* __restrict__ dy, const float* __restrict__ dstate,
                     TR* __restrict__ dr, TR* __restrict__ dk, TR* __restrict__ dv,
                     TW* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ dstate0, float4* __restrict__ ckpt, int S, int H) {
  using Gm = Geo<N>;
  using L = Smem<N>;
  constexpr int kThreads = Gm::kThreads;
  constexpr int kWarps = Gm::kWarps;
  constexpr int kE = Gm::kE;
  constexpr int kE4 = Gm::kE4;
  constexpr int kCk = N * N / 4;  // float4s of one checkpoint
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* hist = smem4 + L::kHist / 4;
  float* Rt = smem + L::kTiles;
  float* Kt = Rt + kC * N;
  float* Vt = Kt + kC * N;
  float* Wt = Vt + kC * N;
  float* DYt = Wt + kC * N;
  float* Odr = smem + L::kOut;
  float* Odk = Odr + kC * N;
  float* Odw = Odk + kC * N;
  float* Dv = smem + L::kDv;
  float* Dots = smem + L::kDots;  // v . dy, then r . (u k)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = tid / kTPR;
  const int q = tid % kTPR;
  const int64_t tok_stride = static_cast<int64_t>(H) * N;
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;  // (b, 0, h, 0)
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;
  const int n_sub = (S + kC - 1) / kC;
  float4* ck = ckpt + static_cast<int64_t>(bh) * n_sub * kCk;
  auto col = [&](int idx) { return 16 * (idx / 4) + 4 * q + idx % 4; };

  // Pass 1: the state forward from the initial one, stored at the start of
  // every sub-chunk (the last sub-chunk's tokens are not needed).
  float s[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    s[j] = state_in != nullptr ? state_in[sbase + row * N + col(j)] : 0.f;
  }
  for (int sc = 0; sc < n_sub; ++sc) {
    float4* cs = ck + static_cast<int64_t>(sc) * kCk;
#pragma unroll
    for (int jj = 0; jj < kE4; ++jj) {
      cs[jj * kThreads + tid] =
          make_float4(s[4 * jj], s[4 * jj + 1], s[4 * jj + 2], s[4 * jj + 3]);
    }
    if (sc == n_sub - 1) break;
    __syncthreads();  // the previous sub-chunk's tiles are read
    load_tile<TR, N, kThreads>(Kt, k, base, tok_stride, sc * kC, kC, tid);
    load_tile<TR, N, kThreads>(Vt, v, base, tok_stride, sc * kC, kC, tid);
    load_tile<TW, N, kThreads>(Wt, w, base, tok_stride, sc * kC, kC, tid);
    __syncthreads();
    for (int i = 0; i < kC; ++i) {
      const float kn = Kt[i * N + row];
      const float wn = Wt[i * N + row];
#pragma unroll
      for (int jj = 0; jj < kE4; ++jj) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vt + i * N + 16 * jj + 4 * q);
        s[4 * jj] = fmaf(wn, s[4 * jj], kn * v4.x);
        s[4 * jj + 1] = fmaf(wn, s[4 * jj + 1], kn * v4.y);
        s[4 * jj + 2] = fmaf(wn, s[4 * jj + 2], kn * v4.z);
        s[4 * jj + 3] = fmaf(wn, s[4 * jj + 3], kn * v4.w);
      }
    }
  }

  // Pass 2: the sub-chunks last to first.
  float g[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    g[j] = dstate != nullptr ? dstate[sbase + row * N + col(j)] : 0.f;
  }
  const float u_row = u[h * N + row];
  float du_acc = 0.f;
  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int t0 = sc * kC;
    const int c = S - t0 < kC ? S - t0 : kC;
    __syncthreads();  // the previous sub-chunk's tiles and outputs are consumed
    load_tile<TR, N, kThreads>(Rt, r, base, tok_stride, t0, c, tid);
    load_tile<TR, N, kThreads>(Kt, k, base, tok_stride, t0, c, tid);
    load_tile<TR, N, kThreads>(Vt, v, base, tok_stride, t0, c, tid);
    load_tile<TW, N, kThreads>(Wt, w, base, tok_stride, t0, c, tid);
    load_tile<TR, N, kThreads>(DYt, dy, base, tok_stride, t0, c, tid);
    const float4* cs = ck + static_cast<int64_t>(sc) * kCk;
#pragma unroll
    for (int jj = 0; jj < kE4; ++jj) {
      const float4 x = cs[jj * kThreads + tid];
      s[4 * jj] = x.x;
      s[4 * jj + 1] = x.y;
      s[4 * jj + 2] = x.z;
      s[4 * jj + 3] = x.w;
    }
    __syncthreads();
    // v . dy and r . (u k) of each token: one warp a token.
    for (int i = warp; i < c; i += kWarps) {
      float vd = 0.f, ruk = 0.f;
      for (int n = lane; n < N; n += 32) {
        vd = fmaf(Vt[i * N + n], DYt[i * N + n], vd);
        ruk = fmaf(Rt[i * N + n] * u[h * N + n], Kt[i * N + n], ruk);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, off);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      }
      if (lane == 0) {
        Dots[i] = vd;
        Dots[kC + i] = ruk;
      }
    }
    // The states before each token of the sub-chunk, from its checkpoint.
    for (int i = 0; i < c; ++i) {
#pragma unroll
      for (int jj = 0; jj < kE4; ++jj) {
        hist[(i * kE4 + jj) * kThreads + tid] =
            make_float4(s[4 * jj], s[4 * jj + 1], s[4 * jj + 2], s[4 * jj + 3]);
      }
      if (i + 1 == c) break;
      const float kn = Kt[i * N + row];
      const float wn = Wt[i * N + row];
#pragma unroll
      for (int jj = 0; jj < kE4; ++jj) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vt + i * N + 16 * jj + 4 * q);
        s[4 * jj] = fmaf(wn, s[4 * jj], kn * v4.x);
        s[4 * jj + 1] = fmaf(wn, s[4 * jj + 1], kn * v4.y);
        s[4 * jj + 2] = fmaf(wn, s[4 * jj + 2], kn * v4.z);
        s[4 * jj + 3] = fmaf(wn, s[4 * jj + 3], kn * v4.w);
      }
    }
    __syncthreads();  // Dots are complete
    for (int i = c - 1; i >= 0; --i) {
      const float rn = Rt[i * N + row];
      const float kn = Kt[i * N + row];
      const float wn = Wt[i * N + row];
      float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
      float p[kE];  // G_t k_t: this row's terms of dv's column sums
#pragma unroll
      for (int jj = 0; jj < kE4; ++jj) {
        const float4 dy4 = *reinterpret_cast<const float4*>(DYt + i * N + 16 * jj + 4 * q);
        const float4 v4 = *reinterpret_cast<const float4*>(Vt + i * N + 16 * jj + 4 * q);
        const float4 s4 = hist[(i * kE4 + jj) * kThreads + tid];
        const float dyv[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gm = g[4 * jj + e];
          a_dr = fmaf(sv[e], dyv[e], a_dr);
          a_dk = fmaf(gm, vv[e], a_dk);
          a_dw = fmaf(gm, sv[e], a_dw);
          p[4 * jj + e] = gm * kn;
          g[4 * jj + e] = fmaf(wn, gm, rn * dyv[e]);
        }
      }
#pragma unroll
      for (int off = 1; off < kTPR; off <<= 1) {
        a_dr += __shfl_xor_sync(0xffffffffu, a_dr, off);
        a_dk += __shfl_xor_sync(0xffffffffu, a_dk, off);
        a_dw += __shfl_xor_sync(0xffffffffu, a_dw, off);
      }
      if (q == 0) {
        const float vd = Dots[i];
        Odr[i * N + row] = fmaf(u_row * kn, vd, a_dr);
        Odk[i * N + row] = fmaf(u_row * rn, vd, a_dk);
        Odw[i * N + row] = a_dw;
        du_acc = fmaf(rn * kn, vd, du_acc);
      }
      // dv's column sums over the warp's eight rows (lane bits 2-4).
      int first = 0;
      bool owner = true;
      rows_reduce_step<kE, 16>(p, lane, first, owner);
      rows_reduce_step<(kE / 2 > 1 ? kE / 2 : 1), 8>(p, lane, first, owner);
      rows_reduce_step<(kE / 4 > 1 ? kE / 4 : 1), 4>(p, lane, first, owner);
      if (owner) {
#pragma unroll
        for (int j = 0; j < Gm::kLeft; ++j) {
          Dv[(i * kWarps + warp) * N + col(first + j)] = p[j];
        }
      }
    }
    __syncthreads();  // the sub-chunk's outputs are staged
    for (int idx = tid; idx < c * N; idx += kThreads) {
      const int i = idx / N;
      const int m = idx % N;
      const int64_t off = base + (t0 + i) * tok_stride + m;
      float dvs = Dots[kC + i] * DYt[idx];
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) dvs += Dv[(i * kWarps + wp) * N + m];
      dr[off] = from_f32<TR>(Odr[idx]);
      dk[off] = from_f32<TR>(Odk[idx]);
      dv[off] = from_f32<TR>(dvs);
      dw[off] = from_f32<TW>(Odw[idx]);
    }
  }

  if (dstate0 != nullptr) {
#pragma unroll
    for (int j = 0; j < kE; ++j) dstate0[sbase + row * N + col(j)] = g[j];
  }
  if (q == 0) du_part[static_cast<int64_t>(bh) * N + row] = du_acc;
}

template <typename TR, typename TW, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const void* w,
                     const float* u, const float* state_in, const void* dy,
                     const float* dstate, void* dr, void* dk, void* dv, void* dw,
                     float* du_part, float* dstate0, float4* ckpt, int B, int S, int H,
                     cudaStream_t stream) {
  auto kernel = rwkv_scan_bwd_kernel<TR, TW, N>;
  const size_t smem = Smem<N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(static_cast<int64_t>(B) * H), Geo<N>::kThreads, smem,
           stream>>>(static_cast<const TR*>(r), static_cast<const TR*>(k),
                     static_cast<const TR*>(v), static_cast<const TW*>(w), u, state_in,
                     static_cast<const TR*>(dy), dstate, static_cast<TR*>(dr),
                     static_cast<TR*>(dk), static_cast<TR*>(dv), static_cast<TW*>(dw),
                     du_part, dstate0, ckpt, S, H);
  return cudaGetLastError();
}

template <typename TR, typename TW>
cudaError_t launch_dtype(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* state_in, const void* dy,
                         const float* dstate, void* dr, void* dk, void* dv, void* dw,
                         float* du_part, float* dstate0, float4* ckpt, int B, int S, int H,
                         int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_n<TR, TW, 16>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, ckpt, B, S, H, stream);
    case 32:
      return launch_n<TR, TW, 32>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, ckpt, B, S, H, stream);
    case 64:
      return launch_n<TR, TW, 64>(r, k, v, w, u, state_in, dy, dstate, dr, dk, dv, dw,
                                  du_part, dstate0, ckpt, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (r, k, v, w, dy and the gradients), 1 = bfloat16, 2 = r,
// k, v, dy, dr, dk, dv bfloat16 with w and dw float32.  N: 16, 32 or 64.  u
// (H, N), state_in and dstate (B, H, N, N, or null), du_part (B, H, N),
// dstate0 (B, H, N, N, or null): float32.  ckpt: float32 scratch of
// B * H * ceil(S / sub) * N * N, 16-byte aligned; sub must be the kernel's
// checkpoint interval kC (any other is refused: the scratch would be sized
// wrong).  All contiguous; B * H < 2^31.  The wrapper checks the rest.
int rwkv_scan_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* state_in, const void* dy,
                         const void* dstate, void* dr, void* dk, void* dv, void* dw,
                         void* du_part, void* dstate0, void* ckpt, int B, int S, int H,
                         int N, int sub, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0 || sub != kC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s_in = static_cast<const float*>(state_in);
  const float* ds = static_cast<const float*>(dstate);
  float* dup = static_cast<float*>(du_part);
  float* ds0 = static_cast<float*>(dstate0);
  float4* ck = static_cast<float4*>(ckpt);
  switch (dtype) {
    case 0:
      err = launch_dtype<float, float>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup,
                                       ds0, ck, B, S, H, N, s);
      break;
    case 1:
      err = launch_dtype<bf16, bf16>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup,
                                     ds0, ck, B, S, H, N, s);
      break;
    case 2:
      err = launch_dtype<bf16, float>(r, k, v, w, uf, s_in, dy, ds, dr, dk, dv, dw, dup,
                                      ds0, ck, B, S, H, N, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* rwkv_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
