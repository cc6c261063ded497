// TF32 wgmma throughput on the card, by N (32, 64), by where A comes from
// (ss: shared memory; rs: registers) and by warpgroups a block (one, two),
// with the port's own MmaTf32 and descriptors (src/repro_torch/kernels/csrc/
// hopper_wgmma.cuh): 132 blocks, each warpgroup issuing k-steps of three
// m64nNk8 products into one accumulator, as the f32 flash-attention bodies
// do, then waiting on them.  Prints TFLOP/s against the card's 495 dense
// TF32 and the cycles a product takes a warpgroup.  Needs nvcc and one card;
// from the repo root:
//
//     nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//         -o build/tf32_wgmma_rate scripts/tf32_wgmma_rate.cu && build/tf32_wgmma_rate

#include <cstdio>

#include "../src/repro_torch/kernels/csrc/hopper_wgmma.cuh"

constexpr int kBlocks = 132;
constexpr int kSmem = 65536;  // A (64 rows x 8 k-steps) at 0, B at 32 KB

template <int N, bool kRs>
__global__ void __launch_bounds__(256, 1) rate(float* out, int iters, long long* cycles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::align1024(smem_raw);
  for (int i = threadIdx.x; i < kSmem / 4; i += blockDim.x) {
    reinterpret_cast<float*>(base)[i] = 1e-3f * (i % 7);
  }
  hopper::fence_async_smem();
  __syncthreads();
  const uint32_t a = hopper::smem_u32(base), b = a + kSmem / 2;
  float d[N / 2];
  hopper::zero(d);
  const uint32_t af[4] = {0x3a800000u, 0x3a800000u, 0x3a800000u, 0x3a800000u};  // 2^-10
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if constexpr (kRs) {
          hopper::MmaTf32<N>::rs(d, af, hopper::f32_desc<128>(b, N, kk), 1);
        } else {
          hopper::MmaTf32<N>::ss(d, hopper::f32_desc<128>(a, 64, kk),
                                 hopper::f32_desc<128>(b, N, kk), 1);
        }
      }
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(d);
  }
  const long long t1 = clock64();
  if (threadIdx.x % 128 == 0) cycles[blockIdx.x * 2 + threadIdx.x / 128] = t1 - t0;
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

template <int N, bool kRs>
void run(int warpgroups) {
  const int iters = 2000;
  float* out;
  long long* cycles;
  cudaMalloc(&out, kBlocks * 256 * sizeof(float));
  cudaMalloc(&cycles, kBlocks * 2 * sizeof(long long));
  auto kernel = rate<N, kRs>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem + 1024);
  kernel<<<kBlocks, 128 * warpgroups, kSmem + 1024>>>(out, 10, cycles);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<kBlocks, 128 * warpgroups, kSmem + 1024>>>(out, iters, cycles);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c0 = 0;
  cudaMemcpy(&c0, cycles, sizeof(long long), cudaMemcpyDeviceToHost);
  const double flop = 2.0 * 64 * N * 8 * 24 * iters * kBlocks * warpgroups;
  const double tflops = flop / ms / 1e9;
  printf("m64n%dk8 %s, %d warpgroup(s) a block: %.1f TFLOP/s (%.0f%% of 495), %.1f cycles a "
         "product a warpgroup (%s)\n",
         N, kRs ? "rs" : "ss", warpgroups, tflops, tflops / 495 * 100,
         static_cast<double>(c0) / (24.0 * iters), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  for (int warpgroups = 1; warpgroups <= 2; ++warpgroups) {
    run<32, false>(warpgroups);
    run<32, true>(warpgroups);
    run<64, false>(warpgroups);
    run<64, true>(warpgroups);
  }
  return 0;
}
