// Device helpers shared by the packed-matmul kernels K1 (quant_matmul.cu)
// and K2 (quant_matmul_plane.cu): the bf16 mma.sync tile,
// cp.async copies into shared memory and their group waits, and the
// split-order sum of a K split's partials.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// c += a · b on the tensor cores: m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;   // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 4 : 0;   // 0: fill with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` (clamped to 7) copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending < 7 ? pending : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// y[i] = sum over splits s = 0, 1, ... of ws[s][i], in split order
__global__ void split_sum(const float* __restrict__ ws, float* __restrict__ y, size_t n,
                          int ksplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float t = ws[i];
    for (int s = 1; s < ksplit; ++s) t += ws[(size_t)s * n + i];
    y[i] = t;
  }
}

// the launch of split_sum over n outputs of ksplit splits
inline cudaError_t launch_split_sum(const float* ws, float* y, size_t n, int ksplit,
                                    cudaStream_t s) {
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 1024 ? want : 1024);
  split_sum<<<blocks, threads, 0, s>>>(ws, y, n, ksplit);
  return cudaGetLastError();
}

}  // namespace
