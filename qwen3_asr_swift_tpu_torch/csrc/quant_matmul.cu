// K1: packed group-quantized matmul (GEMV-shaped), y = x @ (scale*code + bias)^T.
//
// Replaces the Pallas TPU kernel
//   qwen3_asr_swift_tpu/ops/quant.py::_quant_matmul_kernel_fused
//   (launched by _quant_matmul_pallas_2d / quant_matmul_pallas).
// It computes what the plain version
//   qwen3_asr_swift_tpu_torch/ops/quant.py::quant_matmul
// computes, reading the packed MLX codes (2/4/8 bits LSB-first in 32-bit
// words, groups of `gs` inputs sharing an fp32 scale and bias) and never
// writing a dense weight to global memory.
//
// What bounds it on an H100. At decode the call is GEMV-shaped (B <= 256
// activation rows). For one full-width LM-head call (out 151936, in 1024,
// 4 bits) the kernel must read 78 MB of codes plus 19 MB of fp32
// scales/biases (~29 us at 3.35 TB/s), and at B = 32 it does 10 GFLOP of
// fp32 FMAs (~150 us at the 67 TFLOP/s of the CUDA cores). So at the
// batch this slice serves, this simple CUDA-core version is bound by FMA
// issue and shared-memory loads, not by HBM; tensor cores (mma/wgmma on
// bf16 planes) are the later step.
//
// Design:
// - A block holds BT activation rows of x in shared memory, one K chunk
//   (KC inputs) at a time; the TPU kernel kept all of x[B, in] in 16 MB
//   of VMEM, which a Hopper block (227 KB) cannot.
// - Each warp owns R output rows; its lanes walk the packed words of
//   those rows in natural column order (consecutive lanes read
//   consecutive words: coalesced). No plane permutation: that layout
//   served the TPU matrix unit's contraction depth, not this card.
// - A lane dequantizes 4 codes of each of its R rows into registers
//   (w = scale*code + bias, fp32) and FMAs them against a float4 of x per
//   activation row, so each 16-byte shared load feeds 4*R FMAs.
// - The partial sums reduce across the warp with shuffles; lane 0 writes.
// - The ragged out dim and batch tail are masked in the kernel (the TPU
//   version padded the out dim on the host).
// - All arithmetic is fp32: the TPU kernel's bf16 planes are dropped, so
//   the kernel agrees with the fp32 plain version to summation order.
// Codes arrive as an int32 view of the uint32 words and are read through
// a uint32 pointer, so shifts never sign-extend.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // warps per block
constexpr int kR = 4;               // output rows per warp
constexpr int kBT = 8;              // activation rows per block
constexpr int kKC = 1024;           // K chunk staged in shared memory
constexpr int kRowsPerBlock = kWarps * kR;

template <int BITS>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_kernel(const float* __restrict__ x, const uint32_t* __restrict__ codes,
                    const float* __restrict__ scales, const float* __restrict__ biases,
                    float* __restrict__ y, int B, int K, int N, int gs) {
  constexpr int PW = 32 / BITS;             // codes per word
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ __align__(16) float xs[kBT * kKC];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kBT;
  const int o0 = blockIdx.y * kRowsPerBlock + warp * kR;
  const int words = K / PW;
  const int groups = K / gs;

  float acc[kR][kBT];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[r][b] = 0.f;

  for (int kc = 0; kc < K; kc += kKC) {
    const int klen = min(kKC, K - kc);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kBT * kKC; i += blockDim.x) {
      const int bb = i / kKC, kk = i - bb * kKC;
      xs[i] = (b0 + bb < B && kk < klen) ? x[(size_t)(b0 + bb) * K + kc + kk] : 0.f;
    }
    __syncthreads();

    const int w0 = kc / PW;
    const int nw = klen / PW;
    for (int wi = lane; wi < nw; wi += 32) {
      const int w = w0 + wi;
      const int g = (w * PW) / gs;
      uint32_t c[kR];
      float s[kR], z[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int o = o0 + r;
        if (o < N) {
          c[r] = codes[(size_t)o * words + w];
          s[r] = scales[(size_t)o * groups + g];
          z[r] = biases[(size_t)o * groups + g];
        } else {
          c[r] = 0u; s[r] = 0.f; z[r] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < PW / 4; ++q) {
        float wv[kR][4];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            wv[r][t] = fmaf(s[r], (float)((c[r] >> (BITS * (4 * q + t))) & MASK), z[r]);
        const float* xrow = xs + wi * PW + 4 * q;
#pragma unroll
        for (int b = 0; b < kBT; ++b) {
          const float4 xv = *reinterpret_cast<const float4*>(xrow + b * kKC);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            float a = acc[r][b];
            a = fmaf(wv[r][0], xv.x, a);
            a = fmaf(wv[r][1], xv.y, a);
            a = fmaf(wv[r][2], xv.z, a);
            a = fmaf(wv[r][3], xv.w, a);
            acc[r][b] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int b = 0; b < kBT; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int o = o0 + r;
      if (lane == 0 && o < N && b0 + b < B) y[(size_t)(b0 + b) * N + o] = v;
    }
  }
}

}  // namespace

extern "C" {

// x [B, K] fp32, codes [N, K*bits/32] (uint32 words), scales/biases
// [N, K/gs] fp32 → y [B, N] fp32. All row-major and contiguous.
int qs_quant_matmul(const void* x, const void* codes, const void* scales,
                    const void* biases, void* y, int B, int K, int N, int bits,
                    int gs, void* stream) {
  const int pw = 32 / bits;
  if ((bits != 2 && bits != 4 && bits != 8) || K % pw || K % 4 || gs % pw ||
      K % gs || B <= 0 || N <= 0 || (N + kRowsPerBlock - 1) / kRowsPerBlock > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((B + kBT - 1) / kBT, (N + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint32_t* cw = (const uint32_t*)codes;
  const float* sc = (const float*)scales;
  const float* bz = (const float*)biases;
  float* yf = (float*)y;
  switch (bits) {
    case 2: quant_matmul_kernel<2><<<grid, block, 0, s>>>(xf, cw, sc, bz, yf, B, K, N, gs); break;
    case 4: quant_matmul_kernel<4><<<grid, block, 0, s>>>(xf, cw, sc, bz, yf, B, K, N, gs); break;
    default: quant_matmul_kernel<8><<<grid, block, 0, s>>>(xf, cw, sc, bz, yf, B, K, N, gs); break;
  }
  return (int)cudaGetLastError();
}

const char* qs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
