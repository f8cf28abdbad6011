// K2: packed group-quantized matmul with bf16 planes on the tensor cores,
//   y[b,o] = sum_i bf16(x[b,i]) * bf16(bf16(code[o,i]) * bf16(scale[o,g(i)]))
//          + sum_g bias[o,g] * (sum_{i in g} x[b,i])
// with the products accumulated in fp32 and the bias term in fp32 from the
// unrounded x.
//
// Replaces the Pallas TPU kernel
//   qwen3_asr_swift_tpu/ops/quant.py::_quant_matmul_kernel
//   (the per-bit-plane body of _quant_matmul_pallas_2d, QUANT_KERNEL=plane).
// It computes what the plain version
//   qwen3_asr_swift_tpu_torch/ops/quant.py::quant_matmul_plane
// computes, with the TPU kernel's roundings: x and the expanded scale are
// rounded to bf16, each code*scale product is rounded to bf16 again, and
// bf16 x bf16 products (exact in fp32) accumulate in fp32.
//
// What bounds it on an H100. At decode (B <= 256 rows) the call reads the
// packed codes once (the LM head at 4 bits: 78 MB, ~23 us at 3.35 TB/s)
// and, at B = 16..32, does 2*B*N*K bf16 FLOPs that the tensor cores take
// in a few microseconds. What this simple version spends beyond that is
// the dequantization on the CUDA cores (shift, mask, two roundings per
// weight, once per 32-row batch tile) and the re-reading of the bf16
// activations from L2 by every block (B*K*2 bytes per 16 or 32 output
// rows); TMA for the code stream, a shared x tile and wgmma are the later
// steps.
//
// Design:
// - A first, small kernel rounds x to bf16 and sums each group of the
//   unrounded x in fp32, in input order (workspaces the wrapper allocates).
//   The TPU kernel re-strided x into bit planes on the host so each plane's
//   dot was a contiguous MXU contraction; here the planes are formed in
//   registers instead. A sum over k may be taken in any fixed order, so one
//   mma.sync.m16n8k16 bf16 tile maps its 16 contraction slots onto inputs
//   so that each lane holds 8 consecutive inputs of an output row (one
//   32-bit word of 4-bit codes) across two mmas, and its B fragment is one
//   16-byte load of 8 consecutive bf16 activations.
// - A block computes 16*MT output rows x 32 activation rows with 8 warps
//   that split K (warp w takes 32-input chunks w, w+8, ...), each keeping
//   a 16x8 fp32 accumulator per (m-tile, n-tile). MT = 2 for wide outputs
//   (the LM head: half the activation reads), 1 otherwise (more blocks for
//   out = 1024). The warps' partials and the bias term are added in shared
//   memory in a fixed order. Nothing in any output's sum order depends on
//   B, so a row does not change with the number of rows that share the call.
// - No barrier inside the K loop: warps run independently until the
//   epilogue. Rows past N and activation rows past B are masked.
// Codes arrive as an int32 view of the uint32 words and are read through
// a uint32 pointer, so shifts never sign-extend.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps per block, splitting K
constexpr int kNT = 4;               // 8-column n-tiles per block (activation rows)
constexpr int kBT = 8 * kNT;         // 32 activation rows per block
constexpr int kWideN = 8192;         // out >= this: 2 m-tiles per block
constexpr int kPrepThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16(bf16(code) * bf16 scale): the code (< 2^bits) is exact in bf16 and the
// product of two bf16 values is exact in fp32, so one rounding remains.
__device__ __forceinline__ float dq(uint32_t code, float s_bf) {
  return __bfloat162float(__float2bfloat16_rn((float)code * s_bf));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 codes of inputs k..k+7 (k % 8 == 0) of one output row.
template <int BITS>
__device__ __forceinline__ void load_codes(const uint32_t* __restrict__ row, int k,
                                           uint32_t (&c)[8]) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  if constexpr (BITS == 4) {
    const uint32_t w = row[k / 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = (w >> (4 * j)) & MASK;
  } else if constexpr (BITS == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + k / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (w.x >> (8 * j)) & MASK;
      c[4 + j] = (w.y >> (8 * j)) & MASK;
    }
  } else {  // 2 bits: half a word
    const uint32_t w = row[k / 16] >> (2 * (k % 16));
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = (w >> (2 * j)) & MASK;
  }
}

// x [B, K] fp32 → xb [B, K] bf16 and xsum [B, K/gs] fp32 (each group summed
// in input order).
__global__ void __launch_bounds__(kPrepThreads)
quant_plane_prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                        float* __restrict__ xsum, int K, int gs) {
  const int groups = K / gs;
  const int g = blockIdx.x * kPrepThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (g >= groups) return;
  const float* src = x + (size_t)b * K + (size_t)g * gs;
  __nv_bfloat16* dst = xb + (size_t)b * K + (size_t)g * gs;
  float s = 0.f;
  for (int j = 0; j < gs; ++j) {
    const float v = src[j];
    s += v;
    dst[j] = __float2bfloat16_rn(v);
  }
  xsum[(size_t)b * groups + g] = s;
}

template <int BITS, int MT>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_plane_kernel(const __nv_bfloat16* __restrict__ xb, const float* __restrict__ xsum,
                          const uint32_t* __restrict__ codes, const float* __restrict__ scales,
                          const float* __restrict__ biases, float* __restrict__ y, int B, int K,
                          int N, int gs) {
  constexpr int kRows = 16 * MT;           // output rows per block
  constexpr int kRed = kRows + 4;          // padded row of the partials (no bank conflicts)
  __shared__ float red[kWarps * kBT * kRed];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;   // mma groupID
  const int tig = lane & 3;    // mma thread-in-group
  const int b0 = blockIdx.x * kBT;
  const int o0 = blockIdx.y * kRows;
  const int words = K * BITS / 32;
  const int groups = K / gs;
  const int n_rows = min(kBT, B - b0);
  const int n_tiles = (n_rows + 7) / 8;   // warp-uniform

  // the rows this lane feeds into the A fragments: gid and gid + 8 of each m-tile
  const uint32_t* crow[MT][2];
  const float* srow[MT][2];
  bool rok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + mt * 16 + gid + 8 * h;
      rok[mt][h] = o < N;
      const int oc = rok[mt][h] ? o : 0;
      crow[mt][h] = codes + (size_t)oc * words;
      srow[mt][h] = scales + (size_t)oc * groups;
    }
  // this lane's activation row in each n-tile (B fragment column gid)
  const __nv_bfloat16* xrow[kNT];
  bool xok[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int b = b0 + nt * 8 + gid;
    xok[nt] = b < B;
    xrow[nt] = xb + (size_t)(xok[nt] ? b : 0) * K;
  }

  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int ch = warp; ch < K / 32; ch += kWarps) {
    const int k = ch * 32 + 8 * tig;    // this lane's 8 inputs
    const int g = k / gs;
    uint32_t a[MT][2][4];               // [m-tile][mma 0/1][regs]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float w[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t c[8];
        float s_bf = 0.f;
        if (rok[mt][h]) {
          load_codes<BITS>(crow[mt][h], k, c);
          s_bf = __bfloat162float(__float2bfloat16_rn(srow[mt][h][g]));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) c[j] = 0u;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) w[h][j] = dq(c[j], s_bf);
      }
      // mma q covers inputs 4q..4q+3 of each lane's 8:
      // regs {row gid: slots 2t,2t+1}, {row gid+8: 2t,2t+1},
      //      {row gid: 2t+8,2t+9}, {row gid+8: 2t+8,2t+9}
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[mt][q][0] = pack_bf16(w[0][4 * q + 0], w[0][4 * q + 1]);
        a[mt][q][1] = pack_bf16(w[1][4 * q + 0], w[1][4 * q + 1]);
        a[mt][q][2] = pack_bf16(w[0][4 * q + 2], w[0][4 * q + 3]);
        a[mt][q][3] = pack_bf16(w[1][4 * q + 2], w[1][4 * q + 3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < n_tiles) {
        // 8 consecutive bf16 activations: slots {2t,2t+1} and {2t+8,2t+9}
        // of mma 0, then of mma 1
        uint4 xv = make_uint4(0u, 0u, 0u, 0u);
        if (xok[nt]) xv = *reinterpret_cast<const uint4*>(xrow[nt] + k);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt][0], xv.x, xv.y);
          mma_bf16(acc[mt][nt], a[mt][1], xv.z, xv.w);
        }
      }
    }
  }

  // the warps' partials, output row fastest: red[warp][b][o]
  float* part = red + warp * kBT * kRed;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int o = mt * 16 + gid, b = nt * 8 + 2 * tig;
      part[b * kRed + o] = acc[mt][nt][0];
      part[(b + 1) * kRed + o] = acc[mt][nt][1];
      part[b * kRed + o + 8] = acc[mt][nt][2];
      part[(b + 1) * kRed + o + 8] = acc[mt][nt][3];
    }
  __syncthreads();
  // epilogue: this thread owns output row o and activation rows bs,
  // bs + kStep, ...: the bias term (each beta read once), then the
  // partials in warp order
  constexpr int kStep = kWarps * 32 / kRows;
  constexpr int kPer = kBT / kStep;
  const int o = tid % kRows, bs = tid / kRows;
  if (o0 + o >= N) return;
  const float* beta = biases + (size_t)(o0 + o) * groups;
  const float* xs[kPer];
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = bs + j * kStep;
    xs[j] = xsum + (size_t)(b0 + (b < n_rows ? b : 0)) * groups;
    v[j] = 0.f;
  }
  for (int g = 0; g < groups; ++g) {
    const float bg = beta[g];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = fmaf(bg, xs[j][g], v[j]);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = bs + j * kStep;
    if (b >= n_rows) continue;
    float t = v[j];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[(w * kBT + b) * kRed + o];
    y[(size_t)(b0 + b) * N + o0 + o] = t;
  }
}

template <int BITS>
void launch(const __nv_bfloat16* xb, const float* xs, const uint32_t* cw, const float* sc,
            const float* bz, float* yf, int B, int K, int N, int gs, cudaStream_t s) {
  const dim3 block(kWarps * 32);
  if (N >= kWideN) {
    const dim3 grid((B + kBT - 1) / kBT, (N + 31) / 32);
    quant_matmul_plane_kernel<BITS, 2><<<grid, block, 0, s>>>(xb, xs, cw, sc, bz, yf, B, K, N, gs);
  } else {
    const dim3 grid((B + kBT - 1) / kBT, (N + 15) / 16);
    quant_matmul_plane_kernel<BITS, 1><<<grid, block, 0, s>>>(xb, xs, cw, sc, bz, yf, B, K, N, gs);
  }
}

}  // namespace

extern "C" {

// x [B, K] fp32, codes [N, K*bits/32] (uint32 words), scales/biases
// [N, K/gs] fp32 → y [B, N] fp32; xb [B, K] bf16 and xsum [B, K/gs] fp32 are
// scratch. All row-major and contiguous; codes 8-byte aligned.
int qs_quant_matmul_plane(const void* x, const void* codes, const void* scales,
                          const void* biases, void* y, void* xb, void* xsum, int B, int K,
                          int N, int bits, int gs, void* stream) {
  if ((bits != 2 && bits != 4 && bits != 8) || K <= 0 || K % 32 || gs <= 0 || gs % 8 ||
      K % gs || B <= 0 || B > 65535 || N <= 0 || (N + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* xbf = (__nv_bfloat16*)xb;
  float* xs = (float*)xsum;
  const int groups = K / gs;
  const dim3 pgrid((groups + kPrepThreads - 1) / kPrepThreads, B);
  quant_plane_prep_kernel<<<pgrid, kPrepThreads, 0, s>>>((const float*)x, xbf, xs, K, gs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint32_t* cw = (const uint32_t*)codes;
  const float* sc = (const float*)scales;
  const float* bz = (const float*)biases;
  float* yf = (float*)y;
  switch (bits) {
    case 2: launch<2>(xbf, xs, cw, sc, bz, yf, B, K, N, gs, s); break;
    case 4: launch<4>(xbf, xs, cw, sc, bz, yf, B, K, N, gs, s); break;
    default: launch<8>(xbf, xs, cw, sc, bz, yf, B, K, N, gs, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
