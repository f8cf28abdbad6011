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
// What bounds it on an H100. At decode (B <= 256 rows) the call must read
// every code, scale and bias once: for the LM head at 4 bits (out 151936,
// in 1024) 78 MB of codes and 19 MB of scales and biases, ~32 us at
// 3.35 TB/s; its 2*B*N*K bf16 FLOPs take a few microseconds on the tensor
// cores. So it is bound by bytes at the LM head, and by the latency of one
// block's chain (copy in, products, cross-warp sum, store) at the small
// projections, whose bytes take < 1 us.
//
// Design:
// - The weight operand is formed in registers from the packed codes: a
//   code (< 2^bits) is exact in bf16, times the bf16 scale of its group
//   (read once per output row and group), rounded to bf16 once. Output rows
//   lie on the mma.sync.m16n8k16 M (16), activation rows on its N (8).
// - Fragment mapping: one lane holds 8 consecutive inputs of an output row
//   (one 32-bit word of 4-bit codes) across two mmas, and its B fragment is
//   one 16-byte load of 8 consecutive bf16 activations (two float4 for fp32
//   x, rounded to bf16 in registers). A mma's 16 contraction slots span 32
//   consecutive inputs, so the group size must be a multiple of 32.
// - A block owns 16*MT output rows and every activation row of the call:
//   each code word, scale and bias is read from device memory once per
//   call. At the start it issues, with cp.async, every copy it needs into
//   shared memory — the codes, the scales and biases, and a tile of x in
//   its own dtype (bf16 x, the main path, needs no cast launch) — in stages
//   of 8 groups; the 8 warps take one group each per stage, so the tensor
//   cores work on stage j while stages j+1.. are in flight. The fp32 group
//   sums of the bias term are taken from the same shared x reads. Calls of
//   more than 32 rows take row-blocks of 32, each copying its x tile anew.
// - Wide outputs (the LM head) take 32 output rows a block, or 64 when the
//   call has at most 16 rows, so fewer blocks re-read the x tile from L2.
// - When out is small (out 1024: 64 m-tiles) the groups are also split over
//   ksplit blocks, so the grid fills the 132 SMs; each split writes its
//   partial to a workspace and a second small kernel adds the splits in
//   split order. The split depends on the weight's shape alone.
// - No sum order depends on the number of activation rows: a warp sums its
//   groups in order, the warps' partials add in warp order, the splits in
//   split order. A row is bit-identical however many rows share the call.
// Codes arrive as an int32 view of the uint32 words and are read through
// a uint32 pointer, so shifts never sign-extend.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_async.cuh"

namespace {

constexpr int kWarps = 8;            // warps per block; one group each per stage
constexpr int kMaxRB = 32;           // activation rows per row-block, at most
constexpr int kPad = 4;              // words of padding per shared code row
constexpr int kWideN = 8192;         // out >= this: 2 m-tiles per block (4 at <= 16 rows)
constexpr int kMinBlocks = 132;      // split K until the grid has this many blocks
constexpr int kMaxSplit = 4;
constexpr int kMinGroupsPerSplit = 8;
constexpr size_t kMaxSmem = 200 * 1024;   // bytes of shared memory a block may take

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The weights of this lane's inputs k..k+7 (k % 8 == 0, relative to the
// shared row), bf16(code * s_bf), as 4 bf16 pairs: (0,1), (2,3), (4,5),
// (6,7). The code is exact in fp32 and bf16 and the product of two bf16
// values is exact in fp32, so one rounding remains, as in the plain
// version.
template <int BITS>
__device__ __forceinline__ void weights_bf16(const uint32_t* row, int k, float s_bf,
                                             uint32_t (&pr)[4]) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  uint32_t c[8];
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
#pragma unroll
  for (int j = 0; j < 4; ++j)
    pr[j] = pack_bf16((float)c[2 * j] * s_bf, (float)c[2 * j + 1] * s_bf);
}

struct Shape {
  int B, K, N, gs, groups, ksplit;
  int xrows;   // activation rows the shared x tile holds: min(8*NT, B rounded up to 8)
};

template <bool XBF16>
struct XType { using T = float; };
template <>
struct XType<true> { using T = __nv_bfloat16; };

// grid: (ceil(N / (16*MT)), ksplit). Dynamic shared memory, per block:
// codes [16*MT][split words + kPad] uint32; scales and biases
// [16*MT][split groups rounded up to 4] fp32 each; the x tile
// [xrows][split inputs + 64 bytes] in x's dtype; the warps' partials
// [kWarps][xrows][16*MT + kPad] fp32.
template <int BITS, int MT, int NT, bool XBF16>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_plane_kernel(const void* __restrict__ x, const uint32_t* __restrict__ codes,
                          const float* __restrict__ scales, const float* __restrict__ biases,
                          float* __restrict__ out, Shape sh) {
  using XT = typename XType<XBF16>::T;
  constexpr int kRows = 16 * MT;
  constexpr int kRed = kRows + kPad;
  constexpr int kXPad = 64 / (int)sizeof(XT);     // elements of padding per x row
  constexpr int kXPiece = 16 / (int)sizeof(XT);   // elements per 16-byte copy
  constexpr int kThreads = kWarps * 32;
  constexpr int kRB = 8 * NT;                     // activation rows per row-block
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;   // mma groupID
  const int tig = lane & 3;    // mma thread-in-group
  const int o0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int g_begin = (int)((long long)split * sh.groups / sh.ksplit);
  const int g_end = (int)((long long)(split + 1) * sh.groups / sh.ksplit);
  const int n_groups = g_end - g_begin;
  const int gw = sh.gs * BITS / 32;               // code words per group per row
  const int row_words = sh.K * BITS / 32;
  const int sw = n_groups * gw + kPad;            // shared code row stride, words
  const int g4 = (n_groups + 3) & ~3;             // shared scale row stride
  const int xsw = n_groups * sh.gs + kXPad;       // shared x row stride, elements
  const int stages = (n_groups + kWarps - 1) / kWarps;
  uint32_t* s_codes = smem;
  float* s_scale = reinterpret_cast<float*>(s_codes + kRows * sw);
  float* s_bias = s_scale + kRows * g4;
  XT* s_x = reinterpret_cast<XT*>(s_bias + kRows * g4);
  float* red = reinterpret_cast<float*>(s_x + sh.xrows * xsw);
  const XT* xg = static_cast<const XT*>(x);

  // x rows [rb0, rb0 + xrows) at the split's local groups [gl0, gl1)
  auto copy_x = [&](int rb0, int gl0, int gl1) {
    const int per_row = (gl1 - gl0) * sh.gs / kXPiece;
    for (int i = tid; i < sh.xrows * per_row; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      const int b = rb0 + r;
      const bool ok = b < sh.B;
      const XT* src = xg + (size_t)(ok ? b : 0) * sh.K + (size_t)(g_begin + gl0) * sh.gs +
                      q * kXPiece;
      cp_async16(s_x + r * xsw + gl0 * sh.gs + q * kXPiece, src, ok);
    }
  };

  // issue every stage's copies now: stage j holds groups 8j .. 8j+7 of the
  // codes, the scales and biases, and the first row-block's x
  for (int j = 0; j < stages; ++j) {
    const int gl0 = j * kWarps;
    const int gl1 = min(gl0 + kWarps, n_groups);
    const int ng = gl1 - gl0;
    const int per_row = ng * gw / 4;              // 16-byte pieces per row
    for (int i = tid; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      const int o = o0 + r;
      const bool ok = o < sh.N;
      const uint32_t* src = codes + (size_t)(ok ? o : 0) * row_words +
                            (size_t)(g_begin + gl0) * gw + 4 * q;
      cp_async16(s_codes + r * sw + gl0 * gw + 4 * q, src, ok);
    }
    for (int i = tid; i < 2 * kRows * ng; i += kThreads) {
      const int which = i / (kRows * ng), rem = i - which * kRows * ng;
      const int r = rem / ng, q = rem - r * ng;
      const int o = o0 + r;
      const bool ok = o < sh.N;
      const float* src = (which ? biases : scales) + (size_t)(ok ? o : 0) * sh.groups +
                         g_begin + gl0 + q;
      cp_async4((which ? s_bias : s_scale) + r * g4 + gl0 + q, src, ok);
    }
    copy_x(0, gl0, gl1);
    cp_async_commit();
  }

  const int chunks = sh.gs / 32;
  for (int rb0 = 0; rb0 < sh.B; rb0 += kRB) {
    const int n_tiles = min(NT, (sh.B - rb0 + 7) / 8);   // block-uniform
    if (rb0 > 0) {   // a later row-block: its x tile replaces the last one
      copy_x(rb0, 0, n_groups);
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
    }

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

    for (int j = 0; j < stages; ++j) {
      if (rb0 == 0) {
        cp_async_wait(stages - 1 - j);
        __syncthreads();
      }
      const int gl = j * kWarps + warp;
      if (gl >= n_groups) continue;
      float s_bf[MT][2], be[MT][2];   // the group's bf16 scale and fp32 bias per row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + gid + 8 * h;
          s_bf[mt][h] = __bfloat162float(__float2bfloat16_rn(s_scale[r * g4 + gl]));
          be[mt][h] = s_bias[r * g4 + gl];
        }
      float xs[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) xs[nt] = 0.f;

      for (int c = 0; c < chunks; ++c) {
        const int kl = gl * sh.gs + c * 32 + 8 * tig;   // input within the split
        uint32_t a[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t w0[4], w1[4];
          weights_bf16<BITS>(s_codes + (mt * 16 + gid) * sw, kl, s_bf[mt][0], w0);
          weights_bf16<BITS>(s_codes + (mt * 16 + gid + 8) * sw, kl, s_bf[mt][1], w1);
          // mma q covers inputs 4q..4q+3 of each lane's 8:
          // regs {row gid: slots 2t,2t+1}, {row gid+8: 2t,2t+1},
          //      {row gid: 2t+8,2t+9}, {row gid+8: 2t+8,2t+9}
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            a[mt][q][0] = w0[2 * q];
            a[mt][q][1] = w1[2 * q];
            a[mt][q][2] = w0[2 * q + 1];
            a[mt][q][3] = w1[2 * q + 1];
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < n_tiles) {
            // 8 consecutive activations of row nt*8 + gid: slots {2t,2t+1}
            // and {2t+8,2t+9} of mma 0, then of mma 1
            const XT* xp = s_x + (nt * 8 + gid) * xsw + kl;
            uint32_t xb[4];
            float t = 0.f;
            if constexpr (XBF16) {
              const uint4 v = *reinterpret_cast<const uint4*>(xp);
              xb[0] = v.x; xb[1] = v.y; xb[2] = v.z; xb[3] = v.w;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                t += __uint_as_float(xb[q] << 16);           // the low bf16 of the pair
                t += __uint_as_float(xb[q] & 0xffff0000u);   // the high one
              }
            } else {
              const float4 u = reinterpret_cast<const float4*>(xp)[0];
              const float4 v = reinterpret_cast<const float4*>(xp)[1];
              const float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                xb[q] = pack_bf16(f[2 * q], f[2 * q + 1]);
                t += f[2 * q];
                t += f[2 * q + 1];
              }
            }
            xs[nt] += t;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][nt], a[mt][0], xb[0], xb[1]);
              mma_bf16(acc[mt][nt], a[mt][1], xb[2], xb[3]);
            }
          }
        }
      }
      // the bias term of the group from the group's sums of x: this lane's
      // row is gid; the accumulator columns it holds are rows 2*tig, 2*tig+1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
          float t = xs[nt];
          t += __shfl_xor_sync(0xffffffffu, t, 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          const float xa = __shfl_sync(0xffffffffu, t, (2 * tig) * 4);
          const float xb = __shfl_sync(0xffffffffu, t, (2 * tig + 1) * 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float* ac = acc[mt][nt];
            ac[0] = fmaf(be[mt][0], xa, ac[0]);
            ac[1] = fmaf(be[mt][0], xb, ac[1]);
            ac[2] = fmaf(be[mt][1], xa, ac[2]);
            ac[3] = fmaf(be[mt][1], xb, ac[3]);
          }
        }
      }
    }

    // the warps' partials, output row fastest: red[warp][b][o]
    float* part = red + warp * sh.xrows * kRed;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
          const int o = mt * 16 + gid, b = nt * 8 + 2 * tig;
          part[b * kRed + o] = acc[mt][nt][0];
          part[(b + 1) * kRed + o] = acc[mt][nt][1];
          part[b * kRed + o + 8] = acc[mt][nt][2];
          part[(b + 1) * kRed + o + 8] = acc[mt][nt][3];
        }
      }
    __syncthreads();
    const int n_rows = min(kRB, sh.B - rb0);
    for (int i = tid; i < n_rows * kRows; i += kThreads) {
      const int b = i / kRows, o = i - b * kRows;
      if (o0 + o >= sh.N) continue;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[(w * sh.xrows + b) * kRed + o];
      out[((size_t)split * sh.B + rb0 + b) * sh.N + o0 + o] = t;
    }
    __syncthreads();   // red and the x tile are rewritten by the next row-block
  }
}

// Output rows (16 * mt) and activation rows (8 * nt) of a block's tile:
// wide outputs (the LM head) take 2 m-tiles, or 4 when the call has at
// most 16 rows, so fewer blocks re-read x; at most 16 rows need 2 n-tiles.
struct Tiling {
  int mt, nt;
};

Tiling tiling(int B, int N) {
  const bool few = B <= 16;
  return {N >= kWideN ? (few ? 4 : 2) : 1, few ? 2 : 4};
}

size_t smem_bytes(int xrows, int rows, int K, int bits, int gs, bool xbf16, int ks) {
  const size_t groups = (K / gs + ks - 1) / ks;   // the largest split
  const size_t xsize = xbf16 ? 2 : 4;
  const size_t codes = (size_t)rows * (groups * gs * bits / 32 + kPad) * 4;
  const size_t scale_bias = 2 * (size_t)rows * ((groups + 3) / 4 * 4) * 4;
  const size_t xtile = (size_t)xrows * (groups * gs * xsize + 64);
  const size_t red = (size_t)kWarps * xrows * (rows + kPad) * 4;
  return codes + scale_bias + xtile + red;
}

int x_rows(int B, const Tiling& t) { return B >= 8 * t.nt ? 8 * t.nt : (B + 7) / 8 * 8; }

// K split: enough blocks to fill the SMs where each split keeps at least
// kMinGroupsPerSplit groups, and enough splits to fit the largest tile's
// shared memory. It depends on the shapes of the weight alone, never on
// the number of activation rows, so a row's sum order does not either.
int k_splits(int N, int K, int bits, int gs, bool xbf16) {
  const int wide = N >= kWideN;
  const int blocks = (N + (wide ? 31 : 15)) / (wide ? 32 : 16);
  const int groups = K / gs;
  int ks = 1;
  while (ks < kMaxSplit && blocks * ks < kMinBlocks && groups / (2 * ks) >= kMinGroupsPerSplit)
    ks *= 2;
  while (smem_bytes(kMaxRB, wide ? 64 : 16, K, bits, gs, xbf16, ks) > kMaxSmem && ks < groups)
    ks *= 2;
  return ks < groups ? ks : groups;
}

template <int BITS, int MT, int NT, bool XBF16>
cudaError_t launch(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                   float* out, const Shape& sh, size_t smem, cudaStream_t s) {
  auto kern = quant_matmul_plane_kernel<BITS, MT, NT, XBF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((sh.N + 16 * MT - 1) / (16 * MT), sh.ksplit);
  kern<<<grid, kWarps * 32, smem, s>>>(x, cw, sc, bz, out, sh);
  return cudaGetLastError();
}

template <int BITS, bool XBF16>
cudaError_t launch_tiled(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                         float* out, const Shape& sh, const Tiling& t, size_t smem,
                         cudaStream_t s) {
  if (t.mt == 4) return launch<BITS, 4, 2, XBF16>(x, cw, sc, bz, out, sh, smem, s);
  if (t.mt == 2) return launch<BITS, 2, 4, XBF16>(x, cw, sc, bz, out, sh, smem, s);
  if (t.nt == 2) return launch<BITS, 1, 2, XBF16>(x, cw, sc, bz, out, sh, smem, s);
  return launch<BITS, 1, 4, XBF16>(x, cw, sc, bz, out, sh, smem, s);
}

template <int BITS>
cudaError_t launch_bits(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                        float* out, const Shape& sh, const Tiling& t, bool xbf16, size_t smem,
                        cudaStream_t s) {
  return xbf16 ? launch_tiled<BITS, true>(x, cw, sc, bz, out, sh, t, smem, s)
               : launch_tiled<BITS, false>(x, cw, sc, bz, out, sh, t, smem, s);
}

bool bad_args(int B, int K, int N, int bits, int gs) {
  return (bits != 2 && bits != 4 && bits != 8) || B <= 0 || K <= 0 || N <= 0 || gs <= 0 ||
         gs % 32 || (gs * bits) % 128 || K % gs;
}

}  // namespace

extern "C" {

// fp32 floats of workspace qs_quant_matmul_plane needs for these shapes (0: none).
long long qs_quant_matmul_plane_workspace(int B, int K, int N, int bits, int gs, int x_bf16) {
  if (bad_args(B, K, N, bits, gs)) return 0;
  const int ks = k_splits(N, K, bits, gs, x_bf16 != 0);
  return ks > 1 ? (long long)ks * B * N : 0;
}

// x [B, K] bf16 (x_bf16 != 0) or fp32, codes [N, K*bits/32] (uint32 words),
// scales/biases [N, K/gs] fp32 → y [B, N] fp32; ws: the workspace of
// qs_quant_matmul_plane_workspace floats (may be null when that is 0). All
// row-major and contiguous; x and codes 16-byte aligned. The group size
// must be a multiple of 32 with gs*bits a multiple of 128.
int qs_quant_matmul_plane(const void* x, const void* codes, const void* scales,
                          const void* biases, void* y, void* ws, int B, int K, int N, int bits,
                          int gs, int x_bf16, void* stream) {
  if (bad_args(B, K, N, bits, gs)) return (int)cudaErrorInvalidValue;
  const int ks = k_splits(N, K, bits, gs, x_bf16 != 0);
  if (ks > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(B, N);
  const Shape sh{B, K, N, gs, K / gs, ks, x_rows(B, t)};
  const size_t smem = smem_bytes(sh.xrows, 16 * t.mt, K, bits, gs, x_bf16 != 0, ks);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cw = (const uint32_t*)codes;
  const float* sc = (const float*)scales;
  const float* bz = (const float*)biases;
  float* out = ks > 1 ? (float*)ws : (float*)y;
  cudaError_t err;
  switch (bits) {
    case 2: err = launch_bits<2>(x, cw, sc, bz, out, sh, t, x_bf16 != 0, smem, s); break;
    case 4: err = launch_bits<4>(x, cw, sc, bz, out, sh, t, x_bf16 != 0, smem, s); break;
    default: err = launch_bits<8>(x, cw, sc, bz, out, sh, t, x_bf16 != 0, smem, s); break;
  }
  if (err != cudaSuccess || ks == 1) return (int)err;
  return (int)launch_split_sum((const float*)ws, (float*)y, (size_t)B * N, ks, s);
}

}  // extern "C"
