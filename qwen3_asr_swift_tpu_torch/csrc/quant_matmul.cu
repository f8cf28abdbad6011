// K1: packed group-quantized matmul on the tensor cores, in the group
// decomposition
//   y[b,o] = sum_g s[o,g] * (sum_{i in g} code[o,i] * x[b,i])
//          + sum_g bias[o,g] * (sum_{i in g} x[b,i]),          all in fp32.
//
// Replaces the Pallas TPU kernel
//   qwen3_asr_swift_tpu/ops/quant.py::_quant_matmul_kernel_fused
//   (launched by _quant_matmul_pallas_2d / quant_matmul_pallas).
// It computes what the plain version
//   qwen3_asr_swift_tpu_torch/ops/quant.py::quant_matmul
// computes: the fp32 function of the reference's XLA group decomposition
// (quant_matmul_xla), not the fused Pallas body's bf16 roundings of x and
// of each scale*code. The reference takes quant_matmul_xla on the CPU, the
// port's tokens must equal the reference's there, and the port's CPU path
// is the plain version; so the scale multiplies fp32 sums here and is never
// rounded into a bf16 weight (that function is K2's).
//
// What bounds it on an H100. At decode (B <= 256 rows) the call must read
// every code, scale and bias once: one decode step at 32 rows (28 layers
// of qkv, o, gate_up and down plus the LM head, 4-bit group 64) moves about
// 450 MB, 0.134 ms at 3.35 TB/s, while its 38 GFLOP take 0.04 ms on the
// bf16 tensor cores. So it is bound by bytes: at the LM head by its 78 MB
// of codes and 19 MB of scales and biases, and at the small projections,
// whose bytes take about a microsecond, by the latency of one block's chain
// (copy in, products, cross-warp sum, store).
//
// Design:
// - Exact products on the tensor cores. A code (< 2^bits) is exact in
//   bf16, and so is bf16 x; fp32 x enters as three bf16 terms (hi, mid, lo,
//   each the top half of what the last left), which hold any normal fp32
//   value exactly. So each code*x product is exact, and
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) sums a group's
//   products in a fresh fragment; the group's fp32 scale then multiplies
//   that fragment into the row's fp32 sum, and the bias term adds bias
//   times the group's sum of x, which one more mma forms in fp32 from an
//   all-ones A fragment. Output rows lie on the mma M (16), activation rows
//   on its N (8).
// - Fragment mapping: one lane holds 8 consecutive inputs of an output row
//   across two mmas, and its B fragment is one 16-byte load of 8
//   consecutive bf16 activations (two float4 for fp32 x). Codes become bf16
//   pairs of inputs (j, j+4) by one mask-and-or into the bf16 bits of
//   128 + code and one exact bf16x2 subtraction of 128 (8-bit codes by way
//   of fp32); the activations pair the same way by byte permutes. A mma's
//   16 contraction slots span 32 consecutive inputs, so the group size is a
//   multiple of 32.
// - A block owns 16*MT output rows and every activation row of the call:
//   each code word, scale and bias is read from device memory once per
//   call. First it starts, with cp.async, every copy it needs into
//   shared memory - the codes, the scales and biases, and a tile of x in
//   its own dtype (bf16 x, the main path, needs no cast launch) - in stages
//   of 8 groups; the 8 warps take one group each per stage, so the tensor
//   cores work on stage j while stages j+1.. are in flight. Above 32 rows
//   the block loops over row-blocks of 32 over the codes it has staged,
//   copying only the x tile anew.
// - Every block re-reads the x tile from L2, so blocks take more output
//   rows where they are many: 32 from out 4225 (gate_up), 64 for the LM
//   head (32 for fp32 x). The warps' partials reuse the x tile's room, and
//   bf16 x tiles of at most 8 accumulator fragments keep to 128 registers a
//   thread, so two blocks share an SM and one's copies overlap the other's
//   products.
// - When out is small (out 1024) the groups are also split over ksplit
//   blocks, so the grid fills the 132 SMs; each split writes its partial to
//   a workspace and a second small kernel adds the splits in split order.
//   The split depends on the weight's shape and x's dtype alone.
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
constexpr int kOneWave = 16 * 2 * 132;   // out above this: 2 m-tiles per block
constexpr int kWideN = 8192;         // out >= this: 4 m-tiles per block
constexpr int kMinBlocks = 132;      // split K until the grid has this many blocks
constexpr int kMaxSplit = 4;
constexpr int kMinGroupsPerSplit = 8;
constexpr size_t kMaxSmem = 200 * 1024;   // bytes of shared memory a block may take
constexpr uint32_t kBias128 = 0x43004300u;  // the bf16 pair (128, 128)
constexpr uint32_t kBf16One = 0x3F803F80u;  // the bf16 pair (1, 1)

// an 8-byte copy: the 2-bit group of 32 inputs
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 8 : 0;   // 0: fill with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// a bf16 pair (128 + c0, 128 + c1) → (c0, c1), exact: t * 1 + (-128)
__device__ __forceinline__ uint32_t minus_128(uint32_t t) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(t), "r"(kBf16One), "r"(0xC300C300u));
  return d;
}

// The codes of this lane's inputs k..k+7 (k % 8 == 0, relative to the
// shared row) as bf16 pairs of inputs (0,4), (1,5), (2,6), (3,7). Codes
// below 128 take the bf16 bits of 128 + code by a mask-and-or; 8-bit codes
// take the fp32 2^23 + code, less 2^23, whose top half is the exact bf16.
template <int BITS>
__device__ __forceinline__ void code_pairs(const uint32_t* row, int k, uint32_t (&pr)[4]) {
  if constexpr (BITS == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + k / 4);   // inputs 0-3, 4-7
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = __uint_as_float(__byte_perm(w.x, 0x4B000000u, 0x7440 | j)) - 8388608.f;
      const float b = __uint_as_float(__byte_perm(w.y, 0x4B000000u, 0x7440 | j)) - 8388608.f;
      pr[j] = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
    }
  } else {
    uint32_t w;   // code j at bits BITS*j, code j+4 at bits 16 + BITS*j
    if constexpr (BITS == 4) {
      w = row[k / 8];
    } else {      // 2 bits: half a word, its codes 4-7 moved up to bit 16
      const uint32_t h = row[k / 16] >> (2 * (k % 16));
      w = (h & 0xffu) | ((h & 0xff00u) << 8);
    }
    constexpr uint32_t kMask = BITS == 4 ? 0x000f000fu : 0x00030003u;
#pragma unroll
    for (int j = 0; j < 4; ++j) pr[j] = minus_128(((w >> (BITS * j)) & kMask) | kBias128);
  }
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
// [xrows][split inputs + 64 bytes] in x's dtype, whose room the warps'
// partials [kWarps][xrows][16*MT + kPad] fp32 take at the end of a
// row-block.
// Two blocks an SM where registers allow (at most 128 a thread): bf16 x
// with at most 8 fragments of accumulators, whose shared memory fits twice.
template <int BITS, int MT, int NT, bool XBF16>
__global__ void __launch_bounds__(kWarps * 32, (XBF16 && MT * NT <= 8) ? 2 : 1)
quant_matmul_kernel(const void* __restrict__ x, const uint32_t* __restrict__ codes,
                    const float* __restrict__ scales, const float* __restrict__ biases,
                    float* __restrict__ out, Shape sh) {
  using XT = typename XType<XBF16>::T;
  constexpr int kTerms = XBF16 ? 1 : 3;           // bf16 terms of one activation
  constexpr int kRows = 16 * MT;
  constexpr int kRed = kRows + kPad;
  constexpr int kXPad = 64 / (int)sizeof(XT);     // elements of padding per x row
  constexpr int kXPiece = 16 / (int)sizeof(XT);   // elements per 16-byte copy
  constexpr int kThreads = kWarps * 32;
  constexpr int kRB = 8 * NT;                     // activation rows per row-block
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t ones[4] = {kBf16One, kBf16One, kBf16One, kBf16One};   // an all-ones A

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
  const int cw = gw % 4 ? 2 : 4;                  // words per copy (8 bytes: 2-bit group 32)
  const int row_words = sh.K * BITS / 32;
  const int sw = n_groups * gw + kPad;            // shared code row stride, words
  const int g4 = (n_groups + 3) & ~3;             // shared scale row stride
  const int xsw = n_groups * sh.gs + kXPad;       // shared x row stride, elements
  const int stages = (n_groups + kWarps - 1) / kWarps;
  uint32_t* s_codes = smem;
  float* s_scale = reinterpret_cast<float*>(s_codes + kRows * sw);
  float* s_bias = s_scale + kRows * g4;
  XT* s_x = reinterpret_cast<XT*>(s_bias + kRows * g4);
  float* red = reinterpret_cast<float*>(s_x);   // the warps' partials reuse the x tile
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

  // start every stage's copies now: stage j holds groups 8j .. 8j+7 of the
  // codes, the scales and biases, and the first row-block's x
  for (int j = 0; j < stages; ++j) {
    const int gl0 = j * kWarps;
    const int gl1 = min(gl0 + kWarps, n_groups);
    const int ng = gl1 - gl0;
    const int per_row = ng * gw / cw;             // copies per row
    for (int i = tid; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      const int o = o0 + r;
      const bool ok = o < sh.N;
      const uint32_t* src = codes + (size_t)(ok ? o : 0) * row_words +
                            (size_t)(g_begin + gl0) * gw + cw * q;
      uint32_t* dst = s_codes + r * sw + gl0 * gw + cw * q;
      if (cw == 4) cp_async16(dst, src, ok);
      else cp_async8(dst, src, ok);
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
      float sc[MT][2], be[MT][2];   // the group's fp32 scale and bias per row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + gid + 8 * h;
          sc[mt][h] = s_scale[r * g4 + gl];
          be[mt][h] = s_bias[r * g4 + gl];
        }
      // the group's sums of code * x, and of x (an all-ones A fragment: each
      // row of the result holds every activation row's sum)
      float grp[MT][NT][4], xsum[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          xsum[nt][r] = 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) grp[mt][nt][r] = 0.f;
        }

      for (int c = 0; c < chunks; ++c) {
        const int kl = gl * sh.gs + c * 32 + 8 * tig;   // input within the split
        // 8 consecutive activations of row nt*8 + gid as bf16 pairs of
        // inputs (0,4), (1,5), (2,6), (3,7), one set per term
        uint32_t xb[NT][kTerms][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < n_tiles) {
            const XT* xp = s_x + (nt * 8 + gid) * xsw + kl;
            if constexpr (XBF16) {
              const uint4 v = *reinterpret_cast<const uint4*>(xp);
              xb[nt][0][0] = __byte_perm(v.x, v.z, 0x5410);
              xb[nt][0][1] = __byte_perm(v.x, v.z, 0x7632);
              xb[nt][0][2] = __byte_perm(v.y, v.w, 0x5410);
              xb[nt][0][3] = __byte_perm(v.y, v.w, 0x7632);
            } else {
              const float4 u = reinterpret_cast<const float4*>(xp)[0];
              const float4 v = reinterpret_cast<const float4*>(xp)[1];
              float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
              // term by term: the top half of what is left; the third
              // holds the last 8 significant bits, so the terms sum to x
#pragma unroll
              for (int tm = 0; tm < kTerms; ++tm) {
                uint32_t h[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                  h[q] = __float_as_uint(f[q]) & 0xffff0000u;
                  f[q] -= __uint_as_float(h[q]);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) xb[nt][tm][q] = __byte_perm(h[q], h[q + 4], 0x7632);
              }
            }
#pragma unroll
            for (int tm = 0; tm < kTerms; ++tm) {
              mma_bf16(xsum[nt], ones, xb[nt][tm][0], xb[nt][tm][1]);
              mma_bf16(xsum[nt], ones, xb[nt][tm][2], xb[nt][tm][3]);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t p0[4], p1[4];   // rows gid and gid + 8
          code_pairs<BITS>(s_codes + (mt * 16 + gid) * sw, kl, p0);
          code_pairs<BITS>(s_codes + (mt * 16 + gid + 8) * sw, kl, p1);
          // mma 0 takes pairs 0 and 1 of each row, mma 1 pairs 2 and 3:
          // {row gid: slots 2t,2t+1}, {row gid+8: 2t,2t+1},
          // {row gid: 2t+8,2t+9}, {row gid+8: 2t+8,2t+9}
          const uint32_t a0[4] = {p0[0], p1[0], p0[1], p1[1]};
          const uint32_t a1[4] = {p0[2], p1[2], p0[3], p1[3]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt < n_tiles) {
#pragma unroll
              for (int tm = 0; tm < kTerms; ++tm) {
                mma_bf16(grp[mt][nt], a0, xb[nt][tm][0], xb[nt][tm][1]);
                mma_bf16(grp[mt][nt], a1, xb[nt][tm][2], xb[nt][tm][3]);
              }
            }
          }
        }
      }
      // scale the group's sums into the rows' fp32 sums, then add the bias
      // term: this lane's output rows are gid and gid + 8; its accumulator
      // columns are activation rows 2*tig and 2*tig + 1, whose x sums are
      // xsum[nt][0] and xsum[nt][1]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float* ac = acc[mt][nt];
            const float* g = grp[mt][nt];
            ac[0] = fmaf(sc[mt][0], g[0], ac[0]);
            ac[1] = fmaf(sc[mt][0], g[1], ac[1]);
            ac[2] = fmaf(sc[mt][1], g[2], ac[2]);
            ac[3] = fmaf(sc[mt][1], g[3], ac[3]);
            ac[0] = fmaf(be[mt][0], xsum[nt][0], ac[0]);
            ac[1] = fmaf(be[mt][0], xsum[nt][1], ac[1]);
            ac[2] = fmaf(be[mt][1], xsum[nt][0], ac[2]);
            ac[3] = fmaf(be[mt][1], xsum[nt][1], ac[3]);
          }
        }
      }
    }

    // the warps' partials, output row fastest: red[warp][b][o], written
    // over the x tile once every warp is done with it
    __syncthreads();
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
    __syncthreads();   // the next row-block copies its x tile over red
  }
}

// Output rows (16 * mt) and activation rows (8 * nt) of a block's tile.
// Every block re-reads the x tile from L2, so a block takes more output
// rows where there are blocks enough: 1 m-tile where one-m-tile blocks fit
// the card in one wave at two blocks an SM (out <= kOneWave), 2 up to
// kWideN, 4 above it (the LM head) for bf16 x, whose fragments take a
// third of fp32 x's registers. At most 16 rows need 2 n-tiles.
struct Tiling {
  int mt, nt;
};

Tiling tiling(int B, int N, bool xbf16) {
  return {N >= kWideN ? (xbf16 ? 4 : 2) : N > kOneWave ? 2 : 1, B <= 16 ? 2 : 4};
}

int x_rows(int B, const Tiling& t) { return B >= 8 * t.nt ? 8 * t.nt : (B + 7) / 8 * 8; }

size_t smem_bytes(int xrows, int rows, int K, int bits, int gs, bool xbf16, int ks) {
  const size_t groups = (K / gs + ks - 1) / ks;   // the largest split
  const size_t xsize = xbf16 ? 2 : 4;
  const size_t codes = (size_t)rows * (groups * gs * bits / 32 + kPad) * 4;
  const size_t scale_bias = 2 * (size_t)rows * ((groups + 3) / 4 * 4) * 4;
  const size_t xtile = (size_t)xrows * (groups * gs * xsize + 64);
  const size_t red = (size_t)kWarps * xrows * (rows + kPad) * 4;
  return codes + scale_bias + (xtile > red ? xtile : red);
}

// K split: enough blocks to fill the SMs where each split keeps at least
// kMinGroupsPerSplit groups, and enough splits to fit a tile of 32 rows in
// shared memory. It depends on the shapes of the weight and x's dtype
// alone, never on the number of activation rows, so a row's sum order does
// not either.
int k_splits(int N, int K, int bits, int gs, bool xbf16) {
  const Tiling t = tiling(kMaxRB, N, xbf16);
  const int blocks = (N + 16 * t.mt - 1) / (16 * t.mt);
  const int groups = K / gs;
  int ks = 1;
  while (ks < kMaxSplit && blocks * ks < kMinBlocks && groups / (2 * ks) >= kMinGroupsPerSplit)
    ks *= 2;
  while (smem_bytes(kMaxRB, 16 * t.mt, K, bits, gs, xbf16, ks) > kMaxSmem && ks < groups) ks *= 2;
  return ks < groups ? ks : groups;
}

template <int BITS, int MT, int NT, bool XBF16>
cudaError_t launch(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                   float* out, const Shape& sh, size_t smem, cudaStream_t s) {
  auto kern = quant_matmul_kernel<BITS, MT, NT, XBF16>;
  // once per kernel (thread-safe): every launch's shared memory is within it
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sh.N + 16 * MT - 1) / (16 * MT), sh.ksplit);
  kern<<<grid, kWarps * 32, smem, s>>>(x, cw, sc, bz, out, sh);
  return cudaGetLastError();
}

template <int BITS, bool XBF16>
cudaError_t launch_tiled(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                         float* out, const Shape& sh, const Tiling& t, size_t smem,
                         cudaStream_t s) {
  if constexpr (XBF16) {
    if (t.mt == 4) {
      return t.nt == 2 ? launch<BITS, 4, 2, XBF16>(x, cw, sc, bz, out, sh, smem, s)
                       : launch<BITS, 4, 4, XBF16>(x, cw, sc, bz, out, sh, smem, s);
    }
  }
  if (t.mt == 2) {
    return t.nt == 2 ? launch<BITS, 2, 2, XBF16>(x, cw, sc, bz, out, sh, smem, s)
                     : launch<BITS, 2, 4, XBF16>(x, cw, sc, bz, out, sh, smem, s);
  }
  return t.nt == 2 ? launch<BITS, 1, 2, XBF16>(x, cw, sc, bz, out, sh, smem, s)
                   : launch<BITS, 1, 4, XBF16>(x, cw, sc, bz, out, sh, smem, s);
}

template <int BITS>
cudaError_t launch_bits(const void* x, const uint32_t* cw, const float* sc, const float* bz,
                        float* out, const Shape& sh, const Tiling& t, bool xbf16, size_t smem,
                        cudaStream_t s) {
  return xbf16 ? launch_tiled<BITS, true>(x, cw, sc, bz, out, sh, t, smem, s)
               : launch_tiled<BITS, false>(x, cw, sc, bz, out, sh, t, smem, s);
}

bool bad_args(int B, int K, int N, int bits, int gs) {
  return (bits != 2 && bits != 4 && bits != 8) || (gs != 32 && gs != 64 && gs != 128) ||
         B <= 0 || K <= 0 || N <= 0 || K % gs;
}

}  // namespace

extern "C" {

// fp32 floats of workspace qs_quant_matmul needs for these shapes (0: none).
long long qs_quant_matmul_workspace(int B, int K, int N, int bits, int gs, int x_bf16) {
  if (bad_args(B, K, N, bits, gs)) return 0;
  const int ks = k_splits(N, K, bits, gs, x_bf16 != 0);
  return ks > 1 ? (long long)ks * B * N : 0;
}

// x [B, K] bf16 (x_bf16 != 0) or fp32, codes [N, K*bits/32] (uint32 words),
// scales/biases [N, K/gs] fp32 → y [B, N] fp32; ws: the workspace of
// qs_quant_matmul_workspace floats (may be null when that is 0). All
// row-major and contiguous; x and codes 16-byte aligned. bits 2, 4 or 8;
// group size 32, 64 or 128.
int qs_quant_matmul(const void* x, const void* codes, const void* scales, const void* biases,
                    void* y, void* ws, int B, int K, int N, int bits, int gs, int x_bf16,
                    void* stream) {
  if (bad_args(B, K, N, bits, gs)) return (int)cudaErrorInvalidValue;
  const bool xbf16 = x_bf16 != 0;
  const int ks = k_splits(N, K, bits, gs, xbf16);
  if (ks > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(B, N, xbf16);
  const Shape sh{B, K, N, gs, K / gs, ks, x_rows(B, t)};
  const size_t smem = smem_bytes(sh.xrows, 16 * t.mt, K, bits, gs, xbf16, ks);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cw = (const uint32_t*)codes;
  const float* sc = (const float*)scales;
  const float* bz = (const float*)biases;
  float* out = ks > 1 ? (float*)ws : (float*)y;
  cudaError_t err;
  switch (bits) {
    case 2: err = launch_bits<2>(x, cw, sc, bz, out, sh, t, xbf16, smem, s); break;
    case 4: err = launch_bits<4>(x, cw, sc, bz, out, sh, t, xbf16, smem, s); break;
    default: err = launch_bits<8>(x, cw, sc, bz, out, sh, t, xbf16, smem, s); break;
  }
  if (err != cudaSuccess || ks == 1) return (int)err;
  return (int)launch_split_sum((const float*)ws, (float*)y, (size_t)B * N, ks, s);
}

const char* qs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
