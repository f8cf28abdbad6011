// K3: single-token GQA decode attention over an int8 KV cache.
//
// Replaces the Pallas TPU kernel
//   qwen3_asr_swift_tpu/ops/attention_pallas.py::_decode_attn_kernel
//   (launched by decode_attention_int8).
// For each batch row b and kv-head h, with the G query heads that share
// h (GQA), it computes
//   s_j  = (q . k_j) / sqrt(D) * ks_j       (masked rows: -1e30)
//   out  = sum_j p_j * vs_j * v_j / sum_j p_j,   p_j = exp(s_j - max s)
// in fp32: the per-slot scales fold into the scores and the probabilities
// and no dequantized [L, D] buffer is ever written. A fully masked row
// scores -1e30 everywhere and so gives the uniform average over all of L,
// as the TPU kernel does. The plain version is
//   qwen3_asr_swift_tpu_torch/ops/attention_int8.py::decode_attention_int8_ref.
//
// What bounds it on an H100: bytes. A call reads the int8 K and V of every
// (b, h) once (2*L*D bytes a head: 148 KB at L = 580, D = 128; 39 MB with
// the scales at B = 32, Hkv = 8, 11.7 us at 3.35 TB/s) and does about 4*G
// flops a byte (76 MFLOP there, under 2 us even on the fp32 pipe), so the
// tensor cores would not bind it. Reaching the bytes takes enough blocks
// to fill the 132 SMs and enough copies in flight on each. In practice the
// kernel is bound by the instructions it issues a key (int8 conversions,
// FMAs, shuffles, shared loads, barriers): with its K/V copies zero-filled
// it ran hardly faster, so the design below spends few of them.
//
// Design:
// - Split-L. A block owns one (b, h, split): `split` consecutive keys
//   (the last split ragged), chosen by the wrapper from L and D alone, so
//   a row's result never depends on B. At B 32, Hkv 8, L 580 that is
//   1,024 blocks of 145 keys where one block per (b, h) gave 256 (smaller
//   splits pay each block's fixed cost more often, larger ones fill the
//   card less; PERF.md holds the timings of the neighbours). Each split's exact softmax gives its partial (m, l,
//   acc[G][D]) in fp32; with more than one split they go to a workspace
//   and a second small kernel, launched from the same entry point, merges
//   a (b, h)'s splits in split order (acc_s * exp(m_s - M) over
//   l_s * exp(m_s - M)). No atomics: the result is bit-identical from
//   call to call. One split writes the output itself. (Merging in the
//   last block of a (b, h) to arrive, found by a counter, saves the launch
//   but was slower at B 32: the merges then queue at the end of the grid.)
// - Occupancy. A block is a short chain (copy in, score, softmax, p.V,
//   store), so latency hides only behind other blocks: 128 threads held
//   to 80 registers let 6 blocks share an SM.
// - Asynchronous copies through shared memory. In the [B, Hkv, L, D]
//   layout a tile of T = 4096/D keys is 4 KB of contiguous bytes; the
//   block streams its K tiles, then its V tiles, through a ring of
//   kStages tile slots with 16-byte cp.async (zero-filled past the split),
//   so the next tiles are in flight while one is scored. The split's
//   scales come in the first copy group with 4-byte copies (a row of L
//   scales is 16-byte aligned only when L is a multiple of 4); `valid`
//   takes plain loads into shared memory while the first tiles fly.
// - q.k_j: LPK = D/DPL lanes share a key, each holding DPL dims of q for
//   the G heads in registers (at most 32 floats), and reduce with
//   log2(LPK) shuffles; the lanes of a warp read consecutive bytes of the
//   tile, so the reads are free of bank conflicts. Scores land in shared
//   memory.
// - After the last K tile the block takes the split's exact softmax (one
//   warp a head), and keeps p_j * vs_j in place of the scores.
// - p.V: each thread owns DPV dims of the G heads (G * DPV >= 16 where D
//   allows, so a loaded word of codes serves many sums) and every KG-th key
//   of a tile, with zero weights past the split; the KG partial sums add
//   through shared memory in a fixed order.
// - int8 codes become floats by a byte permute into the float 2^23 +
//   (code + 128) and one exact subtraction, not by a quarter-rate I2F.
// - q arrives bf16 (widened exactly) or fp32; the output leaves fp32, or
//   bf16 rounded once from the fp32 result (what `.to(torch.bfloat16)`
//   does), so the caller needs no cast kernels.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_async.cuh"

namespace {

constexpr int kThreads = 128;       // threads of a split block
constexpr int kMinBlocks = 6;       // resident blocks an SM (at most 80 registers)
constexpr int kTileBytes = 4096;    // bytes of one K or V tile: kTileBytes / D keys
constexpr int kStages = 2;          // tile slots in the ring
constexpr int kMaxGD = 1024;        // G * D bound (registers)
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;

template <int G, int D>
struct Plan {
  static constexpr int T = kTileBytes / D;                  // keys a tile
  static constexpr int DPL = G <= 2 ? 16 : (G == 4 ? 8 : 4);  // q.k: dims a lane
  static constexpr int LPK = D / DPL;                       // q.k: lanes a key
  static constexpr int KPP = kThreads / LPK;                // q.k: keys a pass
  static constexpr int DPV_G = G == 1 ? 16 : (G == 2 ? 8 : 4);
  static constexpr int DPV = DPV_G > D / 32 ? DPV_G : D / 32;   // p.V: dims a thread
  static constexpr int TPR = D / DPV;                       // p.V: threads a row
  static constexpr int KG = kThreads / TPR;                 // p.V: key groups
  static constexpr int RED = KG * G * D * 4;                // bytes of the p.V sum
  static_assert(LPK <= 32 && T % KPP == 0 && TPR <= 32, "tile mapping");
};

// four int8 codes (one 32-bit word) to exact floats: each becomes the float
// 2^23 + (code + 128) by a byte permute, then one exact subtraction
__device__ __forceinline__ void codes4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// N consecutive codes at a 4N-byte-aligned shared address (N = 4, 8, 16)
template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, float (&f)[N]) {
  if constexpr (N == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    codes4(w.x, f); codes4(w.y, f + 4); codes4(w.z, f + 8); codes4(w.w, f + 12);
  } else if constexpr (N == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    codes4(w.x, f); codes4(w.y, f + 4);
  } else {
    codes4(*reinterpret_cast<const uint32_t*>(p), f);
  }
}

__device__ __forceinline__ void store_out(void* out, size_t i, float x, bool bf16) {
  if (bf16) reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else reinterpret_cast<float*>(out)[i] = x;
}

struct Args {
  const void* q; const int8_t* k; const float* ks; const int8_t* v; const float* vs;
  const uint8_t* ok; void* out; float* ws; int B, Hkv, L, split, n_split;
  bool q_bf16, out_bf16; float scale; cudaStream_t stream;
};

// keys rounded up to whole tiles, for the per-key arrays in shared memory
__host__ __device__ constexpr int key_cap(int keys, int t) { return (keys + t - 1) / t * t; }

template <int G, int D>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kTileBytes > Plan<G, D>::RED ? kStages * kTileBytes : Plan<G, D>::RED;
}

template <int G, int D>
size_t smem_bytes(int split) {
  const int cap = key_cap(split, Plan<G, D>::T);
  return ring_bytes<G, D>() + (size_t)(G * cap + 2 * cap + 2 * G) * sizeof(float) + cap;
}

template <int G, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attn_int8_split(Args a) {
  using P = Plan<G, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / a.n_split, s_idx = blockIdx.x - bh * a.n_split;
  const int b = bh / a.Hkv;
  const int j_begin = s_idx * a.split;
  const int n = min(a.split, a.L - j_begin);       // keys of this split, >= 1
  const int nt = (n + P::T - 1) / P::T;            // K tiles, then as many V tiles
  const int cap = nt * P::T;

  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* red = reinterpret_cast<float*>(smem);     // [KG][G][D], once the ring is drained
  float* w_s = reinterpret_cast<float*>(smem + ring_bytes<G, D>());  // [G][cap]
  float* ks_s = w_s + G * cap;
  float* vs_s = ks_s + cap;
  float* m_s = vs_s + cap;
  float* l_s = m_s + G;
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(l_s + G);   // [cap]

  const size_t row0 = (size_t)bh * a.L + j_begin;  // the split's first key
  const int8_t* kp = a.k + row0 * D;
  const int8_t* vp = a.v + row0 * D;
  const float* ksp = a.ks + row0;
  const float* vsp = a.vs + row0;
  const uint8_t* okp = a.ok + (size_t)b * a.L + j_begin;

  // tile t of 2*nt (K tiles, then V tiles) into ring slot `slot` (t %
  // kStages); every call commits one copy group, empty past the last tile
  auto issue = [&](int t, int slot) {
    if (t < 2 * nt) {
      const int tt = t < nt ? t : t - nt;
      const int8_t* src = (t < nt ? kp : vp) + (size_t)tt * kTileBytes;
      int8_t* dst = ring + slot * kTileBytes;
      const int bytes = min(P::T, n - tt * P::T) * D;
#pragma unroll
      for (int i = 0; i < kTileBytes / (kThreads * 16); ++i) {
        const int c = (i * kThreads + tid) * 16;
        const bool in = c < bytes;
        cp_async16(dst + c, src + (in ? c : 0), in);
      }
      if (t == 0) {
        for (int i = tid; i < cap; i += kThreads) {
          const bool in = i < n;
          cp_async4(ks_s + i, ksp + (in ? i : 0), in);
          cp_async4(vs_s + i, vsp + (in ? i : 0), in);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) issue(t, t);
  int slot = 0;                    // t % kStages
  // the split's mask bytes, by plain loads while the first tiles fly
  for (int i = tid; i < n; i += kThreads) ok_s[i] = okp[i];

  // q.k: key slot key0 (+ KPP a pass), dims part*DPL.. of q, for G heads
  {
    const int part = tid % P::LPK, key0 = tid / P::LPK;
    float qr[G][P::DPL];
    const size_t q0 = (size_t)bh * G * D + part * P::DPL;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < P::DPL; ++e) {
        const size_t i = q0 + (size_t)g * D + e;
        qr[g][e] = a.q_bf16
            ? __uint_as_float((uint32_t)reinterpret_cast<const uint16_t*>(a.q)[i] << 16)
            : reinterpret_cast<const float*>(a.q)[i];
      }
    for (int t = 0; t < nt; ++t) {
      issue(t + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
      cp_async_wait(kStages - 1);   // this thread's copies of tile t have landed
      __syncthreads();             // and everyone's
      const int8_t* tile = ring + slot * kTileBytes;
      // scores of this K tile: s_j = (q.k_j) * scale * ks_j, masked -1e30
#pragma unroll
      for (int pass = 0; pass < P::T / P::KPP; ++pass) {
        const int jj = key0 + pass * P::KPP;
        float kf[P::DPL];
        load_codes<P::DPL>(tile + jj * D + part * P::DPL, kf);
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < P::DPL; ++e) d = fmaf(qr[g][e], kf[e], d);
          s[g] = d;
        }
#pragma unroll
        for (int off = P::LPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        // (no loads under the branch: past n, ks is 0 and the mask unread)
        const int j = t * P::T + jj;
        const float sc = a.scale * ks_s[j];
        const bool ok = ok_s[j] != 0;
        if (part == 0 && j < n) {
#pragma unroll
          for (int g = 0; g < G; ++g) w_s[g * cap + j] = ok ? s[g] * sc : kNegInf;
        }
      }
      __syncthreads();             // this slot is free for tile t + kStages
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
  }

  // the split's exact softmax, one warp a head: m, l, and p_j * vs_j in
  // place of the scores (the V tiles keep flying)
  for (int g = warp; g < G; g += kThreads / 32) {
    float* w = w_s + g * cap;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, w[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(w[j] - mx);
      sum += p;
      w[j] = p * vs_s[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) { m_s[g] = mx; l_s[g] = sum; }
    for (int j = n + lane; j < cap; j += 32) w[j] = 0.f;
  }

  // p.V: key group kg (every KG-th key of a tile), dims c*DPV.., G heads
  const int kg = tid / P::TPR, c = tid % P::TPR;
  float acc[G][P::DPV];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < P::DPV; ++e) acc[g][e] = 0.f;
  for (int t = nt; t < 2 * nt; ++t) {
    issue(t + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
    cp_async_wait(kStages - 1);
    __syncthreads();               // (the first also publishes the softmax)
    const int8_t* tile = ring + slot * kTileBytes;
    const float* w = w_s + (t - nt) * P::T;
#pragma unroll
    for (int r = 0; r < P::T / P::KG; ++r) {  // keys past the split: codes 0, weight 0
      const int jj = kg + r * P::KG;
      float vf[P::DPV];
      load_codes<P::DPV>(tile + jj * D + c * P::DPV, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pw = w[g * cap + jj];
#pragma unroll
        for (int e = 0; e < P::DPV; ++e) acc[g][e] = fmaf(pw, vf[e], acc[g][e]);
      }
    }
    __syncthreads();
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }

  // the key groups' partial sums, added in group order
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < P::DPV; ++e) red[(kg * G + g) * D + c * P::DPV + e] = acc[g][e];
  __syncthreads();
  float* mine = a.ws + ((size_t)bh * a.n_split + s_idx) * G * D;   // this split's acc
  for (int i = tid; i < G * D; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < P::KG; ++r) x += red[r * G * D + i];
    if (a.n_split == 1) store_out(a.out, (size_t)bh * G * D + i, x / l_s[i / D], a.out_bf16);
    else mine[i] = x;
  }
  if (a.n_split == 1 || tid >= G) return;
  const size_t ml0 = (size_t)a.B * a.Hkv * a.n_split * G * D + (size_t)bh * a.n_split * G * 2;
  a.ws[ml0 + (s_idx * G + tid) * 2] = m_s[tid];
  a.ws[ml0 + (s_idx * G + tid) * 2 + 1] = l_s[tid];
}

// out[bh][g][d] = sum_s acc_s * exp(m_s - M) / sum_s l_s * exp(m_s - M),
// M = max_s m_s, over one (b, h)'s splits: the weights exp(m_s - M) and
// the denominators first (one warp a head), then every output element sums
// its splits in split order
__global__ void __launch_bounds__(kMergeThreads)
decode_attn_int8_merge(const float* __restrict__ ws, void* out, int G, int D, int n_split,
                       int BH, bool out_bf16) {
  extern __shared__ float wsm[];   // [n_split][G] weights, then [G] denominators
  float* den = wsm + n_split * G;
  const int bh = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gd = G * D;
  const float* acc = ws + (size_t)bh * n_split * gd;
  const float* ml = ws + (size_t)BH * n_split * gd + (size_t)bh * n_split * G * 2;
  for (int g = warp; g < G; g += kMergeThreads / 32) {
    float mx = -INFINITY;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, ml[(s * G + g) * 2]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float c = expf(ml[(s * G + g) * 2] - mx);
      wsm[s * G + g] = c;
      sum = fmaf(ml[(s * G + g) * 2 + 1], c, sum);
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) den[g] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gd; i += blockDim.x) {
    const int g = i / D;
    float num = 0.f;
    for (int s = 0; s < n_split; ++s) num = fmaf(acc[(size_t)s * gd + i], wsm[s * G + g], num);
    store_out(out, (size_t)bh * gd + i, num / den[g], out_bf16);
  }
}

template <int G, int D>
cudaError_t launch(const Args& a) {
  if constexpr (G * D > kMaxGD) {
    return cudaErrorInvalidValue;  // no instantiation beyond the register budget
  } else {
    const size_t smem = smem_bytes<G, D>(a.split);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_attn_int8_split<G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    decode_attn_int8_split<G, D><<<a.B * a.Hkv * a.n_split, kThreads, smem, a.stream>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || a.n_split == 1) return e;
    const int bh = a.B * a.Hkv;
    const size_t merge_smem = (size_t)(a.n_split + 1) * G * sizeof(float);
    if (merge_smem > 48 * 1024) return cudaErrorInvalidValue;   // over 12,287 splits / G
    decode_attn_int8_merge<<<bh, kMergeThreads, merge_smem, a.stream>>>(
        a.ws, a.out, G, D, a.n_split, bh, a.out_bf16);
    return cudaGetLastError();
  }
}

template <int G>
cudaError_t launch_g(int D, const Args& a) {
  switch (D) {
    case 32: return launch<G, 32>(a);
    case 64: return launch<G, 64>(a);
    case 128: return launch<G, 128>(a);
    default: return launch<G, 256>(a);
  }
}

}  // namespace

extern "C" {

// q [B, Hkv, G, D] bf16 (q_bf16) or fp32; k, v [B, Hkv, L, D] int8;
// k_scale, v_scale [B, Hkv, L] fp32; valid [B, L] uint8 (0/1) →
// out [B, Hkv, G, D] bf16 (out_bf16) or fp32. G in {1, 2, 4, 8}, D in
// {32, 64, 128, 256}, G * D <= 1024; k and v 16-byte aligned; `split` keys
// a block (>= 1). With n_split = ceil(L / split) > 1, `workspace` holds
// B * Hkv * n_split * G * (D + 2) floats; with one split it is not read.
int qs_decode_attn_int8(const void* q, const void* k, const void* k_scale,
                        const void* v, const void* v_scale, const void* valid,
                        void* out, void* workspace, int B, int Hkv, int G, int L, int D,
                        int split, int q_bf16, int out_bf16, float scale, void* stream) {
  const bool g_ok = G == 1 || G == 2 || G == 4 || G == 8;
  const bool d_ok = D == 32 || D == 64 || D == 128 || D == 256;
  if (B <= 0 || Hkv <= 0 || L <= 0 || !g_ok || !d_ok || G * D > kMaxGD || split <= 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_split = (L + split - 1) / split;
  if (n_split > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)B * Hkv * n_split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{q, (const int8_t*)k, (const float*)k_scale, (const int8_t*)v,
               (const float*)v_scale, (const uint8_t*)valid, out, (float*)workspace,
               B, Hkv, L, split < L ? split : L, n_split,
               q_bf16 != 0, out_bf16 != 0, scale, (cudaStream_t)stream};
  switch (G) {
    case 1: return (int)launch_g<1>(D, a);
    case 2: return (int)launch_g<2>(D, a);
    case 4: return (int)launch_g<4>(D, a);
    default: return (int)launch_g<8>(D, a);
  }
}

}  // extern "C"
