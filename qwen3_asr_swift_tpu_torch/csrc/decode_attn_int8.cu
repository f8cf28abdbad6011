// K3: single-token GQA decode attention over an int8 KV cache.
//
// Replaces the Pallas TPU kernel
//   qwen3_asr_swift_tpu/ops/attention_pallas.py::_decode_attn_kernel
//   (launched by decode_attention_int8).
// For each batch row b and kv-head h, with the G query heads that share
// h (GQA), it computes
//   s_j  = (q . k_j) / sqrt(D) * ks_j       (masked rows: -1e30)
//   out  = sum_j p_j * vs_j * v_j / sum_j p_j,   p_j = exp(s_j - max s)
// i.e. the per-slot scales fold into the scores and the probabilities and
// no dequantized [L, D] buffer is ever written. The plain version is
//   qwen3_asr_swift_tpu_torch/ops/attention_int8.py::decode_attention_int8_ref.
//
// What bounds it on an H100: bytes and load latency. A step reads the
// int8 K and V of every (b, h) once (2*L*D bytes per head: 145 KB at
// L = 580, D = 128; 37 MB per layer at B = 32, Hkv = 8, ~11 us at
// 3.35 TB/s) and does only ~4*G flops per byte, so the kernel must keep
// many independent loads in flight rather than wait on barriers.
//
// Design:
// - One block of kWarps warps per (b, h); the TPU kernel ran one grid
//   cell per batch row with a loop over kv-heads, which would give this
//   card only B blocks.
// - Each warp owns a contiguous range of keys and walks it with its own
//   online softmax (running max m, running sum l, rescaled accumulators):
//   no block barrier until the end, and shared memory does not bound L.
//   The TPU version held all of L in VMEM and padded L to a multiple of
//   128; here keys past L are simply never visited.
// - A lane holds DPL = D/32 consecutive dims of q (for all G query heads),
//   of each key row and of the output accumulators, so one key row is one
//   coalesced 32*DPL-byte load per warp. U keys are loaded at once (K and
//   V rows, scales, mask) to keep U independent loads in flight; the G*U
//   dot products then reduce with warp shuffles.
// - At the end the warps' (m, l, acc) merge through shared memory with
//   the usual rescaling by exp(m_w - max_w m_w).
// - Masked rows score NEG_INF = -1e30 exactly as the TPU kernel does, so
//   a fully-masked row degenerates to the same uniform average.
// - q arrives fp32; everything accumulates in fp32.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;           // warps per block, each a range of keys
constexpr int kMaxGD = 1024;        // G * D bound of the merge buffer (32 KB)
constexpr float kNegInf = -1e30f;

template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float (&f)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL / 4; ++i) {
      const char4 c = reinterpret_cast<const char4*>(p)[i];
      f[4 * i] = c.x; f[4 * i + 1] = c.y; f[4 * i + 2] = c.z; f[4 * i + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) f[i] = p[i];
  }
}

template <int G, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                        const float* __restrict__ ks, const int8_t* __restrict__ v,
                        const float* __restrict__ vs, const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int Hkv, int L, float scale) {
  constexpr int D = 32 * DPL;
  constexpr int U = G * DPL <= 8 ? 8 : (G * DPL <= 16 ? 4 : 2);  // keys in flight
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][D];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e0 = lane * DPL;

  const int8_t* kp = k + (size_t)bh * L * D + e0;
  const int8_t* vp = v + (size_t)bh * L * D + e0;
  const float* ksp = ks + (size_t)bh * L;
  const float* vsp = vs + (size_t)bh * L;
  const uint8_t* ok = valid + (size_t)b * L;

  float qr[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      qr[g][e] = q[((size_t)bh * G + g) * D + e0 + e];
      acc[g][e] = 0.f;
    }
  }

  const int per = (L + kWarps - 1) / kWarps;
  const int j_begin = warp * per;
  const int j_end = min(L, j_begin + per);
  for (int j0 = j_begin; j0 < j_end; j0 += U) {
    float kf[U][DPL], vf[U][DPL], ksj[U], vsj[U];
    bool in[U], okj[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      in[u] = j < j_end;
      if (in[u]) {
        load_row<DPL>(kp + (size_t)j * D, kf[u]);
        load_row<DPL>(vp + (size_t)j * D, vf[u]);
        ksj[u] = ksp[j];
        vsj[u] = vsp[j];
        okj[u] = ok[j] != 0;
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) { kf[u][e] = 0.f; vf[u][e] = 0.f; }
        ksj[u] = 0.f; vsj[u] = 0.f; okj[u] = false;
      }
    }
    // scores: lane-partial dot products, then one butterfly per (u, g)
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) part = fmaf(qr[g][e], kf[u][e], part);
        s[u][g] = part;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
    // online softmax over these U keys (keys past the range score -inf and
    // weigh 0; the tile's first key is always in range, so mn is finite)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = !in[u] ? -INFINITY : (okj[u] ? s[u][g] * scale * ksj[u] : kNegInf);
        mn = fmaxf(mn, s[u][g]);
      }
      const float corr = expf(m[g] - mn);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u][g] - mn);
        l[g] += p;
        const float pv = p * vsj[u];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pv, vf[u][e], acc[g][e]);
      }
      m[g] = mn;
    }
  }

  // merge the warps: a warp with no keys has m = -inf, l = 0, acc = 0
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) { m_s[warp][g] = m[g]; l_s[warp][g] = l[g]; }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_s[warp][g][e0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][g] - mx);
      num = fmaf(acc_s[w][g][d], c, num);
      den = fmaf(l_s[w][g], c, den);
    }
    out[((size_t)bh * G + g) * D + d] = num / den;
  }
}

struct Args {
  const float* q; const int8_t* k; const float* ks; const int8_t* v; const float* vs;
  const uint8_t* ok; float* out; int B, Hkv, L; float scale; cudaStream_t stream;
};

template <int G, int DPL>
cudaError_t launch(const Args& a) {
  if constexpr (G * 32 * DPL > kMaxGD) {
    return cudaErrorInvalidValue;  // no instantiation beyond the merge buffer
  } else {
    decode_attn_int8_kernel<G, DPL><<<a.B * a.Hkv, kWarps * 32, 0, a.stream>>>(
        a.q, a.k, a.ks, a.v, a.vs, a.ok, a.out, a.Hkv, a.L, a.scale);
    return cudaGetLastError();
  }
}

template <int G>
cudaError_t launch_g(int D, const Args& a) {
  switch (D) {
    case 32: return launch<G, 1>(a);
    case 64: return launch<G, 2>(a);
    case 128: return launch<G, 4>(a);
    default: return launch<G, 8>(a);
  }
}

}  // namespace

extern "C" {

// q [B, Hkv, G, D] fp32; k, v [B, Hkv, L, D] int8; k_scale, v_scale
// [B, Hkv, L] fp32; valid [B, L] uint8 (0/1) → out [B, Hkv, G, D] fp32.
// G in {1, 2, 4, 8}, D in {32, 64, 128, 256}, G * D <= 1024; k and v
// 16-byte aligned.
int qs_decode_attn_int8(const void* q, const void* k, const void* k_scale,
                        const void* v, const void* v_scale, const void* valid,
                        void* out, int B, int Hkv, int G, int L, int D,
                        float scale, void* stream) {
  const bool g_ok = G == 1 || G == 2 || G == 4 || G == 8;
  const bool d_ok = D == 32 || D == 64 || D == 128 || D == 256;
  if (B <= 0 || Hkv <= 0 || L <= 0 || !g_ok || !d_ok || G * D > kMaxGD ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const float*)q, (const int8_t*)k, (const float*)k_scale, (const int8_t*)v,
               (const float*)v_scale, (const uint8_t*)valid, (float*)out, B, Hkv, L, scale,
               (cudaStream_t)stream};
  switch (G) {
    case 1: return (int)launch_g<1>(D, a);
    case 2: return (int)launch_g<2>(D, a);
    case 4: return (int)launch_g<4>(D, a);
    default: return (int)launch_g<8>(D, a);
  }
}

}  // extern "C"
