// Native wire-format encoders (µ-law int8, block-scaled 4-bit PCM).
//
// Staging a batch over the host→device wire costs real host CPU on the
// encode side: numpy needs ~160 ms (µ-law, log1p per sample) / ~90 ms
// (pcm4) per 7.7M-sample batch on this 1-core host, which both burns
// throughput and makes latency-lane probes queue behind bulk staging for
// the GIL. These loops do the same transforms in C++ (ctypes releases
// the GIL for the duration), with a 64K µ-law LUT instead of per-sample
// log1p.
//
// Python-side parity: qwen3_asr_swift_tpu/audio/companding.py keeps the
// numpy implementations as the reference and fallback; tests pin the
// native outputs against them (tests/test_companding.py).
//
// No reference counterpart: the reference runs model and audio I/O in
// one process on unified memory (Sources/Qwen3ASR/Qwen3ASR.swift) and
// never stages PCM across a link.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// float32 -> IEEE half bits, round-to-nearest-even (matches numpy's
// astype(float16))
inline uint16_t f32_to_f16_bits(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = static_cast<int32_t>((x >> 23) & 0xFFu) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // inf/overflow
    if (exp <= 0) {
        // subnormal half (scales can reach 1e-5 < 2^-14)
        if (exp < -10) return static_cast<uint16_t>(sign);
        mant |= 0x800000u;
        const uint32_t shift = static_cast<uint32_t>(14 - exp);
        uint32_t half = mant >> shift;
        const uint32_t rem = mant & ((1u << shift) - 1u);
        const uint32_t mid = 1u << (shift - 1);
        if (rem > mid || (rem == mid && (half & 1u))) half++;
        return static_cast<uint16_t>(sign | half);
    }
    uint32_t res = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
    const uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (res & 1u))) res++;
    return static_cast<uint16_t>(res);
}

inline float f16_bits_to_f32(uint16_t h) {
    const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) {
            x = sign;
        } else {  // subnormal
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) {
                mant <<= 1;
                exp--;
            }
            mant &= 0x3FFu;
            x = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        x = sign | 0x7F800000u | (mant << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

// µ-law LUT over the int16 domain: code = round(sign(v) *
// log1p(255*|v|)/log1p(255) * 127) for v = i/32767. Two-stage rounding
// (float -> int16 -> LUT) differs from numpy's direct float path by at
// most 1 code on exact quantization boundaries (<0.1% of samples,
// inaudible at 38 dB SNR); tests bound it.
struct MulawLut {
    int8_t lut[65536];
    MulawLut() {
        const double inv = 1.0 / std::log1p(255.0);
        for (int i = -32768; i < 32768; ++i) {
            double v = static_cast<double>(i) / 32767.0;
            if (v > 1.0) v = 1.0;
            if (v < -1.0) v = -1.0;
            const double a = std::fabs(v);
            const double y = std::log1p(255.0 * a) * inv;
            const double s = (v < 0 ? -y : y) * 127.0;
            lut[static_cast<uint16_t>(i)] = static_cast<int8_t>(std::lrint(s));
        }
    }
};
const MulawLut g_mulaw;

}  // namespace

extern "C" {

// float32 PCM in [-1,1] -> µ-law int8. x and out may not alias.
void qs_mulaw_encode(const float* x, int8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        const int idx = static_cast<int>(std::lrintf(v * 32767.0f));
        out[i] = g_mulaw.lut[static_cast<uint16_t>(static_cast<int16_t>(idx))];
    }
}

// Block-scaled 4-bit PCM. x: [rows, n] contiguous float32 (n a multiple
// of 2*block). packed: [rows, n/2] uint8. scales: [rows, n/block] IEEE
// half bits. Matches companding.pcm4_encode_np: scale = max(|x|, 1e-5)
// per block rounded to f16; q = clip(round(x/scale*7), -7, 7).
void qs_pcm4_encode(const float* x, int64_t rows, int64_t n, int64_t block,
                    uint8_t* packed, uint16_t* scales) {
    const int64_t nblocks = n / block;
    for (int64_t r = 0; r < rows; ++r) {
        const float* xr = x + r * n;
        uint8_t* pr = packed + r * (n / 2);
        uint16_t* sr = scales + r * nblocks;
        for (int64_t b = 0; b < nblocks; ++b) {
            const float* xb = xr + b * block;
            float m = 1e-5f;
            for (int64_t i = 0; i < block; ++i) {
                const float a = std::fabs(xb[i]);
                if (a > m) m = a;
            }
            const uint16_t h = f32_to_f16_bits(m);
            sr[b] = h;
            // same op order as the numpy reference ((x/scale)*7) so the
            // two paths produce bit-identical codes
            const float s = f16_bits_to_f32(h);
            uint8_t* pb = pr + b * block / 2;
            for (int64_t i = 0; i < block; i += 2) {
                int q0 = static_cast<int>(std::lrintf(xb[i] / s * 7.0f));
                int q1 = static_cast<int>(std::lrintf(xb[i + 1] / s * 7.0f));
                if (q0 > 7) q0 = 7;
                if (q0 < -7) q0 = -7;
                if (q1 > 7) q1 = 7;
                if (q1 < -7) q1 = -7;
                pb[i / 2] = static_cast<uint8_t>((q0 & 0xF) | ((q1 & 0xF) << 4));
            }
        }
    }
}

// Closed-loop first-order DPCM at 4 bit/sample ("dpcm4"). x: [rows, n]
// float32 (n a multiple of 2*block). packed: [rows, n/2] uint8 (each
// block's nibble 0 unused). scales2: [rows, 2*n/block] IEEE half bits,
// interleaved (delta_scale, first_sample) per block. Matches
// companding.dpcm4_encode_np exactly: scale = max(max|diff|/7, 1e-6)
// rounded to f16; each delta quantized against the RECONSTRUCTED
// previous sample so error does not accumulate through the cumsum.
void qs_dpcm4_encode(const float* x, int64_t rows, int64_t n, int64_t block,
                     uint8_t* packed, uint16_t* scales2) {
    const int64_t nblocks = n / block;
    for (int64_t row = 0; row < rows; ++row) {
        const float* xr = x + row * n;
        uint8_t* pr = packed + row * (n / 2);
        uint16_t* sr = scales2 + row * 2 * nblocks;
        for (int64_t b = 0; b < nblocks; ++b) {
            const float* xb = xr + b * block;
            float m = 0.0f;
            for (int64_t i = 1; i < block; ++i) {
                const float d = std::fabs(xb[i] - xb[i - 1]);
                if (d > m) m = d;
            }
            float s = m / 7.0f;
            if (s < 1e-6f) s = 1e-6f;
            const uint16_t sh = f32_to_f16_bits(s);
            const uint16_t x0h = f32_to_f16_bits(xb[0]);
            sr[2 * b] = sh;
            sr[2 * b + 1] = x0h;
            s = f16_bits_to_f32(sh);          // quantize against what the
            float r = f16_bits_to_f32(x0h);   // decoder will reconstruct
            uint8_t* pb = pr + b * block / 2;
            int q_even = 0;  // nibble 0 of the block is unused (= 0)
            for (int64_t i = 1; i < block; ++i) {
                int q = static_cast<int>(std::lrintf((xb[i] - r) / s));
                if (q > 7) q = 7;
                if (q < -7) q = -7;
                r += static_cast<float>(q) * s;
                if (i % 2 == 0) {
                    q_even = q;
                } else {
                    pb[i / 2] = static_cast<uint8_t>((q_even & 0xF) | ((q & 0xF) << 4));
                    q_even = 0;
                }
            }
        }
    }
}

}  // extern "C"
