"""Operations and bytes of Qwen3-ASR transcription, from a configuration
file's shapes and the clips' lengths: what the inputs need, not what a
padded layout computes.

A decode step of B rows runs, per layer, the packed products q|k|v, o,
gate|up and down, and then the tied head; each reads its codes, its fp32
group scales and biases, bf16 x, and writes fp32 y. Kernel K3 reads, per
layer and step, the int8 keys and values of each row's valid slots and
their fp32 scales, the bf16 queries and the [B, L] valid map, and writes
bf16 out.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

#: the prompt around the audio: 9 tokens before it, 7 after (no language,
#: no context)
PREFIX_TOKENS, SUFFIX_TOKENS = 9, 7


def mel_frames(cfg: dict, samples: int) -> int:
    """Valid log-mel frames of a clip: the reflect-padded STFT's frames but the last."""
    m = cfg["mel"]
    padded = samples + 2 * (m["n_fft"] // 2)
    return max((padded - m["n_fft"]) // m["hop_length"], 0)


def _halve(n: int) -> int:
    return (n - 1) // 2 + 1


def audio_tokens(cfg: dict, samples: int) -> int:
    """Encoder tokens of a clip: 13 a whole 100-frame chunk, and the
    three stride-2 convs' output of the last partial chunk."""
    e = cfg["encoder"]
    chunk = 2 * e["n_window"]
    frames = mel_frames(cfg, samples)
    per_chunk = _halve(_halve(_halve(chunk)))
    full, rem = divmod(frames, chunk)
    return full * per_chunk + (max(_halve(_halve(_halve(rem))), 1) if rem else 0)


def prompt_rows(cfg: dict, samples: int) -> int:
    """Valid prompt rows of a clip: prefix, audio tokens, suffix."""
    return PREFIX_TOKENS + audio_tokens(cfg, samples) + SUFFIX_TOKENS


def decode_products(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """(name, in, out, calls a step) of the packed products of one decode step."""
    d = cfg["decoder"]
    h, hd, inter = d["hidden_size"], d["head_dim"], d["intermediate_size"]
    q, kv, n = d["num_heads"] * hd, d["num_kv_heads"] * hd, d["num_layers"]
    return [("qkv", h, q + 2 * kv, n), ("o", q, h, n), ("gate_up", h, 2 * inter, n),
            ("down", inter, h, n), ("head", h, d["vocab_size"], 1)]


def packed_product(cfg: dict, rows: int, d_in: int, d_out: int) -> Tuple[float, float]:
    """(bytes, flops) of one packed product of ``rows`` bf16 rows."""
    s = cfg["serving"]
    groups = d_in // s["group_size"]
    n_bytes = (d_out * d_in * s["quant_bits"] / 8 + 2 * 4 * d_out * groups
               + 2 * rows * d_in + 4 * rows * d_out)
    return n_bytes, 2.0 * rows * d_in * d_out


def bound_s(n_bytes: float, flops: float, peaks: dict) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over the bf16 tensor-core peak."""
    return max(n_bytes / peaks["hbm_bytes_s"], flops / peaks["bf16_flops_s"])


def k1_decode_bound_s(cfg: dict, rows: int, steps: int, peaks: dict) -> float:
    """Summed bounds of every packed product of ``steps`` decode steps."""
    per_step = sum(calls * bound_s(*packed_product(cfg, rows, i, o), peaks)
                   for _, i, o, calls in decode_products(cfg))
    return steps * per_step


def k1_decode_launches(cfg: dict, steps: int) -> int:
    return steps * sum(calls for *_, calls in decode_products(cfg))


def k3_call(cfg: dict, keys: Sequence[int], cache_len: int) -> Tuple[float, float]:
    """(bytes, flops) of one K3 call over rows with ``keys`` valid slots each."""
    d = cfg["decoder"]
    hq, hkv, hd = d["num_heads"], d["num_kv_heads"], d["head_dim"]
    rows = len(keys)
    n_bytes = (sum(keys) * hkv * (2 * hd + 2 * 4) + 2 * 2 * rows * hq * hd + rows * cache_len)
    return n_bytes, 4.0 * hq * hd * sum(keys)


def k3_decode_bound_s(cfg: dict, prompt: Sequence[int], steps: int, cache_len: int,
                      peaks: dict) -> float:
    """Summed bounds of K3's calls over ``steps`` decode steps; row r's
    step s reads prompt[r] + s slots."""
    n = cfg["decoder"]["num_layers"]
    return n * sum(bound_s(*k3_call(cfg, [p + s for p in prompt], cache_len), peaks)
                   for s in range(1, steps + 1))


def _linear_params(cfg: dict) -> int:
    return sum(calls * i * o for name, i, o, calls in decode_products(cfg) if name != "head")


def encoder_flops(cfg: dict, samples: int) -> float:
    """Convs over the valid chunks, then the transformer over the valid tokens."""
    e, m = cfg["encoder"], cfg["mel"]
    chunk = 2 * e["n_window"]
    ch, dm = e["downsample_hidden"], e["d_model"]
    chunks = math.ceil(mel_frames(cfg, samples) / chunk)
    f1, t1 = _halve(m["n_mels"]), _halve(chunk)
    f2, t2 = _halve(f1), _halve(t1)
    f3, t3 = _halve(f2), _halve(t2)
    conv = 2 * 9 * ch * (f1 * t1 + ch * f2 * t2 + ch * f3 * t3) * chunks
    tokens = audio_tokens(cfg, samples)
    win = (e["n_window_infer"] // chunk) * t3
    windows = [min(win, tokens - s) for s in range(0, tokens, win)]
    layer = (tokens * 2 * (4 * dm * dm + 2 * dm * e["ffn_dim"])
             + sum(4 * w * w * dm for w in windows))
    post = tokens * 2 * (e["conv_out_input_dim"] * dm + dm * dm + dm * e["output_dim"])
    return conv + e["num_layers"] * layer + post


def decoder_flops(cfg: dict, prompt: int, steps: int) -> float:
    """Prefill of ``prompt`` rows (head at its last row), then ``steps`` steps."""
    d = cfg["decoder"]
    attn = 4 * d["num_heads"] * d["head_dim"] * d["num_layers"]
    head = 2 * d["hidden_size"] * d["vocab_size"]
    lin = 2 * _linear_params(cfg)
    pre = prompt * lin + attn * prompt * (prompt + 1) / 2 + head
    dec = sum(lin + head + attn * (prompt + s) for s in range(1, steps + 1))
    return pre + dec


def batch_flops(cfg: dict, samples: Sequence[int], max_tokens: int) -> float:
    """The model's operations for one batch whose every clip is decoded
    to ``max_tokens`` tokens."""
    return sum(encoder_flops(cfg, n) + decoder_flops(cfg, prompt_rows(cfg, n), max_tokens - 1)
               for n in samples)
