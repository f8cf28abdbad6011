"""Streaming Zipformer2 transducer encoder for keyword spotting — port of
``qwen3_asr_swift_tpu/models/wakeword/zipformer.py``.

icefall's KWS Zipformer (gigaspeech, 3.49M parameters): Conv2dSubsampling
with a ConvNeXt block, six encoder stacks at downsampling factors
1/2/4/8/4/2, shared relative-position attention weights per layer feeding
two self-attention modules and a nonlin-attention module, two
chunk-causal depthwise convolution modules, three feed-forwards, BiasNorm
and learned bypasses. :func:`encode_chunk` consumes one 45-frame mel
window (32 fresh frames) and carries every per-layer cache in an explicit
state dict (the reference's pytree, leaf for leaf); :func:`encode_windows`
is a Python loop over windows carrying the states, where the reference
scans. The transducer head (:func:`decoder_out`, :func:`joiner_logits`)
stays numpy on the host, as the reference's beam search calls it.

The tree is the reference's: linear kernels ``[in, out]``, conv weights
HWIO / ``(width, in, out)``. The depthwise 7×7 ConvNeXt conv is
``ops/nn.py::depthwise_conv2d`` and the depthwise 1-d convs
``ops/nn.py::conv1d``, both fp32 tap sums.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...core.params import _linear, _normal
from ...ops.nn import conv1d, conv2d, depthwise_conv2d, linear


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    """Hyperparameters of the KWS Zipformer (icefall gigaspeech recipe).

    Defaults reproduce the 3.49M-param wake-word checkpoint
    (reference: Configuration.swift:57-96 — chunk 16, left context 64,
    joiner_dim 320, vocab 500, context_size 2).
    """

    num_mel_bins: int = 80
    num_layers: Tuple[int, ...] = (1, 1, 1, 1, 1, 1)
    downsampling: Tuple[int, ...] = (1, 2, 4, 8, 4, 2)
    encoder_dim: Tuple[int, ...] = (128, 128, 128, 128, 128, 128)
    ff_dim: Tuple[int, ...] = (192, 192, 192, 192, 192, 192)
    num_heads: Tuple[int, ...] = (4, 4, 4, 8, 4, 4)
    cnn_kernel: Tuple[int, ...] = (31, 31, 15, 15, 15, 31)
    query_head_dim: int = 32
    pos_head_dim: int = 4
    value_head_dim: int = 12
    pos_dim: int = 48
    chunk_size: int = 16          # 50 Hz frames per streaming step
    left_context: int = 64        # 50 Hz frames of attention left context
    embed_channels: Tuple[int, int, int] = (8, 32, 128)
    joiner_dim: int = 320
    decoder_dim: int = 320
    vocab_size: int = 500
    context_size: int = 2
    blank_id: int = 0

    @property
    def output_dim(self) -> int:
        return max(self.encoder_dim)

    @property
    def mel_window(self) -> int:
        """Mel frames per streaming step: chunk*2 fresh + 13 overlap
        (7 subsampling + 2*3 ConvNeXt pad — Configuration.swift:77)."""
        return self.chunk_size * 2 + 13

    @property
    def mel_stride(self) -> int:
        return self.chunk_size * 2

    @property
    def embed_freq_out(self) -> int:
        f = self.num_mel_bins                      # conv0: pad 1, k 3 → same
        f = (f - 3) // 2 + 1                       # conv1: k 3 stride 2
        f = (f - 3) // 2 + 1                       # conv2: k 3 stride (1,2)
        return f


# ---------------------------------------------------------------------------
# Scheduled-nonlinearity primitives (inference forms)
# ---------------------------------------------------------------------------

def swoosh_l(x):
    return torch.logaddexp(x.new_zeros(()), x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    return torch.logaddexp(x.new_zeros(()), x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(x, p):
    """BiasNorm: scale x by the inverse RMS of (x - bias); per-tensor
    learned log_scale."""
    d = x - p["bias"]
    rms = torch.sqrt((d * d).mean(dim=-1, keepdim=True) + 1e-8)
    return x * (torch.exp(p["log_scale"]) / rms)


def bypass(p, x_orig, x):
    scale = torch.clamp(p["bypass_scale"], 0.0, 1.0)
    return x_orig + (x - x_orig) * scale


# ---------------------------------------------------------------------------
# Random parameters (the reference's tree, drawn with numpy or on a card)
# ---------------------------------------------------------------------------

def init_zipformer_params(rng, cfg: ZipformerConfig) -> dict:
    """Random weights in the reference's tree: fp32 numpy from a numpy
    generator, or the kernels on a ``torch.Generator``'s device."""
    lin = functools.partial(_linear, rng)

    def biasnorm(dim):
        return {"bias": np.zeros((dim,), np.float32), "log_scale": np.zeros((), np.float32)}

    def conv2d_p(kh, kw, cin, cout):
        return {"w": _normal(rng, (kh, kw, cin, cout), 1.0 / np.sqrt(kh * kw * cin)),
                "b": np.zeros((cout,), np.float32)}

    c1, c2, c3 = cfg.embed_channels
    embed = {
        "conv0": conv2d_p(3, 3, 1, c1),
        "conv1": conv2d_p(3, 3, c1, c2),
        "conv2": conv2d_p(3, 3, c2, c3),
        "convnext": {"dw": {"w": _normal(rng, (7, 7, 1, c3), 0.02),
                            "b": np.zeros((c3,), np.float32)},
                     "pw1": lin(c3, 3 * c3), "pw2": lin(3 * c3, c3)},
        "out": lin(cfg.embed_freq_out * c3, cfg.encoder_dim[0]),
        "out_norm": biasnorm(cfg.encoder_dim[0]),
    }

    def layer(stack):
        d, ff, h = cfg.encoder_dim[stack], cfg.ff_dim[stack], cfg.num_heads[stack]
        qd, pd, vd = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim
        kernel = cfg.cnn_kernel[stack]
        hidden = 3 * d // 4

        def conv_module():
            return {"in_proj": lin(d, 2 * d),
                    "causal_w": _normal(rng, ((kernel + 1) // 2, 1, d), 0.02),
                    "causal_b": np.zeros((d,), np.float32),
                    "chunkwise_w": _normal(rng, (kernel, 1, d), 0.02),
                    "chunkwise_b": np.zeros((d,), np.float32),
                    "out_proj": lin(d, d)}

        return {
            "attn_weights": {"in_proj": lin(d, h * (2 * qd + pd)),
                             "linear_pos": lin(cfg.pos_dim, h * pd, bias=False)},
            "self_attn1": {"in_proj": lin(d, h * vd), "out_proj": lin(h * vd, d)},
            "self_attn2": {"in_proj": lin(d, h * vd), "out_proj": lin(h * vd, d)},
            "nonlin_attention": {"in_proj": lin(d, 3 * hidden), "out_proj": lin(hidden, d)},
            "conv_module1": conv_module(),
            "conv_module2": conv_module(),
            "feed_forward1": {"in_proj": lin(d, (ff * 3) // 4), "out_proj": lin((ff * 3) // 4, d)},
            "feed_forward2": {"in_proj": lin(d, ff), "out_proj": lin(ff, d)},
            "feed_forward3": {"in_proj": lin(d, (ff * 5) // 4), "out_proj": lin((ff * 5) // 4, d)},
            "norm": biasnorm(d),
            "bypass": {"bypass_scale": np.full((d,), 0.5, np.float32)},
            "bypass_mid": {"bypass_scale": np.full((d,), 0.5, np.float32)},
        }

    stacks = []
    for i, n in enumerate(cfg.num_layers):
        stack = {"layers": [layer(i) for _ in range(n)]}
        if cfg.downsampling[i] > 1:
            stack["downsample_bias"] = np.zeros((cfg.downsampling[i],), np.float32)
            stack["out_combiner"] = {"bypass_scale": np.full((cfg.encoder_dim[i],), 0.5,
                                                             np.float32)}
        stacks.append(stack)
    return {
        "embed": embed,
        "stacks": stacks,
        "downsample_output_bias": np.zeros((2,), np.float32),
        "encoder_proj": lin(cfg.output_dim, cfg.joiner_dim),
        "decoder": {"embedding": _normal(rng, (cfg.vocab_size, cfg.decoder_dim), 0.02),
                    "conv_w": _normal(rng, (cfg.context_size, 4, cfg.decoder_dim), 0.05)},
        "joiner": {"decoder_proj": lin(cfg.decoder_dim, cfg.joiner_dim),
                   "output_linear": lin(cfg.joiner_dim, cfg.vocab_size)},
    }


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return int(np.prod(tuple(params.shape)))


# ---------------------------------------------------------------------------
# Streaming state
# ---------------------------------------------------------------------------

def init_states(cfg: ZipformerConfig, batch: int = 1, dtype=torch.float32, device="cuda") -> dict:
    """Zeroed caches, leaf for leaf the reference's state pytree."""
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    layer_states = []
    for i, n in enumerate(cfg.num_layers):
        d = cfg.encoder_dim[i]
        h = cfg.num_heads[i]
        left = cfg.left_context // cfg.downsampling[i]
        hidden = 3 * d // 4
        for _ in range(n):
            layer_states.append({
                "cached_key": zeros((batch, left, h * cfg.query_head_dim)),
                "cached_val1": zeros((batch, left, h * cfg.value_head_dim)),
                "cached_val2": zeros((batch, left, h * cfg.value_head_dim)),
                "cached_nonlin": zeros((batch, left, hidden)),
                "cached_conv1": zeros((batch, (cfg.cnn_kernel[i] + 1) // 2 - 1, d)),
                "cached_conv2": zeros((batch, (cfg.cnn_kernel[i] + 1) // 2 - 1, d)),
            })
    return {
        # ConvNeXt causal left pad: 6 frames at the post-subsampling rate
        "cached_embed_left_pad": zeros((batch, 6, cfg.embed_freq_out, cfg.embed_channels[2])),
        "layers": layer_states,
        "processed": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _conv(p):
    return {"kernel": p["w"], "bias": p["b"]}


def embed_chunk(params, mel, left_pad):
    """Conv2dSubsampling over a mel window.

    mel: [B, T_mel, 80] → features [B, (T_mel-7)//2, d0] with the ConvNeXt
    block causal over time via the carried 6-frame left pad.
    Returns (features, new_left_pad).
    """
    x = mel[..., None]                                          # [B, T, F, 1]
    x = swoosh_r(conv2d(x, _conv(params["conv0"]), padding=((0, 0), (1, 1))))
    x = swoosh_r(conv2d(x, _conv(params["conv1"]), stride=(2, 2), padding=((0, 0), (0, 0))))
    x = swoosh_r(conv2d(x, _conv(params["conv2"]), stride=(1, 2), padding=((0, 0), (0, 0))))
    cn = params["convnext"]
    padded = torch.cat([left_pad, x], dim=1)                    # causal time pad
    # consecutive windows overlap by 3 conv frames (19 produced, 16-frame
    # stride), so the next window's causal context is the 6 frames BEFORE
    # its first conv frame: padded[-9:-3], not the last 6
    new_left_pad = padded[:, -9:-3]
    dw = depthwise_conv2d(padded, _conv(cn["dw"]), padding=((0, 0), (3, 3)))
    y = linear(swoosh_l(linear(dw, cn["pw1"])), cn["pw2"])
    x = x + y[:, : x.shape[1]]
    b, t, f, c = x.shape
    x = linear(x.reshape(b, t, f * c), params["out"])
    return bias_norm(x, params["out_norm"]), new_left_pad


@functools.lru_cache(maxsize=64)
def _rel_pos_embedding(t: int, s: int, pos_dim: int, device: torch.device) -> torch.Tensor:
    """Compact relative positional embedding [T, S, pos_dim] of the
    distances key - query (queries at S-T … S-1): compressed
    logarithmically, then expanded in sinusoids. Computed once a shape, in
    fp32 on the host, so the card and the host read the same table."""
    with torch.inference_mode(False), torch.no_grad():
        rel = torch.arange(s)[None, :] - (torch.arange(t)[:, None] + (s - t))
        x = torch.sign(rel).float() * torch.log1p(rel.abs().float())
        half = pos_dim // 2
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                          * np.float32(np.log(100.0) / max(half - 1, 1)))
        ang = x[..., None] * freqs
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device)


def attention_weights(p, x, cached_key, cfg: ZipformerConfig, n_heads: int):
    """Shared relative-position attention weights over (left | chunk).

    x: [B, T, D] current chunk at this stack's rate. Returns
    (weights [B, H, T, L+T], new_cached_key)."""
    qd, pd = cfg.query_head_dim, cfg.pos_head_dim
    b, t, _ = x.shape
    proj = linear(x, p["in_proj"])
    q, k, pq = proj.split([n_heads * qd, n_heads * qd, n_heads * pd], dim=-1)
    keys = torch.cat([cached_key, k], dim=1)                    # [B, L+T, H*qd]
    s = keys.shape[1]
    left = s - t

    qh = q.reshape(b, t, n_heads, qd).transpose(1, 2)
    kh = keys.reshape(b, s, n_heads, qd).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qd)

    ph = pq.reshape(b, t, n_heads, pd).transpose(1, 2)          # [B,H,T,pd]
    emb = _rel_pos_embedding(t, s, cfg.pos_dim, x.device).to(x.dtype)
    pos_proj = linear(emb, p["linear_pos"]).reshape(t, s, n_heads, pd)
    pos_scores = torch.einsum("bhtd,tshd->bhts", ph, pos_proj)
    weights = torch.softmax(scores + pos_scores, dim=-1)

    new_key = keys[:, -left:] if left > 0 else keys[:, :0]
    return weights, new_key


def self_attention(p, x, cached_val, weights, n_heads: int, vd: int):
    b, t, _ = x.shape
    v = linear(x, p["in_proj"])
    vals = torch.cat([cached_val, v], dim=1)
    s = vals.shape[1]
    left = s - t
    vh = vals.reshape(b, s, n_heads, vd).transpose(1, 2)
    out = torch.matmul(weights, vh)
    out = out.transpose(1, 2).reshape(b, t, n_heads * vd)
    new_cached = vals[:, -left:] if left > 0 else vals[:, :0]
    return linear(out, p["out_proj"]), new_cached


def nonlin_attention(p, x, cached, weights_head0):
    """NonlinAttention: gated value aggregation using the first attention
    head's weights. weights_head0: [B, T, L+T]."""
    t = x.shape[1]
    s_, xx, y = linear(x, p["in_proj"]).chunk(3, dim=-1)
    xx = xx * torch.tanh(s_)
    vals = torch.cat([cached, xx], dim=1)
    left = vals.shape[1] - t
    agg = torch.matmul(weights_head0, vals)
    new_cached = vals[:, -left:] if left > 0 else vals[:, :0]
    return linear(agg * y, p["out_proj"]), new_cached


def conv_module(p, x, cached):
    """Chunk-causal depthwise conv: a causal half-kernel conv (with carried
    left state) plus a chunk-internal full-kernel conv, as in icefall's
    ChunkCausalDepthwiseConv1d."""
    d = x.shape[-1]
    xx, s = linear(x, p["in_proj"]).chunk(2, dim=-1)
    xx = xx * torch.sigmoid(s)

    causal_in = torch.cat([cached, xx], dim=1)
    new_cached = causal_in[:, -cached.shape[1]:] if cached.shape[1] > 0 else cached
    causal = conv1d(causal_in, {"kernel": p["causal_w"], "bias": p["causal_b"]}, groups=d)
    kernel = p["chunkwise_w"].shape[0]
    chunkwise = conv1d(xx, {"kernel": p["chunkwise_w"], "bias": p["chunkwise_b"]},
                       padding=kernel // 2, groups=d)
    out = swoosh_r(causal + chunkwise)
    return linear(out, p["out_proj"]), new_cached


def feed_forward(p, x):
    return linear(swoosh_l(linear(x, p["in_proj"])), p["out_proj"])


def encoder_layer(p, x, state, cfg: ZipformerConfig, stack: int):
    """One Zipformer2 layer streaming step at this stack's frame rate."""
    n_heads = cfg.num_heads[stack]
    vd = cfg.value_head_dim
    src_orig = x
    weights, new_key = attention_weights(
        p["attn_weights"], x, state["cached_key"], cfg, n_heads)

    x = x + feed_forward(p["feed_forward1"], x)
    na, new_nonlin = nonlin_attention(p["nonlin_attention"], x, state["cached_nonlin"],
                                      weights[:, 0])
    x = x + na
    sa, new_val1 = self_attention(p["self_attn1"], x, state["cached_val1"], weights, n_heads, vd)
    x = x + sa
    cv, new_conv1 = conv_module(p["conv_module1"], x, state["cached_conv1"])
    x = x + cv
    x = x + feed_forward(p["feed_forward2"], x)
    x = bypass(p["bypass_mid"], src_orig, x)
    sa, new_val2 = self_attention(p["self_attn2"], x, state["cached_val2"], weights, n_heads, vd)
    x = x + sa
    cv, new_conv2 = conv_module(p["conv_module2"], x, state["cached_conv2"])
    x = x + cv
    x = x + feed_forward(p["feed_forward3"], x)
    x = bias_norm(x, p["norm"])
    x = bypass(p["bypass"], src_orig, x)
    new_state = {"cached_key": new_key,
                 "cached_val1": new_val1, "cached_val2": new_val2,
                 "cached_nonlin": new_nonlin,
                 "cached_conv1": new_conv1, "cached_conv2": new_conv2}
    return x, new_state


def simple_downsample(x, bias, ds: int):
    b, t, d = x.shape
    w = torch.softmax(bias, dim=-1)
    return torch.einsum("bkgd,g->bkd", x.reshape(b, t // ds, ds, d), w)


def encode_chunk(params, cfg: ZipformerConfig, mel_window, states):
    """One streaming step: 45-frame mel window → 8 joiner-space frames.

    mel_window: [B, cfg.mel_window, 80]. Returns (encoder_out
    [B, chunk//2, joiner_dim], new_states)."""
    x, new_embed_pad = embed_chunk(params["embed"], mel_window, states["cached_embed_left_pad"])
    # keep the freshest chunk_size frames at 50 Hz
    x = x[:, -cfg.chunk_size:]

    new_layer_states: List[dict] = []
    li = 0
    for i in range(len(cfg.num_layers)):
        ds = cfg.downsampling[i]
        src = x
        if ds > 1:
            x = simple_downsample(x, params["stacks"][i]["downsample_bias"], ds)
        for j in range(cfg.num_layers[i]):
            x, ns = encoder_layer(params["stacks"][i]["layers"][j], x,
                                  states["layers"][li], cfg, i)
            new_layer_states.append(ns)
            li += 1
        if ds > 1:
            x = torch.repeat_interleave(x, ds, dim=1)[:, : src.shape[1]]
            x = bypass(params["stacks"][i]["out_combiner"], src, x)

    # final 2x output downsample then the fused joiner-space projection
    x = simple_downsample(x, params["downsample_output_bias"], 2)
    out = linear(x, params["encoder_proj"])
    new_states = {"cached_embed_left_pad": new_embed_pad,
                  "layers": new_layer_states,
                  "processed": states["processed"] + cfg.mel_stride}
    return out, new_states


def encode_windows(params, cfg: ZipformerConfig, windows, states):
    """``encode_chunk`` over [N, B, mel_window, 80] chunk windows in order,
    carrying the states (the reference's ``lax.scan``). Returns
    ([B, N*chunk//2, joiner_dim], final_states)."""
    outs = []
    for win in windows:
        out, states = encode_chunk(params, cfg, win, states)
        outs.append(out)
    outs = torch.stack(outs)
    n, b, t, d = outs.shape
    return outs.transpose(0, 1).reshape(b, n * t, d), states


# ---------------------------------------------------------------------------
# Transducer head (host side: tiny matmuls driven by the beam search; numpy
# as in the reference, over the head's leaves as numpy arrays)
# ---------------------------------------------------------------------------

def decoder_out(params, context: Sequence[int], cfg: ZipformerConfig) -> np.ndarray:
    """Stateless decoder: embed ``context_size`` tokens, grouped conv over
    the context axis, ReLU, project to joiner space. Negative ids (initial
    padding) embed as zeros, matching icefall's padded start context."""
    emb_table = np.asarray(params["decoder"]["embedding"])
    ctx = list(context)[-cfg.context_size:]
    while len(ctx) < cfg.context_size:
        ctx.insert(0, -1)
    emb = np.stack([np.zeros(emb_table.shape[1], emb_table.dtype) if t < 0 else emb_table[t]
                    for t in ctx])                              # [ctx, D]
    w = np.asarray(params["decoder"]["conv_w"])                 # [ctx, D/groups→4, D]
    d = emb.shape[1]
    groups = d // (w.shape[1])
    per = d // groups
    out = np.zeros(d, emb.dtype)
    for g in range(groups):
        seg = emb[:, g * per:(g + 1) * per]                     # [ctx, per]
        out[g * per:(g + 1) * per] = np.einsum("ki,kio->o", seg, w[:, :, g * per:(g + 1) * per])
    out = np.maximum(out, 0.0)
    dp = params["joiner"]["decoder_proj"]
    return out @ np.asarray(dp["kernel"]) + np.asarray(dp["bias"])


def joiner_logits(params, enc_frame: np.ndarray, dec_out: np.ndarray) -> np.ndarray:
    """logits = output_linear(tanh(enc + dec)); encoder projection is fused
    into the encoder program."""
    ol = params["joiner"]["output_linear"]
    return np.tanh(enc_frame + dec_out) @ np.asarray(ol["kernel"]) + np.asarray(ol["bias"])
