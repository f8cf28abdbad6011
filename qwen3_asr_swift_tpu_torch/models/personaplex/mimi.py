"""Mimi neural audio codec, 24 kHz ⇄ 16 codebooks at 12.5 Hz — port of
``qwen3_asr_swift_tpu/models/personaplex/mimi.py``, batch and streaming.

The published topology over the reference's parameter tree (conv weights
``[K, in/groups, out]``, transposed-conv weights flipped, as
``convert.py`` writes them):

- SEANet encoder: conv-in k7 → per stage (ratios reversed: 4, 5, 6, 8) a
  residual unit (ELU → k3 → ELU → k1) and a stride-``r`` downsample conv
  k = 2r → ELU → conv k3 to ``hidden``; every conv causal (left pad =
  kernel − stride, a ceil-based extra right pad);
- 8-layer transformers on each side: LayerNorm, attention with RoPE and a
  250-frame sliding causal window, LayerScale residual gains, GELU MLP;
- the learnt 2× down/upsample (k4 s2; the upsample depthwise);
- split residual VQ: 1 semantic + 15 acoustic codebooks behind shared 1×1
  projections, codebooks as ``embed_sum / cluster_usage``;
- the mirrored SEANet decoder with causal transposed convs (trim right).

Convs are tap matmuls (``ops/nn.py::conv1d``; cuDNN in bf16) and
transposed convs a matmul per tap with an overlap-add, so fp32 runs in full
fp32 on the card as on the host. The streaming codec
(:func:`mimi_encode_frame`, :func:`mimi_decode_frame`) carries each conv's
left context, each transposed conv's overlap tail and a KV ring of the
transformers' window, and uses the same helpers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _linear, _norm, _normal
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import conv1d, conv_transpose1d_full, layer_norm, linear
from ...ops.rope import apply_rope, rope_angles


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24000
    frame_rate: float = 12.5
    hidden: int = 512                  # SEANet output / transformer width
    num_filters: int = 64
    ratios: Tuple[int, ...] = (8, 6, 5, 4)  # decoder order; encoder reversed
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    compress: int = 2
    num_quantizers: int = 16
    codebook_size: int = 2048
    codebook_dim: int = 256
    transformer_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    intermediate: int = 2048
    sliding_window: int = 250
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def latent_dim(self) -> int:
        return self.hidden

    @property
    def samples_per_frame(self) -> int:
        out = 2  # learnt 2x resample stage
        for r in self.ratios:
            out *= r
        return out  # 1920

    @property
    def num_stages(self) -> int:
        return len(self.ratios)


def config_tiny() -> MimiConfig:
    return MimiConfig(hidden=32, num_filters=8, ratios=(4, 4, 2, 2),
                      codebook_size=64, codebook_dim=16,
                      transformer_layers=1, num_heads=2, num_kv_heads=2,
                      head_dim=16, intermediate=64)


# ---------------------------------------------------------------------------
# causal conv helpers (MimiConv1d / MimiConvTranspose1d semantics)
# ---------------------------------------------------------------------------

def _causal_pad(length: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(left, right) padding: left = effective_kernel - stride; right =
    ceil-based extra so every sample is consumed (MimiConv1d
    _get_extra_padding_for_conv1d)."""
    eff_k = (kernel - 1) * dilation + 1
    pad_total = eff_k - stride
    n_frames = (length - eff_k + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + eff_k - pad_total
    return pad_total, max(ideal - length, 0)


def causal_conv(x: torch.Tensor, p, stride: int = 1, dilation: int = 1,
                pad_mode: str = "constant") -> torch.Tensor:
    """x: [B, T, C]; p["w"]: [K, in, out]. ``pad_mode`` "edge" for
    the learnt 2x downsample (HF Mimi pads by replication there)."""
    k = p["w"].shape[0]
    left, right = _causal_pad(x.shape[1], k, stride, dilation)
    if pad_mode == "edge":
        x = F.pad(x.transpose(1, 2), (left, right), mode="replicate").transpose(1, 2)
    else:
        x = F.pad(x, (0, 0, left, right))
    conv = {"kernel": p["w"]}
    if "b" in p:
        conv["bias"] = p["b"]
    return conv1d(x, conv, stride=stride, dilation=dilation)


def causal_conv_transpose(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """Causal transpose conv: the full output ((T-1)·stride + K samples),
    then ``K - stride`` trimmed from the right (MimiConvTranspose1d,
    trim_right_ratio=1). p["w"]: [K, in/groups, out], taps flipped (the
    reference's ``conv_transpose`` layout); the groups follow from the
    weight's shape (the 2x upsample is depthwise). Each tap is one product
    of the input, overlap-added at its offset."""
    k = p["w"].shape[0]
    y = _conv_transpose_full(x, p, stride)
    if "b" in p:
        y = y + p["b"]
    trim = k - stride
    return y[:, :-trim] if trim > 0 else y


def _conv_transpose_full(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """The untrimmed transposed conv without its bias: (T-1)·stride + K
    samples (``ops/nn.py::conv_transpose1d_full``)."""
    return conv_transpose1d_full(x, p["w"], stride)


# ---------------------------------------------------------------------------
# parameter init (numpy, from a generator; the reference's tree)
# ---------------------------------------------------------------------------

def _conv_p(rng, k, cin, cout, bias=True):
    p = {"w": _normal(rng, (k, cin, cout), 1.0 / np.sqrt(k * cin))}
    if bias:
        p["b"] = np.zeros((cout,), np.float32)
    return p


def _init_seanet_encoder(rng, cfg: MimiConfig):
    f = cfg.num_filters
    conv_in = _conv_p(rng, cfg.kernel_size, 1, f)
    stages = []
    ch = f
    for ratio in reversed(cfg.ratios):
        stages.append({
            "res": {"conv1": _conv_p(rng, cfg.residual_kernel_size, ch, ch // cfg.compress),
                    "conv2": _conv_p(rng, 1, ch // cfg.compress, ch)},
            "down": _conv_p(rng, ratio * 2, ch, ch * 2),
        })
        ch *= 2
    return {"conv_in": conv_in, "stages": stages,
            "conv_out": _conv_p(rng, cfg.last_kernel_size, ch, cfg.hidden)}


def _init_seanet_decoder(rng, cfg: MimiConfig):
    ch = cfg.num_filters * (2 ** cfg.num_stages)
    conv_in = _conv_p(rng, cfg.kernel_size, cfg.hidden, ch)
    stages = []
    for ratio in cfg.ratios:
        stages.append({
            "up": _conv_p(rng, ratio * 2, ch, ch // 2),
            "res": {"conv1": _conv_p(rng, cfg.residual_kernel_size, ch // 2,
                                     ch // (2 * cfg.compress)),
                    "conv2": _conv_p(rng, 1, ch // (2 * cfg.compress), ch // 2)},
        })
        ch //= 2
    return {"conv_in": conv_in, "stages": stages,
            "conv_out": _conv_p(rng, cfg.last_kernel_size, cfg.num_filters, 1)}


def _init_transformer(rng, cfg: MimiConfig):
    layers = []
    d = cfg.hidden
    for _ in range(cfg.transformer_layers):
        layers.append({
            "ln1": _norm(d, bias=True),
            "q": _linear(rng, d, cfg.num_heads * cfg.head_dim, bias=False),
            "k": _linear(rng, d, cfg.num_kv_heads * cfg.head_dim, bias=False),
            "v": _linear(rng, d, cfg.num_kv_heads * cfg.head_dim, bias=False),
            "o": _linear(rng, cfg.num_heads * cfg.head_dim, d, bias=False),
            "attn_scale": np.full((d,), 0.01, np.float32),
            "ln2": _norm(d, bias=True),
            "fc1": _linear(rng, d, cfg.intermediate, bias=False),
            "fc2": _linear(rng, cfg.intermediate, d, bias=False),
            "mlp_scale": np.full((d,), 0.01, np.float32),
        })
    return layers


def _init_rvq(rng, cfg: MimiConfig, n: int):
    return {
        "input_proj": _conv_p(rng, 1, cfg.hidden, cfg.codebook_dim, bias=False),
        "output_proj": _conv_p(rng, 1, cfg.codebook_dim, cfg.hidden, bias=False),
        # EMA codebook stats, embedding = embed_sum / max(cluster_usage, eps)
        "embed_sum": _normal(rng, (n, cfg.codebook_size, cfg.codebook_dim), 0.05),
        "cluster_usage": np.ones((n, cfg.codebook_size), np.float32),
    }


def init_mimi_params(rng: np.random.Generator, cfg: MimiConfig) -> dict:
    """Random Mimi weights drawn with numpy, in the reference's tree."""
    return {
        "encoder": _init_seanet_encoder(rng, cfg),
        "encoder_transformer": _init_transformer(rng, cfg),
        "downsample": _conv_p(rng, 4, cfg.hidden, cfg.hidden, bias=False),
        "quantizer": {
            "semantic": _init_rvq(rng, cfg, 1),
            "acoustic": _init_rvq(rng, cfg, cfg.num_quantizers - 1),
        },
        # depthwise: [K, in/groups=1, out=C]
        "upsample": _conv_p(rng, 4, 1, cfg.hidden, bias=False),
        "decoder_transformer": _init_transformer(rng, cfg),
        "decoder": _init_seanet_decoder(rng, cfg),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _resblock(p, x, dilation: int = 1):
    h = causal_conv(F.elu(x), p["conv1"], dilation=dilation)
    h = causal_conv(F.elu(h), p["conv2"])
    return x + h


def seanet_encode(p, cfg: MimiConfig, audio):
    """audio [B, T] → [B, T/960, hidden]."""
    h = causal_conv(audio[:, :, None], p["conv_in"])
    for stage, ratio in zip(p["stages"], reversed(cfg.ratios)):
        h = _resblock(stage["res"], h)
        h = causal_conv(F.elu(h), stage["down"], stride=ratio)
    return causal_conv(F.elu(h), p["conv_out"])


def seanet_decode(p, cfg: MimiConfig, h):
    """[B, F', hidden] → audio [B, T]."""
    h = causal_conv(h, p["conv_in"])
    for stage, ratio in zip(p["stages"], cfg.ratios):
        h = causal_conv_transpose(F.elu(h), stage["up"], ratio)
        h = _resblock(stage["res"], h)
    return causal_conv(F.elu(h), p["conv_out"])[..., 0]


def mimi_transformer(layers, cfg: MimiConfig, x):
    """Sliding-window causal transformer with LayerScale residuals."""
    b, t, _ = x.shape
    dev = x.device
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(t, device=dev)[None, :]
    keep = (cols <= rows) & (cols > rows - cfg.sliding_window)
    mask = torch.where(keep, 0.0, NEG_INF).to(torch.float32)[None, None]
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    for p in layers:
        h = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"], eps=cfg.norm_eps)
        q = linear(h, p["q"]).reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        k = linear(h, p["k"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        v = linear(h, p["v"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        a = sdpa(q, k, v, 1.0 / np.sqrt(cfg.head_dim), mask)
        a = a.transpose(1, 2).reshape(b, t, -1)
        x = x + linear(a, p["o"]) * p["attn_scale"]
        h = layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"], eps=cfg.norm_eps)
        x = x + linear(F.gelu(linear(h, p["fc1"])), p["fc2"]) * p["mlp_scale"]
    return x


def _codebooks(rvq):
    """EMA stats → embeddings [n, size, dim]."""
    usage = torch.clamp(rvq["cluster_usage"], min=1e-5)
    return rvq["embed_sum"] / usage[..., None]


def _rvq_encode(rvq, x, n: int):
    """x [B, F, hidden] → codes [B, n, F] (int64)."""
    resid = causal_conv(x, rvq["input_proj"])
    books = _codebooks(rvq)
    codes = []
    for i in range(n):
        book = books[i]
        d2 = ((resid ** 2).sum(-1, keepdim=True)
              - 2 * resid @ book.T
              + (book ** 2).sum(-1)[None, None])
        idx = torch.argmin(d2, dim=-1)
        codes.append(idx)
        resid = resid - book[idx]
    return torch.stack(codes, dim=1)


def _rvq_decode(rvq, codes):
    """codes [B, n, F] → [B, F, hidden]."""
    books = _codebooks(rvq)
    summed = sum(books[i][codes[:, i].long()] for i in range(codes.shape[1]))
    return causal_conv(summed, rvq["output_proj"])


def mimi_encode_latent(params, cfg: MimiConfig, audio):
    h = seanet_encode(params["encoder"], cfg, audio)
    h = mimi_transformer(params["encoder_transformer"], cfg, h)
    return causal_conv(h, params["downsample"], stride=2, pad_mode="edge")


def mimi_encode(params, cfg: MimiConfig, audio):
    """audio [B, T] → codes [B, num_quantizers, F] (int64, semantic first)."""
    latent = mimi_encode_latent(params, cfg, audio)
    sem = _rvq_encode(params["quantizer"]["semantic"], latent, 1)
    aco = _rvq_encode(params["quantizer"]["acoustic"], latent, cfg.num_quantizers - 1)
    return torch.cat([sem, aco], dim=1)


def rvq_decode(params, cfg: MimiConfig, codes):
    """codes [B, K, F] → latent [B, F, hidden]."""
    out = _rvq_decode(params["quantizer"]["semantic"], codes[:, :1])
    if codes.shape[1] > 1:
        out = out + _rvq_decode(params["quantizer"]["acoustic"], codes[:, 1:])
    return out


def mimi_decode(params, cfg: MimiConfig, codes):
    """codes [B, K, F] → audio [B, F*1920]."""
    h = rvq_decode(params, cfg, codes)
    h = causal_conv_transpose(h, params["upsample"], 2)
    h = mimi_transformer(params["decoder_transformer"], cfg, h)
    return torch.clamp(seanet_decode(params["decoder"], cfg, h), -1.0, 1.0)


# ---------------------------------------------------------------------------
# Streaming (carried-state) encode/decode: every conv carries its left
# context, every transposed conv its overlap-add tail, and both transformers
# a KV ring of the last ``sliding_window`` positions. Frame by frame, the
# stream equals the batch ``mimi_encode``/``mimi_decode`` of the whole clip:
# the causal left pad is zeros, which is what the zero carries hold. A state
# is a dict of tensors (the transformers' position a host int) that each
# call replaces with a new one.
# ---------------------------------------------------------------------------

def _sconv_init(p, batch: int, dtype, device, stride: int = 1, dilation: int = 1):
    """Carry for a streaming causal conv: the last eff_k - stride inputs."""
    k, cin, _ = p["w"].shape
    n = (k - 1) * dilation + 1 - stride
    return torch.zeros((batch, n, cin), dtype=dtype, device=device)


def _sconv(x, p, carry, stride: int = 1, dilation: int = 1):
    """Streaming ``causal_conv``: x [B, L, C] with L % stride == 0 (no right
    pad is needed). → (y, new carry)."""
    xx = torch.cat([carry, x], dim=1)
    conv = {"kernel": p["w"]}
    if "b" in p:
        conv["bias"] = p["b"]
    return conv1d(xx, conv, stride=stride, dilation=dilation), xx[:, x.shape[1]:]


def _sconv_edge(x, p, carry, first: bool, stride: int):
    """Streaming conv with replicate ("edge") left padding: on the first
    chunk the pad repeats the chunk's first element, as the batch op's
    replicate pad does; afterwards the carry holds real history."""
    if first:
        carry = x[:, :1].expand(-1, carry.shape[1], -1)
    return _sconv(x, p, carry, stride=stride)


def _stconv_init(p, batch: int, dtype, device, stride: int):
    """Carry for a streaming transposed conv: the k - stride output tail
    (bias excluded) that overlap-adds into the next chunk's head."""
    k = p["w"].shape[0]
    return torch.zeros((batch, k - stride, p["w"].shape[2]), dtype=dtype, device=device)


def _stconv(x, p, carry, stride: int):
    """Streaming ``causal_conv_transpose``: emit L·stride samples and carry
    the k - stride tail. The tail leaves out the bias (each output gets it
    once); the last tail is never emitted — the batch op's right trim."""
    k = p["w"].shape[0]
    y = _conv_transpose_full(x, p, stride)
    emit = x.shape[1] * stride
    tail = y[:, emit:]
    y = y[:, :emit].clone()
    y[:, : k - stride] += carry
    if "b" in p:
        y = y + p["b"]
    return y, tail


def _sresblock(p, carry, x):
    h, c1 = _sconv(F.elu(x), p["conv1"], carry)
    h = causal_conv(F.elu(h), p["conv2"])  # k1: no carry
    return x + h, c1


def _xf_stream_init(cfg: MimiConfig, n_layers: int, batch: int, dtype, device):
    shape = (batch, cfg.sliding_window, cfg.num_kv_heads * cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layers)],
            "pos": 0}


def _xf_stream(layers, cfg: MimiConfig, st, x):
    """Streaming ``mimi_transformer`` over t new positions with a ring of
    the last ``sliding_window`` keys and values (keys stored RoPE'd at their
    absolute positions, so the ring is exact). Slot j of the state holds
    position pos0 - w + j; attention runs over [state || new], w + t keys,
    so a chunk's first query still sees its whole window."""
    b, t, _ = x.shape
    w = cfg.sliding_window
    pos0 = st["pos"]
    dev = x.device
    positions = (pos0 + torch.arange(t, device=dev))[None].expand(b, t)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    abs_key = pos0 - w + torch.arange(w + t, device=dev)
    q_abs = pos0 + torch.arange(t, device=dev)
    ok = ((abs_key[None, :] <= q_abs[:, None]) & (abs_key[None, :] > q_abs[:, None] - w)
          & (abs_key[None, :] >= 0))
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[None, None]
    new_k, new_v = [], []
    for li, p in enumerate(layers):
        h = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"], eps=cfg.norm_eps)
        q = linear(h, p["q"]).reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        k = linear(h, p["k"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        v = linear(h, p["v"])
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        kbuf = torch.cat([st["k"][li], k.transpose(1, 2).reshape(b, t, -1)], dim=1)
        vbuf = torch.cat([st["v"][li], v], dim=1)
        new_k.append(kbuf[:, t:])
        new_v.append(vbuf[:, t:])
        kh = kbuf.reshape(b, w + t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        vh = vbuf.reshape(b, w + t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        a = sdpa(q, kh, vh, 1.0 / np.sqrt(cfg.head_dim), mask)
        a = a.transpose(1, 2).reshape(b, t, -1)
        x = x + linear(a, p["o"]) * p["attn_scale"]
        h = layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"], eps=cfg.norm_eps)
        x = x + linear(F.gelu(linear(h, p["fc1"])), p["fc2"]) * p["mlp_scale"]
    return x, {"k": new_k, "v": new_v, "pos": pos0 + t}


def _mimi_dtype_device(params):
    w = params["encoder"]["conv_in"]["w"]
    return w.dtype, w.device


def init_mimi_encoder_stream(params, cfg: MimiConfig, batch: int = 1) -> dict:
    """The encoder's zero state, in the dtype and on the device of ``params``."""
    dt, dev = _mimi_dtype_device(params)
    enc = params["encoder"]
    return {
        "conv_in": _sconv_init(enc["conv_in"], batch, dt, dev),
        "stages": [{
            "res": _sconv_init(s["res"]["conv1"], batch, dt, dev),
            "down": _sconv_init(s["down"], batch, dt, dev, stride=r),
        } for s, r in zip(enc["stages"], reversed(cfg.ratios))],
        "conv_out": _sconv_init(enc["conv_out"], batch, dt, dev),
        "xf": _xf_stream_init(cfg, len(params["encoder_transformer"]), batch, dt, dev),
        "down2": _sconv_init(params["downsample"], batch, dt, dev, stride=2),
        "first": True,
    }


def mimi_encode_frame(params, cfg: MimiConfig, st, audio) -> tuple:
    """One streaming step: audio [B, n·1920] → (codes [B, K, n] int64, new
    state); the stream equals the batch ``mimi_encode`` of the whole clip."""
    enc = params["encoder"]
    st = dict(st)
    h, st["conv_in"] = _sconv(audio[:, :, None], enc["conv_in"], st["conv_in"])
    stages = []
    for s_p, s_st, r in zip(enc["stages"], st["stages"], reversed(cfg.ratios)):
        s_st = dict(s_st)
        h, s_st["res"] = _sresblock(s_p["res"], s_st["res"], h)
        h, s_st["down"] = _sconv(F.elu(h), s_p["down"], s_st["down"], stride=r)
        stages.append(s_st)
    st["stages"] = stages
    h, st["conv_out"] = _sconv(F.elu(h), enc["conv_out"], st["conv_out"])
    h, st["xf"] = _xf_stream(params["encoder_transformer"], cfg, st["xf"], h)
    latent, st["down2"] = _sconv_edge(h, params["downsample"], st["down2"], st["first"],
                                      stride=2)
    st["first"] = False
    sem = _rvq_encode(params["quantizer"]["semantic"], latent, 1)
    aco = _rvq_encode(params["quantizer"]["acoustic"], latent, cfg.num_quantizers - 1)
    return torch.cat([sem, aco], dim=1), st


def init_mimi_decoder_stream(params, cfg: MimiConfig, batch: int = 1) -> dict:
    """The decoder's zero state, in the dtype and on the device of ``params``."""
    dt, dev = _mimi_dtype_device(params)
    dec = params["decoder"]
    return {
        "up2": _stconv_init(params["upsample"], batch, dt, dev, stride=2),
        "xf": _xf_stream_init(cfg, len(params["decoder_transformer"]), batch, dt, dev),
        "conv_in": _sconv_init(dec["conv_in"], batch, dt, dev),
        "stages": [{
            "up": _stconv_init(s["up"], batch, dt, dev, stride=r),
            "res": _sconv_init(s["res"]["conv1"], batch, dt, dev),
        } for s, r in zip(dec["stages"], cfg.ratios)],
        "conv_out": _sconv_init(dec["conv_out"], batch, dt, dev),
    }


def mimi_decode_frame(params, cfg: MimiConfig, st, codes) -> tuple:
    """One streaming step: codes [B, K, n] → (audio [B, n·1920], new state);
    the stream equals the batch ``mimi_decode`` of all the codes."""
    dec = params["decoder"]
    st = dict(st)
    h = rvq_decode(params, cfg, codes)
    h, st["up2"] = _stconv(h, params["upsample"], st["up2"], stride=2)
    h, st["xf"] = _xf_stream(params["decoder_transformer"], cfg, st["xf"], h)
    h, st["conv_in"] = _sconv(h, dec["conv_in"], st["conv_in"])
    stages = []
    for s_p, s_st, r in zip(dec["stages"], st["stages"], cfg.ratios):
        s_st = dict(s_st)
        h, s_st["up"] = _stconv(F.elu(h), s_p["up"], s_st["up"], stride=r)
        h, s_st["res"] = _sresblock(s_p["res"], s_st["res"], h)
        stages.append(s_st)
    st["stages"] = stages
    wav, st["conv_out"] = _sconv(F.elu(h), dec["conv_out"], st["conv_out"])
    return torch.clamp(wav[..., 0], -1.0, 1.0), st
