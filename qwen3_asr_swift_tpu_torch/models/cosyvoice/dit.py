"""CosyVoice3 flow-matching DiT — port of
``qwen3_asr_swift_tpu/models/cosyvoice/dit.py``.

22-layer AdaLN-Zero diffusion transformer (dim 1024, 16 heads × 64, ff_mult
2) with a causal grouped-conv position embedding, RoPE on the first
``dim_head`` features of the flat Q/K (head 0 only, the x_transformers
convention), a classifier-free-guidance Euler ODE with a cosine timestep
schedule, and the token encoder (FSQ embedding → look-ahead and causal
convs → ×2 repeat to the mel rate). Everything is time-major [B, T, C].

The reference runs the ODE as one ``lax.scan``; here it is a loop of
device ops with no host read. Its start noise comes from the caller
(``noise`` of :func:`solve_flow` and :func:`flow_generate`), so one draw
gives one mel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import sdpa
from ...ops.nn import conv1d, linear
from ..qwen3_tts.codec import causal_conv1d


@dataclasses.dataclass(frozen=True)
class CosyDiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 80
    mu_dim: int = 80
    spk_dim: int = 80            # projected speaker dim fed to the DiT
    freq_embed_dim: int = 256
    conv_pos_kernel: int = 31
    conv_pos_groups: Optional[int] = None  # default dim // 64
    rope_base: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    @property
    def pos_groups(self) -> int:
        return self.conv_pos_groups or max(1, self.dim // 64)


@dataclasses.dataclass(frozen=True)
class CosyFlowConfig:
    vocab_size: int = 6561       # FSQ codes
    output_size: int = 80        # mel dim
    spk_embed_dim: int = 192     # raw CAM++ x-vector
    token_mel_ratio: int = 2     # 25 Hz tokens → 50 Hz mel
    pre_lookahead_hidden: int = 1024
    n_timesteps: int = 10
    cfg_rate: float = 0.7
    dit: CosyDiTConfig = dataclasses.field(default_factory=CosyDiTConfig)


def flow_config_tiny() -> CosyFlowConfig:
    return CosyFlowConfig(
        vocab_size=40, output_size=16, spk_embed_dim=8, pre_lookahead_hidden=32,
        n_timesteps=2,
        dit=CosyDiTConfig(dim=64, depth=2, heads=2, dim_head=16, ff_mult=2,
                          mel_dim=16, mu_dim=16, spk_dim=16, freq_embed_dim=16,
                          conv_pos_kernel=7, conv_pos_groups=2),
    )


# -- init (the reference's tree and scales; ``normal(shape, scale)`` draws) ----

def _lin(normal, zeros, d_in, d_out, bias=True):
    p = {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}
    if bias:
        p["bias"] = zeros(d_out)
    return p


def _conv(normal, zeros, width, cin, cout):
    return {"kernel": normal((width, cin, cout), 1.0 / np.sqrt(width * cin)),
            "bias": zeros(cout)}


def draw_flow_params(cfg: CosyFlowConfig, normal, zeros) -> dict:
    d, dc = cfg.dit.dim, cfg.dit
    inner = dc.inner_dim
    in_dim = dc.mel_dim * 2 + dc.mu_dim + dc.spk_dim
    dit = {
        "time_mlp1": _lin(normal, zeros, dc.freq_embed_dim, d),
        "time_mlp2": _lin(normal, zeros, d, d),
        "input_proj": _lin(normal, zeros, in_dim, d),
        "conv_pos1": _conv(normal, zeros, dc.conv_pos_kernel, d // dc.pos_groups, d),
        "conv_pos2": _conv(normal, zeros, dc.conv_pos_kernel, d // dc.pos_groups, d),
        "norm_out_linear": _lin(normal, zeros, d, d * 2),
        "proj_out": _lin(normal, zeros, d, dc.mel_dim),
        "blocks": [{
            "ada_linear": _lin(normal, zeros, d, d * 6),
            "to_q": _lin(normal, zeros, d, inner),
            "to_k": _lin(normal, zeros, d, inner),
            "to_v": _lin(normal, zeros, d, inner),
            "to_out": _lin(normal, zeros, inner, d),
            "ff1": _lin(normal, zeros, d, d * dc.ff_mult),
            "ff2": _lin(normal, zeros, d * dc.ff_mult, d),
        } for _ in range(dc.depth)],
    }
    return {
        "input_embedding": normal((cfg.vocab_size, cfg.output_size), 0.02),
        "spk_affine": _lin(normal, zeros, cfg.spk_embed_dim, cfg.output_size),
        "pre_lookahead": {
            "conv1": _conv(normal, zeros, 4, cfg.output_size, cfg.pre_lookahead_hidden),
            "conv2": _conv(normal, zeros, 3, cfg.pre_lookahead_hidden, cfg.output_size),
        },
        "dit": dit,
    }


# -- building blocks -------------------------------------------------------------

def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _layer_norm_nonaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def timestep_embedding(t: torch.Tensor, p, freq_dim: int) -> torch.Tensor:
    """t [B] in [0, 1] → [B, dim]: sinusoid (scale 1000) → linear → SiLU →
    linear."""
    half = freq_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(ar * (-math.log(10000.0) / (half - 1)))
    angles = 1000.0 * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return linear(F.silu(linear(emb, p["time_mlp1"])), p["time_mlp2"])


def _rope_interleaved(x: torch.Tensor, dim_head: int, base: float) -> torch.Tensor:
    """Rotate the first ``dim_head`` features of x [B, T, inner] with
    interleaved-pair RoPE (after the head reshape: head 0 only)."""
    b, t, _ = x.shape
    rot, rest = x[..., :dim_head], x[..., dim_head:]
    half = dim_head // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None], torch.sin(ang)[None]
    pairs = rot.float().reshape(b, t, half, 2)
    even, odd = pairs[..., 0], pairs[..., 1]
    rot_out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return torch.cat([rot_out.reshape(b, t, dim_head).to(x.dtype), rest], dim=-1)


def conv_pos_embed(x: torch.Tensor, p, cfg: CosyDiTConfig) -> torch.Tensor:
    """Two causal grouped convs + Mish, no internal residual."""
    h = _mish(causal_conv1d(x, p["conv_pos1"], groups=cfg.pos_groups))
    return _mish(causal_conv1d(h, p["conv_pos2"], groups=cfg.pos_groups))


def dit_block(x: torch.Tensor, bp, t_emb: torch.Tensor, mask, cfg: CosyDiTConfig):
    """x [B, T, D], t_emb [B, D], mask additive [B, 1, 1, T] or None."""
    mod = linear(F.silu(t_emb), bp["ada_linear"])
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    h = _layer_norm_nonaffine(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]

    b, t, _ = x.shape
    q = _rope_interleaved(linear(h, bp["to_q"]), cfg.dim_head, cfg.rope_base)
    k = _rope_interleaved(linear(h, bp["to_k"]), cfg.dim_head, cfg.rope_base)
    v = linear(h, bp["to_v"])
    q = q.reshape(b, t, cfg.heads, cfg.dim_head).transpose(1, 2)
    k = k.reshape(b, t, cfg.heads, cfg.dim_head).transpose(1, 2)
    v = v.reshape(b, t, cfg.heads, cfg.dim_head).transpose(1, 2)
    a = sdpa(q, k, v, 1.0 / math.sqrt(cfg.dim_head), mask)
    attn = linear(a.transpose(1, 2).reshape(b, t, -1), bp["to_out"])
    x = x + gate_msa[:, None] * attn

    h2 = _layer_norm_nonaffine(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    ff = linear(F.gelu(linear(h2, bp["ff1"]), approximate="tanh"), bp["ff2"])
    return x + gate_mlp[:, None] * ff


def dit_forward(p, cfg: CosyDiTConfig, x, mu, t, spks=None, cond=None, seq_mask=None):
    """Predict the velocity. x/mu/cond [B, T, mel]; t [B]; spks [B, spk_dim]
    or None; seq_mask [B, T] bool or None. Returns [B, T, mel]."""
    b, t_len, _ = x.shape
    if cond is None:
        cond = torch.zeros_like(x)
    if spks is None:
        spks_exp = torch.zeros((b, t_len, cfg.spk_dim), dtype=x.dtype, device=x.device)
    else:
        spks_exp = spks[:, None, :].expand(b, t_len, cfg.spk_dim).to(x.dtype)

    t_emb = timestep_embedding(t, p, cfg.freq_embed_dim).to(x.dtype)

    h = linear(torch.cat([x, cond, mu, spks_exp], dim=-1), p["input_proj"])
    h = conv_pos_embed(h, p, cfg) + h

    attn_mask = None
    if seq_mask is not None:
        attn_mask = torch.where(seq_mask[:, None, None, :], 0.0, -1e9).float()
    for bp in p["blocks"]:
        h = dit_block(h, bp, t_emb, attn_mask, cfg)

    mod = linear(F.silu(t_emb), p["norm_out_linear"])
    scale, shift = mod.chunk(2, dim=-1)
    h = _layer_norm_nonaffine(h) * (1 + scale[:, None]) + shift[:, None]
    return linear(h, p["proj_out"])


# -- token encoder + CFM solver ----------------------------------------------

def encode_mu(p, cfg: CosyFlowConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] → mu [B, T·ratio, mel]: embed → conv1 (k 4, padded at
    the end: look-ahead), ReLU → conv2 (k 3, causal) → repeat ×ratio."""
    mu = p["input_embedding"][tokens.long()]                      # [B, T, mel]
    k1 = p["pre_lookahead"]["conv1"]["kernel"].shape[0]
    h = F.relu(conv1d(mu, p["pre_lookahead"]["conv1"], padding=((0, k1 - 1),)))
    mu = causal_conv1d(h, p["pre_lookahead"]["conv2"])
    return mu.repeat_interleave(cfg.token_mel_ratio, dim=1)


def project_speaker(p, spk_embedding: torch.Tensor) -> torch.Tensor:
    """L2-normalize the raw x-vector, then affine 192 → 80."""
    norm = torch.sqrt(spk_embedding.square().sum(dim=-1, keepdim=True)) + 1e-8
    return linear(spk_embedding / norm, p["spk_affine"])


def flow_schedule(steps: int):
    """The cosine t-schedule's (starts, steps) as fp32 numpy arrays."""
    lin = np.linspace(0.0, 1.0, steps + 1, dtype=np.float32)
    ts = (np.float32(1.0) - np.cos(lin * np.float32(0.5 * np.pi))).astype(np.float32)
    return ts[:-1], (ts[1:] - ts[:-1]).astype(np.float32)


def solve_flow(p, cfg: CosyFlowConfig, mu, noise, spks=None, cond=None,
               temperature: float = 1.0, n_timesteps: Optional[int] = None):
    """Euler CFM with CFG batch doubling and the cosine t-schedule. mu [B,
    T, mel]; noise [B, T, mel] standard normal (the start is noise ×
    temperature) → mel [B, T, mel]. A loop of device ops, no host read."""
    steps = n_timesteps or cfg.n_timesteps
    b = mu.shape[0]
    x = noise.to(mu.dtype) * temperature
    t_starts, dts = flow_schedule(steps)

    mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks_in = None if spks is None else torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = None if cond is None else torch.cat([cond, torch.zeros_like(cond)], dim=0)
    for t, dt in zip(t_starts.tolist(), dts.tolist()):
        x_in = torch.cat([x, x], dim=0)
        t_in = torch.full((2 * b,), t, dtype=torch.float32, device=mu.device)
        v = dit_forward(p["dit"], cfg.dit, x_in, mu_in, t_in, spks_in, cond_in)
        v_cfg = (1.0 + cfg.cfg_rate) * v[:b] - cfg.cfg_rate * v[b:]
        x = x + dt * v_cfg.to(x.dtype)
    return x


def flow_generate(p, cfg: CosyFlowConfig, tokens, noise, spk_embedding=None,
                  prompt_tokens=None, prompt_feat=None, temperature: float = 1.0):
    """The flow stage: speech tokens [B, T] (with an optional cloning
    prompt) → [B, T_mel, mel]. ``noise`` [B, T_mel, mel] with T_mel =
    (prompt + T)·ratio. prompt_feat [B, T_prompt·ratio, mel] fills the cond
    slot frame-aligned; the caller slices off the prompt's mel frames."""
    if prompt_tokens is not None:
        tokens = torch.cat([prompt_tokens, tokens], dim=1)
    mu = encode_mu(p, cfg, tokens)
    spks = None if spk_embedding is None else project_speaker(p, spk_embedding).to(mu.dtype)
    cond = None
    if prompt_feat is not None:
        pad = mu.shape[1] - prompt_feat.shape[1]
        cond = F.pad(prompt_feat, (0, 0, 0, pad)).to(mu.dtype)
    return solve_flow(p, cfg, mu, noise, spks=spks, cond=cond, temperature=temperature)
