"""VoxCPM2 studio TTS on one device: dual MiniCPM4 LMs + FSQ bottleneck +
patch-level conditional-flow-matching LocDiT + DAC-style AudioVAE (16 kHz
analysis / 48 kHz synthesis); port of
``qwen3_asr_swift_tpu/models/voxcpm2/model.py``.

- **AudioVAE** (``vae.py``): causal encoder to 64-d latents at 25 Hz and a
  transpose-conv decoder to 48 kHz, fp32 whatever the model's dtype.
- **LocEnc**: a bidirectional MiniCPM transformer over each patch of
  latents plus a learned special token, whose output is the patch
  embedding.
- **base_lm / residual_lm**: MiniCPM4 transformers with µP scaling
  (``scale_emb`` on embeddings, ``scale_depth/√L`` residuals); the
  residual LM has no RoPE. Audio positions of the base LM output pass
  through the FSQ layer (in_proj → tanh → round to 2·9+1 levels →
  out_proj).
- **UnifiedCFM / LocDiTV2**: each Euler step runs the DiT over [mu (2
  tokens), time token, cond patch, noisy patch] and CFG-Zero* (zero
  velocity on the first max(1, 4 %) steps — skipped here, as they change
  nothing —, guidance projected onto the negative branch).
- **stop head**: 2-class linear over silu(stop_proj(h)).
- Voice cloning: reference audio is VAE-encoded and spliced into the
  prefix ``[103] ref [104] text`` with complementary text/audio masks.

The patch loop (:func:`generate_patches`) runs device ops only and reads
the stop flag on the host every :data:`STOP_CHECK_PATCHES` patches;
patches after the stop record nothing, so the patches and ``n_steps`` do
not depend on that cadence. The start noise of every CFM solve comes from
the caller ([max_tokens, 1, patch, latent]); :meth:`VoxCPM2TTS.synthesize`
draws it from a ``torch.Generator`` on the model's device seeded with
``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import params_from_jax
from ...core.protocols import SpeechGenerationModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.kv_cache import after_prefill, after_token, init_cache, write_prompt, write_token
from ...ops.nn import acc_dtype, linear, rms_norm, swiglu_mlp, upcast
from .vae import (AudioVAEConfig, CONFIG_VAE, draw_vae_params, vae_config_tiny, vae_decode,
                  vae_encode)

#: the stop flag is read on the host every this many patches (the patch loop
#: otherwise never syncs); what a patch records does not depend on it
STOP_CHECK_PATCHES = 8


class ModDims(NamedTuple):
    """Per-transformer geometry (base/residual/enc/dit differ only here —
    the reference builds them all from one LMConfig, VoxCPM2TTS.swift:75-110)."""
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    inter: int
    rope: bool


@dataclasses.dataclass(frozen=True)
class VoxCPM2Config:
    # base LM (MiniCPM4 — Configuration.swift:39-57)
    hidden_size: int = 2048
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 2
    head_dim: int = 128          # kv_channels
    intermediate_size: int = 6144
    vocab_size: int = 73448
    rope_theta: float = 1e4
    rms_norm_eps: float = 1e-5
    scale_emb: float = 12.0
    scale_depth: float = 1.4
    # residual LM (Configuration.swift:238-239)
    res_layers: int = 8
    # patching / latents (Configuration.swift:234-237)
    latent_dim: int = 64
    patch_size: int = 4
    fsq_latent: int = 512
    fsq_scale: int = 9
    # LocEnc / LocDiT (EncoderConfig/DiTConfig defaults)
    enc_hidden: int = 1024
    enc_layers: int = 12
    enc_heads: int = 16
    enc_inter: int = 4096
    dit_hidden: int = 1024
    dit_layers: int = 12
    dit_heads: int = 16
    #: per-tower head dims (the reference honors per-tower kv_channels;
    #: None = inherit the base LM's head_dim — the published default is a
    #: uniform 128)
    enc_head_dim: Optional[int] = None
    dit_head_dim: Optional[int] = None
    dit_inter: int = 4096
    cfm_steps: int = 10
    cfg_value: float = 2.0
    # AudioVAE
    vae: AudioVAEConfig = CONFIG_VAE
    max_tokens: int = 500
    min_tokens: int = 2
    # special ids (reference: VoxCPM2TTS.swift:1170-1232)
    audio_start_id: int = 103
    audio_end_id: int = 104
    text_end_id: int = 101

    @property
    def sample_rate(self) -> int:
        return self.vae.out_sample_rate

    @property
    def chunk_size(self) -> int:
        return self.vae.hop_length

    def dims(self, which: str) -> ModDims:
        if which == "base":
            return ModDims(self.num_layers, self.hidden_size, self.num_heads,
                           self.num_kv_heads, self.head_dim, self.intermediate_size, True)
        if which == "residual":
            return ModDims(self.res_layers, self.hidden_size, self.num_heads,
                           self.num_kv_heads, self.head_dim, self.intermediate_size, False)
        if which == "enc":
            return ModDims(self.enc_layers, self.enc_hidden, self.enc_heads,
                           self.enc_heads, self.enc_head_dim or self.head_dim,
                           self.enc_inter, True)
        if which == "dit":
            return ModDims(self.dit_layers, self.dit_hidden, self.dit_heads,
                           self.dit_heads, self.dit_head_dim or self.head_dim,
                           self.dit_inter, True)
        raise KeyError(which)


CONFIG_2B = VoxCPM2Config()


def config_tiny() -> VoxCPM2Config:
    return VoxCPM2Config(hidden_size=32, num_layers=2, num_heads=2, num_kv_heads=1,
                         head_dim=16, intermediate_size=64, vocab_size=300,
                         res_layers=1, latent_dim=8, patch_size=2, fsq_latent=8,
                         enc_hidden=16, enc_layers=1, enc_heads=2, enc_inter=32,
                         dit_hidden=16, dit_layers=1, dit_heads=2, dit_inter=32,
                         cfm_steps=2, vae=vae_config_tiny(), max_tokens=6)


# -- init (the reference's tree and scales) -------------------------------------------

def _draw_params(cfg: VoxCPM2Config, normal, zeros, ones) -> dict:
    h, d_lat = cfg.hidden_size, cfg.latent_dim

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}
        if bias:
            p["bias"] = zeros((d_out,))
        return p

    def lm(dims: ModDims):
        return {"layers": [{
            "input_layernorm": {"weight": ones((dims.hidden,))},
            "post_attention_layernorm": {"weight": ones((dims.hidden,))},
            "q_proj": lin(dims.hidden, dims.heads * dims.head_dim, bias=False),
            "k_proj": lin(dims.hidden, dims.kv_heads * dims.head_dim, bias=False),
            "v_proj": lin(dims.hidden, dims.kv_heads * dims.head_dim, bias=False),
            "o_proj": lin(dims.heads * dims.head_dim, dims.hidden, bias=False),
            "mlp": {"gate_proj": lin(dims.hidden, dims.inter, bias=False),
                    "up_proj": lin(dims.hidden, dims.inter, bias=False),
                    "down_proj": lin(dims.inter, dims.hidden, bias=False)},
        } for _ in range(dims.layers)], "norm": {"weight": ones((dims.hidden,))}}

    def mlp(d):
        return {"linear_1": lin(d, 4 * d), "linear_2": lin(4 * d, d)}

    base = lm(cfg.dims("base"))
    base["embed_tokens"] = normal((cfg.vocab_size, h), 0.02)
    return {
        "base_lm": base,
        "residual_lm": lm(cfg.dims("residual")),
        "feat_encoder": {"special_token": zeros((cfg.enc_hidden,)),
                         "in_proj": lin(d_lat, cfg.enc_hidden),
                         "encoder": lm(cfg.dims("enc"))},
        "enc_to_lm_proj": lin(cfg.enc_hidden, h),
        "fsq_layer": {"in_proj": lin(h, cfg.fsq_latent), "out_proj": lin(cfg.fsq_latent, h)},
        "fusion_concat_proj": lin(2 * h, h),
        "lm_to_dit_proj": lin(h, cfg.dit_hidden),
        "res_to_dit_proj": lin(h, cfg.dit_hidden),
        "stop_proj": lin(h, h),
        "stop_head": lin(h, 2, bias=False),
        "feat_decoder": {"estimator": {
            "in_proj": lin(d_lat, cfg.dit_hidden),
            "cond_proj": lin(d_lat, cfg.dit_hidden),
            "out_proj": lin(cfg.dit_hidden, d_lat),
            "time_mlp": mlp(cfg.dit_hidden),
            "delta_time_mlp": mlp(cfg.dit_hidden),
            "decoder": lm(cfg.dims("dit")),
        }},
        "audio_vae": draw_vae_params(cfg.vae, normal, zeros, ones),
    }


def init_voxcpm2_params(rng: np.random.Generator, cfg: VoxCPM2Config) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda shape: np.zeros(shape, np.float32), lambda shape: np.ones(shape, np.float32))


def init_voxcpm2_params_on_device(cfg: VoxCPM2Config, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda shape: torch.zeros(shape, device=dev), lambda shape: torch.ones(shape, device=dev))


# -- MiniCPM core ---------------------------------------------------------------------

def _rope_cos_sin(lm, positions: torch.Tensor, dims: ModDims, cfg, dtype: torch.dtype):
    """LongRoPE cos/sin [..., P, head_dim/2]; factors and scaling from the
    checkpoint when present (1 otherwise)."""
    half = dims.head_dim // 2
    ct = acc_dtype(dtype)
    inv = lm.get("rope_inv_freq")
    if inv is None:
        inv = torch.tensor(np.asarray(1.0 / (cfg.rope_theta ** (np.arange(half) / half)),
                                      np.float32), device=positions.device)
    scale = lm.get("rope_scale", 1.0)
    ang = positions.to(ct)[..., None] * inv.to(ct)
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = upcast(x[..., :half]), upcast(x[..., half:])
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def _minicpm_layer(p, x, cos_sin, mask, dims: ModDims, cfg, cache_layer=None, cursor=None):
    """One layer; with ``cache_layer`` it writes k/v in place, at row 0
    (prefill, attending the prompt's own k/v) or at ``cursor`` (one decode
    step, attending the whole cache)."""
    b, t, _ = x.shape
    hd = dims.head_dim
    res_scale = cfg.scale_depth / np.sqrt(dims.layers)
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    q = linear(h, p["q_proj"]).reshape(b, t, dims.heads, hd).transpose(1, 2)
    k = linear(h, p["k_proj"]).reshape(b, t, dims.kv_heads, hd).transpose(1, 2)
    v = linear(h, p["v_proj"]).reshape(b, t, dims.kv_heads, hd).transpose(1, 2)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = _apply_rope(q, cos[:, None], sin[:, None])
        k = _apply_rope(k, cos[:, None], sin[:, None])
    if cache_layer is not None and cursor is not None:
        upd = write_token(cache_layer, k, v, cursor)
        a = sdpa(q, upd.k, upd.v, 1.0 / np.sqrt(hd), mask)
    else:
        if cache_layer is not None:
            write_prompt(cache_layer, k, v)
        a = sdpa(q, k, v, 1.0 / np.sqrt(hd), mask)
    x = x + linear(a.transpose(1, 2).reshape(b, t, -1), p["o_proj"]) * res_scale
    h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    return x + swiglu_mlp(h2, p["mlp"]) * res_scale


def _lm_forward(lm, x, positions, mask, cache, dims: ModDims, cfg, cursor=None):
    """Causal cached forward for the base/residual LMs: a prefill (``cursor``
    None) or one decode step at ``cursor``; the cache is written in place."""
    cos_sin = _rope_cos_sin(lm, positions, dims, cfg, x.dtype) if dims.rope else None
    for li, p in enumerate(lm["layers"]):
        x = _minicpm_layer(p, x, cos_sin, mask, dims, cfg, cache.layers[li], cursor)
    return rms_norm(x, lm["norm"]["weight"], cfg.rms_norm_eps)


def _bidir_forward(lm, x, dims: ModDims, cfg):
    """Non-causal cacheless forward (the LocEnc and LocDiT decoders)."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    cos_sin = _rope_cos_sin(lm, positions, dims, cfg, x.dtype) if dims.rope else None
    for p in lm["layers"]:
        x = _minicpm_layer(p, x, cos_sin, None, dims, cfg)
    return rms_norm(x, lm["norm"]["weight"], cfg.rms_norm_eps)


# -- sub-modules -----------------------------------------------------------------------

def loc_enc(p, cfg: VoxCPM2Config, patches: torch.Tensor) -> torch.Tensor:
    """patches [B, T, patch, latent] → patch embeddings [B, T, enc_hidden]
    (the special token's output)."""
    b, t, ps, dl = patches.shape
    x = linear(patches.reshape(b * t, ps, dl), p["in_proj"])
    tok = p["special_token"][None, None].expand(b * t, 1, x.shape[-1]).to(x.dtype)
    x = torch.cat([tok, x], dim=1)
    x = _bidir_forward(p["encoder"], x, cfg.dims("enc"), cfg)
    return x[:, 0].reshape(b, t, -1)


def fsq(p, cfg: VoxCPM2Config, x: torch.Tensor) -> torch.Tensor:
    """Scalar quantization: in_proj → tanh → round (half to even) to
    2·scale + 1 levels → out_proj."""
    z = torch.tanh(upcast(linear(x, p["in_proj"])))
    z = torch.round(z * cfg.fsq_scale) / cfg.fsq_scale
    return linear(z.to(x.dtype), p["out_proj"])


def _sinusoid(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """SinusoidalPosEmb: concat(sin, cos) halves, fp32."""
    half = dim // 2
    freqs = torch.exp(float(-np.log(10000.0) / (half - 1))
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    emb = scale * t.float()[..., None] * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], -1)


def _time_mlp(p, emb: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(emb, p["linear_1"])), p["linear_2"])


def dit_velocity(p, cfg: VoxCPM2Config, x, mu, cond, t, dt):
    """LocDiTV2. x, cond [B, patch, latent]; mu [B, 2·dit_hidden]; t, dt
    [B]. The token sequence [mu tokens, time token, cond tokens, x tokens]
    through the bidirectional decoder; returns the velocity [B, patch,
    latent]."""
    est = p["estimator"]
    b = x.shape[0]
    x_tok = linear(x, est["in_proj"])
    c_tok = linear(cond, est["cond_proj"])
    t_emb = _time_mlp(est["time_mlp"], _sinusoid(t, cfg.dit_hidden).to(x_tok.dtype))
    dt_emb = _time_mlp(est["delta_time_mlp"], _sinusoid(dt, cfg.dit_hidden).to(x_tok.dtype))
    time_tok = (t_emb + dt_emb)[:, None]
    mu_tok = mu.reshape(b, -1, cfg.dit_hidden)
    hidden = torch.cat([mu_tok, time_tok, c_tok, x_tok], dim=1)
    decoded = _bidir_forward(est["decoder"], hidden, cfg.dims("dit"), cfg)
    trimmed = decoded[:, mu_tok.shape[1] + 1 + c_tok.shape[1]:]
    return linear(trimmed, est["out_proj"])


def cfm_time_span(n: int) -> np.ndarray:
    """Sway-shaped span (MiniCPM4.swift:152-166): linspace 1→0, then
    t + (cos(π/2·t) − 1 + t) with sway coefficient 1."""
    t = 1.0 - np.arange(n + 1) / n
    return (t + (np.cos(np.pi / 2 * t) - 1.0 + t)).astype(np.float32)


def cfm_sample(p, cfg: VoxCPM2Config, mu, cond, x0: torch.Tensor) -> torch.Tensor:
    """The Euler ODE from the start noise ``x0`` [B, patch, latent] to a
    patch, with CFG-Zero*: zero velocity on the first max(1, 4 %) steps
    (the DiT is not run there: those steps leave x as it is), then
    classifier-free guidance projected onto the negative branch; Δt
    conditioning is zero (non-mean mode)."""
    b = mu.shape[0]
    x = upcast(x0)
    n = cfg.cfm_steps
    t_span = cfm_time_span(n)
    zero_init = max(1, int(n * 0.04))
    dev = mu.device
    for i in range(zero_init, n):
        t = float(t_span[i])
        dt = float(t_span[i] - t_span[i + 1])            # fp32, as the reference's
        out = upcast(dit_velocity(p, cfg, torch.cat([x, x]).to(mu.dtype),
                                  torch.cat([mu, torch.zeros_like(mu)]), torch.cat([cond, cond]),
                                  torch.full((2 * b,), t, device=dev),
                                  torch.zeros((2 * b,), device=dev)))
        pos, neg = out[:b], out[b:]
        pf, nf = pos.reshape(b, -1), neg.reshape(b, -1)
        st = ((pf * nf).sum(1) / ((nf * nf).sum(1) + 1e-8)).reshape(b, 1, 1)
        dphi = neg * st + cfg.cfg_value * (pos - neg * st)
        x = x - dt * dphi
    return x


def start_noise(cfg: VoxCPM2Config, max_tokens: int, generator: torch.Generator):
    """The start of every CFM solve, standard normal [max_tokens, 1, patch,
    latent]."""
    return torch.randn((max_tokens, 1, cfg.patch_size, cfg.latent_dim), generator=generator,
                       device=generator.device)


def _stop_logits(p, lm_hidden: torch.Tensor) -> torch.Tensor:
    return upcast(linear(F.silu(linear(lm_hidden, p["stop_proj"])), p["stop_head"]))


def prefill(p, cfg: VoxCPM2Config, ids, n_valid: int, ref_patches, n_ref: int, max_tokens: int,
            dtype: torch.dtype):
    """The prefix ``[103] ref [104] text`` through both LMs into fresh
    caches: (cache_b, cache_r, lm_hidden [1, H], res_hidden [1, H],
    prefix_cond [1, patch, latent])."""
    dev = p["base_lm"]["embed_tokens"].device
    ids = torch.as_tensor(np.asarray(ids), device=dev).long()
    ref_patches = torch.as_tensor(np.asarray(ref_patches), device=dev).float()
    t_bucket, ref_cap = ids.shape[0], ref_patches.shape[0]
    total = t_bucket + ref_cap + 2
    cache_b = init_cache(cfg.num_layers, 1, cfg.num_kv_heads, total + max_tokens, cfg.head_dim,
                         dtype, device=dev)
    cache_r = init_cache(cfg.res_layers, 1, cfg.num_kv_heads, total + max_tokens, cfg.head_dim,
                         dtype, device=dev)
    tok_ids = torch.cat([torch.tensor([cfg.audio_start_id], device=dev),
                         torch.zeros((ref_cap,), dtype=torch.long, device=dev),
                         torch.tensor([cfg.audio_end_id], device=dev), ids])
    zero = torch.zeros((1, cfg.patch_size, cfg.latent_dim), device=dev)
    patches = torch.cat([zero, ref_patches, zero, zero.expand(t_bucket, -1, -1)])[None]
    idx = torch.arange(total, device=dev)
    text_mask = ((idx == 0) | (idx == ref_cap + 1)
                 | ((idx >= ref_cap + 2) & (idx < ref_cap + 2 + n_valid)))
    audio_mask = (idx >= 1) & (idx < 1 + n_ref)
    valid = text_mask | audio_mask

    feat_embed = linear(loc_enc(p["feat_encoder"], cfg, patches.to(dtype)), p["enc_to_lm_proj"])
    text_embed = p["base_lm"]["embed_tokens"][tok_ids][None] * cfg.scale_emb
    embeds = torch.where(text_mask[None, :, None], text_embed,
                         torch.where(audio_mask[None, :, None], feat_embed, 0.0))
    vi = valid.long()
    positions = ((torch.cumsum(vi, 0) - 1) * vi)[None]
    mask = torch.where((idx[None, :] <= idx[:, None]) & valid[None, :], 0.0,
                       NEG_INF).float()[None, None]
    h_base = _lm_forward(p["base_lm"], embeds, positions, mask, cache_b, cfg.dims("base"), cfg)
    after_prefill(cache_b, valid[None], total)
    masked = torch.where(audio_mask[None, :, None], fsq(p["fsq_layer"], cfg, h_base), h_base)
    res_in = linear(torch.cat([masked, torch.where(audio_mask[None, :, None], feat_embed, 0.0)],
                              -1), p["fusion_concat_proj"])
    h_res = _lm_forward(p["residual_lm"], res_in, positions, mask, cache_r,
                        cfg.dims("residual"), cfg)
    after_prefill(cache_r, valid[None], total)
    # the reference reads the hidden state at (number of valid slots - 1),
    # a slot index in the padded layout: the last text slot only when the
    # reference clip fills all ref_cap slots (ROADMAP §3)
    last = n_valid + n_ref + 1
    ref_last = min(max(n_ref, 1), ref_cap) if n_ref > 0 else 1
    return cache_b, cache_r, masked[:, last], h_res[:, last], patches[0, ref_last].float()[None]


def generate_patches(p, cfg: VoxCPM2Config, ids, n_valid: int, ref_patches, n_ref: int,
                     starts: torch.Tensor, max_tokens: int, dtype: torch.dtype):
    """The reference's ``_generate``: the prefill, then one patch a step
    until the stop head fires after ``min_tokens`` or ``max_tokens`` run.
    ``starts`` [max_tokens, 1, patch, latent] (:func:`start_noise`).
    Returns (patches [max_tokens, patch, latent] fp32, n_steps (0-d),
    {"steps_run", "stop_reads"}); the patch of the step where the stop
    fires is kept."""
    cache_b, cache_r, lm_hidden, res_hidden, prefix_cond = prefill(
        p, cfg, ids, n_valid, ref_patches, n_ref, max_tokens, dtype)
    dev = lm_hidden.device
    out = torch.zeros((max_tokens, cfg.patch_size, cfg.latent_dim), dtype=acc_dtype(dtype),
                      device=dev)
    cols = torch.arange(cache_b.valid.shape[1], device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_steps = torch.zeros((), dtype=torch.long, device=dev)
    steps_run, reads = 0, 0
    for step in range(max_tokens):
        if step and step % STOP_CHECK_PATCHES == 0:
            reads += 1
            if bool(done):
                break
        mu = torch.cat([linear(lm_hidden, p["lm_to_dit_proj"]),
                        linear(res_hidden, p["res_to_dit_proj"])], -1)
        patch = cfm_sample(p["feat_decoder"], cfg, mu, prefix_cond, starts[step])
        out[step] = torch.where(done, out[step], patch[0])
        n_steps = n_steps + (~done).long()
        if step > cfg.min_tokens:
            done = done | (torch.argmax(_stop_logits(p, lm_hidden)[0]) == 1)

        cur = linear(loc_enc(p["feat_encoder"], cfg, patch[:, None].to(dtype)),
                     p["enc_to_lm_proj"])
        pos = cache_b.positions[:, None].clone()
        m = torch.where(cache_b.valid | (cols == cache_b.cursor)[None], 0.0,
                        NEG_INF).float()[:, None, None, :]
        hb = _lm_forward(p["base_lm"], cur, pos, m, cache_b, cfg.dims("base"), cfg,
                         cursor=cache_b.cursor)
        after_token(cache_b)
        lm_hidden = fsq(p["fsq_layer"], cfg, hb[:, 0])
        res_in = linear(torch.cat([lm_hidden[:, None], cur], -1), p["fusion_concat_proj"])
        hr = _lm_forward(p["residual_lm"], res_in, pos, m, cache_r, cfg.dims("residual"), cfg,
                         cursor=cache_r.cursor)
        after_token(cache_r)
        res_hidden = hr[:, 0]
        prefix_cond = upcast(patch)
        steps_run += 1
    return out, n_steps, {"steps_run": steps_run, "stop_reads": reads}


class VoxCPM2TTS(SpeechGenerationModel):
    """VoxCPM2 on one device. ``params`` is a tree in the JAX package's
    layout (numpy arrays or tensors), carried onto ``device`` in ``dtype``;
    the AudioVAE stays fp32 whatever the dtype, as the reference's."""

    def __init__(self, cfg: VoxCPM2Config, params, tokenizer=None,
                 dtype: torch.dtype = torch.float32, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.dtype = dtype
        params = dict(params)  # don't mutate the caller's tree
        vae_params = params.pop("audio_vae", None)
        self.params = params_from_jax(params, self.device, dtype)
        if vae_params is not None:
            self.params["audio_vae"] = params_from_jax(vae_params, self.device, torch.float32)
        #: steps the last patch loop ran, and the host reads of its stop flag
        self.last_loop = {"steps_run": 0, "stop_reads": 0}
        self._loaded = True

    # -- constructors ----------------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Optional[VoxCPM2Config] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "VoxCPM2TTS":
        """Random weights drawn with numpy from ``seed``."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_voxcpm2_params(np.random.default_rng(seed), cfg), device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[VoxCPM2Config] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "VoxCPM2TTS":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``:
        the quick way to build the full-size model."""
        cfg = cfg or CONFIG_2B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_voxcpm2_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "openbmb/VoxCPM2", cache_dir=None,
                        offline_mode: bool = False, dtype: torch.dtype = torch.bfloat16,
                        **kw) -> "VoxCPM2TTS":
        """Load a local checkpoint directory (MLX-format or torch-named
        safetensors, or a ``.pt``/``.pth``/``.bin``; the tokenizer files if
        present); a model id is found in the cache or fetched
        (``core/hub.py``)."""
        from ...core.hub import download_weights
        from ...tokenizers.bpe import BPETokenizer
        from .convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        tokenizer = None
        try:
            tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        except FileNotFoundError:
            pass
        cfg, params = convert_checkpoint(model_dir)
        return cls(cfg, params, tokenizer=tokenizer, dtype=dtype, **kw)

    # -- API ---------------------------------------------------------------------

    def _starts(self, seed: int, max_tokens: int) -> torch.Tensor:
        return start_noise(self.cfg, max_tokens,
                           torch.Generator(device=self.device).manual_seed(seed))

    def encode_reference(self, audio: np.ndarray, sample_rate: int = 48000) -> np.ndarray:
        """Reference audio → patch latents [T, patch, latent] for cloning
        (resampled to the VAE's 16 kHz analysis rate, right-padded to patch
        multiples)."""
        from ...audio.resample import resample

        cfg = self.cfg
        if sample_rate != cfg.vae.sample_rate:
            audio = resample(np.asarray(audio, np.float32), sample_rate, cfg.vae.sample_rate)
        patch_len = cfg.patch_size * cfg.chunk_size
        if len(audio) % patch_len:
            audio = np.pad(audio, (0, patch_len - len(audio) % patch_len))
        with torch.inference_mode():
            lat = vae_encode(self.params["audio_vae"], cfg.vae,
                             torch.as_tensor(np.asarray(audio, np.float32),
                                             device=self.device)[None])[0].cpu().numpy()
        t = len(lat) // cfg.patch_size
        return lat[: t * cfg.patch_size].reshape(t, cfg.patch_size, cfg.latent_dim)

    def prepare(self, text: str, voice: Optional[np.ndarray] = None,
                instruct: Optional[str] = None):
        """The host half of :meth:`synthesize`: (ids [bucket] int32, n_valid,
        ref patches [32, patch, latent], n_ref)."""
        cfg = self.cfg
        full_text = f"{instruct} {text}" if instruct else text
        ids = (self.tokenizer.encode(full_text) if self.tokenizer
               else [5 + (ord(c) % 90) for c in full_text])[:256]
        ids.append(cfg.text_end_id % cfg.vocab_size)
        n = len(ids)
        bucket = max(16, ((n + 15) // 16) * 16)
        arr = np.zeros(bucket, np.int32)
        arr[:n] = ids
        if voice is not None and len(voice):
            ref = self.encode_reference(np.asarray(voice, np.float32))[:32]
        else:
            ref = np.zeros((0, cfg.patch_size, cfg.latent_dim), np.float32)
        ref_cap = 32
        ref_pad = np.zeros((ref_cap, cfg.patch_size, cfg.latent_dim), np.float32)
        ref_pad[: len(ref)] = ref
        return arr, n, ref_pad, len(ref)

    def synthesize(self, text: str, voice: Optional[np.ndarray] = None,
                   instruct: Optional[str] = None, max_tokens: Optional[int] = None,
                   seed: int = 0, **kwargs) -> AudioChunk:
        """voice: raw reference audio at 48 kHz (cloning); instruct: a
        voice-design instruction prepended to the text."""
        cfg = self.cfg
        arr, n, ref_pad, n_ref = self.prepare(text, voice, instruct)
        max_tokens = max_tokens or cfg.max_tokens
        starts = self._starts(seed, max_tokens)
        with torch.inference_mode():
            patches, n_steps, self.last_loop = generate_patches(
                self.params, cfg, arr, n, ref_pad, n_ref, starts, max_tokens, self.dtype)
            n_steps = int(n_steps)
            if n_steps == 0:
                return AudioChunk(np.zeros(0, np.float32), cfg.sample_rate)
            lat = patches[:n_steps].reshape(-1, cfg.latent_dim).float()
            wav = vae_decode(self.params["audio_vae"], cfg.vae, lat[None])
        return AudioChunk(wav[0].cpu().numpy().astype(np.float32), cfg.sample_rate)

    def warm_up(self):
        self.synthesize("hi", max_tokens=2)

    def unload(self):
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self):
        return self._loaded
