"""VoxCPM2 checkpoint conversion.

Maps the published VoxCPM2 checkpoint (the MLX-format safetensors the
reference consumes — module paths are pinned by the reference's
``@ModuleInfo`` keys: Sources/VoxCPM2TTS/VoxCPM2TTS.swift:43-54,
MiniCPM4.swift:232-424, AudioVAE.swift — or the equivalent torch state
dict with the same names) onto the canonical tree in ``model.py``:

  base_lm.{embed_tokens, layers.{i}.self_attn/mlp/…, norm, rope.*}
  residual_lm.*                           (no rope — residualLMNoRope)
  feat_encoder.{special_token, in_proj, encoder.*}
  feat_decoder.estimator.{in_proj, cond_proj, out_proj, time_mlp,
                          delta_time_mlp, decoder.*}
  fsq_layer.{in_proj, out_proj}
  enc_to_lm_proj / lm_to_dit_proj / res_to_dit_proj / fusion_concat_proj /
  stop_proj / stop_head
  audio_vae.encoder.{conv_in, blocks.layers.{i}.{res1..3, snake, conv},
                     fc_mu}
  audio_vae.decoder.{conv_in.layers.{0,1}, blocks.layers.{i}.{snake,
                     conv_t, res1..3}, srCondLayers.layers.{i}.{scale_embed,
                     bias_embed}, snake_out, conv_out}

Weight-norm pairs (``weight_g``/``weight_v``) are fused exactly as the
reference's ``AudioVAE.sanitize`` (AudioVAE.swift:647-683); ``fc_logvar``
is dropped.  Conv weights arrive in MLX [out, k, in/groups] (torch
[out, in/groups, k] also accepted — disambiguated per tensor by matching
the known kernel size) and are rewritten to our NLC [k, in/groups, out];
transpose-conv taps are flipped for the lhs-dilated formulation.  All
model dims are inferred from tensor shapes."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .model import CONFIG_2B, VoxCPM2Config
from .vae import AudioVAEConfig


def _fuse_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    from ...core.weights import fuse_weight_norm

    # the VAE's fc_logvar head is train-time only — drop it after fusing
    return {k: v for k, v in fuse_weight_norm(sd).items() if "fc_logvar" not in k}


def _load_state_dict(src: Path) -> Dict[str, np.ndarray]:
    if src.is_dir():
        from ...core.weights import load_safetensors

        try:
            raw = load_safetensors(src)
        except FileNotFoundError:
            import torch

            cands = sorted(src.glob("*.pt")) + sorted(src.glob("*.pth")) + sorted(src.glob("*.bin"))
            if not cands:
                raise
            obj = torch.load(str(cands[0]), map_location="cpu", weights_only=True)
            for k in ("state_dict", "model"):
                if isinstance(obj, dict) and k in obj and isinstance(obj[k], dict):
                    obj = obj[k]
            raw = {k: v.detach().cpu().float().numpy() for k, v in obj.items()
                   if hasattr(v, "detach")}
    else:
        from safetensors.numpy import load_file

        raw = load_file(str(src))
    raw = {k.replace("module.", ""): np.asarray(v) for k, v in raw.items()}
    # the reference prefixes bare encoder./decoder. VAE keys
    # (AudioVAE.swift:675-683)
    remapped = {}
    for k, v in raw.items():
        if k.startswith(("encoder.", "decoder.")):
            remapped["audio_vae." + k] = v
        else:
            remapped[k] = v
    return _fuse_weight_norm(remapped)


def _lin(sd, name, required=True):
    w = sd.get(f"{name}.weight")
    if w is None:
        if required:
            raise KeyError(f"{name}.weight")
        return None
    p = {"kernel": np.ascontiguousarray(w.T.astype(np.float32))}
    b = sd.get(f"{name}.bias")
    if b is not None:
        p["bias"] = b.astype(np.float32)
    return p


def _conv(sd, name, k_expect: int, *, transpose=False):
    """MLX conv weight [out, k, in/g] (or torch [out, in/g, k]) → HIO
    [k, in/g, out]."""
    w = sd[f"{name}.weight"].astype(np.float32)
    if w.ndim != 3:
        raise ValueError(f"{name}: expected 3-d conv weight, got {w.shape}")
    if w.shape[1] == k_expect and w.shape[2] != k_expect:
        layout = "mlx"          # [O, K, I]
    elif w.shape[2] == k_expect and w.shape[1] != k_expect:
        layout = "torch"        # [O, I, K]
    else:
        layout = "mlx"          # ambiguous (k == in/g) — published repos are MLX
    if layout == "torch":
        w = np.transpose(w, (0, 2, 1))
    w = np.transpose(w, (1, 2, 0))              # [K, I, O]
    if transpose:
        w = w[::-1]                              # flip taps (lhs-dilated form)
    p = {"w": np.ascontiguousarray(w)}
    b = sd.get(f"{name}.bias")
    if b is not None:
        p["b"] = b.astype(np.float32)
    return p


def _snake(sd, name):
    return sd[f"{name}.alpha"].astype(np.float32).reshape(-1)


def _lm(sd, prefix: str, *, embed=False) -> Tuple[dict, dict]:
    """MiniCPM stack → tree; returns (params, dims_info)."""
    n = 0
    while f"{prefix}.layers.{n}.input_layernorm.weight" in sd:
        n += 1
    if n == 0:
        raise KeyError(f"no layers under {prefix}")
    layers = []
    for i in range(n):
        l = f"{prefix}.layers.{i}"
        layers.append({
            "input_layernorm": {"weight": sd[f"{l}.input_layernorm.weight"].astype(np.float32)},
            "post_attention_layernorm": {"weight": sd[f"{l}.post_attention_layernorm.weight"].astype(np.float32)},
            "q_proj": _lin(sd, f"{l}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{l}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{l}.self_attn.v_proj"),
            "o_proj": _lin(sd, f"{l}.self_attn.o_proj"),
            "mlp": {"gate_proj": _lin(sd, f"{l}.mlp.gate_proj"),
                    "up_proj": _lin(sd, f"{l}.mlp.up_proj"),
                    "down_proj": _lin(sd, f"{l}.mlp.down_proj")},
        })
    lm = {"layers": layers, "norm": {"weight": sd[f"{prefix}.norm.weight"].astype(np.float32)}}
    if embed and f"{prefix}.embed_tokens.weight" in sd:
        lm["embed_tokens"] = sd[f"{prefix}.embed_tokens.weight"].astype(np.float32)
    # LongRoPE buffers (MiniCPM4.swift:36-92): effective inv_freq folds the
    # short/long factor; scaling stays 1 when max == original positions.
    inv = sd.get(f"{prefix}.rope.inv_freq")
    if inv is not None:
        factor = sd.get(f"{prefix}.rope.short_factor")
        inv = inv.astype(np.float32)
        if factor is not None:
            inv = inv / factor.astype(np.float32)
        lm["rope_inv_freq"] = inv
    hidden = layers[0]["q_proj"]["kernel"].shape[0]
    q_out = layers[0]["q_proj"]["kernel"].shape[1]
    kv_out = layers[0]["k_proj"]["kernel"].shape[1]
    inter = layers[0]["mlp"]["gate_proj"]["kernel"].shape[1]
    return lm, {"layers": n, "hidden": hidden, "q_out": q_out,
                "kv_out": kv_out, "inter": inter}


def _vae(sd, cfg: AudioVAEConfig) -> Tuple[dict, AudioVAEConfig]:
    p = "audio_vae"
    # infer geometry
    enc_dim = sd[f"{p}.encoder.conv_in.weight"].shape[0]
    latent = sd[f"{p}.encoder.fc_mu.weight"].shape[0]
    n_enc = 0
    while f"{p}.encoder.blocks.layers.{n_enc}.snake.alpha" in sd:
        n_enc += 1
    n_dec = 0
    while f"{p}.decoder.blocks.layers.{n_dec}.snake.alpha" in sd:
        n_dec += 1
    dec_dim = sd[f"{p}.decoder.conv_in.layers.1.weight"].shape[0]

    # kernel = 2·stride; kernels are far smaller than the channel dims, so
    # min(shape[1], shape[2]) picks the tap axis in either MLX or torch layout
    enc_rates, dec_rates = [], []
    for i in range(n_enc):
        w = sd[f"{p}.encoder.blocks.layers.{i}.conv.weight"]
        enc_rates.append(min(w.shape[1], w.shape[2]) // 2)
    for i in range(n_dec):
        w = sd[f"{p}.decoder.blocks.layers.{i}.conv_t.weight"]
        dec_rates.append(min(w.shape[1], w.shape[2]) // 2)
    n_bins = sd[f"{p}.decoder.srCondLayers.layers.0.scale_embed.weight"].shape[0] \
        if f"{p}.decoder.srCondLayers.layers.0.scale_embed.weight" in sd \
        else len(cfg.sr_bin_boundaries) + 1

    cfg = dataclasses.replace(cfg, encoder_dim=enc_dim, latent_dim=latent,
                              decoder_dim=dec_dim,
                              encoder_rates=tuple(enc_rates),
                              decoder_rates=tuple(dec_rates))

    def res_unit(name):
        return {"snake1": _snake(sd, f"{name}.snake1"),
                "conv1": _conv(sd, f"{name}.conv1", 7),
                "snake2": _snake(sd, f"{name}.snake2"),
                "conv2": _conv(sd, f"{name}.conv2", 1)}

    enc_blocks = []
    for i, stride in enumerate(cfg.encoder_rates):
        b = f"{p}.encoder.blocks.layers.{i}"
        enc_blocks.append({
            "res": [res_unit(f"{b}.res{j + 1}") for j in range(3)],
            "snake": _snake(sd, f"{b}.snake"),
            "conv": _conv(sd, f"{b}.conv", 2 * stride),
        })
    encoder = {"conv_in": _conv(sd, f"{p}.encoder.conv_in", 7),
               "blocks": enc_blocks,
               "fc_mu": _conv(sd, f"{p}.encoder.fc_mu", 3)}

    dec_blocks = []
    for i, stride in enumerate(cfg.decoder_rates):
        b = f"{p}.decoder.blocks.layers.{i}"
        din = cfg.decoder_dim // (1 << i)
        scale_key = f"{p}.decoder.srCondLayers.layers.{i}.scale_embed.weight"
        if scale_key in sd:
            scale = sd[scale_key].astype(np.float32).reshape(n_bins, din)
            bias = sd[f"{p}.decoder.srCondLayers.layers.{i}.bias_embed.weight"] \
                .astype(np.float32).reshape(n_bins, din)
        else:
            scale = np.ones((n_bins, din), np.float32)
            bias = np.zeros((n_bins, din), np.float32)
        dec_blocks.append({
            "sr_scale": scale, "sr_bias": bias,
            "snake": _snake(sd, f"{b}.snake"),
            "conv_t": _conv(sd, f"{b}.conv_t", 2 * stride, transpose=True),
            "res": [res_unit(f"{b}.res{j + 1}") for j in range(3)],
        })
    decoder = {"conv_in0": _conv(sd, f"{p}.decoder.conv_in.layers.0", 7),
               "conv_in1": _conv(sd, f"{p}.decoder.conv_in.layers.1", 1),
               "blocks": dec_blocks,
               "snake_out": _snake(sd, f"{p}.decoder.snake_out"),
               "conv_out": _conv(sd, f"{p}.decoder.conv_out", 7)}
    return {"encoder": encoder, "decoder": decoder}, cfg


def map_voxcpm2_state_dict(sd: Dict[str, np.ndarray],
                           config_json: dict | None = None
                           ) -> Tuple[VoxCPM2Config, dict]:
    base, bi = _lm(sd, "base_lm", embed=True)
    residual, ri = _lm(sd, "residual_lm")
    enc, ei = _lm(sd, "feat_encoder.encoder")
    dit, di = _lm(sd, "feat_decoder.estimator.decoder")

    special = sd["feat_encoder.special_token"].astype(np.float32).reshape(-1)
    fsq_in = _lin(sd, "fsq_layer.in_proj")
    if "base_lm.rope.inv_freq" in sd:
        head_dim = 2 * sd["base_lm.rope.inv_freq"].reshape(-1).shape[0]
    elif config_json:
        head_dim = config_json.get("lm_config", {}).get("kv_channels", CONFIG_2B.head_dim)
    else:
        head_dim = CONFIG_2B.head_dim

    vae_params, vae_cfg = _vae(sd, CONFIG_2B.vae)

    def _tower_head_dim(rope_key, cfg_key):
        # per-tower head dim: the tower's own rope buffer is authoritative
        # (the reference honors per-tower kv_channels, Configuration.swift)
        if rope_key in sd:
            return 2 * sd[rope_key].reshape(-1).shape[0]
        return ((config_json or {}).get(cfg_key, {}) or {}).get("kv_channels", head_dim)

    enc_hd = _tower_head_dim("feat_encoder.encoder.rope.inv_freq", "encoder_config")
    dit_hd = _tower_head_dim("feat_decoder.decoder.rope.inv_freq", "dit_config")

    cfg = dataclasses.replace(
        CONFIG_2B,
        hidden_size=bi["hidden"],
        num_layers=bi["layers"],
        num_heads=bi["q_out"] // head_dim,
        num_kv_heads=bi["kv_out"] // head_dim,
        head_dim=head_dim,
        intermediate_size=bi["inter"],
        vocab_size=base["embed_tokens"].shape[0] if "embed_tokens" in base
        else CONFIG_2B.vocab_size,
        res_layers=ri["layers"],
        latent_dim=vae_cfg.latent_dim,
        patch_size=(config_json or {}).get("patch_size", CONFIG_2B.patch_size),
        fsq_latent=fsq_in["kernel"].shape[1],
        enc_hidden=ei["hidden"], enc_layers=ei["layers"],
        enc_heads=ei["q_out"] // enc_hd, enc_inter=ei["inter"],
        enc_head_dim=enc_hd,
        dit_hidden=di["hidden"], dit_layers=di["layers"],
        dit_heads=di["q_out"] // dit_hd, dit_inter=di["inter"],
        dit_head_dim=dit_hd,
        vae=vae_cfg,
    )

    params = {
        "base_lm": base,
        "residual_lm": residual,
        "feat_encoder": {"special_token": special,
                         "in_proj": _lin(sd, "feat_encoder.in_proj"),
                         "encoder": enc},
        "enc_to_lm_proj": _lin(sd, "enc_to_lm_proj"),
        "fsq_layer": {"in_proj": fsq_in, "out_proj": _lin(sd, "fsq_layer.out_proj")},
        "fusion_concat_proj": _lin(sd, "fusion_concat_proj"),
        "lm_to_dit_proj": _lin(sd, "lm_to_dit_proj"),
        "res_to_dit_proj": _lin(sd, "res_to_dit_proj"),
        "stop_proj": _lin(sd, "stop_proj"),
        "stop_head": _lin(sd, "stop_head"),
        "feat_decoder": {"estimator": {
            "in_proj": _lin(sd, "feat_decoder.estimator.in_proj"),
            "cond_proj": _lin(sd, "feat_decoder.estimator.cond_proj"),
            "out_proj": _lin(sd, "feat_decoder.estimator.out_proj"),
            "time_mlp": {
                "linear_1": _lin(sd, "feat_decoder.estimator.time_mlp.linear_1"),
                "linear_2": _lin(sd, "feat_decoder.estimator.time_mlp.linear_2")},
            "delta_time_mlp": {
                "linear_1": _lin(sd, "feat_decoder.estimator.delta_time_mlp.linear_1"),
                "linear_2": _lin(sd, "feat_decoder.estimator.delta_time_mlp.linear_2")},
            "decoder": dit,
        }},
        "audio_vae": vae_params,
    }
    return cfg, params


def convert_checkpoint(src) -> Tuple[VoxCPM2Config, dict]:
    src = Path(src)
    config_json = None
    cj = (src if src.is_dir() else src.parent) / "config.json"
    if cj.exists():
        try:
            config_json = json.loads(cj.read_text())
        except (OSError, json.JSONDecodeError):
            config_json = None
    return map_voxcpm2_state_dict(_load_state_dict(src), config_json)
