"""VibeVoice checkpoint conversion (microsoft/VibeVoice-Realtime layout) —
the port's copy of ``qwen3_asr_swift_tpu/models/vibevoice/convert.py``.

Maps the upstream safetensors keys — ``model.language_model.*`` (bottom
Qwen2 layers), ``model.tts_language_model.*`` (top layers + final norm),
``model.prediction_head.*`` (diffusion head), ``model.acoustic_tokenizer.
{encoder,decoder}.*`` (σ-VAE; SConv nesting ``.conv.conv`` /
``.convtr.convtr``), ``model.acoustic_connector.*``,
``model.tts_eos_classifier.*``, ``model.tts_input_types.weight`` and the
``speech_scaling_factor`` / ``speech_bias_factor`` scalars — into the
canonical tree of :mod:`model` / :mod:`tokenizer` / :mod:`diffusion`.

Key-name source: the reference's loader accepts exactly these spellings
(Sources/VibeVoiceTTS/Inference/WeightLoader.swift — e.g.
``t_embedder.mlp.0`` vs ``t_embedder.mlp.linear1`` variants, the
``.conv.conv`` nesting, ``model.`` prefix). Torch layout fixes applied
once here (Linear transpose, Conv [out,in,k] → [k,in,out], ConvTranspose
[in,out,k] flipped+transposed for jax.lax.conv_transpose).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .model import CONFIG_05B, VibeVoiceConfig


class _Keys:
    def __init__(self, flat: Dict[str, np.ndarray]):
        # strip the "model." wrapper once
        self.flat = {}
        for k, v in flat.items():
            self.flat[k[6:] if k.startswith("model.") else k] = v

    def get(self, *names, required=True) -> Optional[np.ndarray]:
        for n in names:
            if n in self.flat:
                return self.flat[n]
        if required:
            raise KeyError(f"none of {names} in checkpoint "
                           f"(sample keys: {sorted(self.flat)[:6]})")
        return None

    def has(self, name) -> bool:
        return name in self.flat

    def linear(self, *names, required=True):
        w = self.get(*[f"{n}.weight" for n in names], required=required)
        if w is None:
            return None
        p = {"kernel": np.ascontiguousarray(w.T).astype(np.float32)}
        b = self.get(*[f"{n}.bias" for n in names], required=False)
        if b is not None:
            p["bias"] = b.astype(np.float32)
        return p

    def conv(self, *names, required=True):
        """SConv1d: accept X.conv.conv / X.conv / X; torch [out,in,k] →
        [k,in,out]."""
        cands = []
        for n in names:
            cands += [f"{n}.conv.conv.weight", f"{n}.conv.weight", f"{n}.weight"]
        w = self.get(*cands, required=required)
        if w is None:
            return None
        bias = self.get(*[c[:-7] + ".bias" for c in cands], required=False)
        return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0))).astype(np.float32),
                "bias": (bias.astype(np.float32) if bias is not None
                         else np.zeros(w.shape[0], np.float32))}

    def convtr(self, *names, required=True):
        """SConvTranspose1d: [in,out,k] → taps flipped → [k,in,out]
        (jax.lax.conv_transpose with transpose_kernel=False)."""
        cands = []
        for n in names:
            cands += [f"{n}.convtr.convtr.weight", f"{n}.convtr.weight", f"{n}.weight"]
        w = self.get(*cands, required=required)
        if w is None:
            return None
        bias = self.get(*[c[:-7] + ".bias" for c in cands], required=False)
        return {"kernel": np.ascontiguousarray(
                    np.transpose(w[:, :, ::-1], (2, 0, 1))).astype(np.float32),
                "bias": (bias.astype(np.float32) if bias is not None
                         else np.zeros(w.shape[1], np.float32))}

    def rms(self, *names):
        return {"weight": self.get(*[f"{n}.weight" for n in names]).astype(np.float32)}

    def array(self, *names, required=True):
        a = self.get(*names, required=required)
        return None if a is None else a.astype(np.float32)


def _qwen2_layer(k: _Keys, prefix: str) -> dict:
    return {
        "input_layernorm": k.rms(f"{prefix}.input_layernorm"),
        "post_attention_layernorm": k.rms(f"{prefix}.post_attention_layernorm"),
        "q_proj": k.linear(f"{prefix}.self_attn.q_proj"),
        "k_proj": k.linear(f"{prefix}.self_attn.k_proj"),
        "v_proj": k.linear(f"{prefix}.self_attn.v_proj"),
        "o_proj": k.linear(f"{prefix}.self_attn.o_proj"),
        "mlp": {
            "gate_proj": k.linear(f"{prefix}.mlp.gate_proj"),
            "up_proj": k.linear(f"{prefix}.mlp.up_proj"),
            "down_proj": k.linear(f"{prefix}.mlp.down_proj"),
        },
    }


def _connector(k: _Keys, prefix: str) -> dict:
    return {
        "fc1": k.linear(f"{prefix}.fc1"),
        "norm": k.rms(f"{prefix}.norm"),
        "fc2": k.linear(f"{prefix}.fc2"),
    }


def convert_diffusion_head(k: _Keys, cfg: VibeVoiceConfig) -> dict:
    pre = "prediction_head"
    p = {
        "noisy_proj": k.linear(f"{pre}.noisy_images_proj"),
        "cond_proj": k.linear(f"{pre}.cond_proj"),
        "t_mlp1": k.linear(f"{pre}.t_embedder.mlp.0", f"{pre}.t_embedder.mlp.linear1"),
        "t_mlp2": k.linear(f"{pre}.t_embedder.mlp.2", f"{pre}.t_embedder.mlp.linear2"),
        "final_ada": k.linear(f"{pre}.final_layer.adaLN_modulation.1",
                              f"{pre}.final_layer.adaLN_modulation.linear"),
        "final_linear": k.linear(f"{pre}.final_layer.linear"),
        "layers": [],
    }
    fn = k.array(f"{pre}.final_layer.norm_final.weight",
                 f"{pre}.final_layer.norm.weight", required=False)
    p["final_norm"] = {"weight": fn if fn is not None
                       else np.ones(cfg.diffusion.hidden_size, np.float32)}
    i = 0
    while (k.has(f"{pre}.layers.{i}.ffn.gate_proj.weight")):
        lp = f"{pre}.layers.{i}"
        nw = k.array(f"{lp}.norm.weight", required=False)
        p["layers"].append({
            "ada": k.linear(f"{lp}.adaLN_modulation.1", f"{lp}.adaLN_modulation.linear"),
            "norm": {"weight": nw if nw is not None
                     else np.ones(cfg.diffusion.hidden_size, np.float32)},
            "gate_proj": k.linear(f"{lp}.ffn.gate_proj"),
            "up_proj": k.linear(f"{lp}.ffn.up_proj"),
            "down_proj": k.linear(f"{lp}.ffn.down_proj"),
        })
        i += 1
    return p


def _tokenizer_block(k: _Keys, prefixes) -> Optional[dict]:
    for prefix in prefixes:
        if (k.has(f"{prefix}.norm.weight")
                or k.has(f"{prefix}.mixer.conv.conv.weight")
                or k.has(f"{prefix}.mixer.conv.weight")):
            gamma = k.array(f"{prefix}.gamma", required=False)
            ffn_gamma = k.array(f"{prefix}.ffn_gamma", required=False)
            dim = None
            return {
                "norm": k.rms(f"{prefix}.norm"),
                "mixer": k.conv(f"{prefix}.mixer"),
                "gamma": gamma,
                "ffn_norm": k.rms(f"{prefix}.ffn_norm"),
                "ffn1": k.linear(f"{prefix}.ffn.linear1"),
                "ffn2": k.linear(f"{prefix}.ffn.linear2"),
                "ffn_gamma": ffn_gamma,
            }
    return None


def convert_tokenizer_side(k: _Keys, side: str, n_down: int, depths) -> Optional[dict]:
    base = f"acoustic_tokenizer.{side}"
    layer_key = "downsample_layers" if side == "encoder" else "upsample_layers"
    if not any(key.startswith(base) for key in k.flat):
        return None
    out = {layer_key: [], "stages": [], "head": k.conv(f"{base}.head")}
    for i in range(n_down + 1):
        name = f"{base}.{layer_key}.{i}"
        if side == "decoder" and i > 0:
            out[layer_key].append(k.convtr(name))
        else:
            out[layer_key].append(k.conv(name))
    # stages: flat (stages.{j}) or nested (stages.{si}.{bi})
    flat_idx = 0
    for si in range(len(depths)):
        for bi in range(depths[si]):
            blk = _tokenizer_block(k, (f"{base}.stages.{flat_idx}",
                                       f"{base}.stages.{si}.{bi}"))
            if blk is None:
                raise KeyError(f"tokenizer block {side} stage {si} block {bi} not found")
            dim = blk["norm"]["weight"].shape[0]
            if blk["gamma"] is None:
                blk["gamma"] = np.full(dim, 1e-6, np.float32)
            if blk["ffn_gamma"] is None:
                blk["ffn_gamma"] = np.full(dim, 1e-6, np.float32)
            out["stages"].append(blk)
            flat_idx += 1
    return out


def convert_checkpoint(model_dir_or_flat, cfg: VibeVoiceConfig = CONFIG_05B) -> dict:
    """Upstream snapshot dir (safetensors) or pre-loaded flat dict →
    canonical tree. The Realtime-0.5B ships inference-only (no acoustic
    ENCODER weights); encode_voice then raises at runtime, matching the
    reference's hasAcousticEncoder gate."""
    if isinstance(model_dir_or_flat, (str, Path)):
        from ...core.weights import load_safetensors

        flat = load_safetensors(model_dir_or_flat)
    else:
        flat = model_dir_or_flat
    k = _Keys(flat)

    params = {
        "embed_tokens": k.array("language_model.embed_tokens.weight",
                                "language_model.model.embed_tokens.weight"),
        "tts_input_types": k.array("tts_input_types.weight"),
        "lm_layers": [], "tts_layers": [],
        "tts_norm": k.rms("tts_language_model.norm", "tts_language_model.model.norm"),
        "acoustic_connector": _connector(k, "acoustic_connector"),
        "eos_classifier": {
            "fc1": k.linear("tts_eos_classifier.fc1"),
            "fc2": k.linear("tts_eos_classifier.fc2"),
        },
        "prediction_head": convert_diffusion_head(k, cfg),
        "speech_scaling_factor": np.float32(
            k.array("speech_scaling_factor", required=False) if
            k.array("speech_scaling_factor", required=False) is not None else 1.0),
        "speech_bias_factor": np.float32(
            k.array("speech_bias_factor", required=False) if
            k.array("speech_bias_factor", required=False) is not None else 0.0),
    }
    for i in range(cfg.lm_layers):
        params["lm_layers"].append(_qwen2_layer(k, f"language_model.layers.{i}"))
    for i in range(cfg.tts_backbone_layers):
        params["tts_layers"].append(_qwen2_layer(k, f"tts_language_model.layers.{i}"))

    tok_cfg = cfg.tokenizer
    n_down = len(tok_cfg.ratios)
    tok = {"decoder": convert_tokenizer_side(k, "decoder", n_down, tok_cfg.depths)}
    enc = convert_tokenizer_side(k, "encoder", n_down, tok_cfg.depths)
    if enc is not None:
        tok["encoder"] = enc
    params["acoustic_tokenizer"] = tok
    if "semantic_connector.fc1.weight" in k.flat:
        params["semantic_connector"] = _connector(k, "semantic_connector")
    return params
