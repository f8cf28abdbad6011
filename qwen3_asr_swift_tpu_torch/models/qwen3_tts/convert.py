"""Qwen3-TTS checkpoint → param-tree conversion — the port's copy of
``qwen3_asr_swift_tpu/models/qwen3_tts/convert.py`` (numpy only).

Key names follow the published MLX repos as consumed by the reference
loader (reference: Sources/Qwen3TTS/TTSWeightLoading.swift:24-276):
``talker.model.*`` (talker), ``talker.code_predictor.*`` (code predictor),
``decoder.*`` (speech tokenizer decoder), ``speaker_encoder.*`` (x-vector
encoder — handled by the speaker module). MLX group-quantized tensors are
dequantized via core.weights.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ...core.config import detect_bits, detect_size
from ...core.weights import dequantize_mlx
from .config import CONFIG_06B, CONFIG_17B, Qwen3TTSConfig


def detect_tts_config(model_id: str, model_dir=None) -> Qwen3TTSConfig:
    return detect_size(model_id, {"1.7b": CONFIG_17B}, CONFIG_06B)


def load_speaker_config(model_dir) -> dict:
    """Speaker name → codec token id (reference: SpeakerConfig from
    config.json of CustomVoice variants)."""
    cfg_path = Path(model_dir) / "config.json"
    if not cfg_path.exists():
        return {}
    data = json.loads(cfg_path.read_text())
    spk = data.get("speaker_ids") or data.get("talker_config", {}).get("speaker_ids") or {}
    return {str(k).lower(): int(v) for k, v in spk.items()}


class _Loader:
    def __init__(self, flat: Dict[str, np.ndarray], bits: int, group: int, dtype=np.float32):
        self.flat = flat
        self.bits = bits
        self.group = group
        self.dtype = dtype

    def dense(self, name: str) -> np.ndarray:
        w = self.flat[f"{name}.weight"]
        if f"{name}.scales" in self.flat:
            w = dequantize_mlx(w, self.flat[f"{name}.scales"], self.flat[f"{name}.biases"],
                               bits=self.bits, group_size=self.group)
        return w.astype(self.dtype)

    def lin(self, name: str) -> dict:
        # MLX-quantized linears stay packed for the quantized-matmul path
        # (talker/CP steps are the TTS hot loop); embeddings and convs go
        # through dense().
        if f"{name}.scales" in self.flat:
            p = {"codes": self.flat[f"{name}.weight"].astype(np.uint32),
                 "scales": self.flat[f"{name}.scales"].astype(np.float32),
                 "biases": self.flat[f"{name}.biases"].astype(np.float32)}
        else:
            p = {"kernel": np.ascontiguousarray(self.dense(name).T)}
        if f"{name}.bias" in self.flat:
            p["bias"] = self.flat[f"{name}.bias"].astype(self.dtype)
        return p

    def rms(self, name: str) -> dict:
        return {"weight": self.flat[f"{name}.weight"].astype(self.dtype)}

    def ln(self, name: str) -> dict:
        return {"weight": self.flat[f"{name}.weight"].astype(self.dtype),
                "bias": self.flat[f"{name}.bias"].astype(self.dtype)}

    def conv(self, name: str) -> dict:
        """MLX conv1d weight [out, width, in] → [width, in, out]."""
        w = self.flat[f"{name}.weight"]
        p = {"kernel": np.transpose(w, (1, 2, 0)).astype(self.dtype)}
        if f"{name}.bias" in self.flat:
            p["bias"] = self.flat[f"{name}.bias"].astype(self.dtype)
        return p

    def convt(self, name: str) -> dict:
        """MLX ConvTransposed1d weight [out, width, in] → taps flipped →
        [width, in, out].  codec.causal_transpose_conv1d runs
        jax.lax.conv_transpose with transpose_kernel=False, which
        cross-correlates the lhs-dilated input with the kernel as given;
        the upstream op (reference Sources/Qwen3TTS/
        SpeechTokenizerDecoder.swift:51-66 CausalTransposeConv1d) is the
        conv adjoint, so the taps must be mirrored — same convention as
        every other transpose-conv converter in this repo (kokoro,
        personaplex, vibevoice, voxcpm2)."""
        w = self.flat[f"{name}.weight"][:, ::-1, :]
        p = {"kernel": np.ascontiguousarray(
            np.transpose(w, (1, 2, 0))).astype(self.dtype)}
        if f"{name}.bias" in self.flat:
            p["bias"] = self.flat[f"{name}.bias"].astype(self.dtype)
        return p

    def has(self, name: str) -> bool:
        return f"{name}.weight" in self.flat


def _decoder_layers(L: _Loader, prefix: str, n_layers: int) -> list:
    out = []
    for i in range(n_layers):
        p = f"{prefix}.layers.{i}"
        out.append({
            "q_proj": L.lin(f"{p}.self_attn.q_proj"),
            "k_proj": L.lin(f"{p}.self_attn.k_proj"),
            "v_proj": L.lin(f"{p}.self_attn.v_proj"),
            "o_proj": L.lin(f"{p}.self_attn.o_proj"),
            "q_norm": L.rms(f"{p}.self_attn.q_norm"),
            "k_norm": L.rms(f"{p}.self_attn.k_norm"),
            "input_layernorm": L.rms(f"{p}.input_layernorm"),
            "post_attention_layernorm": L.rms(f"{p}.post_attention_layernorm"),
            "mlp": {
                "gate_proj": L.lin(f"{p}.mlp.gate_proj"),
                "up_proj": L.lin(f"{p}.mlp.up_proj"),
                "down_proj": L.lin(f"{p}.mlp.down_proj"),
            },
        })
    return out


def _rvq_codebook(other: dict, prefix: str) -> np.ndarray:
    """Resolve an RVQ codebook the reference's way
    (TTSWeightLoading.swift:285-300): precomputed ``embed`` /
    ``embedding.weight`` first, else the EMA statistics
    ``embedding_sum / clamp(cluster_usage, 1e-7)`` — the raw sum is an
    accumulator, NOT the codebook."""
    for k in (f"{prefix}.embed", f"{prefix}.embedding.weight"):
        if k in other:
            return np.asarray(other[k])
    es = other.get(f"{prefix}.embedding_sum")
    cu = other.get(f"{prefix}.cluster_usage")
    if es is None:
        raise KeyError(f"no codebook tensors under {prefix}")
    if cu is not None:
        return np.asarray(es) / np.maximum(np.asarray(cu), 1e-7)[..., None]
    return np.asarray(es)


def convert_tts_checkpoint(flat: Dict[str, np.ndarray], cfg: Qwen3TTSConfig,
                           bits: int = 4, group: int = 64):
    talker_flat = {}
    cp_flat = {}
    other = {}
    for k, v in flat.items():
        if k.startswith("talker.code_predictor."):
            cp_flat[k[len("talker.code_predictor."):]] = v
        elif k.startswith("talker."):
            talker_flat[k[len("talker."):]] = v
        else:
            other[k] = v

    TL = _Loader(talker_flat, bits, group)
    talker = {
        "text_embedding": TL.dense("model.text_embedding"),
        "codec_embedding": TL.dense("model.codec_embedding"),
        "text_projection": {
            "fc1": TL.lin("text_projection.linear_fc1"),
            "fc2": TL.lin("text_projection.linear_fc2"),
        },
        "codec_head": TL.lin("codec_head"),
        "norm": TL.rms("model.norm"),
        "layers": _decoder_layers(TL, "model", cfg.talker.num_layers),
    }

    CL = _Loader(cp_flat, bits, group)
    ng = cfg.code_predictor.num_code_groups - 1
    cp = {
        "group_embeds": np.stack([CL.dense(f"model.codec_embedding.{i}") for i in range(ng)]),
        "lm_heads": np.stack([np.ascontiguousarray(CL.dense(f"lm_head.{i}").T) for i in range(ng)]),
        "norm": CL.rms("model.norm"),
        "layers": _decoder_layers(CL, "model", cfg.code_predictor.num_layers),
    }
    if CL.has("small_to_mtp_projection"):
        cp["projection"] = CL.lin("small_to_mtp_projection")

    DL = _Loader(other, bits, group)
    ccfg = cfg.codec
    codec = {
        "rvq_first": {
            "codebook": np.stack([_rvq_codebook(
                other, "decoder.quantizer.rvq_first.vq.layers.0._codebook")]),
            "output_proj": DL.conv("decoder.quantizer.rvq_first.output_proj"),
        },
        "rvq_rest": {
            "codebook": np.stack([
                _rvq_codebook(other, f"decoder.quantizer.rvq_rest.vq.layers.{i}._codebook")
                for i in range(ccfg.num_quantizers - 1)
            ]),
            "output_proj": DL.conv("decoder.quantizer.rvq_rest.output_proj"),
        },
        "pre_conv": DL.conv("decoder.pre_conv.conv"),
        "transformer": {
            "input_proj": DL.lin("decoder.pre_transformer.input_proj"),
            "output_proj": DL.lin("decoder.pre_transformer.output_proj"),
            "norm": DL.rms("decoder.pre_transformer.norm"),
            "layers": [],
        },
        "pre_upsample": [
            {"upsample": DL.convt("decoder.upsample.0.0.conv"),
             "convnext": _convnext_from(DL, "decoder.upsample.0.1")},
            {"upsample": DL.convt("decoder.upsample.1.0.conv"),
             "convnext": _convnext_from(DL, "decoder.upsample.1.1")},
        ],
        "input_conv": DL.conv("decoder.decoder.0.conv"),
        "blocks": [],
        "final_snake": _snake_from(other, "decoder.decoder.5"),
        "final_conv": DL.conv("decoder.decoder.6.conv"),
    }
    for i in range(ccfg.num_layers):
        p = f"decoder.pre_transformer.layers.{i}"
        codec["transformer"]["layers"].append({
            "norm1": DL.rms(f"{p}.norm1" if DL.has(f"{p}.norm1") else f"{p}.input_layernorm"),
            "norm2": DL.rms(f"{p}.norm2" if DL.has(f"{p}.norm2") else f"{p}.post_attention_layernorm"),
            "q_proj": DL.lin(f"{p}.self_attn.q_proj"),
            "k_proj": DL.lin(f"{p}.self_attn.k_proj"),
            "v_proj": DL.lin(f"{p}.self_attn.v_proj"),
            "o_proj": DL.lin(f"{p}.self_attn.o_proj"),
            "gate_proj": DL.lin(f"{p}.mlp.gate_proj" if DL.has(f"{p}.mlp.gate_proj") else f"{p}.gate_proj"),
            "up_proj": DL.lin(f"{p}.mlp.up_proj" if DL.has(f"{p}.mlp.up_proj") else f"{p}.up_proj"),
            "down_proj": DL.lin(f"{p}.mlp.down_proj" if DL.has(f"{p}.mlp.down_proj") else f"{p}.down_proj"),
            "attn_scale": other.get(f"{p}.self_attn_layer_scale.scale",
                                    np.full(ccfg.hidden_size, 0.01)).astype(np.float32).reshape(-1),
            "mlp_scale": other.get(f"{p}.mlp_layer_scale.scale",
                                   np.full(ccfg.hidden_size, 0.01)).astype(np.float32).reshape(-1),
        })
    for bi in range(1, 5):  # decoder.decoder.{1..4} = upsample blocks
        p = f"decoder.decoder.{bi}"
        block = {
            "snake": _snake_from(other, f"{p}.block.0" if f"{p}.block.0.alpha" in other else f"{p}.snake"),
            "upsample": DL.convt(f"{p}.block.1.conv" if DL.has(f"{p}.block.1.conv") else f"{p}.upsample.conv"),
            "units": [],
        }
        for ui in range(3):
            base = f"{p}.block.{2 + ui}"
            if f"{base}.snake1.alpha" not in other:
                base = f"{p}.residual_units.{ui}"
            block["units"].append({
                "snake1": _snake_from(other, f"{base}.snake1"),
                "conv1": DL.conv(f"{base}.conv1.conv" if DL.has(f"{base}.conv1.conv") else f"{base}.conv1"),
                "snake2": _snake_from(other, f"{base}.snake2"),
                "conv2": DL.conv(f"{base}.conv2.conv" if DL.has(f"{base}.conv2.conv") else f"{base}.conv2"),
            })
        codec["blocks"].append(block)
    return talker, cp, codec


def _snake_from(flat, prefix) -> dict:
    return {
        "alpha": flat[f"{prefix}.alpha"].astype(np.float32).reshape(-1),
        "beta": flat[f"{prefix}.beta"].astype(np.float32).reshape(-1),
    }


def _convnext_from(L: _Loader, prefix: str) -> dict:
    return {
        "dw": L.conv(f"{prefix}.dwconv.conv" if L.has(f"{prefix}.dwconv.conv") else f"{prefix}.dw_conv.conv"),
        "norm": L.ln(f"{prefix}.norm"),
        "pw1": L.lin(f"{prefix}.pwconv1" if L.has(f"{prefix}.pwconv1") else f"{prefix}.pw_conv1"),
        "pw2": L.lin(f"{prefix}.pwconv2" if L.has(f"{prefix}.pwconv2") else f"{prefix}.pw_conv2"),
        "layer_scale": L.flat[f"{prefix}.layer_scale.scale"].astype(np.float32).reshape(-1),
    }
