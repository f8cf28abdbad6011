"""Convert PersonaPlex / Moshi-family checkpoints to canonical trees.

Two converters live here:

- :func:`convert_mimi_tree` — the Mimi codec. Accepts the HF
  ``transformers.MimiModel`` state_dict naming (``kyutai/mimi``-style:
  ``encoder.layers.N...``, ``encoder_transformer.layers.N...``,
  ``quantizer.{semantic,acoustic}_residual_vector_quantizer...``), which
  is also what NVIDIA's PersonaPlex repo ships for its codec. Golden
  parity vs torch MimiModel is tested in tests/test_personaplex_convert.py.
- :func:`convert_moshi_tree` — the temporal transformer + depformer,
  accepting HF ``MoshiForConditionalGeneration`` naming (``decoder.model.
  layers...``, ``depth_decoder...``) for the 17-stream LM
  (reference: Sources/PersonaPlex/WeightLoading.swift — per-module weight
  application from the upstream safetensors).

Layout conventions (same across the repo): torch Linear [out,in] →
kernel [in,out]; Conv1d [out,in,K] → [K,in,out]; ConvTranspose1d
[in,out,K] → [K,in,out]; grouped (depthwise) ConvTranspose1d [C,1,K] →
[K,1,C].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .mimi import MimiConfig


def _t(w):  # Linear
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _conv(sd, prefix):
    p = {"w": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"], np.float32).transpose(2, 1, 0))}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return p


def _convT(sd, prefix):
    # torch ConvTranspose1d [in, out, K] → [K, in, out], kernel flipped
    # (jax conv_transpose VALID convolves with the unflipped kernel)
    w = np.asarray(sd[f"{prefix}.weight"], np.float32).transpose(2, 0, 1)[::-1]
    p = {"w": np.ascontiguousarray(w)}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return p


def _transformer_layers(sd: Dict[str, np.ndarray], prefix: str, n: int) -> list:
    layers = []
    for i in range(n):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": {"weight": np.asarray(sd[f"{lp}.input_layernorm.weight"], np.float32),
                    "bias": np.asarray(sd[f"{lp}.input_layernorm.bias"], np.float32)},
            "q": {"kernel": _t(sd[f"{lp}.self_attn.q_proj.weight"])},
            "k": {"kernel": _t(sd[f"{lp}.self_attn.k_proj.weight"])},
            "v": {"kernel": _t(sd[f"{lp}.self_attn.v_proj.weight"])},
            "o": {"kernel": _t(sd[f"{lp}.self_attn.o_proj.weight"])},
            "attn_scale": np.asarray(sd[f"{lp}.self_attn_layer_scale.scale"], np.float32),
            "ln2": {"weight": np.asarray(sd[f"{lp}.post_attention_layernorm.weight"], np.float32),
                    "bias": np.asarray(sd[f"{lp}.post_attention_layernorm.bias"], np.float32)},
            "fc1": {"kernel": _t(sd[f"{lp}.mlp.fc1.weight"])},
            "fc2": {"kernel": _t(sd[f"{lp}.mlp.fc2.weight"])},
            "mlp_scale": np.asarray(sd[f"{lp}.mlp_layer_scale.scale"], np.float32),
        })
    return layers


def _seanet_encoder(sd: Dict[str, np.ndarray], cfg: MimiConfig) -> dict:
    stages = []
    idx = 1
    for _ in cfg.ratios:
        res = {"conv1": _conv(sd, f"encoder.layers.{idx}.block.1.conv"),
               "conv2": _conv(sd, f"encoder.layers.{idx}.block.3.conv")}
        down = _conv(sd, f"encoder.layers.{idx + 2}.conv")
        stages.append({"res": res, "down": down})
        idx += 3
    return {"conv_in": _conv(sd, "encoder.layers.0.conv"),
            "stages": stages,
            "conv_out": _conv(sd, f"encoder.layers.{idx + 1}.conv")}


def _seanet_decoder(sd: Dict[str, np.ndarray], cfg: MimiConfig) -> dict:
    stages = []
    idx = 2
    for _ in cfg.ratios:
        up = _convT(sd, f"decoder.layers.{idx}.conv")
        res = {"conv1": _conv(sd, f"decoder.layers.{idx + 1}.block.1.conv"),
               "conv2": _conv(sd, f"decoder.layers.{idx + 1}.block.3.conv")}
        stages.append({"up": up, "res": res})
        idx += 3
    return {"conv_in": _conv(sd, "decoder.layers.0.conv"),
            "stages": stages,
            "conv_out": _conv(sd, f"decoder.layers.{idx}.conv")}


def _rvq(sd: Dict[str, np.ndarray], prefix: str, n: int) -> dict:
    return {
        "input_proj": {"w": np.ascontiguousarray(
            np.asarray(sd[f"{prefix}.input_proj.weight"], np.float32).transpose(2, 1, 0))},
        "output_proj": {"w": np.ascontiguousarray(
            np.asarray(sd[f"{prefix}.output_proj.weight"], np.float32).transpose(2, 1, 0))},
        "embed_sum": np.stack([np.asarray(sd[f"{prefix}.layers.{i}.codebook.embed_sum"], np.float32)
                               for i in range(n)]),
        "cluster_usage": np.stack([np.asarray(sd[f"{prefix}.layers.{i}.codebook.cluster_usage"], np.float32)
                                   for i in range(n)]),
    }


def dequantize_state_dict(sd: Dict[str, np.ndarray], group_size: int = 64) -> Dict[str, np.ndarray]:
    """Dequantize MLX group-quantized tensors in an upstream state dict:
    any ``X.weight``/``X_weight`` (packed uint32) with sibling
    ``scales``/``biases`` becomes a float matrix; bit width is inferred
    from the packed/scales shapes."""
    from ...core.weights import dequantize_mlx

    out: Dict[str, np.ndarray] = {}
    consumed = set()
    for key, val in sd.items():
        for w_suf, s_suf, b_suf in ((".weight", ".scales", ".biases"),
                                    ("_weight", "_scales", "_biases")):
            if key.endswith(w_suf):
                base = key[: -len(w_suf)]
                s_key, b_key = base + s_suf, base + b_suf
                if s_key in sd and np.asarray(val).dtype == np.uint32:
                    scales = np.asarray(sd[s_key])
                    in_dim = scales.shape[1] * group_size
                    bits = 32 // (in_dim // np.asarray(val).shape[1])
                    out[key] = dequantize_mlx(np.asarray(val), scales,
                                              np.asarray(sd[b_key]), bits, group_size)
                    consumed.update({s_key, b_key})
                break
        if key not in out and key not in consumed:
            out[key] = val
    for key in consumed:
        out.pop(key, None)
    return out


def _rope_traditional_to_half(w: np.ndarray, num_heads: int, head_dim: int) -> np.ndarray:
    """Permute projection output rows so MLX/moshi 'traditional' RoPE
    (rotating pairs (2i, 2i+1)) becomes our split-half RoPE (pairs
    (i, i+hd/2)): new_row[i] = old_row[2i], new_row[i+hd/2] = old_row[2i+1].
    w: [num_heads*head_dim, in]."""
    w = w.reshape(num_heads, head_dim, -1)
    half = head_dim // 2
    perm = np.empty(head_dim, np.int64)
    perm[:half] = np.arange(half) * 2
    perm[half:] = np.arange(half) * 2 + 1
    return np.ascontiguousarray(w[:, perm].reshape(num_heads * head_dim, -1))


def convert_moshi_tree(sd: Dict[str, np.ndarray], cfg) -> dict:
    """Upstream PersonaPlex/Moshi checkpoint → canonical temporal+depformer
    tree. Accepts the kyutai naming the reference consumes
    (reference: Sources/PersonaPlex/WeightLoading.swift:112-256 —
    temporal ``layers.N.self_attn.in_proj_weight`` packed QKV,
    ``gating.linear_in/out``, RMSNorm ``.alpha`` [1,1,D]; depformer
    per-step MultiLinear banks and ``depformer_in.{k}`` /
    ``depformer_emb.{k}`` / ``linears.{k}``; embeddings ``text_emb`` /
    ``emb.{k}`` / ``text_linear``). Quantized (MLX int4) tensors must be
    dequantized upstream first. ``cfg``: PersonaPlexConfig."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def norm_w(prefix):
        a = np.asarray(sd[f"{prefix}.alpha"], np.float32)
        return {"weight": a.reshape(-1)}

    d, hd, nh = cfg.d_model, cfg.head_dim, cfg.num_heads
    layers = []
    for i in range(cfg.num_layers):
        lp = f"layers.{i}"
        in_proj = np.asarray(sd[f"{lp}.self_attn.in_proj_weight"], np.float32)  # [3D, D]
        q_w, k_w, v_w = in_proj[:d], in_proj[d:2 * d], in_proj[2 * d:]
        q_w = _rope_traditional_to_half(q_w, nh, hd)
        k_w = _rope_traditional_to_half(k_w, nh, hd)
        gating_in = np.asarray(sd[f"{lp}.gating.linear_in.weight"], np.float32)  # [2F, D]
        f = gating_in.shape[0] // 2
        layers.append({
            "input_layernorm": norm_w(f"{lp}.norm1"),
            "post_attention_layernorm": norm_w(f"{lp}.norm2"),
            "q_proj": {"kernel": _t(q_w)},
            "k_proj": {"kernel": _t(k_w)},
            "v_proj": {"kernel": _t(v_w)},
            "o_proj": {"kernel": _t(sd[f"{lp}.self_attn.out_proj.weight"])},
            "mlp": {
                "gate_proj": {"kernel": _t(gating_in[:f])},
                "up_proj": {"kernel": _t(gating_in[f:])},
                "down_proj": {"kernel": _t(sd[f"{lp}.gating.linear_out.weight"])},
            },
        })

    s, dd = cfg.num_codebooks, cfg.dep_d_model
    dep_layers = []
    for i in range(cfg.dep_layers):
        lp = f"depformer.layers.{i}"
        in_proj = np.asarray(sd[f"{lp}.self_attn.in_proj_weight"], np.float32)   # [S*3dd, dd]
        out_proj = np.asarray(sd[f"{lp}.self_attn.out_proj_weight"], np.float32)  # [S*dd, dd]
        gin = np.stack([_t(sd[f"{lp}.gating.{k}.linear_in.weight"]) for k in range(s)])
        gout = np.stack([_t(sd[f"{lp}.gating.{k}.linear_out.weight"]) for k in range(s)])
        dep_layers.append({
            "norm1": norm_w(f"{lp}.norm1"),
            "norm2": norm_w(f"{lp}.norm2"),
            "in_proj": np.stack([_t(in_proj[k * 3 * dd:(k + 1) * 3 * dd]) for k in range(s)]),
            "out_proj": np.stack([_t(out_proj[k * dd:(k + 1) * dd]) for k in range(s)]),
            "gating_in": gin,
            "gating_out": gout,
        })

    return {
        "text_embed": np.asarray(sd["text_emb.weight"], np.float32),
        "audio_embed": np.stack([np.asarray(sd[f"emb.{k}.weight"], np.float32)
                                 for k in range(2 * cfg.temporal_codebooks)]),
        "text_head": {"kernel": _t(sd["text_linear.weight"])},
        "norm": norm_w("out_norm"),
        "layers": layers,
        "dep_in": np.stack([_t(sd[f"depformer_in.{k}.weight"]) for k in range(s)]),
        "dep_text_emb": np.asarray(sd["depformer_text_emb.weight"], np.float32),
        "dep_embed": np.stack([np.asarray(sd[f"depformer_emb.{k}.weight"], np.float32)
                               for k in range(s - 1)]),
        "dep_heads_bank": np.stack([_t(sd[f"linears.{k}.weight"]) for k in range(s)]),
        "dep_layers": dep_layers,
    }


def export_moshi_state_dict(params: dict, cfg) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_moshi_tree` (synthetic round-trip tests)."""
    d, hd, nh = cfg.d_model, cfg.head_dim, cfg.num_heads
    sd: Dict[str, np.ndarray] = {}

    def inv_rope(w):  # inverse of _rope_traditional_to_half on [out, in]
        w = w.reshape(nh, hd, -1)
        half = hd // 2
        inv = np.empty(hd, np.int64)
        inv[np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])] = np.arange(hd)
        return w[:, inv].reshape(nh * hd, -1)

    sd["text_emb.weight"] = np.asarray(params["text_embed"])
    for k in range(2 * cfg.temporal_codebooks):
        sd[f"emb.{k}.weight"] = np.asarray(params["audio_embed"][k])
    sd["text_linear.weight"] = np.asarray(params["text_head"]["kernel"]).T
    sd["out_norm.alpha"] = np.asarray(params["norm"]["weight"]).reshape(1, 1, -1)
    for i, lp_params in enumerate(params["layers"]):
        lp = f"layers.{i}"
        q = inv_rope(np.asarray(lp_params["q_proj"]["kernel"]).T)
        kk = inv_rope(np.asarray(lp_params["k_proj"]["kernel"]).T)
        v = np.asarray(lp_params["v_proj"]["kernel"]).T
        sd[f"{lp}.self_attn.in_proj_weight"] = np.concatenate([q, kk, v])
        sd[f"{lp}.self_attn.out_proj.weight"] = np.asarray(lp_params["o_proj"]["kernel"]).T
        sd[f"{lp}.gating.linear_in.weight"] = np.concatenate(
            [np.asarray(lp_params["mlp"]["gate_proj"]["kernel"]).T,
             np.asarray(lp_params["mlp"]["up_proj"]["kernel"]).T])
        sd[f"{lp}.gating.linear_out.weight"] = np.asarray(lp_params["mlp"]["down_proj"]["kernel"]).T
        sd[f"{lp}.norm1.alpha"] = np.asarray(lp_params["input_layernorm"]["weight"]).reshape(1, 1, -1)
        sd[f"{lp}.norm2.alpha"] = np.asarray(lp_params["post_attention_layernorm"]["weight"]).reshape(1, 1, -1)

    s = cfg.num_codebooks
    for k in range(s):
        sd[f"depformer_in.{k}.weight"] = np.asarray(params["dep_in"][k]).T
        sd[f"linears.{k}.weight"] = np.asarray(params["dep_heads_bank"][k]).T
    sd["depformer_text_emb.weight"] = np.asarray(params["dep_text_emb"])
    for k in range(s - 1):
        sd[f"depformer_emb.{k}.weight"] = np.asarray(params["dep_embed"][k])
    for i, lp_params in enumerate(params["dep_layers"]):
        lp = f"depformer.layers.{i}"
        sd[f"{lp}.self_attn.in_proj_weight"] = np.concatenate(
            [np.asarray(lp_params["in_proj"][k]).T for k in range(s)])
        sd[f"{lp}.self_attn.out_proj_weight"] = np.concatenate(
            [np.asarray(lp_params["out_proj"][k]).T for k in range(s)])
        for k in range(s):
            sd[f"{lp}.gating.{k}.linear_in.weight"] = np.asarray(lp_params["gating_in"][k]).T
            sd[f"{lp}.gating.{k}.linear_out.weight"] = np.asarray(lp_params["gating_out"][k]).T
        sd[f"{lp}.norm1.alpha"] = np.asarray(lp_params["norm1"]["weight"]).reshape(1, 1, -1)
        sd[f"{lp}.norm2.alpha"] = np.asarray(lp_params["norm2"]["weight"]).reshape(1, 1, -1)
    return sd


def normalize_mimi_keys(sd: Dict[str, np.ndarray], cfg: Optional[MimiConfig] = None
                        ) -> Dict[str, np.ndarray]:
    """Best-effort rename of kyutai/moshi-format Mimi keys
    (``encoder.model.N.conv.conv.weight``, ``encoder_transformer.
    transformer.layers.N.in_proj_weight``, ``quantizer.rvq_first...``) to
    the HF MimiModel naming convert_mimi_tree consumes. HF-named dicts
    pass through untouched. Attention q/k rows are permuted from
    traditional to split-half RoPE."""
    if not any(k.startswith("encoder.model.") for k in sd):
        return sd
    cfg = cfg or MimiConfig()
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        k = key
        k = k.replace("encoder.model.", "encoder.layers.")
        k = k.replace("decoder.model.", "decoder.layers.")
        k = k.replace(".convtr.convtr.", ".conv.")
        k = k.replace(".conv.conv.", ".conv.")
        k = k.replace("encoder_transformer.transformer.layers.", "encoder_transformer.layers.")
        k = k.replace("decoder_transformer.transformer.layers.", "decoder_transformer.layers.")
        k = k.replace(".norm1.", ".input_layernorm.")
        k = k.replace(".norm2.", ".post_attention_layernorm.")
        k = k.replace(".linear1.weight", ".mlp.fc1.weight")
        k = k.replace(".linear2.weight", ".mlp.fc2.weight")
        k = k.replace(".layer_scale_1.scale", ".self_attn_layer_scale.scale")
        k = k.replace(".layer_scale_2.scale", ".mlp_layer_scale.scale")
        k = k.replace("quantizer.rvq_first.", "quantizer.semantic_residual_vector_quantizer.")
        k = k.replace("quantizer.rvq_rest.", "quantizer.acoustic_residual_vector_quantizer.")
        k = k.replace(".vq.layers.", ".layers.")
        k = k.replace("._codebook.", ".codebook.")
        k = k.replace(".embedding_sum", ".embed_sum")
        if ".self_attn.in_proj_weight" in k:
            d = val.shape[0] // 3
            nh = cfg.num_heads
            hd = d // nh
            base = k.replace(".self_attn.in_proj_weight", "")
            out[f"{base}.self_attn.q_proj.weight"] = _rope_traditional_to_half(val[:d], nh, hd)
            out[f"{base}.self_attn.k_proj.weight"] = _rope_traditional_to_half(val[d:2 * d], nh, hd)
            out[f"{base}.self_attn.v_proj.weight"] = val[2 * d:]
            continue
        k = k.replace(".self_attn.out_proj.weight", ".self_attn.o_proj.weight")
        out[k] = val
    return out


def convert_mimi_tree(sd: Dict[str, np.ndarray], cfg: Optional[MimiConfig] = None) -> dict:
    """HF MimiModel state_dict (numpy values) → canonical Mimi pytree.
    kyutai-format dicts are normalized first (normalize_mimi_keys)."""
    cfg = cfg or MimiConfig()
    sd = normalize_mimi_keys(sd, cfg)
    # depthwise transpose upsample: torch [C, 1, K] → [K, 1, C], flipped
    up_w = np.asarray(sd["upsample.conv.weight"], np.float32)
    return {
        "encoder": _seanet_encoder(sd, cfg),
        "encoder_transformer": _transformer_layers(sd, "encoder_transformer", cfg.transformer_layers),
        "downsample": {"w": np.ascontiguousarray(
            np.asarray(sd["downsample.conv.weight"], np.float32).transpose(2, 1, 0))},
        "quantizer": {
            "semantic": _rvq(sd, "quantizer.semantic_residual_vector_quantizer", 1),
            "acoustic": _rvq(sd, "quantizer.acoustic_residual_vector_quantizer", cfg.num_quantizers - 1),
        },
        "upsample": {"w": np.ascontiguousarray(up_w.transpose(2, 1, 0)[::-1])},
        "decoder_transformer": _transformer_layers(sd, "decoder_transformer", cfg.transformer_layers),
        "decoder": _seanet_decoder(sd, cfg),
    }
