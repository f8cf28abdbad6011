"""The port's copy of ``qwen3_asr_swift_tpu/models/chat/convert.py``:
Qwen3.5 chat checkpoint conversion (HF / MLX-quantized layouts), numpy only."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ...core.weights import dequantize_mlx
from .model import ChatConfig


def convert_chat_checkpoint(flat: Dict[str, np.ndarray], cfg: ChatConfig,
                            bits: int = 4, group: int = 64,
                            keep_quantized: bool = True) -> dict:
    f = {k[len("model."):] if k.startswith("model.") else k: v for k, v in flat.items()}

    def packed(name):
        return {"codes": f[f"{name}.weight"].astype(np.uint32),
                "scales": f[f"{name}.scales"].astype(np.float32),
                "biases": f[f"{name}.biases"].astype(np.float32)}

    def dense(name):
        w = f[f"{name}.weight"]
        if f"{name}.scales" in f:
            w = dequantize_mlx(w, f[f"{name}.scales"], f[f"{name}.biases"], bits=bits, group_size=group)
        return w.astype(np.float32)

    def lin(name):
        if keep_quantized and f"{name}.scales" in f:
            return packed(name)
        return {"kernel": np.ascontiguousarray(dense(name).T)}

    def rms(name):
        return {"weight": f[f"{name}.weight"].astype(np.float32)}

    emb = (packed("embed_tokens") if keep_quantized and "embed_tokens.scales" in f
           else dense("embed_tokens"))
    params = {"embed_tokens": emb, "norm": rms("norm"), "layers": []}
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        layer = {
            "input_layernorm": rms(f"{p}.input_layernorm"),
            "post_attention_layernorm": rms(f"{p}.post_attention_layernorm"),
            "mlp": {
                "gate_proj": lin(f"{p}.mlp.gate_proj"),
                "up_proj": lin(f"{p}.mlp.up_proj"),
                "down_proj": lin(f"{p}.mlp.down_proj"),
            },
        }
        if cfg.layer_type(i) == "linear":
            la = f"{p}.linear_attn"
            conv_w = f[f"{la}.conv1d.weight"]  # [C, 1, K] or [C, K, 1]
            conv_w = conv_w.reshape(conv_w.shape[0], -1)
            layer["deltanet"] = {
                "in_proj_qkv": lin(f"{la}.in_proj_qkv"),
                "in_proj_z": lin(f"{la}.in_proj_z"),
                "in_proj_b": lin(f"{la}.in_proj_b"),
                "in_proj_a": lin(f"{la}.in_proj_a"),
                "conv_weight": conv_w.astype(np.float32),
                "dt_bias": f[f"{la}.dt_bias"].astype(np.float32),
                "A_log": f[f"{la}.A_log"].astype(np.float32),
                "norm": rms(f"{la}.norm"),
                "out_proj": lin(f"{la}.out_proj"),
            }
        else:
            sa = f"{p}.self_attn"
            layer["attn"] = {
                "q_proj": lin(f"{sa}.q_proj"),
                "k_proj": lin(f"{sa}.k_proj"),
                "v_proj": lin(f"{sa}.v_proj"),
                "o_proj": lin(f"{sa}.o_proj"),
                "q_norm": rms(f"{sa}.q_norm"),
                "k_norm": rms(f"{sa}.k_norm"),
            }
        params["layers"].append(layer)
    return params
