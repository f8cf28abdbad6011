"""T5/MADLAD checkpoint conversion (HF t5 state dict layout)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .model import T5Config


def convert_t5_checkpoint(flat: Dict[str, np.ndarray], cfg: T5Config) -> dict:
    def lin(name):
        return {"kernel": np.ascontiguousarray(flat[f"{name}.weight"].T).astype(np.float32)}

    def rms(name):
        return {"weight": flat[f"{name}.weight"].astype(np.float32)}

    def attn(base):
        return {"q": lin(f"{base}.q"), "k": lin(f"{base}.k"),
                "v": lin(f"{base}.v"), "o": lin(f"{base}.o")}

    def ffn(base):
        return {"wi_0": lin(f"{base}.wi_0"), "wi_1": lin(f"{base}.wi_1"), "wo": lin(f"{base}.wo")}

    params = {
        "shared": flat["shared.weight"].astype(np.float32),
        "lm_head": lin("lm_head"),
        "enc_rel": flat["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].astype(np.float32),
        "dec_rel": flat["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].astype(np.float32),
        "enc_final_norm": rms("encoder.final_layer_norm"),
        "dec_final_norm": rms("decoder.final_layer_norm"),
        "encoder": [], "decoder": [],
    }
    for i in range(cfg.num_encoder_layers):
        b = f"encoder.block.{i}"
        params["encoder"].append({
            "ln1": rms(f"{b}.layer.0.layer_norm"),
            "attn": attn(f"{b}.layer.0.SelfAttention"),
            "ln2": rms(f"{b}.layer.1.layer_norm"),
            "ffn": ffn(f"{b}.layer.1.DenseReluDense"),
        })
    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}"
        params["decoder"].append({
            "ln1": rms(f"{b}.layer.0.layer_norm"),
            "self_attn": attn(f"{b}.layer.0.SelfAttention"),
            "ln2": rms(f"{b}.layer.1.layer_norm"),
            "cross_attn": attn(f"{b}.layer.1.EncDecAttention"),
            "ln3": rms(f"{b}.layer.2.layer_norm"),
            "ffn": ffn(f"{b}.layer.2.DenseReluDense"),
        })
    return params
