"""PL-BERT (ALBERT) phoneme encoder for Kokoro-82M — port of
``qwen3_asr_swift_tpu/models/kokoro/albert.py``.

ALBERT with one shared layer applied ``num_layers`` times: factorized
embedding (vocab 178 → 128 → hidden 768), 12 heads, intermediate 2048,
post-LN, attention through the port's ``sdpa``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.attention import sdpa
from ...ops.nn import gelu, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 178
    embedding_size: int = 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12


def albert_config_tiny() -> AlbertConfig:
    # vocab stays 178: tiny configs must still cover the full phonemizer range
    return AlbertConfig(vocab_size=178, embedding_size=8, hidden_size=16,
                        num_layers=2, num_heads=2, intermediate_size=32,
                        max_position_embeddings=512)


def draw_albert_params(cfg: AlbertConfig, normal, zeros, ones) -> dict:
    """The reference's tree and scales, each leaf from ``normal(shape,
    scale)``, ``zeros(n)`` or ``ones(n)``."""
    e, h = cfg.embedding_size, cfg.hidden_size

    def lin(d_in, d_out):
        return {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in)), "bias": zeros(d_out)}

    def ln(n):
        return {"weight": ones(n), "bias": zeros(n)}

    return {
        "word_embeddings": normal((cfg.vocab_size, e), 0.02),
        "position_embeddings": normal((cfg.max_position_embeddings, e), 0.02),
        "token_type_embeddings": normal((2, e), 0.02),
        "embed_ln": ln(e),
        "embed_proj": lin(e, h),
        # one shared layer (ALBERT weight sharing)
        "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "attn_out": lin(h, h),
        "attn_ln": ln(h),
        "ffn": lin(h, cfg.intermediate_size),
        "ffn_out": lin(cfg.intermediate_size, h),
        "full_ln": ln(h),
    }


def albert_forward(p, cfg: AlbertConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids [B, T] integer, attention_mask [B, T] bool (True = valid)
    → last hidden state [B, T, hidden]."""
    b, t = input_ids.shape
    emb = (p["word_embeddings"][input_ids.long()]
           + p["position_embeddings"][None, :t]
           + p["token_type_embeddings"][0][None, None])
    emb = layer_norm(emb, p["embed_ln"]["weight"], p["embed_ln"]["bias"], eps=cfg.layer_norm_eps)
    x = linear(emb, p["embed_proj"])

    hd = cfg.hidden_size // cfg.num_heads
    mask = torch.where(attention_mask[:, None, None, :], 0.0, -1e9)
    for _ in range(cfg.num_layers):  # shared weights, repeated application
        q = linear(x, p["q"]).reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        k = linear(x, p["k"]).reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        v = linear(x, p["v"]).reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        a = sdpa(q, k, v, 1.0 / np.sqrt(hd), mask)
        attn = linear(a.transpose(1, 2).reshape(b, t, -1), p["attn_out"])
        x = layer_norm(x + attn, p["attn_ln"]["weight"], p["attn_ln"]["bias"],
                       eps=cfg.layer_norm_eps)
        ff = linear(gelu(linear(x, p["ffn"])), p["ffn_out"])
        x = layer_norm(x + ff, p["full_ln"]["weight"], p["full_ln"]["bias"],
                       eps=cfg.layer_norm_eps)
    return x
