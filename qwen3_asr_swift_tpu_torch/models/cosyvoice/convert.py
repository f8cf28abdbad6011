"""CosyVoice3 checkpoint conversion — the port's copy of
``qwen3_asr_swift_tpu/models/cosyvoice/convert.py`` (``_load_state`` reads
safetensors through the port's bf16-capable reader).

Maps the upstream FunAudioLLM/CosyVoice checkpoint trio (``llm.pt`` /
``flow.pt`` / ``hift.pt``, or their safetensors exports) into the canonical
param trees consumed by :mod:`model`, :mod:`dit` and :mod:`hift`.

Key-name sources: the upstream module hierarchy as documented in the
reference's loader (Sources/CosyVoiceTTS/WeightLoading.swift:16-330 — e.g.
``decoder.time_embed.time_mlp.0``, ``transformer_blocks.{i}.attn.to_q``,
``ff.ff.0.0``, ``f0_predictor.condnet.{2i}``, ``m_source.l_linear``) and the
upstream CosyVoice repo layout (``llm.model.model.layers.{i}.*`` for the
Qwen2 backbone, ``llm_decoder`` head, ``speech_embedding``). Layout fixes
applied here once: torch Linear ``[out,in]`` → kernel ``[in,out]``; torch
Conv1d ``[out,in,k]`` → kernel ``[k,in,out]``; torch weight-norm pairs
(``weight_g``/``weight_v`` or ``parametrizations.weight.original{0,1}``)
fused into a plain weight.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .dit import CosyDiTConfig, CosyFlowConfig
from .hift import CosyHiFTConfig
from .model import CosyVoiceConfig, CONFIG_05B


# -- generic helpers -----------------------------------------------------------

from ...core.weights import fuse_weight_norm as _fuse_weight_norm  # noqa: E402


def _strip_prefixes(flat: Dict[str, np.ndarray], prefixes) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in flat.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


class _Keys:
    """Tolerant key resolution: try several upstream spellings."""

    def __init__(self, flat: Dict[str, np.ndarray]):
        self.flat = flat
        self.used = set()

    def get(self, *names, required=True) -> Optional[np.ndarray]:
        for n in names:
            if n in self.flat:
                self.used.add(n)
                return self.flat[n]
        if required:
            raise KeyError(f"none of {names} found in checkpoint "
                           f"(have e.g. {sorted(self.flat)[:8]}...)")
        return None

    def linear(self, *names, required=True):
        w = self.get(*[f"{n}.weight" for n in names], required=required)
        if w is None:
            return None
        p = {"kernel": np.ascontiguousarray(w.T).astype(np.float32)}
        b = self.get(*[f"{n}.bias" for n in names], required=False)
        if b is not None:
            p["bias"] = b.astype(np.float32)
        return p

    def conv1d(self, *names, required=True):
        """torch [out, in/groups, k] → [k, in/groups, out]."""
        w = self.get(*[f"{n}.weight" for n in names], required=required)
        if w is None:
            return None
        p = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0))).astype(np.float32)}
        b = self.get(*[f"{n}.bias" for n in names], required=False)
        if b is not None:
            p["bias"] = b.astype(np.float32)
        else:
            p["bias"] = np.zeros(w.shape[0], np.float32)
        return p

    def array(self, *names, required=True):
        a = self.get(*names, required=required)
        return None if a is None else a.astype(np.float32)


# -- LLM (Qwen2.5-0.5B backbone + speech embedding/head) -------------------------

def convert_llm(flat: Dict[str, np.ndarray], cfg: CosyVoiceConfig = CONFIG_05B) -> dict:
    """Upstream ``llm.pt`` state dict → LLM part of the canonical tree.

    Upstream names the Qwen2 backbone ``llm.model.model.*`` (a transformers
    Qwen2ForCausalLM wrapped twice); the speech token embedding is
    ``speech_embedding`` and the head ``llm_decoder``.
    """
    flat = _fuse_weight_norm(flat)
    k = _Keys(flat)

    def backbone(suffix: str) -> tuple:
        return (f"llm.model.model.{suffix}", f"llm.model.{suffix}",
                f"model.{suffix}", suffix)

    params = {
        "text_embed": k.array(*backbone("embed_tokens.weight"), "text_embedding.weight"),
        "speech_embed": k.array("speech_embedding.weight"),
        "speech_head": k.linear("llm_decoder", "speech_head"),
        "norm": {"weight": k.array(*backbone("norm.weight"))},
        "layers": [],
    }
    n_layers = 0
    while any(f"{p}.input_layernorm.weight" in flat
              for p in backbone(f"layers.{n_layers}")):
        n_layers += 1
    for i in range(n_layers):
        b = backbone(f"layers.{i}")

        def sub(name):
            return tuple(f"{p}.{name}" for p in b)

        params["layers"].append({
            "input_layernorm": {"weight": k.array(*sub("input_layernorm.weight"))},
            "post_attention_layernorm": {"weight": k.array(*sub("post_attention_layernorm.weight"))},
            "q_proj": k.linear(*sub("self_attn.q_proj")),
            "k_proj": k.linear(*sub("self_attn.k_proj")),
            "v_proj": k.linear(*sub("self_attn.v_proj")),
            "o_proj": k.linear(*sub("self_attn.o_proj")),
            "mlp": {
                "gate_proj": k.linear(*sub("mlp.gate_proj")),
                "up_proj": k.linear(*sub("mlp.up_proj")),
                "down_proj": k.linear(*sub("mlp.down_proj")),
            },
        })
    return params


# -- Flow (token encoder + DiT) ---------------------------------------------------

def convert_flow(flat: Dict[str, np.ndarray],
                 cfg: CosyFlowConfig = CONFIG_05B.flow) -> dict:
    """Upstream ``flow.pt`` state dict → flow param tree.

    DiT keys may sit under ``decoder.estimator.*`` (upstream CFM wrapper) or
    ``decoder.*`` (reference-converted layout) — both accepted.
    """
    flat = _fuse_weight_norm(flat)
    k = _Keys(flat)

    def dit_names(suffix: str) -> tuple:
        return (f"decoder.estimator.{suffix}", f"decoder.{suffix}", f"estimator.{suffix}")

    dit = {
        "time_mlp1": k.linear(*dit_names("time_embed.time_mlp.0")),
        "time_mlp2": k.linear(*dit_names("time_embed.time_mlp.2")),
        "input_proj": k.linear(*dit_names("input_embed.proj")),
        "conv_pos1": k.conv1d(*dit_names("input_embed.conv_pos_embed.conv1.0"),
                              *dit_names("input_embed.conv_pos_embed.conv1")),
        "conv_pos2": k.conv1d(*dit_names("input_embed.conv_pos_embed.conv2.0"),
                              *dit_names("input_embed.conv_pos_embed.conv2")),
        "norm_out_linear": k.linear(*dit_names("norm_out.linear")),
        "proj_out": k.linear(*dit_names("proj_out")),
        "blocks": [],
    }
    i = 0
    while any(f"{n}.attn.to_q.weight" in flat
              for n in dit_names(f"transformer_blocks.{i}")):
        b = f"transformer_blocks.{i}"
        dit["blocks"].append({
            "ada_linear": k.linear(*dit_names(f"{b}.attn_norm.linear")),
            "to_q": k.linear(*dit_names(f"{b}.attn.to_q")),
            "to_k": k.linear(*dit_names(f"{b}.attn.to_k")),
            "to_v": k.linear(*dit_names(f"{b}.attn.to_v")),
            "to_out": k.linear(*dit_names(f"{b}.attn.to_out.0"),
                               *dit_names(f"{b}.attn.to_out")),
            "ff1": k.linear(*dit_names(f"{b}.ff.ff.0.0"), *dit_names(f"{b}.ff.linear1")),
            "ff2": k.linear(*dit_names(f"{b}.ff.ff.2"), *dit_names(f"{b}.ff.linear2")),
        })
        i += 1

    return {
        "input_embedding": k.array("input_embedding.weight"),
        "spk_affine": k.linear("spk_embed_affine_layer"),
        "pre_lookahead": {
            "conv1": k.conv1d("pre_lookahead_layer.conv1", "pre_lookahead_layer.conv1.conv"),
            "conv2": k.conv1d("pre_lookahead_layer.conv2", "pre_lookahead_layer.conv2.conv"),
        },
        "dit": dit,
    }


# -- HiFT vocoder ------------------------------------------------------------------

def convert_hift(flat: Dict[str, np.ndarray],
                 cfg: CosyHiFTConfig = CONFIG_05B.hift) -> dict:
    """Upstream ``hift.pt`` state dict → vocoder param tree.

    Upstream wraps everything in weight-norm (fused here); Sequential
    wrappers shift some indices (``ups.{i}.1``, ``condnet.{2i}``).
    """
    flat = _fuse_weight_norm(flat)
    flat = _strip_prefixes(flat, ("generator.",))
    k = _Keys(flat)

    def resblock(prefix: str, n_dil: int) -> dict:
        rb = {"convs1": [], "convs2": [], "alphas1": [], "alphas2": []}
        for j in range(n_dil):
            rb["convs1"].append(k.conv1d(f"{prefix}.convs1.{j}", f"{prefix}.convs1.{j}.conv"))
            rb["convs2"].append(k.conv1d(f"{prefix}.convs2.{j}", f"{prefix}.convs2.{j}.conv"))
            rb["alphas1"].append(k.array(f"{prefix}.activations1.{j}.alpha",
                                         f"{prefix}.activations1.{j}.snake.alpha"))
            rb["alphas2"].append(k.array(f"{prefix}.activations2.{j}.alpha",
                                         f"{prefix}.activations2.{j}.snake.alpha"))
        return rb

    n_stages = len(cfg.upsample_rates)
    n_dil = len(cfg.resblock_dilations)
    params = {
        "f0_condnet": [], "f0_classifier": k.linear("f0_predictor.classifier"),
        "source_linear": k.linear("m_source.l_linear"),
        "conv_pre": k.conv1d("conv_pre", "conv_pre.conv"),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
        "conv_post": k.conv1d("conv_post", "conv_post.conv"),
    }
    for i in range(cfg.f0_layers):
        params["f0_condnet"].append(
            k.conv1d(f"f0_predictor.condnet.{2 * i}", f"f0_predictor.condnet.{i}"))
    for i in range(n_stages):
        params["ups"].append(k.conv1d(f"ups.{i}", f"ups.{i}.1", f"ups.{i}.conv"))
        params["source_downs"].append(
            k.conv1d(f"source_downs.{i}", f"source_downs.{i}.conv"))
        params["source_resblocks"].append(resblock(f"source_resblocks.{i}", n_dil))
    for fi in range(n_stages * len(cfg.resblock_kernel_sizes)):
        params["resblocks"].append(resblock(f"resblocks.{fi}", n_dil))
    return params


# -- top-level entry -----------------------------------------------------------------

def _load_state(path: Path) -> Dict[str, np.ndarray]:
    if path.suffix == ".pt":
        import torch

        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return {k: v.float().numpy() for k, v in sd.items()}
    from ...core.weights import read_safetensors_file

    return read_safetensors_file(path)


def convert_checkpoint(model_dir: str | Path, cfg: CosyVoiceConfig = CONFIG_05B) -> dict:
    """Convert an upstream CosyVoice3 snapshot directory (llm/flow/hift in
    .pt or .safetensors) into the full canonical param tree."""
    model_dir = Path(model_dir)

    def find(stem: str) -> Path:
        for suffix in (".safetensors", ".pt"):
            p = model_dir / f"{stem}{suffix}"
            if p.exists():
                return p
        raise FileNotFoundError(f"{stem}.pt / {stem}.safetensors not in {model_dir}")

    params = convert_llm(_load_state(find("llm")), cfg)
    params["flow"] = convert_flow(_load_state(find("flow")), cfg.flow)
    params["hift"] = convert_hift(_load_state(find("hift")), cfg.hift)
    return params


def load_or_convert(model_dir: str | Path, cfg: CosyVoiceConfig = CONFIG_05B) -> dict:
    """from_pretrained entry: a snapshot is either already-converted
    (canonical flat safetensors written by ``save_converted``) or upstream."""
    from ...core.weights import load_safetensors, unflatten

    model_dir = Path(model_dir)
    converted = model_dir / "cosyvoice_tpu.safetensors"
    if converted.exists():
        flat = load_safetensors(model_dir)
        return _tree_from_flat(unflatten({k: v for k, v in flat.items()}))
    return convert_checkpoint(model_dir, cfg)


def _tree_from_flat(tree):
    """Convert unflattened dicts with integer-string keys into lists."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [_tree_from_flat(tree[str(i)]) for i in range(len(tree))]
        return {k: _tree_from_flat(v) for k, v in tree.items()}
    return tree


def save_converted(params: dict, model_dir: str | Path) -> Path:
    """Persist a converted tree as one flat safetensors for fast reload."""
    from safetensors.numpy import save_file

    from ...core.weights import flatten

    out = Path(model_dir) / "cosyvoice_tpu.safetensors"
    save_file({k: np.asarray(v) for k, v in flatten(params).items()}, str(out))
    return out
