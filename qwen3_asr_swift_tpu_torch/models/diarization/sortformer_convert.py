"""NeMo streaming-Sortformer checkpoint conversion.

Maps the ``nvidia/diar_streaming_sortformer_4spk-v2`` state dict (a
``.nemo`` tar or exported safetensors; the reference consumes the same
network as an opaque CoreML artifact — Sources/SpeechVAD/
SortformerDiarizer.swift) onto the canonical tree in ``sortformer.py``:

  encoder.*                              → FastConformer (reused Parakeet
                                           converter — models/parakeet/convert.py)
  sortformer_modules.encoder_proj        → encoder_proj (512→192)
  transformer_encoder.layers.{i}.
      first_sub_layer.{query,key,value}_net / out_projection,
      layer_norm_1 / 2,
      second_sub_layer.dense_in / dense_out
                                         → post-LN transformer blocks
  sortformer_modules.first_hidden_to_hidden,
  sortformer_modules.single_hidden_to_spks
                                         → sigmoid head

Config dims (encoder layers/width, transformer depth/width, speaker
count) are inferred from tensor shapes."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..parakeet.convert import _lin, _ln, _load_state_dict, convert_encoder
from .sortformer import CONFIG_SORTFORMER, SortformerConfig


def map_sortformer_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[SortformerConfig, dict]:
    enc_layers = 0
    while f"encoder.layers.{enc_layers}.norm_out.weight" in sd:
        enc_layers += 1
    tf_layers = 0
    while f"transformer_encoder.layers.{tf_layers}.layer_norm_1.weight" in sd:
        tf_layers += 1
    if enc_layers == 0 or tf_layers == 0:
        raise KeyError("not a NeMo sortformer state dict (encoder.layers.* / "
                       "transformer_encoder.layers.* missing)")

    proj_w = sd["sortformer_modules.encoder_proj.weight"]   # [192, 512]
    spks_w = sd["sortformer_modules.single_hidden_to_spks.weight"]
    d_enc = proj_w.shape[1]
    d_tf = proj_w.shape[0]
    # mel count from the pre-encode out projection: in = C * subsampled(mel)
    c_sub = sd["encoder.pre_encode.conv.0.weight"].shape[0]
    f_sub = sd["encoder.pre_encode.out.weight"].shape[1] // c_sub
    n_mels = {16: 128, 10: 80, 4: 32}.get(f_sub, CONFIG_SORTFORMER.n_mels)

    cfg = dataclasses.replace(
        CONFIG_SORTFORMER,
        n_mels=n_mels,
        encoder_layers=enc_layers,
        encoder_hidden=d_enc,
        num_heads=sd["encoder.layers.0.self_attn.pos_bias_u"].shape[0],
        subsampling_channels=c_sub,
        ffn_expansion=sd["encoder.layers.0.feed_forward1.linear1.weight"].shape[0] // d_enc,
        conv_kernel=sd["encoder.layers.0.conv.depthwise_conv.weight"].shape[-1],
        tf_layers=tf_layers,
        tf_hidden=d_tf,
        tf_ff=sd["transformer_encoder.layers.0.second_sub_layer.dense_in.weight"].shape[0],
        max_speakers=spks_w.shape[0],
    )

    transformer = []
    for i in range(tf_layers):
        l = f"transformer_encoder.layers.{i}"
        transformer.append({
            "ln1": _ln(sd, f"{l}.layer_norm_1"),
            "q": _lin(sd, f"{l}.first_sub_layer.query_net"),
            "k": _lin(sd, f"{l}.first_sub_layer.key_net"),
            "v": _lin(sd, f"{l}.first_sub_layer.value_net"),
            "o": _lin(sd, f"{l}.first_sub_layer.out_projection"),
            "ln2": _ln(sd, f"{l}.layer_norm_2"),
            "ff1": _lin(sd, f"{l}.second_sub_layer.dense_in"),
            "ff2": _lin(sd, f"{l}.second_sub_layer.dense_out"),
        })

    params = {
        "encoder": convert_encoder(sd, cfg.encoder_config()),
        "encoder_proj": _lin(sd, "sortformer_modules.encoder_proj"),
        "transformer": transformer,
        "head": {
            "hidden": _lin(sd, "sortformer_modules.first_hidden_to_hidden"),
            "spks": _lin(sd, "sortformer_modules.single_hidden_to_spks"),
        },
    }
    return cfg, params


def convert_checkpoint(src) -> Tuple[SortformerConfig, dict]:
    """Load + map a NeMo sortformer checkpoint directory."""
    return map_sortformer_state_dict(_load_state_dict(Path(src)))
