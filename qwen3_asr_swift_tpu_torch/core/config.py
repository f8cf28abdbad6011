"""The port's copy of ``qwen3_asr_swift_tpu/core/config.py``: dataclass
configs from a HF-style ``config.json`` or a dict, and size presets and
quantization bits from a model id or a checkpoint directory's name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Type, TypeVar

T = TypeVar("T")


def from_json_file(cls: Type[T], path: str | Path, **overrides: Any) -> T:
    """Build a dataclass config from a HF-style config.json, ignoring
    unknown keys, applying ``overrides`` last."""
    data = json.loads(Path(path).read_text())
    return from_dict(cls, data, **overrides)


def from_dict(cls: Type[T], data: dict, **overrides: Any) -> T:
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in data.items() if k in names}
    kwargs.update({k: v for k, v in overrides.items() if k in names})
    return cls(**kwargs)


def detect_size(model_id: str, sizes: dict[str, Any], default: Any) -> Any:
    """Sniff a model size preset from a model id, e.g.
    ``detect_size(id, {"1.7b": LARGE, "0.6b": SMALL}, SMALL)``
    (reference: ASRModelSize.detect, Qwen3ASR.swift:581-587)."""
    lower = model_id.lower()
    for marker, preset in sizes.items():
        if marker.lower() in lower:
            return preset
    return default


def detect_bits(model_id: str, default: int = 4) -> int:
    """Sniff quantization bits from a model id
    (reference: ASRModelSize.detectBits, Qwen3ASR.swift:590-601)."""
    lower = model_id.lower()
    if "8bit" in lower or "8-bit" in lower:
        return 8
    if "4bit" in lower or "4-bit" in lower:
        return 4
    if "bf16" in lower or "fp16" in lower or "float16" in lower:
        return 16
    return default
