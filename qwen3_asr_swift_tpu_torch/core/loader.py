"""Multi-model load orchestration + memory tiers.

TPU-native analog of the reference's ModelLoader and MemoryTier
(reference: Sources/AudioCommon/ModelLoader.swift:22-175 — parallel
group-0 (VAD+STT) / sequential group-1 (TTS) loading with weighted
aggregate progress; Sources/SpeechCore/MemoryTier.swift:11-69 —
device-RAM-based model selection ladders).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class ModelSpec:
    """One model to load. ``group`` 0 loads in parallel (small streaming
    models), group 1+ sequentially (large generators) — the reference's
    peak-memory-aware load groups."""

    name: str
    loader: Callable[[Callable[[float, str], None]], object]
    weight: float = 1.0
    group: int = 0

    @classmethod
    def vad(cls, loader, weight: float = 0.5):
        return cls("vad", loader, weight, group=0)

    @classmethod
    def stt(cls, loader, weight: float = 2.0):
        return cls("stt", loader, weight, group=0)

    @classmethod
    def tts(cls, loader, weight: float = 3.0):
        return cls("tts", loader, weight, group=1)


class ModelSet(dict):
    """name → loaded model instance."""


class ModelLoader:
    @staticmethod
    def load(specs: Sequence[ModelSpec],
             progress_handler: Optional[Callable[[float, str], None]] = None) -> ModelSet:
        total_weight = sum(s.weight for s in specs) or 1.0
        done_weight = {"v": 0.0}
        lock = threading.Lock()
        results = ModelSet()
        errors: Dict[str, Exception] = {}

        def report(frac_done: float, message: str):
            if progress_handler:
                progress_handler(min(frac_done, 1.0), message)

        def run(spec: ModelSpec):
            def sub_progress(frac: float, msg: str):
                with lock:
                    report((done_weight["v"] + frac * spec.weight) / total_weight,
                           f"{spec.name}: {msg}")

            try:
                model = spec.loader(sub_progress)
                with lock:
                    results[spec.name] = model
                    done_weight["v"] += spec.weight
                    report(done_weight["v"] / total_weight, f"{spec.name}: ready")
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors[spec.name] = e

        groups = sorted({s.group for s in specs})
        for g in groups:
            if errors:
                break  # don't burn minutes/HBM loading later groups after a failure
            group_specs = [s for s in specs if s.group == g]
            if g == 0 and len(group_specs) > 1:
                with ThreadPoolExecutor(max_workers=len(group_specs)) as ex:
                    list(ex.map(run, group_specs))
            else:
                for spec in group_specs:
                    run(spec)
        if errors:
            summary = "; ".join(f"{n}: {e}" for n, e in errors.items())
            _, first_err = next(iter(errors.items()))
            raise RuntimeError(f"failed to load {summary}") from first_err
        report(1.0, "all models ready")
        return results


class MemoryTier(enum.Enum):
    """HBM-based model-selection ladder (reference: MemoryTier.swift:11-69
    selects by device RAM; here by per-chip HBM)."""

    LOW = "low"        # <8 GiB: 0.6B ASR 4-bit, Kokoro, Silero
    MEDIUM = "medium"  # 8-16 GiB: 0.6B ASR bf16, Qwen3-TTS 0.6B
    HIGH = "high"      # 16-32 GiB: 1.7B models
    MAX = "max"        # >32 GiB (or TP mesh): 7B PersonaPlex bf16

    @classmethod
    def detect(cls, hbm_bytes: Optional[int] = None) -> "MemoryTier":
        if hbm_bytes is None:
            hbm_bytes = device_memory_bytes()
        gib = hbm_bytes / (1 << 30)
        if gib < 8:
            return cls.LOW
        if gib < 16:
            return cls.MEDIUM
        if gib < 32:
            return cls.HIGH
        return cls.MAX

    @property
    def asr_model_id(self) -> str:
        return {
            MemoryTier.LOW: "aufklarer/Qwen3-ASR-0.6B-MLX-4bit",
            MemoryTier.MEDIUM: "aufklarer/Qwen3-ASR-0.6B-MLX-8bit",
            MemoryTier.HIGH: "aufklarer/Qwen3-ASR-1.7B-MLX-8bit",
            MemoryTier.MAX: "aufklarer/Qwen3-ASR-1.7B-MLX-8bit",
        }[self]

    @property
    def tts_model_id(self) -> str:
        """Reference MemoryTier ladder: Kokoro on tight memory, Qwen3-TTS
        above (MemoryTier.swift:11-69)."""
        return {
            MemoryTier.LOW: "hexgrad/Kokoro-82M",
            MemoryTier.MEDIUM: "aufklarer/Qwen3-TTS-0.6B-MLX-8bit",
            MemoryTier.HIGH: "aufklarer/Qwen3-TTS-1.7B-MLX-4bit",
            MemoryTier.MAX: "aufklarer/Qwen3-TTS-1.7B-MLX-8bit",
        }[self]

    @property
    def vad_model_id(self) -> str:
        return "silero-vad-v5"  # 309K params — every tier

    @property
    def s2s_model_id(self) -> Optional[str]:
        """PersonaPlex 7B only fits the top tier (or a TP mesh)."""
        return "nvidia/personaplex-7b-v1" if self is MemoryTier.MAX else None


def device_memory_bytes(device="cuda") -> int:
    """The memory of one device: a CUDA card's ``total_memory``, or for an
    explicit CPU device the reference's 16 GiB heuristic. A request for a
    card this machine does not have raises, as ``resolve_device`` does."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return 16 << 30


def can_fit(model_bytes: int, headroom: float = 0.8, device="cuda") -> bool:
    """Preflight check (reference: MetalBudget.canFit)."""
    return model_bytes <= device_memory_bytes(device) * headroom
