"""Serving: the port's own HTTP server (``/health``, ``/transcribe``,
``/speak``) over its group batchers (``ContinuousBatcher`` +
``DispatchGate``, ``TTSBatcher``) or its slot pools (``SlotPoolASR``,
``SlotPoolTTS``)."""

from .batching import ContinuousBatcher, TTSBatcher
from .dispatch import DispatchGate
from .registry import build_registry
from .server import ModelRegistry, SpeechServer
from .slotpool import SlotPoolASR
from .ttspool import SlotPoolTTS

__all__ = ["ContinuousBatcher", "DispatchGate", "ModelRegistry", "SlotPoolASR", "SlotPoolTTS",
           "SpeechServer", "TTSBatcher", "build_registry"]
