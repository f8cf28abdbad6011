"""Serving: the port's own HTTP server (``/health``, ``/transcribe``,
``/speak``, ``/respond``, ``/enhance`` and the ``/v1/realtime`` WebSocket)
over its group batchers (``ContinuousBatcher`` +
``DispatchGate``, ``TTSBatcher``) or its slot pools (``SlotPoolASR``,
``SlotPoolTTS``)."""

from .batching import ContinuousBatcher, TTSBatcher
from .dispatch import DispatchGate
from .registry import build_registry
from .server import ModelRegistry, RealtimeSession, SpeechServer, build_default_registry
from .slotpool import SlotPoolASR
from .ttspool import SlotPoolTTS

__all__ = ["ContinuousBatcher", "DispatchGate", "ModelRegistry", "RealtimeSession", "SlotPoolASR",
           "SlotPoolTTS", "SpeechServer", "TTSBatcher", "build_default_registry", "build_registry"]
