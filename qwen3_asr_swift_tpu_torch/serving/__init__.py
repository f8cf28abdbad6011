"""Serving: the port's own HTTP server (``/health``, ``/transcribe``) over
its group batcher (``ContinuousBatcher`` + ``DispatchGate``) or its slot
pool (``SlotPoolASR``)."""

from .batching import ContinuousBatcher
from .dispatch import DispatchGate
from .registry import build_registry
from .server import ModelRegistry, SpeechServer
from .slotpool import SlotPoolASR

__all__ = ["ContinuousBatcher", "DispatchGate", "ModelRegistry", "SlotPoolASR", "SpeechServer",
           "build_registry"]
