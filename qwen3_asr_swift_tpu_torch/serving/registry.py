"""A registry that serves port models as the ``"asr"`` and ``"tts"``
entries of the port's :class:`~.server.SpeechServer`."""

from __future__ import annotations

from .server import ModelRegistry


def build_registry(model=None, tts=None) -> ModelRegistry:
    """A registry serving ``model`` as the ``"asr"`` entry and ``tts`` as
    the ``"tts"`` entry (either may be None)."""
    registry = ModelRegistry()
    if model is not None:
        registry.register_instance("asr", model)
    if tts is not None:
        registry.register_instance("tts", tts)
    return registry
