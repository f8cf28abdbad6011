"""A registry that serves one port model as the ``"asr"`` entry of the
port's :class:`~.server.SpeechServer`."""

from __future__ import annotations

from .server import ModelRegistry


def build_registry(model) -> ModelRegistry:
    """A registry serving ``model`` as the ``"asr"`` entry."""
    registry = ModelRegistry()
    registry.register_instance("asr", model)
    return registry
