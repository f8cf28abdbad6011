"""A registry that serves port models as the ``"asr"``, ``"tts"``,
``"enhance"`` and ``"s2s"`` entries of the port's
:class:`~.server.SpeechServer`."""

from __future__ import annotations

from .server import ModelRegistry


def build_registry(model=None, tts=None, enhance=None, s2s=None) -> ModelRegistry:
    """A registry serving ``model`` as the ``"asr"`` entry, ``tts`` as
    ``"tts"``, ``enhance`` (``/enhance``) as ``"enhance"`` and ``s2s``
    (``/respond``) as ``"s2s"`` (any may be None)."""
    registry = ModelRegistry()
    for name, instance in (("asr", model), ("tts", tts), ("enhance", enhance), ("s2s", s2s)):
        if instance is not None:
            registry.register_instance(name, instance)
    return registry
