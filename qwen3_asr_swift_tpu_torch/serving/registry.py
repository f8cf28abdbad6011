"""The port behind the JAX package's server.

``SpeechServer``, ``ContinuousBatcher`` and ``DispatchGate`` in
``qwen3_asr_swift_tpu/serving`` import no jax and call nothing but the
model's ``transcribe_batch`` and its ``dispatch_gate`` attribute, so they
serve the port's model unchanged; this module only fills their registry.
"""

from __future__ import annotations

from qwen3_asr_swift_tpu.serving.server import ModelRegistry


def build_registry(model) -> ModelRegistry:
    """A registry serving ``model`` as the ``"asr"`` entry."""
    registry = ModelRegistry()
    registry.register_instance("asr", model)
    return registry
