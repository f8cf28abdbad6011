"""Serving glue: the port behind the JAX package's jax-free server.

``SpeechServer`` is re-exported from ``qwen3_asr_swift_tpu.serving.server``,
which imports no jax, so callers of the port need no import from the JAX
package.
"""

from qwen3_asr_swift_tpu.serving.server import SpeechServer

from .registry import build_registry

__all__ = ["SpeechServer", "build_registry"]
