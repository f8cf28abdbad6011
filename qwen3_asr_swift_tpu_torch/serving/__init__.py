"""Serving glue: the port behind the JAX package's jax-free server.

``SpeechServer`` subclasses ``qwen3_asr_swift_tpu.serving.server``'s, which
imports no jax, so that ``scheduler="slotpool"`` builds the port's
:class:`SlotPoolASR`; callers of the port need no import from the JAX
package.
"""

from .registry import build_registry
from .server import SpeechServer
from .slotpool import SlotPoolASR

__all__ = ["SpeechServer", "SlotPoolASR", "build_registry"]
