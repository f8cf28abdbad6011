"""The JAX package's jax-free ``SpeechServer``, with the port's slot pool.

The base server builds its ``scheduler="slotpool"`` batcher from the JAX
package's ``SlotPoolASR``, and only for a model with that package's
``_encode_audio_batch``: given the port's model it would fall back to the
group batcher. This subclass overrides only ``_batcher_for`` so that the
port's model gets the port's :class:`~.slotpool.SlotPoolASR`, sized as the
base sizes its pool.
"""

from __future__ import annotations

from qwen3_asr_swift_tpu.serving import server as _base

from ..models.qwen3_asr.model import Qwen3ASR
from .slotpool import SlotPoolASR


class SpeechServer(_base.SpeechServer):
    """``qwen3_asr_swift_tpu.serving.server.SpeechServer`` serving the port."""

    def _batcher_for(self, model):
        key = id(model)
        if self.scheduler == "slotpool" and isinstance(model, Qwen3ASR):
            if key not in self._batchers:
                self._batchers[key] = SlotPoolASR(
                    model, slots=self._max_batch,
                    max_len=SlotPoolASR.max_len_for(model, self.slotpool_max_s),
                    oversize="fallback")
            return self._batchers[key]
        return super()._batcher_for(model)
