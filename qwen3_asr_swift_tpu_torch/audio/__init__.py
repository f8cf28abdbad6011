"""On-device audio wire decoders, and the host WAV helpers.

``wav_bytes`` and ``load_audio`` are re-exported from the JAX package's
jax-free ``audio.io``.
"""

from qwen3_asr_swift_tpu.audio.io import load_audio, wav_bytes

__all__ = ["load_audio", "wav_bytes"]
