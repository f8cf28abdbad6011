"""qwen3_asr_swift_tpu_torch — the PyTorch/CUDA port of qwen3_asr_swift_tpu.

The JAX package ``qwen3_asr_swift_tpu`` is the reference; this package
mirrors its layout so each module's counterpart is easy to find:

    core/      weights carried across from the JAX parameter tree; copies
               of the value types, protocols, quantize_mlx, logging
    ops/       nn primitives, group-quantized matmul (kernels K1, K2),
               RoPE, attention, static KV cache, int8-KV decode attention
               (kernel K3), sampling, log-mel
    audio/     WAV I/O, resampling, the wire formats' host encoders and
               on-device decoders (mu-law, pcm4, dpcm4)
    tokenizers/  the byte-level BPE tokenizer
    models/    Qwen3-ASR (encoder, decoder, batched transcription, beam)
    serving/   the port's own SpeechServer (/health, /transcribe) over the
               group batcher or the slot pool
    csrc/      the hand-written CUDA kernels (sm_90a), built at first use

Importing or running this package never imports ``jax`` nor any module of
the JAX package; it keeps its own copy of what it needs.
"""

__version__ = "0.1.0"
