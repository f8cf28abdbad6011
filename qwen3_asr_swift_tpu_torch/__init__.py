"""qwen3_asr_swift_tpu_torch — the PyTorch/CUDA port of qwen3_asr_swift_tpu.

The JAX package ``qwen3_asr_swift_tpu`` is the reference; this package
mirrors its layout so each module's counterpart is easy to find:

    core/      weights carried across from the JAX parameter tree
    ops/       nn primitives, group-quantized matmul (kernel K1), RoPE,
               attention, static KV cache, int8-KV decode attention
               (kernel K3), greedy sampling, log-mel
    audio/     on-device wire decoders (mu-law, pcm4, dpcm4)
    models/    Qwen3-ASR (encoder, decoder, batched transcription)
    serving/   a registry that puts the port behind the JAX package's
               jax-free ``SpeechServer``
    csrc/      the hand-written CUDA kernels (sm_90a), built at first use

Importing this package never imports ``jax``.
"""

__version__ = "0.1.0"
