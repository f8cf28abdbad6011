"""Model families of the port: ``qwen3_asr`` (ASR and the forced aligner),
``silero_vad``, ``qwen3_tts``, ``cosyvoice``, ``vibevoice``, ``kokoro``,
``voxcpm2``, ``enhancement`` (DeepFilterNet3), ``personaplex`` and
``chat`` (Qwen3.5)."""
