"""Model families of the port: ``qwen3_asr`` (ASR and the forced aligner),
``silero_vad``, ``pyannote`` (segmentation-3.0 and its VAD),
``firered_vad``, ``speaker`` (WeSpeaker ResNet34 and CAM++),
``diarization`` (the VAD + embedding + clustering pipeline and the
Sortformer diarizer), ``wakeword`` (the Zipformer keyword spotter),
``parakeet`` (Parakeet TDT), ``parakeet_streaming`` (streaming Parakeet
EOU and Nemotron), ``omnilingual`` (Omnilingual CTC), ``qwen3_tts``,
``cosyvoice``, ``vibevoice``, ``kokoro``, ``voxcpm2``, ``enhancement``
(DeepFilterNet3), ``separation`` (Open-Unmix), ``translation``
(MADLAD-400), ``personaplex`` and ``chat`` (Qwen3.5)."""
