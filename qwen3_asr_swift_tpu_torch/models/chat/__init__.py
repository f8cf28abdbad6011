"""Qwen3.5 hybrid chat LLM (DeltaNet + gated attention) — port of
``qwen3_asr_swift_tpu/models/chat``."""

from .model import (CONFIG_08B, ChatConfig, ChatSamplingConfig,  # noqa: F401
                    Qwen3Chat, chat_sample, config_tiny, init_chat_params)
