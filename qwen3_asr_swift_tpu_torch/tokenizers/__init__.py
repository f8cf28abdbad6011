"""Tokenizers: the Qwen byte-level BPE."""

from .bpe import BPETokenizer  # noqa: F401
