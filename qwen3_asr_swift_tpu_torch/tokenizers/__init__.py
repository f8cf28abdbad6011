"""Tokenizers: the Qwen byte-level BPE and the SentencePiece model reader."""

from .bpe import BPETokenizer  # noqa: F401
from .sentencepiece_model import SentencePieceModel  # noqa: F401
