"""Sentence-aware text chunking for long-form TTS.

TPU-native analog of the reference's TextChunker
(reference: Sources/Qwen3TTS/TextChunker.swift): split long input on
sentence boundaries (falling back to clause/word boundaries) into chunks
below a character budget so each synthesis call stays inside the
generator's frame cap.
"""

from __future__ import annotations

import re
from typing import List

# Latin enders need trailing whitespace ("3.14" must not split); CJK
# enders are unambiguous and followed by no space.
_SENTENCE_END = re.compile(r"(?<=[.!?])\s+|(?<=[。！？])\s*")
_CLAUSE_END = re.compile(r"(?<=[,;:，；：])\s*")


def chunk_text(text: str, max_chars: int = 300) -> List[str]:
    text = text.strip()
    if not text:
        return []
    if len(text) <= max_chars:
        return [text]

    chunks: List[str] = []
    current = ""
    for sentence in _SENTENCE_END.split(text):
        if not sentence:
            continue
        if len(sentence) > max_chars:
            # split over-long sentences on clauses, then words
            pieces = _CLAUSE_END.split(sentence)
            for piece in pieces:
                while len(piece) > max_chars:
                    cut = piece.rfind(" ", 0, max_chars)
                    cut = cut if cut > 0 else max_chars
                    part, piece = piece[:cut], piece[cut:].lstrip()
                    current = _flush(chunks, current, part, max_chars)
                current = _flush(chunks, current, piece, max_chars)
        else:
            current = _flush(chunks, current, sentence, max_chars)
    if current:
        chunks.append(current)
    return chunks


#: joining after these (CJK enders/clause marks) must NOT inject an ASCII
#: space — the source text had none, and the inserted space mutates the
#: synthesized text's prosody
_NO_SPACE_AFTER = "。！？，；：、"


def _joiner(current: str) -> str:
    return "" if current and current[-1] in _NO_SPACE_AFTER else " "


def _flush(chunks: List[str], current: str, piece: str, max_chars: int) -> str:
    piece = piece.strip()
    if not piece:
        return current
    sep = _joiner(current)
    if current and len(current) + len(sep) + len(piece) > max_chars:
        chunks.append(current)
        return piece
    return f"{current}{sep}{piece}".strip()
