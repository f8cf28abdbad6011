"""The port's copy of ``BPETokenizer`` and ``StreamingDecoder`` from
``qwen3_asr_swift_tpu/tokenizers/bpe.py``.

Byte-level BPE tokenizer for the Qwen vocabulary.

TPU-native analog of the reference's hand-rolled tokenizer
(reference: Sources/AudioCommon/Tokenizer.swift:18-297 — byte-level BPE
from vocab.json + merges.txt with special-token handling and safe decode
across CJK/UTF-8 boundaries). Pure Python, no external tokenizer dep.

The byte↔unicode table and pre-tokenization regex follow the GPT-2/Qwen2
scheme the checkpoint's vocab.json was built with.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte → printable-unicode bijection."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# Qwen2 pre-tokenization pattern (contractions, letters, numbers, punct,
# spaces). stdlib re has no \p{L}/\p{N}; letters are expressed as
# [^\W\d_] (word chars minus digits/underscore) and their complement as
# [^\w]|[\d_], keeping digits OUT of the letter run so number runs hit
# the \d{1,3} alternative (the upstream tokenizer splits digit runs into
# 1-3-digit groups — folding digits into \w merged them arbitrarily).
_PRETOKENIZE = re.compile(
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|(?:[^\r\n\w]|_)?[^\W\d_]+"
    r"|\d{1,3}"
    r"| ?(?:[^\s\w]|_)+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+",
    re.UNICODE,
)


class BPETokenizer:
    """Byte-level BPE with special tokens."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
    ):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merge_ranks = {pair: rank for rank, pair in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        for tok, idx in self.special_tokens.items():
            self.id_to_token.setdefault(idx, tok)
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if self.special_tokens:
            escaped = sorted((re.escape(t) for t in self.special_tokens), key=len, reverse=True)
            self._special_re: Optional[re.Pattern] = re.compile("(" + "|".join(escaped) + ")")
        else:
            self._special_re = None
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained_dir(cls, model_dir: str | Path) -> "BPETokenizer":
        """Load vocab.json + merges.txt (+ tokenizer_config.json specials),
        falling back to tokenizer.json if present."""
        model_dir = Path(model_dir)
        vocab_path = model_dir / "vocab.json"
        merges_path = model_dir / "merges.txt"
        tok_json = model_dir / "tokenizer.json"

        special_tokens: Dict[str, int] = {}

        if vocab_path.exists() and merges_path.exists():
            vocab = json.loads(vocab_path.read_text(encoding="utf-8"))
            merges = []
            for line in merges_path.read_text(encoding="utf-8").splitlines():
                if not line or line.startswith("#version"):
                    continue
                parts = line.split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        elif tok_json.exists():
            data = json.loads(tok_json.read_text(encoding="utf-8"))
            vocab = data["model"]["vocab"]
            merges = []
            for m in data["model"]["merges"]:
                if isinstance(m, str):
                    a, b = m.split(" ")
                else:
                    a, b = m
                merges.append((a, b))
            for added in data.get("added_tokens", []):
                special_tokens[added["content"]] = added["id"]
        else:
            raise FileNotFoundError(f"no tokenizer files in {model_dir}")

        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text(encoding="utf-8"))
            for key, val in (cfg.get("added_tokens_decoder") or {}).items():
                content = val.get("content") if isinstance(val, dict) else None
                if content:
                    special_tokens[content] = int(key)

        # Qwen special tokens not always present in configs: derive any
        # <|...|> entries already in vocab.
        for tok, idx in vocab.items():
            if tok.startswith("<|") and tok.endswith("|>"):
                special_tokens.setdefault(tok, idx)

        return cls(vocab, merges, special_tokens)

    # -- BPE core -----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        if len(word) == 1:
            self._bpe_cache[token] = word
            return word
        while True:
            best_rank = None
            best_idx = -1
            for i in range(len(word) - 1):
                rank = self.merge_ranks.get((word[i], word[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                break
            word[best_idx : best_idx + 2] = [word[best_idx] + word[best_idx + 1]]
        self._bpe_cache[token] = word
        return word

    # -- public API ---------------------------------------------------------

    def encode(self, text: str, allow_special: bool = True) -> List[int]:
        if not text:
            return []
        segments: List[Tuple[str, bool]] = []
        if allow_special and self._special_re is not None:
            parts = self._special_re.split(text)
            for part in parts:
                if not part:
                    continue
                segments.append((part, part in self.special_tokens))
        else:
            segments.append((text, False))

        ids: List[int] = []
        for segment, is_special in segments:
            if is_special:
                ids.append(self.special_tokens[segment])
                continue
            for piece in _PRETOKENIZE.findall(segment):
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                for sub in self._bpe(mapped):
                    idx = self.vocab.get(sub)
                    if idx is not None:
                        ids.append(idx)
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = False) -> str:
        """Decode token ids to text. Invalid/partial UTF-8 byte runs are
        replaced rather than raising (CJK characters commonly split across
        tokens — reference Tokenizer.swift decode tests)."""
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for idx in ids:
            token = self.id_to_token.get(int(idx))
            if token is None:
                continue
            if token in self.special_tokens:
                if not skip_special:
                    flush()
                    parts.append(token)
                continue
            for ch in token:
                b = self.byte_decoder.get(ch)
                if b is None:  # token text outside byte alphabet (specials)
                    flush()
                    parts.append(ch)
                else:
                    byte_buf.append(b)
        flush()
        return "".join(parts)

    @property
    def vocab_size(self) -> int:
        return max(len(self.vocab), (max(self.special_tokens.values(), default=-1) + 1))


class StreamingDecoder:
    """Incremental detokenizer that withholds bytes until they form complete
    UTF-8 sequences — required for streaming CJK output."""

    def __init__(self, tokenizer: BPETokenizer, skip_special: bool = True):
        self.tok = tokenizer
        self.skip_special = skip_special
        self._pending = bytearray()

    def push(self, token_id: int) -> str:
        token = self.tok.id_to_token.get(int(token_id))
        if token is None:
            return ""
        if token in self.tok.special_tokens:
            out = self._drain(final=True)
            return out if self.skip_special else out + token
        for ch in token:
            b = self.tok.byte_decoder.get(ch)
            if b is not None:
                self._pending.append(b)
        return self._drain(final=False)

    def _drain(self, final: bool) -> str:
        if not self._pending:
            return ""
        if final:
            out = self._pending.decode("utf-8", errors="replace")
            self._pending.clear()
            return out
        # Find the longest prefix that is complete UTF-8.
        cut = len(self._pending)
        # A UTF-8 sequence is at most 4 bytes; check the tail.
        for back in range(1, min(4, cut) + 1):
            byte = self._pending[cut - back]
            if byte & 0x80 == 0:  # ASCII — tail complete
                break
            if byte & 0xC0 == 0xC0:  # leading byte found `back` bytes in
                need = 2 if byte & 0xE0 == 0xC0 else 3 if byte & 0xF0 == 0xE0 else 4
                if back < need:
                    cut -= back  # incomplete sequence — withhold it
                break
        if cut == 0:
            return ""
        out = bytes(self._pending[:cut]).decode("utf-8", errors="replace")
        del self._pending[:cut]
        return out

    def finish(self) -> str:
        return self._drain(final=True)
