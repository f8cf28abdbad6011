"""Minimal SentencePiece ``.model`` protobuf reader.

TPU-native analog of the reference's hand-rolled protobuf parser
(reference: Sources/AudioCommon/SentencePieceModel.swift:131-152 —
varint/tag/skip walker extracting pieces + scores). No protobuf dependency:
the ModelProto wire format is stable — field 1 is a repeated SentencePiece
message whose field 1 is the piece string, field 2 its float score,
field 3 its type (1=normal, 2=unk, 3=control, 6=byte).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(data, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        length, pos = _read_varint(data, pos)
        return pos + length
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


class SentencePieceModel:
    """Pieces + scores from a SentencePiece .model file."""

    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.unk_id = next((i for i, (_, _, t) in enumerate(pieces) if t == self.UNKNOWN), 0)

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceModel":
        data = Path(path).read_bytes()
        pieces: List[Tuple[str, float, int]] = []
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:  # repeated SentencePiece
                length, pos = _read_varint(data, pos)
                end = pos + length
                piece, score, ptype = "", 0.0, cls.NORMAL
                while pos < end:
                    t2, pos = _read_varint(data, pos)
                    f2, w2 = t2 >> 3, t2 & 7
                    if f2 == 1 and w2 == 2:
                        ln, pos = _read_varint(data, pos)
                        piece = data[pos : pos + ln].decode("utf-8", errors="replace")
                        pos += ln
                    elif f2 == 2 and w2 == 5:
                        import struct

                        score = struct.unpack_from("<f", data, pos)[0]
                        pos += 4
                    elif f2 == 3 and w2 == 0:
                        ptype, pos = _read_varint(data, pos)
                    else:
                        pos = _skip_field(data, pos, w2)
                pieces.append((piece, score, ptype))
                pos = end
            else:
                pos = _skip_field(data, pos, wire)
        return cls(pieces)

    # -- encoding/decoding --------------------------------------------------

    _SPACE = "▁"  # ▁

    def encode(self, text: str) -> List[int]:
        """Greedy longest-match (unigram Viterbi simplified to scores-greedy):
        correct for the CTC/ASR vocabularies used here where pieces are
        unambiguous; full Viterbi can be added per-model if needed."""
        text = self._SPACE + text.replace(" ", self._SPACE)
        ids: List[int] = []
        i = 0
        n = len(text)
        max_len = max((len(p) for p, _, _ in self.pieces), default=1)
        while i < n:
            match = None
            for ln in range(min(max_len, n - i), 0, -1):
                cand = self.piece_to_id.get(text[i : i + ln])
                if cand is not None:
                    match = (cand, ln)
                    break
            if match is None:
                # byte fallback: the character's UTF-8 bytes as <0xXX>
                # pieces (masking the codepoint to one byte corrupts any
                # non-latin1 char and emits invalid standalone bytes)
                for b in text[i].encode("utf-8"):
                    ids.append(self.piece_to_id.get(f"<0x{b:02X}>", self.unk_id))
                i += 1
            else:
                ids.append(match[0])
                i += match[1]
        return ids

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for idx in ids:
            if not (0 <= idx < len(self.pieces)):
                continue
            piece, _, ptype = self.pieces[idx]
            if ptype in (self.CONTROL, self.UNUSED):
                continue
            if ptype == self.BYTE and len(piece) == 6 and piece.startswith("<0x"):
                byte_buf.append(int(piece[3:5], 16))
                continue
            flush_bytes()
            out.append(piece)
        flush_bytes()
        return "".join(out).replace(self._SPACE, " ").lstrip(" ")
