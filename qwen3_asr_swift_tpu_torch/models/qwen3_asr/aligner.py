"""Qwen3 forced aligner: non-autoregressive word-level timestamps — port of
``qwen3_asr_swift_tpu/models/qwen3_asr/aligner.py``.

- text is slotted with a ``<|timestamp|>`` token before and after each
  word; the prompt is [chat prefix | audio block | slotted text];
- ONE non-autoregressive forward: the embedding of the three blocks, a
  ``valid`` mask with holes (prefix padding, audio-bucket padding, text
  padding), one decoder ``prefill`` into a float cache of the prompt's
  length, a gather at the timestamp slots, the 5000-class head (each class
  80 ms) and an argmax;
- LIS-based monotonicity correction with interpolation (host);
- ``align_long`` re-chunks audio beyond ``max_chunk_s``.

The host functions (``split_word_pairs``, ``slot_text``, ``lis_positions``,
``enforce_monotonicity``) and ``align``/``align_long`` are copies of the
reference's. With a packed decoder, a prompt of at most 256 rows takes
kernel K1 in prefill; longer ones (every prompt over the 8 s audio bucket
with a text block of 128) take the plain product, as on the main path.
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import ForcedAlignmentModel
from ...core.types import AlignedWord
from ...ops.nn import embedding_lookup, linear
from ...tokenizers.bpe import BPETokenizer
from .config import ENCODER_ALIGNER, Qwen3ASRConfig, config_tiny
from .decoder import make_cache, prefill
from .model import Qwen3ASR, _round_block


# ---------------------------------------------------------------------------
# Text slotting (host)
# ---------------------------------------------------------------------------

_CJK_LANGS = ("chinese", "zh", "japanese", "ja", "korean", "ko", "thai", "th")


def split_word_pairs(text: str, language: str = "English") -> List[Tuple[str, str]]:
    """(surface, cleaned) pairs. Whitespace-split for space-delimited
    scripts; per-character for CJK. Surface keeps punctuation, cleaned is
    what the tokenizer sees (reference: TextPreprocessing.splitIntoWordPairs)."""
    lang = language.lower()
    pairs: List[Tuple[str, str]] = []
    if any(l in lang for l in _CJK_LANGS):
        for ch in text:
            if ch.isspace():
                continue
            cleaned = ch if not unicodedata.category(ch).startswith("P") else ""
            if cleaned:
                pairs.append((ch, cleaned))
            elif pairs:
                pairs[-1] = (pairs[-1][0] + ch, pairs[-1][1])
        return pairs
    for word in text.split():
        cleaned = re.sub(r"^[\W_]+|[\W_]+$", "", word, flags=re.UNICODE)
        pairs.append((word, cleaned))
    return pairs


@dataclasses.dataclass(frozen=True)
class SlottedText:
    token_ids: List[int]
    timestamp_positions: List[int]  # indices into token_ids
    words: List[str]                # surface forms


def slot_text(text: str, tokenizer: BPETokenizer, timestamp_id: int,
              language: str = "English") -> SlottedText:
    """<|timestamp|> word <|timestamp|> per word; unencodable words attach
    their surface to the previous word (reference: TextPreprocessing:60-80)."""
    token_ids: List[int] = []
    ts_positions: List[int] = []
    words: List[str] = []
    for surface, cleaned in split_word_pairs(text, language):
        word_tokens = tokenizer.encode(cleaned) if cleaned else []
        if not word_tokens:
            if words:
                words[-1] += surface
            continue
        ts_positions.append(len(token_ids))
        token_ids.append(timestamp_id)
        token_ids.extend(word_tokens)
        ts_positions.append(len(token_ids))
        token_ids.append(timestamp_id)
        words.append(surface)
    return SlottedText(token_ids, ts_positions, words)


# ---------------------------------------------------------------------------
# Monotonicity correction (host)
# ---------------------------------------------------------------------------

def lis_positions(arr: Sequence[int]) -> List[int]:
    """Positions of a longest (strictly) increasing subsequence, O(n log n)
    (reference: TimestampCorrection.longestIncreasingSubsequencePositions)."""
    n = len(arr)
    if n == 0:
        return []
    tails: List[int] = []
    tail_idx: List[int] = []
    parent = [-1] * n
    import bisect

    for i, x in enumerate(arr):
        lo = bisect.bisect_left(tails, x)
        if lo == len(tails):
            tails.append(x)
            tail_idx.append(i)
        else:
            tails[lo] = x
            tail_idx[lo] = i
        parent[i] = tail_idx[lo - 1] if lo > 0 else -1

    out = []
    idx = tail_idx[len(tails) - 1]
    while idx != -1:
        out.append(idx)
        idx = parent[idx]
    out.reverse()
    return out


def enforce_monotonicity(raw: Sequence[int]) -> List[int]:
    """Keep the LIS as anchors; repair outliers by nearest-anchor (gaps ≤3)
    or linear interpolation, then clamp to non-decreasing
    (reference: TimestampCorrection.enforceMonotonicity)."""
    raw = list(raw)
    if len(raw) <= 1:
        return raw
    anchors_pos = lis_positions(raw)
    anchor_set = set(anchors_pos)
    if len(anchors_pos) == len(raw):
        return raw
    anchors = [(p, raw[p]) for p in anchors_pos]
    corrected = raw[:]

    for i in range(len(raw)):
        if i in anchor_set:
            continue
        prev = None
        nxt = None
        for p, v in anchors:
            if p < i:
                prev = (p, v)
            elif p > i and nxt is None:
                nxt = (p, v)
        if prev and nxt:
            gap = nxt[0] - prev[0]
            if gap <= 3:
                corrected[i] = prev[1] if (i - prev[0]) <= (nxt[0] - i) else nxt[1]
            else:
                t = (i - prev[0]) / (nxt[0] - prev[0])
                corrected[i] = prev[1] + int(t * (nxt[1] - prev[1]))
        elif prev:
            corrected[i] = prev[1]
        elif nxt:
            corrected[i] = nxt[1]

    for i in range(1, len(corrected)):
        if corrected[i] < corrected[i - 1]:
            corrected[i] = corrected[i - 1]
    return corrected


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Qwen3ForcedAligner(ForcedAlignmentModel):
    """Non-autoregressive forced alignment with the Qwen3-ASR backbone, on
    one device (the card unless the caller asks for the CPU). The trees are
    in the JAX package's layout; ``classify_params`` is the head's linear
    ``{"kernel": [hidden, classify_num]}``."""

    def __init__(self, cfg: Qwen3ASRConfig, encoder_params, decoder_params,
                 classify_params, tokenizer: Optional[BPETokenizer] = None, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16, max_chunk_s: float = 240.0):
        base_buckets = (8, 16, 32, 64, 128, 320)
        self._asr = Qwen3ASR(cfg, encoder_params, decoder_params, device=device,
                             tokenizer=tokenizer, dtype=dtype, audio_buckets_s=base_buckets)
        self.cfg = cfg
        self.device = self._asr.device
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.classify_params = params_from_jax(classify_params, self.device, dtype)
        self.max_chunk_s = max_chunk_s

    # -- constructors --------------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Optional[Qwen3ASRConfig] = None, seed: int = 0, *,
                    device="cuda", dtype: torch.dtype = torch.bfloat16, tokenizer=None,
                    quant_bits: Optional[int] = None, **kw) -> "Qwen3ForcedAligner":
        """Random weights drawn with numpy from ``seed``; ``quant_bits``
        packs the decoder linears and embedding (MLX group 64)."""
        from ...core.params import init_random_params

        if cfg is None:
            cfg = dataclasses.replace(config_tiny(), classify_num=100)
        enc, dec = init_random_params(cfg, seed, quant_bits)
        if quant_bits:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, bits=quant_bits, group_size=64))
        rng = np.random.default_rng(seed + 1)
        h = cfg.decoder.hidden_size
        head = {"kernel": (rng.standard_normal((h, cfg.classify_num), dtype=np.float32)
                           / np.float32(np.sqrt(h)))}
        return cls(cfg, enc, dec, head, tokenizer=tokenizer, device=device, dtype=dtype, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "aufklarer/Qwen3-ForcedAligner-0.6B-4bit",
                        cache_dir=None, offline_mode: bool = False, progress_handler=None, *,
                        device="cuda", dtype: torch.dtype = torch.bfloat16,
                        **kw) -> "Qwen3ForcedAligner":
        """Load a checkpoint in the published layout (``thinker.*`` prefix
        optional, ``lm_head`` the classify head) from a local directory.
        Hub download is not ported."""
        import dataclasses as dc

        from ...core.hub import download_weights
        from ...core.weights import dequantize_mlx, load_safetensors
        from .config import detect_config
        from .convert import convert_decoder, convert_encoder, strip_prefixes

        cfg = dc.replace(detect_config(model_id), encoder=ENCODER_ALIGNER)
        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        flat = strip_prefixes(load_safetensors(model_dir))
        enc = convert_encoder(flat, cfg)
        dec = convert_decoder(flat, cfg)
        head_w = flat["lm_head.weight"]
        if "lm_head.scales" in flat:
            head_w = dequantize_mlx(head_w, flat["lm_head.scales"], flat["lm_head.biases"],
                                    bits=cfg.decoder.bits, group_size=cfg.decoder.group_size)
        head = {"kernel": np.ascontiguousarray(head_w.T)}
        return cls(cfg, enc, dec, head, tokenizer=tokenizer, device=device, dtype=dtype, **kw)

    # -- alignment -----------------------------------------------------------

    @torch.inference_mode()
    def _slot_logits(self, audio: np.ndarray, slotted: SlottedText) -> torch.Tensor:
        """The forward: classify logits [n_ts, classify_num] at the slots,
        fp32, on the device."""
        asr, c, dev = self._asr, self.cfg, self.device
        st = asr.prestage([audio], 16000)            # float32 wire: no encoding
        audio_tokens, n_audio = asr._encode(st)      # [1, a_pad, hidden], [1]
        a_pad = audio_tokens.shape[1]

        prefix = [c.im_start_id, c.system_id, c.newline_id, c.eos_id, c.newline_id,
                  c.im_start_id, c.user_id, c.newline_id, c.audio_start_id]
        # audio_end + im_end + \n + im_start assistant \n then slotted text
        text_ids = [c.audio_end_id, c.eos_id, c.newline_id,
                    c.im_start_id, c.assistant_id, c.newline_id] + slotted.token_ids
        text_offset = 6
        pb = _round_block(len(prefix))
        tb = _round_block(len(text_ids), 128)
        prefix_arr = np.zeros(pb, np.int64)
        prefix_arr[: len(prefix)] = prefix
        text_arr = np.zeros(tb, np.int64)
        text_arr[: len(text_ids)] = text_ids
        ts_pos = torch.as_tensor([p + text_offset for p in slotted.timestamp_positions],
                                 dtype=torch.int64, device=dev)

        dcfg = c.decoder
        dec = asr.decoder_params
        table = dec["embed_tokens"]
        emb_prefix = embedding_lookup(table, torch.from_numpy(prefix_arr).to(dev)[None],
                                      dcfg.hidden_size)
        emb_text = embedding_lookup(table, torch.from_numpy(text_arr).to(dev)[None],
                                    dcfg.hidden_size)
        embeds = torch.cat([emb_prefix, audio_tokens.to(emb_prefix.dtype), emb_text], dim=1)
        valid = torch.cat([
            torch.arange(pb, device=dev) < len(prefix),
            torch.arange(a_pad, device=dev) < n_audio[0],
            torch.arange(tb, device=dev) < len(text_ids),
        ])[None]
        t = embeds.shape[1]
        cache = make_cache(dcfg, 1, t, self.dtype, device=dev)
        hidden, _ = prefill(dec, dcfg, embeds, valid, cache)
        slots = hidden[0, pb + a_pad + ts_pos]                  # [n_ts, hidden]
        return linear(slots, self.classify_params).float()      # [n_ts, classify_num]

    def _raw_indices(self, audio: np.ndarray, slotted: SlottedText) -> List[int]:
        return self._slot_logits(audio, slotted).argmax(dim=-1).cpu().tolist()

    def align(self, audio: np.ndarray, text: str, sample_rate: int = 16000,
              language: str = "English", **kwargs) -> Sequence[AlignedWord]:
        if self.tokenizer is None:
            raise RuntimeError("aligner requires a tokenizer")
        if sample_rate != 16000:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, 16000)
        duration = len(audio) / 16000.0
        if duration > self.max_chunk_s:
            return self.align_long(audio, text, language=language)

        slotted = slot_text(text, self.tokenizer, self.cfg.timestamp_id, language)
        if not slotted.words:
            return []
        raw = self._raw_indices(audio, slotted)
        corrected = enforce_monotonicity(raw)

        seg = self.cfg.timestamp_segment_time
        out: List[AlignedWord] = []
        for wi, word in enumerate(slotted.words):
            si, ei = 2 * wi, 2 * wi + 1
            if ei >= len(corrected):
                break
            start = corrected[si] * seg
            end = max(corrected[ei] * seg, start)
            out.append(AlignedWord(word=word, start=start, end=end))
        return out

    def align_long(self, audio: np.ndarray, text: str, language: str = "English",
                   plateau_window: int = 6) -> Sequence[AlignedWord]:
        """Chunked alignment for audio beyond the model's usable horizon:
        align a chunk, drop trailing plateau words (timestamps saturated at
        the chunk edge), then realign the remaining words against the
        remaining audio (reference: ForcedAligner.alignLong :100-216)."""
        sr = 16000
        chunk_samples = int(self.max_chunk_s * sr)
        # advance over slot_text's MERGED word list (punct-only and
        # unencodable tokens attach to the previous word), the same units
        # align() returns — advancing the raw split_word_pairs surfaces by
        # merged-word counts duplicated or skipped words across chunks.
        # The merge is stable under re-joining: slot_text(" ".join(words))
        # regroups to the same list.
        surfaces = slot_text(text, self.tokenizer, self.cfg.timestamp_id,
                             language).words
        aligned: List[AlignedWord] = []
        offset_s = 0.0
        pos = 0

        while pos < len(audio) and surfaces:
            chunk = audio[pos : pos + chunk_samples]
            chunk_words = self.align(chunk, " ".join(surfaces), language=language)
            if not chunk_words:
                break
            is_last_chunk = pos + chunk_samples >= len(audio)
            if is_last_chunk:
                keep = len(chunk_words)
            else:
                # trailing plateau: last words stuck at ~the same timestamp
                keep = len(chunk_words)
                if len(chunk_words) > plateau_window:
                    tail = chunk_words[-plateau_window:]
                    if tail[-1].end - tail[0].start < 0.2:
                        while keep > 1 and chunk_words[keep - 1].start >= tail[0].start:
                            keep -= 1
            for w in chunk_words[:keep]:
                aligned.append(AlignedWord(w.word, w.start + offset_s, w.end + offset_s, w.confidence))
            surfaces = surfaces[keep:]
            if not surfaces:
                break
            # resume audio just after the last kept word
            resume_s = max(chunk_words[keep - 1].end, 0.0)
            advance = int(resume_s * sr)
            if advance <= 0:
                advance = chunk_samples
            pos += min(advance, chunk_samples)
            offset_s = pos / sr
        return aligned
