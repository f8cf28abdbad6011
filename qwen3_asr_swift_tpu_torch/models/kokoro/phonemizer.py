"""Multilingual grapheme→phoneme front end for Kokoro.

TPU-native analog of the reference's in-repo phonemizers
(reference: Sources/KokoroTTS/Phonemizer.swift (673 lines) + per-language
phonemizers for Latin/Chinese/Japanese/Hindi). English follows the
reference's resolution order (Phonemizer.swift:333-455):

1. special cases (the/a/an/to/of/i — Phonemizer.swift:362-374)
2. dictionary lookup — the embedded ~700-word gold dictionary
   (en_dict.py), overlaid by snapshot ``{us,gb}_gold/silver.json``
   dictionaries when :func:`load_dictionaries` finds them (the misaki
   files the reference downloads with the model)
3. suffix stemming with voicing-sensitive endings: -s/-es/-ies →
   s/z/ɪz, -ed/-ied → t/d/ɪd, -ing with consonant de-doubling and
   silent-e restoration (Phonemizer.swift:378-455)
4. rule-based letter-to-sound fallback (the reference uses a BART G2P
   CoreML model here; a neural fallback is not portable to this
   environment, and the dictionary+stemming tiers take >90% of tokens)

Number expansion and punctuation → prosody marks are shared; CJK/Hindi
route to the table-driven phonemizers in phonemizer_i18n.py.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

from .en_dict import EN_GOLD

# Kokoro symbol set (StyleTTS2 convention): pad + punctuation + IPA letters.
_PAD = "$"
_PUNCT = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_IPA = "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"

SYMBOLS = [_PAD] + list(_PUNCT) + list(_LETTERS) + list(_IPA)
SYMBOL_TO_ID: Dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}
VOCAB_SIZE = len(SYMBOLS)

# special cases resolved before any dictionary (Phonemizer.swift:362-374;
# POS-dependent "a" collapses to the determiner reading)
_SPECIAL = {"the": "ðə", "a": "ɐ", "an": "ən", "to": "tʊ", "of": "ʌv", "i": "aɪ"}


class Lexicon:
    """Pronunciation dictionary tiers: snapshot gold overlay → embedded
    gold dictionary (en_dict.py) → snapshot silver overlay. INSTANCE
    scoped — dictionaries loaded by one ``KokoroTTS.from_pretrained``
    must not leak into other model instances or variants (a gb model and
    a us model in one process keep distinct readings)."""

    def __init__(self):
        self.gold: Dict[str, str] = {}
        self.silver: Dict[str, str] = {}

    def lookup(self, word: str) -> Optional[str]:
        return self.gold.get(word) or EN_GOLD.get(word) or self.silver.get(word)

    def load(self, directory, british: bool = False) -> int:
        """Overlay gold/silver dictionaries from a model snapshot directory
        (``us_gold.json``/``us_silver.json``, or ``gb_`` with
        ``british=True``). Entries may be plain IPA strings or POS-keyed
        heteronym dicts (the ``DEFAULT`` reading is used — this front end
        does not POS-tag). Returns the number of entries loaded."""
        prefix = "gb" if british else "us"
        n = 0
        for name, target in ((f"{prefix}_gold.json", self.gold),
                             (f"{prefix}_silver.json", self.silver)):
            path = Path(directory) / name
            if not path.exists():
                continue
            raw = json.loads(path.read_text())
            for word, entry in raw.items():
                if isinstance(entry, dict):
                    entry = entry.get("DEFAULT") or next(iter(entry.values()), None)
                if isinstance(entry, str):
                    target[word.lower()] = entry
                    n += 1
        return n


#: embedded-dictionary-only default used when no lexicon is passed
_DEFAULT_LEXICON = Lexicon()


def load_dictionaries(directory, british: bool = False) -> Lexicon:
    """Build a fresh :class:`Lexicon` with the snapshot overlays from
    ``directory`` (no module-global state is touched)."""
    lex = Lexicon()
    lex.load(directory, british=british)
    return lex


def _lookup(word: str, lexicon: Optional[Lexicon] = None) -> Optional[str]:
    return (lexicon or _DEFAULT_LEXICON).lookup(word)


_VOICELESS_S = set("ptkfθ")          # -s → /s/ after these (else /z/)
_SIBILANT = set("szʃʒʧʤ")            # -es → /ɪz/ after these
_VOICELESS_ED = set("pkfθsʃʧ")       # -ed → /t/ after these (t/d → /ɪd/)


def _ed_suffix(phonemes: str) -> str:
    last = phonemes[-1] if phonemes else ""
    if last in "td":
        return "ɪd"
    return "t" if last in _VOICELESS_ED else "d"


def _stem_and_lookup(word: str, lexicon: Optional[Lexicon] = None) -> Optional[str]:
    """Suffix stemming with voicing-sensitive endings
    (Phonemizer.swift:378-455): -s/-es/-ies, -ed/-ied with consonant
    de-doubling, -ing with de-doubling and silent-e restoration."""
    def _lookup(w):
        return (lexicon or _DEFAULT_LEXICON).lookup(w)

    if word.endswith("s") and len(word) > 2 and not word.endswith("ss"):
        if word.endswith("ies"):
            base = _lookup(word[:-3] + "y")
            if base:
                return base + "z"
        if word.endswith("es") and len(word) > 3:
            base = _lookup(word[:-2])
            if base:
                return base + ("ɪz" if base[-1] in _SIBILANT else "z")
        base = _lookup(word[:-1])
        if base:
            return base + ("s" if base[-1] in _VOICELESS_S else "z")
    if word.endswith("ed") and len(word) > 3:
        if word.endswith("ied"):
            base = _lookup(word[:-3] + "y")
            if base:
                return base + "d"
        stem = word[:-2]
        if len(stem) >= 2 and stem[-1] == stem[-2]:  # stopped → stop
            base = _lookup(stem[:-1])
            if base:
                return base + _ed_suffix(base)
        base = _lookup(stem) or _lookup(stem + "e")  # moved → move
        if base:
            return base + _ed_suffix(base)
    if word.endswith("ing") and len(word) > 4:
        stem = word[:-3]
        if len(stem) >= 2 and stem[-1] == stem[-2]:  # running → run
            base = _lookup(stem[:-1])
            if base:
                return base + "ɪŋ"
        base = _lookup(stem) or _lookup(stem + "e")  # making → make
        if base:
            return base + "ɪŋ"
    if word.endswith("ly") and len(word) > 3:
        base = _lookup(word[:-2])
        if base:
            return base + "li"
    return None

_RULES = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ough", "oʊ"), ("igh", "aɪ"),
    ("tch", "ʧ"), ("dge", "ʤ"), ("ing", "ɪŋ"), ("qu", "kw"), ("th", "θ"),
    ("sh", "ʃ"), ("ch", "ʧ"), ("ph", "f"), ("wh", "w"), ("ck", "k"),
    ("ee", "iː"), ("oo", "uː"), ("ea", "iː"), ("ou", "aʊ"), ("ow", "oʊ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ar", "ɑːɹ"),
    ("er", "ɚ"), ("or", "ɔːɹ"), ("a", "æ"), ("b", "b"), ("c", "k"),
    ("d", "d"), ("e", "ɛ"), ("f", "f"), ("g", "ɡ"), ("h", "h"), ("i", "ɪ"),
    ("j", "ʤ"), ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɑ"),
    ("p", "p"), ("r", "ɹ"), ("s", "s"), ("t", "t"), ("u", "ʌ"), ("v", "v"),
    ("w", "w"), ("x", "ks"), ("y", "j"), ("z", "z"),
]

_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = "ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def number_to_words(n: int) -> str:
    if n < 10:
        return _ONES[n]
    if n < 20:
        return _TEENS[n - 10]
    if n < 100:
        return _TENS[n // 10] + (" " + _ONES[n % 10] if n % 10 else "")
    if n < 1000:
        rest = n % 100
        return _ONES[n // 100] + " hundred" + (" " + number_to_words(rest) if rest else "")
    if n < 1_000_000:
        rest = n % 1000
        return number_to_words(n // 1000) + " thousand" + (" " + number_to_words(rest) if rest else "")
    return " ".join(number_to_words(int(d)) for d in str(n))


def _letter_to_sound(lw: str) -> str:
    out = []
    i = 0
    while i < len(lw):
        # silent final e
        if lw[i] == "e" and i == len(lw) - 1 and len(lw) > 2:
            break
        for pat, rep in _RULES:
            if lw.startswith(pat, i):
                out.append(rep)
                i += len(pat)
                break
        else:
            i += 1
    return "".join(out)


def _word_to_phonemes(word: str, lexicon: Optional[Lexicon] = None) -> str:
    """Resolution order per the reference (Phonemizer.swift:333-341):
    special case → dictionary → suffix stemming → letter-to-sound."""
    lw = word.lower()
    special = _SPECIAL.get(lw)
    if special is not None:
        return special
    hit = _lookup(lw, lexicon)
    if hit is not None:
        return hit
    stemmed = _stem_and_lookup(lw, lexicon)
    if stemmed is not None:
        return stemmed
    return _letter_to_sound(lw)


def dictionary_hit(word: str, lexicon: Optional[Lexicon] = None) -> bool:
    """True when the word resolves without the letter-to-sound fallback
    (coverage metric; tests assert >90% on a standard sentence set)."""
    lw = re.sub(r"[^a-z']", "", word.lower()).strip("'")
    if not lw:
        return True
    return (lw in _SPECIAL or _lookup(lw, lexicon) is not None
            or _stem_and_lookup(lw, lexicon) is not None)


def phonemize(text: str, language: str = "en",
              lexicon: Optional[Lexicon] = None) -> str:
    """text → phoneme string over the Kokoro symbol set.

    zh/ja/hi route to the dedicated phonemizers (reference:
    ChinesePhonemizer / JapanesePhonemizer / HindiPhonemizer — see
    phonemizer_i18n.py for the platform-free table equivalents)."""
    lang = language.lower()
    if lang.startswith("zh"):
        from .phonemizer_i18n import phonemize_zh

        return phonemize_zh(text)
    if lang.startswith("ja"):
        from .phonemizer_i18n import phonemize_ja

        return phonemize_ja(text)
    if lang.startswith("hi"):
        from .phonemizer_i18n import phonemize_hi

        return phonemize_hi(text)
    if lang.startswith("ko"):
        # no dedicated Korean phonemizer in the reference either —
        # per-character passthrough keeps hangul synthesizable
        return " ".join(ch for ch in text if not ch.isspace())

    text = re.sub(r"\d+", lambda m: number_to_words(int(m.group())), text)
    parts: List[str] = []
    for token in re.findall(r"[A-Za-z']+|[;:,.!?]", text):
        if re.match(r"[;:,.!?]", token):
            parts.append(token)
        else:
            parts.append(_word_to_phonemes(token.strip("'"), lexicon))
    return " ".join(parts)


def phonemes_to_ids(phonemes: str) -> List[int]:
    return [SYMBOL_TO_ID[c] for c in phonemes if c in SYMBOL_TO_ID]
