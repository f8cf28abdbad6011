"""Kokoro multilingual phonemizers: Mandarin, Japanese, Hindi.

TPU-host-native analogs of the reference's per-language phonemizers
(reference: Sources/KokoroTTS/ChinesePhonemizer.swift,
JapanesePhonemizer.swift, HindiPhonemizer.swift).  Where the reference
leans on Apple platform services the equivalents here are pure tables:

  * zh: the reference gets hanzi→pinyin from CFStringTransform
    MandarinLatin, then maps pinyin→IPA (initials/finals tables adapted
    from stefantaubert/pinyin-to-ipa, tones simplified to Kokoro's arrow
    vocabulary — ChinesePhonemizer.swift:15-87).  Here the same
    pinyin→IPA tables are applied to (a) numbered-pinyin input directly
    ("ni3 hao3") and (b) hanzi via a built-in high-frequency
    hanzi→pinyin lexicon; unknown hanzi are skipped like the reference
    skips untransformable runs.
  * ja: the reference romanizes via morphological analysis then maps
    katakana→phonemes (JapanesePhonemizer.swift:15-74).  Here hiragana
    is folded to katakana (U+3041-3096 → +0x60) and the same digraph +
    single tables apply; kanji without readings are skipped silently
    (the reference's unknown-character behavior).
  * hi: the reference transliterates Devanagari→IAST via
    CFStringTransform then maps roman→IPA (HindiPhonemizer.swift:12-36).
    Here the Devanagari→IAST step is the deterministic script mapping
    (inherent schwa after bare consonants, matras, virama, nasal marks,
    word-final schwa deletion), feeding the same roman→IPA tables.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Mandarin
# ---------------------------------------------------------------------------

# longest-match first (zh before z) — ChinesePhonemizer.swift:15-24
_ZH_INITIALS: List[Tuple[str, str]] = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"),
    ("j", "tɕ"), ("q", "tɕʰ"), ("x", "ɕ"),
    ("z", "ts"), ("c", "tsʰ"), ("s", "s"),
    ("r", "ɻ"),
]

# "0" is the tone slot — ChinesePhonemizer.swift:36-46
_ZH_FINALS: List[Tuple[str, str]] = [
    ("iang", "ja0ŋ"), ("iong", "jʊ0ŋ"), ("uang", "wa0ŋ"), ("ueng", "wə0ŋ"),
    ("iao", "jau0"), ("ian", "jɛ0n"), ("iou", "jou0"),
    ("uai", "wai0"), ("uan", "wa0n"), ("uei", "wei0"), ("uen", "wə0n"),
    ("üan", "ɥɛ0n"), ("üe", "ɥe0"),
    ("ang", "a0ŋ"), ("eng", "ə0ŋ"), ("ing", "i0ŋ"), ("ong", "ʊ0ŋ"),
    ("ai", "ai0"), ("ei", "ei0"), ("ao", "au0"), ("ou", "ou0"),
    ("an", "a0n"), ("en", "ə0n"), ("in", "i0n"), ("ün", "y0n"),
    ("ia", "ja0"), ("ie", "je0"), ("uo", "wo0"), ("ua", "wa0"),
    ("a", "a0"), ("e", "ɤ0"), ("i", "i0"), ("o", "wo0"), ("u", "u0"), ("ü", "y0"),
]

_ZH_RETROFLEX_I = "ɨ0"   # after zh/ch/sh/r  (ChinesePhonemizer.swift:52-56)
_ZH_ALVEOLAR_I = "ɨ0"    # after z/c/s

_ZH_INTERJECTIONS = {"er": "ɚ0", "io": "jɔ0", "ê": "ɛ0"}
_ZH_SYLLABIC = {"hng": "hŋ0", "hm": "hm0", "ng": "ŋ0", "m": "m0", "n": "n0"}

# arrow-notation tones matching Kokoro's vocab — ChinesePhonemizer.swift:77-84
_ZH_TONES = {"1": "→", "2": "↗", "3": "↓", "4": "↘", "5": "", "0": ""}

_ZH_PUNCT = {
    "，": ",", "。": ".", "！": "!", "？": "?", "；": ";", "：": ":",
    "、": ",", "—": "-", "「": '"', "」": '"', "『": '"', "』": '"',
    "《": '"', "》": '"', "【": '"', "】": '"', "（": "(", "）": ")",
}

# vowel-with-tone-diacritic → (bare vowel, tone digit) for mark-style pinyin
_ZH_TONE_MARKS = {
    "ā": ("a", "1"), "á": ("a", "2"), "ǎ": ("a", "3"), "à": ("a", "4"),
    "ē": ("e", "1"), "é": ("e", "2"), "ě": ("e", "3"), "è": ("e", "4"),
    "ī": ("i", "1"), "í": ("i", "2"), "ǐ": ("i", "3"), "ì": ("i", "4"),
    "ō": ("o", "1"), "ó": ("o", "2"), "ǒ": ("o", "3"), "ò": ("o", "4"),
    "ū": ("u", "1"), "ú": ("u", "2"), "ǔ": ("u", "3"), "ù": ("u", "4"),
    "ǖ": ("ü", "1"), "ǘ": ("ü", "2"), "ǚ": ("ü", "3"), "ǜ": ("ü", "4"),
}

# High-frequency hanzi → numbered pinyin (stands in for the platform
# transliterator the reference calls; unknown characters are skipped just
# like the reference's untransformable runs).
_HANZI_PINYIN: Dict[str, str] = {
    "你": "ni3", "好": "hao3", "我": "wo3", "是": "shi4", "的": "de5",
    "了": "le5", "在": "zai4", "有": "you3", "他": "ta1", "她": "ta1",
    "们": "men5", "这": "zhe4", "那": "na4", "不": "bu4", "人": "ren2",
    "一": "yi1", "二": "er4", "三": "san1", "四": "si4", "五": "wu3",
    "六": "liu4", "七": "qi1", "八": "ba1", "九": "jiu3", "十": "shi2",
    "百": "bai3", "千": "qian1", "万": "wan4", "零": "ling2",
    "大": "da4", "小": "xiao3", "中": "zhong1", "国": "guo2", "家": "jia1",
    "上": "shang4", "下": "xia4", "来": "lai2", "去": "qu4", "出": "chu1",
    "会": "hui4", "能": "neng2", "要": "yao4", "说": "shuo1", "话": "hua4",
    "看": "kan4", "听": "ting1", "想": "xiang3", "知": "zhi1", "道": "dao4",
    "什": "shen2", "么": "me5", "谁": "shei2", "哪": "na3", "里": "li3",
    "时": "shi2", "候": "hou4", "天": "tian1", "年": "nian2", "月": "yue4",
    "日": "ri4", "今": "jin1", "明": "ming2", "昨": "zuo2", "早": "zao3",
    "晚": "wan3", "点": "dian3", "分": "fen1", "秒": "miao3",
    "水": "shui3", "火": "huo3", "山": "shan1", "口": "kou3", "手": "shou3",
    "心": "xin1", "头": "tou2", "眼": "yan3", "耳": "er3", "嘴": "zui3",
    "吃": "chi1", "喝": "he1", "饭": "fan4", "菜": "cai4", "茶": "cha2",
    "学": "xue2", "生": "sheng1", "老": "lao3", "师": "shi1", "同": "tong2",
    "朋": "peng2", "友": "you3", "爱": "ai4", "喜": "xi3", "欢": "huan1",
    "高": "gao1", "兴": "xing4", "快": "kuai4", "乐": "le4", "谢": "xie4",
    "对": "dui4", "起": "qi3", "没": "mei2", "关": "guan1", "系": "xi4",
    "请": "qing3", "问": "wen4", "再": "zai4", "见": "jian4", "和": "he2",
    "很": "hen3", "太": "tai4", "多": "duo1", "少": "shao3", "个": "ge4",
    "些": "xie1", "都": "dou1", "也": "ye3", "还": "hai2", "就": "jiu4",
    "只": "zhi3", "从": "cong2", "到": "dao4", "给": "gei3", "让": "rang4",
    "被": "bei4", "把": "ba3", "为": "wei4", "因": "yin1", "所": "suo3",
    "以": "yi3", "如": "ru2", "果": "guo3", "但": "dan4", "而": "er2",
    "地": "di4", "方": "fang1", "面": "mian4", "前": "qian2", "后": "hou4",
    "左": "zuo3", "右": "you4", "东": "dong1", "西": "xi1", "南": "nan2",
    "北": "bei3", "京": "jing1", "海": "hai3", "路": "lu4", "车": "che1",
    "飞": "fei1", "机": "ji1", "电": "dian4", "脑": "nao3", "视": "shi4",
    "影": "ying3", "音": "yin1", "声": "sheng1", "字": "zi4", "书": "shu1",
    "写": "xie3", "读": "du2", "做": "zuo4", "工": "gong1", "作": "zuo4",
    "开": "kai1", "始": "shi3", "结": "jie2", "束": "shu4", "买": "mai3",
    "卖": "mai4", "钱": "qian2", "块": "kuai4", "元": "yuan2", "语": "yu3",
    "文": "wen2", "英": "ying1", "汉": "han4", "名": "ming2", "姓": "xing4",
    "叫": "jiao4", "岁": "sui4", "男": "nan2", "女": "nü3", "孩": "hai2",
    "子": "zi3", "妈": "ma1", "爸": "ba4", "哥": "ge1", "姐": "jie3",
    "弟": "di4", "妹": "mei4", "站": "zhan4", "走": "zou3", "跑": "pao3",
    "坐": "zuo4", "住": "zhu4", "门": "men2", "窗": "chuang1", "房": "fang2",
    "间": "jian1", "床": "chuang2", "桌": "zhuo1", "椅": "yi3", "灯": "deng1",
    "红": "hong2", "黄": "huang2", "蓝": "lan2", "绿": "lü4", "白": "bai2",
    "黑": "hei1", "色": "se4", "长": "chang2", "短": "duan3", "新": "xin1",
    "旧": "jiu4", "冷": "leng3", "热": "re4", "风": "feng1", "雨": "yu3",
    "雪": "xue3", "云": "yun2", "太阳": "tai4 yang2", "星": "xing1",
}


def _pinyin_syllable_to_ipa(syl: str) -> str:
    """One numbered-pinyin syllable ("hao3") → IPA with arrow tone."""
    syl = syl.strip().lower()
    if not syl:
        return ""
    tone = "0"
    if syl[-1] in "012345":
        tone = syl[-1]
        syl = syl[:-1]
    # tone-mark style → bare + digit
    out = []
    for ch in syl:
        if ch in _ZH_TONE_MARKS:
            bare, tone = _ZH_TONE_MARKS[ch]
            out.append(bare)
        else:
            out.append(ch)
    syl = "".join(out).replace("v", "ü")

    if syl in _ZH_SYLLABIC:
        base = _ZH_SYLLABIC[syl]
    elif syl in _ZH_INTERJECTIONS:
        base = _ZH_INTERJECTIONS[syl]
    else:
        initial_ipa, rest = "", syl
        for pin, ipa in _ZH_INITIALS:
            if syl.startswith(pin):
                initial_ipa, rest = ipa, syl[len(pin):]
                break
        # pinyin orthography: yi→i, wu→u, yu→ü, y→i, w→u
        if not initial_ipa:
            if rest.startswith("yu"):
                rest = "ü" + rest[2:]
            elif rest.startswith("yi"):
                rest = rest[1:]
            elif rest.startswith("y"):
                rest = "i" + rest[1:]
            elif rest.startswith("wu"):
                rest = rest[1:]
            elif rest.startswith("w"):
                rest = "u" + rest[1:]
        # j/q/x + u means ü
        if initial_ipa in ("tɕ", "tɕʰ", "ɕ") and rest.startswith("u"):
            rest = "ü" + rest[1:]
        if rest == "i" and initial_ipa in ("ʈʂ", "ʈʂʰ", "ʂ", "ɻ"):
            final_ipa = _ZH_RETROFLEX_I
        elif rest == "i" and initial_ipa in ("ts", "tsʰ", "s"):
            final_ipa = _ZH_ALVEOLAR_I
        else:
            final_ipa = ""
            for pin, ipa in _ZH_FINALS:
                if rest == pin:
                    final_ipa = ipa
                    break
            if not final_ipa:
                return ""          # not a pinyin syllable
        base = initial_ipa + final_ipa
    return base.replace("0", _ZH_TONES.get(tone, ""))


def phonemize_zh(text: str) -> str:
    """Mandarin → IPA: hanzi via the built-in lexicon, numbered/toned
    pinyin and ASCII passthrough handled directly."""
    result = []
    last_was_word = False
    pinyin_token = re.compile(r"[a-zümǖǘǚǜāáǎàēéěèīíǐìōóǒòūúǔù]+[0-5]?", re.I)
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in _ZH_PUNCT:
            result.append(_ZH_PUNCT[ch])
            last_was_word = False
            i += 1
        elif ch.isspace():
            if last_was_word:
                result.append(" ")
            last_was_word = False
            i += 1
        elif ch in _HANZI_PINYIN:
            ipa = " ".join(_pinyin_syllable_to_ipa(s)
                           for s in _HANZI_PINYIN[ch].split())
            result.append(ipa)
            last_was_word = True
            i += 1
        else:
            m = pinyin_token.match(text, i)
            if m:
                ipa = _pinyin_syllable_to_ipa(m.group(0))
                if ipa:
                    result.append(ipa)
                else:                      # not pinyin → letter passthrough
                    if not last_was_word:
                        result.append(" ")
                    result.append(m.group(0).lower())
                last_was_word = True
                i = m.end()
            else:
                i += 1                     # unknown char (incl. rare hanzi)
    return "".join(result).strip()


# ---------------------------------------------------------------------------
# Japanese
# ---------------------------------------------------------------------------

_JA_DIGRAPHS = {
    "イェ": "je",
    "ウィ": "wi", "ウゥ": "wu", "ウェ": "we", "ウォ": "wo",
    "キィ": "kyi", "キェ": "kye", "キャ": "kya", "キュ": "kyu", "キョ": "kyo",
    "ギィ": "gyi", "ギェ": "gye", "ギャ": "gya", "ギュ": "gyu", "ギョ": "gyo",
    "クァ": "kwa", "クィ": "kwi", "クゥ": "kwu", "クェ": "kwe", "クォ": "kwo", "クヮ": "kwa",
    "グァ": "gwa", "グィ": "gwi", "グゥ": "gwu", "グェ": "gwe", "グォ": "gwo", "グヮ": "gwa",
    "シェ": "she", "シャ": "sha", "シュ": "shu", "ショ": "sho",
    "ジェ": "je", "ジャ": "ja", "ジュ": "ju", "ジョ": "jo",
    "スィ": "si", "ズィ": "zi",
    "チェ": "che", "チャ": "cha", "チュ": "chu", "チョ": "cho",
    "ヂェ": "je", "ヂャ": "ja", "ヂュ": "ju", "ヂョ": "jo",
    "ツァ": "tsa", "ツィ": "tsi", "ツェ": "tse", "ツォ": "tso",
    "ティ": "ti", "テェ": "tye", "テャ": "tya", "テュ": "tyu", "テョ": "tyo",
    "ディ": "di", "デェ": "dye", "デャ": "dya", "デュ": "dyu", "デョ": "dyo",
    "トゥ": "tu", "ドゥ": "du",
    "ニィ": "nyi", "ニェ": "nye", "ニャ": "nya", "ニュ": "nyu", "ニョ": "nyo",
    "ヒィ": "hyi", "ヒェ": "hye", "ヒャ": "hya", "ヒュ": "hyu", "ヒョ": "hyo",
    "ビィ": "byi", "ビェ": "bye", "ビャ": "bya", "ビュ": "byu", "ビョ": "byo",
    "ピィ": "pyi", "ピェ": "pye", "ピャ": "pya", "ピュ": "pyu", "ピョ": "pyo",
    "ファ": "fa", "フィ": "fi", "フェ": "fe", "フォ": "fo",
    "ミィ": "myi", "ミェ": "mye", "ミャ": "mya", "ミュ": "myu", "ミョ": "myo",
    "リィ": "ryi", "リェ": "rye", "リャ": "rya", "リュ": "ryu", "リョ": "ryo",
    "ヴァ": "va", "ヴィ": "vi", "ヴェ": "ve", "ヴォ": "vo",
    "ヴャ": "bya", "ヴュ": "byu", "ヴョ": "byo",
}

_JA_SINGLES = {
    "ァ": "a", "ア": "a", "ィ": "i", "イ": "i",
    "ゥ": "u", "ウ": "u", "ェ": "e", "エ": "e", "ォ": "o", "オ": "o",
    "カ": "ka", "ガ": "ga", "キ": "ki", "ギ": "gi", "ク": "ku", "グ": "gu",
    "ケ": "ke", "ゲ": "ge", "コ": "ko", "ゴ": "go",
    "サ": "sa", "ザ": "za", "シ": "shi", "ジ": "ji", "ス": "su", "ズ": "zu",
    "セ": "se", "ゼ": "ze", "ソ": "so", "ゾ": "zo",
    "タ": "ta", "ダ": "da", "チ": "chi", "ヂ": "ji", "ツ": "tsu", "ヅ": "zu",
    "テ": "te", "デ": "de", "ト": "to", "ド": "do",
    "ナ": "na", "ニ": "ni", "ヌ": "nu", "ネ": "ne", "ノ": "no",
    "ハ": "ha", "バ": "ba", "パ": "pa", "ヒ": "hi", "ビ": "bi", "ピ": "pi",
    "フ": "fu", "ブ": "bu", "プ": "pu", "ヘ": "he", "ベ": "be", "ペ": "pe",
    "ホ": "ho", "ボ": "bo", "ポ": "po",
    "マ": "ma", "ミ": "mi", "ム": "mu", "メ": "me", "モ": "mo",
    "ャ": "ya", "ヤ": "ya", "ュ": "yu", "ユ": "yu", "ョ": "yo", "ヨ": "yo",
    "ラ": "ra", "リ": "ri", "ル": "ru", "レ": "re", "ロ": "ro",
    "ヮ": "wa", "ワ": "wa", "ヰ": "i", "ヱ": "e", "ヲ": "o",
    "ヴ": "vu", "ヵ": "ka", "ヶ": "ke",
    "ヷ": "va", "ヸ": "vi", "ヹ": "ve", "ヺ": "vo",
    "ッ": "ʔ", "ン": "ɴ", "ー": "ː",
}

_JA_PUNCT = {
    "「": '"', "」": '"', "『": '"', "』": '"', "【": '"', "】": '"',
    "〈": '"', "〉": '"', "《": '"', "》": '"', "«": '"', "»": '"',
    "、": ",", "。": ".", "！": "!", "？": "?", "（": "(", "）": ")",
    "：": ":", "；": ";",
}


def _fold_kana(text: str) -> str:
    """hiragana → katakana (U+3041-3096 shift by 0x60)."""
    return "".join(chr(ord(c) + 0x60) if "ぁ" <= c <= "ゖ" else c
                   for c in text)


def katakana_to_phonemes(katakana: str) -> str:
    """M2P table application (JapanesePhonemizer.swift:161-186)."""
    out = []
    chars = _fold_kana(katakana)
    i = 0
    while i < len(chars):
        if i + 1 < len(chars) and chars[i: i + 2] in _JA_DIGRAPHS:
            out.append(_JA_DIGRAPHS[chars[i: i + 2]])
            i += 2
            continue
        ph = _JA_SINGLES.get(chars[i])
        if ph is not None:
            out.append(ph)
        i += 1
    return "".join(out)


def phonemize_ja(text: str) -> str:
    """Japanese → phonemes: kana directly through the M2P tables; kanji
    without readings are skipped (the reference's unknown-char behavior);
    ASCII letters pass through lowercased."""
    result = []
    last_was_word = False
    kana_run: list = []

    def flush_kana():
        # whole runs go through katakana_to_phonemes so its yoon/extended
        # DIGRAPH lookahead (キョ→kyo, シャ→sha, ...) can actually match —
        # per-character feeding made every palatalized syllable mispronounce
        if kana_run:
            result.append(katakana_to_phonemes("".join(kana_run)))
            kana_run.clear()

    for ch in text:
        if "ぁ" <= ch <= "ヿ":       # kana: accumulate the run
            kana_run.append(ch)
            last_was_word = True
            continue
        flush_kana()
        if ch in _JA_PUNCT:
            result.append(_JA_PUNCT[ch])
            last_was_word = False
        elif ch.isspace():
            if last_was_word:
                result.append(" ")
            last_was_word = False
        elif ch.isascii() and ch.isalpha():
            if not last_was_word:
                result.append(" ")
            result.append(ch.lower())
            last_was_word = True
        elif ch in ",.!?;:-":
            result.append(ch)
            last_was_word = False
        # kanji / unknown: skipped silently
    flush_kana()
    return "".join(result).strip()


# ---------------------------------------------------------------------------
# Hindi
# ---------------------------------------------------------------------------

# HindiPhonemizer.swift:12-31
_HI_CONSONANTS = [
    ("kh", "kʰ"), ("gh", "ɡʱ"), ("ch", "tʃ"), ("jh", "dʒʱ"),
    ("th", "tʰ"), ("dh", "dʱ"), ("ph", "pʰ"), ("bh", "bʱ"),
    ("sh", "ʃ"), ("ṣ", "ʂ"),
    ("k", "k"), ("g", "ɡ"), ("ṅ", "ŋ"),
    ("c", "tʃ"), ("j", "dʒ"), ("ñ", "ɲ"),
    ("ṭ", "ʈ"), ("ḍ", "ɖ"), ("ṇ", "ɳ"),
    ("t", "t"), ("d", "d"), ("n", "n"),
    ("p", "p"), ("b", "b"), ("m", "m"),
    ("y", "j"), ("r", "ɾ"), ("l", "l"), ("v", "ʋ"), ("w", "ʋ"),
    ("s", "s"), ("h", "ɦ"), ("ṛ", "ɾ"), ("ṁ", "̃"),
]
_HI_VOWELS = [
    ("ai", "ɛː"), ("au", "ɔː"),
    ("ā", "aː"), ("ī", "iː"), ("ū", "uː"), ("ē", "eː"), ("ō", "oː"),
    ("a", "ə"), ("i", "ɪ"), ("u", "ʊ"), ("e", "e"), ("o", "o"),
]

# Devanagari → IAST (independent vowels, matras, consonants)
_DEV_VOWELS = {
    "अ": "a", "आ": "ā", "इ": "i", "ई": "ī", "उ": "u", "ऊ": "ū",
    "ऋ": "ṛi", "ए": "ē", "ऐ": "ai", "ओ": "ō", "औ": "au",
}
_DEV_MATRAS = {
    "ा": "ā", "ि": "i", "ी": "ī", "ु": "u", "ू": "ū", "ृ": "ṛi",
    "े": "ē", "ै": "ai", "ो": "ō", "ौ": "au",
}
_DEV_CONSONANTS = {
    "क": "k", "ख": "kh", "ग": "g", "घ": "gh", "ङ": "ṅ",
    "च": "c", "छ": "ch", "ज": "j", "झ": "jh", "ञ": "ñ",
    "ट": "ṭ", "ठ": "ṭh", "ड": "ḍ", "ढ": "ḍh", "ण": "ṇ",
    "त": "t", "थ": "th", "द": "d", "ध": "dh", "न": "n",
    "प": "p", "फ": "ph", "ब": "b", "भ": "bh", "म": "m",
    "य": "y", "र": "r", "ल": "l", "व": "v",
    "श": "sh", "ष": "ṣ", "स": "s", "ह": "h",
    "ड़": "ṛ", "ढ़": "ṛh", "क़": "q", "फ़": "f", "ज़": "z",
}
_DEV_VIRAMA = "्"
_DEV_ANUSVARA = "ं"
_DEV_CANDRABINDU = "ँ"
_HI_PUNCT = {"।": ".", "॥": ".", "，": ","}


def devanagari_to_iast(word: str) -> str:
    """Deterministic script transliteration with inherent-schwa handling
    and word-final schwa deletion (standard Hindi pronunciation)."""
    units: List[str] = []          # romanized units; consonants may need schwa
    pending_consonant = False
    i = 0
    chars = list(word)
    while i < len(chars):
        ch = chars[i]
        two = "".join(chars[i: i + 2])
        if two in _DEV_CONSONANTS:          # nukta pairs
            if pending_consonant:
                units.append("a")
            units.append(_DEV_CONSONANTS[two])
            pending_consonant = True
            i += 2
            continue
        if ch in _DEV_CONSONANTS:
            if pending_consonant:
                units.append("a")           # inherent schwa
            units.append(_DEV_CONSONANTS[ch])
            pending_consonant = True
        elif ch in _DEV_MATRAS:
            units.append(_DEV_MATRAS[ch])
            pending_consonant = False
        elif ch in _DEV_VOWELS:
            if pending_consonant:
                units.append("a")
                pending_consonant = False
            units.append(_DEV_VOWELS[ch])
        elif ch == _DEV_VIRAMA:
            pending_consonant = False       # suppress schwa (cluster)
        elif ch in (_DEV_ANUSVARA, _DEV_CANDRABINDU):
            if pending_consonant:
                units.append("a")
                pending_consonant = False
            units.append("ṁ")
        i += 1
    if pending_consonant:
        pass                                # word-final schwa deletion
    return "".join(units)


def roman_to_ipa_hi(roman: str) -> str:
    """IAST-ish romanization → IPA (HindiPhonemizer.swift:115-150)."""
    out = []
    i = 0
    while i < len(roman):
        matched = False
        for table in (_HI_VOWELS, _HI_CONSONANTS):
            for rom, ipa in table:
                if roman.startswith(rom, i) and len(rom) == 2:
                    out.append(ipa)
                    i += 2
                    matched = True
                    break
            if matched:
                break
        if matched:
            continue
        for table in (_HI_VOWELS, _HI_CONSONANTS):
            for rom, ipa in table:
                if len(rom) == 1 and roman.startswith(rom, i):
                    out.append(ipa)
                    i += 1
                    matched = True
                    break
            if matched:
                break
        if not matched:
            i += 1
    return "".join(out)


def phonemize_hi(text: str) -> str:
    result = []
    last_was_word = False
    for raw_word in re.split(r"(\s+|[।॥，,.!?;:])", text):
        if not raw_word:
            continue
        if raw_word in _HI_PUNCT:
            result.append(_HI_PUNCT[raw_word])
            last_was_word = False
        elif raw_word.strip() == "" :
            if last_was_word:
                result.append(" ")
            last_was_word = False
        elif raw_word in ",.!?;:":
            result.append(raw_word)
            last_was_word = False
        else:
            iast = devanagari_to_iast(raw_word) if any(
                "ऀ" <= c <= "ॿ" for c in raw_word) else raw_word.lower()
            ipa = roman_to_ipa_hi(iast)
            if len(ipa) >= 4:
                ipa = "ˈ" + ipa            # HindiPhonemizer.swift:46
            result.append(ipa)
            last_was_word = True
    return "".join(result).strip()
