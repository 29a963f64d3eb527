"""Korean front-end: hangul → jamo decomposition + number reading; the JAX
package's ``text/korean.py``.

The jamo decomposition is Unicode arithmetic (Hangul syllables are
(lead, vowel, tail) triples packed from U+AC00) and sino-Korean numbers are
read directly. ``normalize`` applies the pronunciation rules with ``g2pk``
where it is installed, else with the native rule engine (``pronounce``).
"""

from __future__ import annotations

import re

_HANGUL_BASE = 0xAC00
_LEADS = [
    "ᄀ", "ᄁ", "ᄂ", "ᄃ", "ᄄ", "ᄅ", "ᄆ", "ᄇ", "ᄈ", "ᄉ",
    "ᄊ", "ᄋ", "ᄌ", "ᄍ", "ᄎ", "ᄏ", "ᄐ", "ᄑ", "ᄒ",
]
_VOWELS = [
    "ᅡ", "ᅢ", "ᅣ", "ᅤ", "ᅥ", "ᅦ", "ᅧ", "ᅨ", "ᅩ", "ᅪ",
    "ᅫ", "ᅬ", "ᅭ", "ᅮ", "ᅯ", "ᅰ", "ᅱ", "ᅲ", "ᅳ", "ᅴ", "ᅵ",
]
_TAILS = [
    "", "ᆨ", "ᆩ", "ᆪ", "ᆫ", "ᆬ", "ᆭ", "ᆮ", "ᆯ", "ᆰ", "ᆱ",
    "ᆲ", "ᆳ", "ᆴ", "ᆵ", "ᆶ", "ᆷ", "ᆸ", "ᆹ", "ᆺ", "ᆻ", "ᆼ",
    "ᆽ", "ᆾ", "ᆿ", "ᇀ", "ᇁ", "ᇂ",
]

_SINO_DIGITS = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_SINO_SMALL = ["", "십", "백", "천"]
_SINO_BIG = ["", "만", "억", "조"]

JAMO_LEADS = _LEADS
JAMO_VOWELS = _VOWELS
JAMO_TAILS = [t for t in _TAILS if t]

# Symbol table for the Korean character path
# (reference: text/__init__.py:26-28 uses char_to_id for korean_cleaners).
_PAD, _SOS, _EOS, _SPACE = "_", "@", "|", " "
_PUNC = "!'(),-.:;?"
KOREAN_SYMBOLS = (
    [_PAD, _SOS, _EOS, _SPACE] + _LEADS + _VOWELS + JAMO_TAILS + list(_PUNC)
)
char_to_id = {c: i for i, c in enumerate(KOREAN_SYMBOLS)}
id_to_char = {i: c for i, c in enumerate(KOREAN_SYMBOLS)}


def is_hangul_syllable(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3


def hangul_to_jamo(text: str) -> list[str]:
    """Decompose hangul syllables to (lead, vowel[, tail]) jamo chars."""
    out: list[str] = []
    for ch in text:
        if is_hangul_syllable(ch):
            code = ord(ch) - _HANGUL_BASE
            lead, rem = divmod(code, 21 * 28)
            vowel, tail = divmod(rem, 28)
            out.append(_LEADS[lead])
            out.append(_VOWELS[vowel])
            if tail:
                out.append(_TAILS[tail])
        else:
            out.append(ch)
    return out


def number_to_korean(n: int) -> str:
    """Sino-Korean integer reading."""
    if n == 0:
        return _SINO_DIGITS[0]
    if n < 0:
        return "마이너스 " + number_to_korean(-n)
    s = str(n)
    groups = []
    while s:
        groups.append(s[-4:])
        s = s[:-4]
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        spoken = ""
        for i, c in enumerate(g):
            d = int(c)
            if d == 0:
                continue
            pos = len(g) - i - 1
            digit = "" if (d == 1 and pos > 0) else _SINO_DIGITS[d]
            spoken += digit + _SINO_SMALL[pos]
        if spoken == _SINO_DIGITS[1] and gi >= 1:
            spoken = ""  # 일만 → 만, 일억 → 억
            parts.append(_SINO_BIG[gi])
        elif spoken:
            parts.append(spoken + _SINO_BIG[gi])
    return "".join(parts)


# ---------------------------------------------------------------------------
# Standard-Korean pronunciation rules (표준발음법), native implementation.
#
# Replaces the g2pk dependency for the common rule set the reference relies
# on (reference: text/korean.py uses g2pk inside normalize): coda
# neutralization, complex-coda reduction, liaison, ㅎ deletion/aspiration,
# palatalization, nasalization, lateralization and obstruent tensification.
# Morphology-dependent exceptions (ㄴ-insertion, lexical tensification) are
# out of scope, as they require a dictionary.

# Lead (onset) indices.
_L = {c: i for i, c in enumerate(
    ["g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss", "", "j",
     "jj", "ch", "k", "t", "p", "h"])}
# Tail (coda) indices (0 = none).
_T = {c: i for i, c in enumerate(
    ["", "g", "kk", "gs", "n", "nj", "nh", "d", "l", "lg", "lm", "lb",
     "ls", "lt", "lp", "lh", "m", "b", "bs", "s", "ss", "ng", "j", "ch",
     "k", "t", "p", "h"])}

# Complex coda → (kept coda, liaison onset) for vowel-initial followers.
_COMPLEX_SPLIT = {
    _T["gs"]: (_T["g"], _L["ss"]), _T["nj"]: (_T["n"], _L["j"]),
    _T["lg"]: (_T["l"], _L["g"]), _T["lm"]: (_T["l"], _L["m"]),
    _T["lb"]: (_T["l"], _L["b"]), _T["ls"]: (_T["l"], _L["ss"]),
    _T["lt"]: (_T["l"], _L["t"]), _T["lp"]: (_T["l"], _L["p"]),
    _T["bs"]: (_T["b"], _L["ss"]),
}
# Complex coda → single coda in non-liaison position.
_COMPLEX_REDUCE = {
    _T["gs"]: _T["g"], _T["nj"]: _T["n"], _T["nh"]: _T["n"],
    _T["lg"]: _T["g"], _T["lm"]: _T["m"], _T["lb"]: _T["l"],
    _T["ls"]: _T["l"], _T["lt"]: _T["l"], _T["lp"]: _T["b"],
    _T["lh"]: _T["l"], _T["bs"]: _T["b"],
}
# Seven-coda neutralization.
_NEUTRAL = {
    _T["kk"]: _T["g"], _T["k"]: _T["g"], _T["s"]: _T["d"],
    _T["ss"]: _T["d"], _T["j"]: _T["d"], _T["ch"]: _T["d"],
    _T["t"]: _T["d"], _T["h"]: _T["d"], _T["p"]: _T["b"],
}
# Coda sound → onset it carries over under liaison.
_TAIL_TO_LEAD = {
    _T["g"]: _L["g"], _T["kk"]: _L["kk"], _T["n"]: _L["n"],
    _T["d"]: _L["d"], _T["l"]: _L["r"], _T["m"]: _L["m"],
    _T["b"]: _L["b"], _T["s"]: _L["s"], _T["ss"]: _L["ss"],
    _T["j"]: _L["j"], _T["ch"]: _L["ch"], _T["k"]: _L["k"],
    _T["t"]: _L["t"], _T["p"]: _L["p"],
}
_ASPIRATE = {_L["g"]: _L["k"], _L["d"]: _L["t"], _L["j"]: _L["ch"],
             _L["b"]: _L["p"]}
_TENSE = {_L["g"]: _L["kk"], _L["d"]: _L["tt"], _L["b"]: _L["pp"],
          _L["s"]: _L["ss"], _L["j"]: _L["jj"]}
_H_TAILS = {_T["h"]: 0, _T["nh"]: _T["n"], _T["lh"]: _T["l"]}
_VOWEL_I = 20  # ㅣ


def _apply_boundary(a: list[int], b: list[int] | None) -> None:
    """Apply pronunciation rules across syllables a→b in place."""
    t = a[2]
    lead = b[0] if b is not None else None

    # Palatalization: ㄷ/ㅌ(+ㄾ) + 이 → 지/치 (표준발음법 17항).
    if b is not None and lead == _L[""] and b[1] == _VOWEL_I:
        if t == _T["d"]:
            a[2], b[0] = 0, _L["j"]
            return
        if t == _T["t"]:
            a[2], b[0] = 0, _L["ch"]
            return
        if t == _T["lt"]:
            a[2], b[0] = _T["l"], _L["ch"]
            return

    # ㅎ codas (12항): aspirate/assimilate/delete.
    if t in _H_TAILS:
        keep = _H_TAILS[t]
        if b is not None and lead in _ASPIRATE:
            a[2], b[0] = keep, _ASPIRATE[lead]
            return
        if b is not None and lead == _L["s"]:
            a[2], b[0] = keep, _L["ss"]
            return
        if b is not None and lead == _L[""]:
            # ㅎ deletes; remaining consonant liaises.
            a[2] = 0
            if keep:
                b[0] = _TAIL_TO_LEAD[keep]
            return
        if b is not None and lead == _L["n"]:
            a[2] = keep if keep else _T["n"]
            if a[2] == _T["l"]:
                b[0] = _L["r"]  # 앓는 → 알른
            return
        a[2] = keep if keep else _T["d"]
        t = a[2]

    # Liaison (13-14항): coda + vowel onset.
    if b is not None and lead == _L[""] and t:
        if t in _COMPLEX_SPLIT:
            a[2], b[0] = _COMPLEX_SPLIT[t]
            return
        if t != _T["ng"]:
            a[2], b[0] = 0, _TAIL_TO_LEAD[t]
            return

    # Reduce complex codas, then neutralize (9-11항).
    lb_lt_stem = t in (_T["lb"], _T["lt"])
    if t in _COMPLEX_REDUCE:
        t = _COMPLEX_REDUCE[t]
    if t in _NEUTRAL:
        t = _NEUTRAL[t]
    # 25항: ㄼ/ㄾ stem codas tensify a following plain obstruent even
    # though the surfaced coda is ㄹ.
    if lb_lt_stem and b is not None and lead in _TENSE:
        a[2] = t
        b[0] = _TENSE[lead]
        return
    a[2] = t
    if b is None:
        return

    # Lateralization (20항).
    if t == _T["n"] and lead == _L["r"]:
        a[2] = _T["l"]
        return
    if t == _T["l"] and lead == _L["n"]:
        b[0] = _L["r"]
        return

    # Nasalization (18-19항).
    nasal = lead in (_L["n"], _L["m"])
    if t == _T["g"] and (nasal or lead == _L["r"]):
        a[2] = _T["ng"]
        if lead == _L["r"]:
            b[0] = _L["n"]
        return
    if t == _T["b"] and (nasal or lead == _L["r"]):
        a[2] = _T["m"]
        if lead == _L["r"]:
            b[0] = _L["n"]
        return
    if t == _T["d"] and nasal:
        a[2] = _T["n"]
        return
    if t in (_T["m"], _T["ng"]) and lead == _L["r"]:
        b[0] = _L["n"]
        return

    # Tensification (23항): obstruent coda + plain obstruent onset.
    if t in (_T["g"], _T["d"], _T["b"]) and lead in _TENSE:
        b[0] = _TENSE[lead]


def pronounce(text: str) -> str:
    """Apply the standard pronunciation rules to hangul text."""
    syls: list[list[int] | None] = []
    for ch in text:
        if is_hangul_syllable(ch):
            code = ord(ch) - _HANGUL_BASE
            lead, rem = divmod(code, 21 * 28)
            vowel, tail = divmod(rem, 28)
            syls.append([lead, vowel, tail])
        else:
            syls.append(None)
    for i, s in enumerate(syls):
        if s is None:
            continue
        nxt = syls[i + 1] if i + 1 < len(syls) else None
        _apply_boundary(s, nxt)
    out = []
    for i, s in enumerate(syls):
        if s is None:
            out.append(text[i])
        else:
            out.append(chr(_HANGUL_BASE + (s[0] * 21 + s[1]) * 28 + s[2]))
    return "".join(out)


def normalize(text: str) -> str:
    """Number expansion + whitespace cleanup + pronunciation rules (g2pk
    when installed, the native rule engine otherwise)."""
    text = re.sub(r"\d+", lambda m: number_to_korean(int(m.group(0))), text)
    text = re.sub(r"\s+", " ", text).strip()
    try:
        from g2pk import G2p  # optional full pronunciation rules

        text = G2p()(text)
    except ImportError:
        text = pronounce(text)
    return text


def korean_text_to_ids(text: str) -> list[int]:
    """Normalize → jamo → symbol IDs (unknown chars dropped)."""
    jamos = hangul_to_jamo(normalize(text))
    return [char_to_id[j] for j in jamos if j in char_to_id]
