"""Pinyin syllable → MFA phoneme decomposition.

Reproduces the rule-based initial/final split used at inference time by the
reference (reference: synthesize_chinese_pinyin.py:34-104): a toneless pinyin
syllable is split into an optional initial (b/p/m/.../zh/ch/sh) and a final,
and the final is mapped onto the 44-phone MFA pinyin inventory, with nasal
codas split out ("an" → "a n", "iang" → "ia ng", ...).
"""

from __future__ import annotations

import re

_INITIALS_2CHAR = ("zh", "ch", "sh")
_INITIALS_1CHAR = (
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
)

# Final → space-separated phoneme string (reference: synthesize_chinese_pinyin.py:47-58).
_FINALS = {
    "a": "a", "o": "o", "e": "e", "i": "i", "u": "u", "v": "y",
    "ai": "ai", "ei": "ei", "ui": "ui", "ao": "ao", "ou": "ou",
    "iu": "iu", "ie": "ie", "ue": "ue", "ve": "ue",
    "an": "a n", "en": "e n", "in": "i n", "un": "u n", "vn": "y n",
    "ang": "a ng", "eng": "e ng", "ing": "i ng", "ong": "o ng",
    "er": "er", "iao": "iao", "ian": "ia n", "iang": "ia ng",
    # NB: "io" is not in the 44-phone MFA inventory — the reference maps
    # iong → "io ng" anyway (synthesize_chinese_pinyin.py:54) and the unknown
    # phone then falls to pad/skip downstream; replicated for parity.
    "iong": "io ng", "uai": "uai", "uan": "ua n", "uang": "ua ng",
}

_TONE_RE = re.compile(r"[0-5]$")


def split_initial_final(syllable: str) -> tuple[str, str]:
    """Split a toneless pinyin syllable into (initial, final).

    The initial may be empty (zero-initial syllables like "an").
    """
    for init in _INITIALS_2CHAR:
        if syllable.startswith(init):
            return init, syllable[len(init):]
    for init in _INITIALS_1CHAR:
        if syllable.startswith(init):
            return init, syllable[len(init):]
    return "", syllable


def pinyin_to_phonemes(syllable: str) -> list[str]:
    """Convert one toneless pinyin syllable to its MFA phoneme sequence.

    Unknown finals fall back to per-character lookup, mirroring the
    reference behavior (reference: synthesize_chinese_pinyin.py:90-100).
    """
    syllable = _TONE_RE.sub("", syllable.strip().lower())
    if not syllable:
        return []
    initial, final = split_initial_final(syllable)
    phonemes: list[str] = []
    if initial:
        phonemes.append(initial)
    if final:
        if final in _FINALS:
            phonemes.extend(_FINALS[final].split())
        else:
            for ch in final:
                if ch in _FINALS:
                    phonemes.extend(_FINALS[ch].split())
                else:
                    phonemes.append(ch)
    return phonemes


def pinyin_sequence_to_phonemes(syllables: list[str]) -> list[str]:
    """Convert a list of pinyin syllables to a flat phoneme list."""
    out: list[str] = []
    for syl in syllables:
        out.extend(pinyin_to_phonemes(syl))
    return out
