"""Text cleaners: named transformations applied to raw text before symbol
lookup; the JAX package's ``text/cleaners.py``, the same five cleaners in
the same registry.

``english_cleaners`` and ``transliteration_cleaners`` transliterate to
ASCII with ``unidecode`` where it is installed, else by NFKD decomposition,
dropping what has no ASCII form.
"""

from __future__ import annotations

import re
import unicodedata

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    try:
        from unidecode import unidecode  # optional

        return unidecode(text)
    except ImportError:
        return (
            unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore")
            .decode("ascii")
        )


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    from .numbers_en import normalize_numbers

    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


def chinese_cleaners(text: str) -> str:
    """Whitespace collapse only (reference: text/cleaners.py:100-102)."""
    return collapse_whitespace(text)


def korean_cleaners(text: str) -> str:
    """Korean pipeline: Hangul normalization (number/abbreviation expansion
    via the jamo rule engine) + whitespace collapse
    (reference: text/cleaners.py:93-98)."""
    from .korean import normalize

    return collapse_whitespace(normalize(text))


_CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "chinese_cleaners": chinese_cleaners,
    "korean_cleaners": korean_cleaners,
}


def clean_text(text: str, cleaner_names: list[str]) -> str:
    for name in cleaner_names:
        if name not in _CLEANERS:
            raise ValueError(f"Unknown cleaner: {name}")
        text = _CLEANERS[name](text)
    return text
