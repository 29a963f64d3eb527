"""Text cleaners: named transformations applied to raw text before symbol
lookup. The synthesis path needs only the basic one."""

from __future__ import annotations

import re

_whitespace_re = re.compile(r"\s+")


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return _whitespace_re.sub(" ", text.lower())


_CLEANERS = {"basic_cleaners": basic_cleaners}


def clean_text(text: str, cleaner_names: list[str]) -> str:
    for name in cleaner_names:
        if name not in _CLEANERS:
            raise ValueError(f"Unknown cleaner: {name}")
        text = _CLEANERS[name](text)
    return text
