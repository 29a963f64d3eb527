"""English G2P: CMUdict lexicon lookup with fallbacks; the JAX package's
``text/english.py``.

1. a user-supplied CMUdict-format lexicon file (``word  AH0 B ...``) is the
   primary source,
2. ``g2p_en`` is used for OOV words when installed,
3. otherwise OOV words fall back to character symbols (the reference's
   cleaner path feeds raw characters through the symbol table too).

ARPAbet phones are ``@``-prefixed before symbol lookup, matching
``_arpabet_to_sequence`` (reference: text/__init__.py:58-60).
"""

from __future__ import annotations

import re

_ALT_RE = re.compile(r"\([0-9]+\)$")
VALID_ARPABET = {
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
}


class CMUDict:
    """CMU pronouncing dictionary (reference: text/cmudict.py semantics:
    first pronunciation wins, stress markers kept)."""

    def __init__(self, path: str | None = None,
                 keep_ambiguous: bool = True):
        self._entries: dict[str, list[str]] = {}
        if path:
            with open(path, encoding="latin-1") as f:
                for line in f:
                    if not line or line.startswith((";;;", "#")):
                        continue
                    parts = line.strip().split("  ")
                    if len(parts) != 2:
                        continue
                    word = _ALT_RE.sub("", parts[0]).upper()
                    if not keep_ambiguous and word in self._entries:
                        continue
                    if word not in self._entries:
                        self._entries[word] = parts[1].split()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        return self._entries.get(word.upper())


def english_to_phonemes(text: str, cmudict: CMUDict | None = None
                        ) -> list[str]:
    """Words → ARPAbet phones where known; OOV → characters."""
    g2p = None
    try:
        from g2p_en import G2p  # optional

        g2p = G2p()
    except ImportError:
        pass

    out: list[str] = []
    for word in re.findall(r"[A-Za-z']+|[^A-Za-z\s]", text):
        pron = cmudict.lookup(word) if cmudict else None
        if pron is None and g2p is not None and word[0].isalpha():
            pron = [p for p in g2p(word) if p.strip()]
        if pron:
            out.extend("@" + p for p in pron)
        else:
            out.extend(word.lower())
    return out
