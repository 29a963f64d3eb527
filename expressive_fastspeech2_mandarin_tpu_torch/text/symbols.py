"""Symbol inventories for the Mandarin front-end.

The same ID schemes as the JAX package's ``text/symbols.py``, so checkpoints
and phoneme IDs interoperate:

* ``PINYIN_SYMBOLS`` (108 symbols) — pad/punct/letters + 44 MFA pinyin phones.
* ``IPA_SYMBOLS`` (138 symbols) — pad/punct/letters + 74 ``@``-prefixed toned
  IPA phones.

The encoder embedding is sized ``len(IPA_SYMBOLS) + 1 = 139`` rows even for
pinyin IDs (``VOCAB_SIZE``), as in the reference implementation.
"""

from __future__ import annotations

PAD = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# The 44 pinyin phones produced by the MFA alignment of ESD-Chinese.
PINYIN_PHONEMES = [
    "a", "ai", "ao", "b", "c", "ch", "d", "e", "ei", "er", "f", "g", "h", "i",
    "ia", "iao", "ie", "iu", "j", "k", "l", "m", "n", "ng", "o", "ou", "p", "q",
    "r", "s", "sh", "spn", "t", "u", "ua", "uai", "ue", "ui", "uo", "w", "x",
    "y", "z", "zh",
]

# The 74 toned-IPA phones (``@``-prefixed for uniqueness vs raw letters).
IPA_PHONEMES = [
    "@aj˥˩", "@aj˧˥", "@aj˨˩˦", "@aj˩", "@aw˥˩", "@aw˧˥", "@aw˨˩˦", "@a˥˩",
    "@a˧˥", "@a˨˩˦", "@a˩", "@ej˥˩", "@ej˧˥", "@ej˨˩˦", "@e˥˩", "@e˧˥",
    "@e˨˩˦", "@e˩", "@f", "@i˥˩", "@i˧˥", "@i˨˩˦", "@i˩", "@j", "@k", "@kʰ",
    "@l", "@m", "@n", "@ow˥˩", "@ow˧˥", "@ow˨˩˦", "@ow˩", "@o˥˩", "@o˧˥",
    "@o˨˩˦", "@p", "@pʰ", "@s", "@spn", "@t", "@ts", "@tsʰ", "@tɕ", "@tɕʰ",
    "@tʰ", "@u˥˩", "@u˧˥", "@u˨˩˦", "@w", "@x", "@y˥˩", "@y˧˥", "@y˨˩˦",
    "@z̩˥˩", "@z̩˨˩˦", "@z̩˩", "@ŋ", "@ɕ", "@ə˥˩", "@ə˧˥", "@ə˨˩˦", "@ə˩",
    "@ɥ", "@ɻ", "@ʂ", "@ʈʂ", "@ʈʂʰ", "@ʐ", "@ʐ̩˥˩", "@ʐ̩˧˥", "@ʐ̩˨˩˦",
    "@ʐ̩˩", "@ʔ",
]

_BASE = [PAD] + list(_special) + list(_punctuation) + list(_letters)

PINYIN_SYMBOLS = _BASE + PINYIN_PHONEMES
IPA_SYMBOLS = _BASE + IPA_PHONEMES

PINYIN_TO_ID = {s: i for i, s in enumerate(PINYIN_SYMBOLS)}
IPA_TO_ID = {s: i for i, s in enumerate(IPA_SYMBOLS)}

VOCAB_SIZE = len(IPA_SYMBOLS) + 1


def get_symbol_table(name: str) -> dict[str, int]:
    """Symbol→ID mapping of a built-in inventory ("pinyin" or "ipa")."""
    if name == "pinyin":
        return PINYIN_TO_ID
    if name == "ipa":
        return IPA_TO_ID
    raise ValueError(f"unknown symbol inventory: {name!r}")
