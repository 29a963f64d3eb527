"""Symbol inventories for the Mandarin front-end.

The same ID schemes as the JAX package's ``text/symbols.py``, so checkpoints
and phoneme IDs interoperate:

* ``PINYIN_SYMBOLS`` (108 symbols) — pad/punct/letters + 44 MFA pinyin phones.
* ``IPA_SYMBOLS`` (138 symbols) — pad/punct/letters + 74 ``@``-prefixed toned
  IPA phones.

The encoder embedding is sized ``len(IPA_SYMBOLS) + 1 = 139`` rows even for
pinyin IDs (``VOCAB_SIZE``), as in the reference implementation.

Custom inventories (``:61-141`` there), such as one harvested from MFA
TextGrids (``preprocess.ipa_harvest``), are registered by name in this
process: the base symbols, then the sorted, prefixed phones. A name that
is a path to an inventory ``.json`` loads itself on first use.
"""

from __future__ import annotations

import json
import os

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
ID_TO_PINYIN = {i: s for i, s in enumerate(PINYIN_SYMBOLS)}
IPA_TO_ID = {s: i for i, s in enumerate(IPA_SYMBOLS)}
ID_TO_IPA = {i: s for i, s in enumerate(IPA_SYMBOLS)}

VOCAB_SIZE = len(IPA_SYMBOLS) + 1

# Special token IDs.
PAD_ID = 0
UNK_ID = 1
BOS_ID = 2
EOS_ID = 3

# Custom inventories registered in this process, by name.
_CUSTOM_TABLES: dict[str, list[str]] = {}


def build_symbol_list(phonemes: list[str], prefix: str = "@") -> list[str]:
    """Base symbols + the sorted, prefixed phones."""
    pref = [p if p.startswith(prefix) else prefix + p
            for p in sorted(set(phonemes))]
    return _BASE + pref


def register_symbol_table(name: str, phonemes: list[str],
                          prefix: str = "@") -> list[str]:
    """Register a custom inventory under ``name``, usable wherever a symbol
    table is named (config, datasets); the built-in names are refused."""
    if name in ("pinyin", "ipa"):
        raise ValueError(f"cannot override builtin inventory {name!r}")
    syms = build_symbol_list(phonemes, prefix)
    _CUSTOM_TABLES[name] = syms
    return syms


def _read_inventory(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_symbol_table(path: str, name: str | None = None) -> str:
    """Register the JSON inventory at ``path`` ({"name", "phonemes",
    "prefix"}, as ``preprocess.ipa_harvest.write_inventory`` writes it)
    under ``name``, its own name, or "custom"; returns the name."""
    data = _read_inventory(path)
    name = name or data.get("name") or "custom"
    register_symbol_table(name, data["phonemes"], data.get("prefix", "@"))
    return name


def _resolve_table_name(name: str) -> str:
    """A name that is the path of an existing ``.json`` inventory and not
    yet registered is loaded and registered under the path itself."""
    if name not in _CUSTOM_TABLES and name.endswith(".json"):
        if os.path.exists(name):
            data = _read_inventory(name)
            register_symbol_table(name, data["phonemes"],
                                  data.get("prefix", "@"))
    return name


def get_symbols(name: str) -> list[str]:
    """The ordered symbol list of an inventory."""
    if name == "pinyin":
        return PINYIN_SYMBOLS
    if name == "ipa":
        return IPA_SYMBOLS
    name = _resolve_table_name(name)
    if name in _CUSTOM_TABLES:
        return _CUSTOM_TABLES[name]
    raise ValueError(f"unknown symbol inventory: {name!r}")


def get_symbol_table(name: str) -> dict[str, int]:
    """Symbol→ID mapping of an inventory: "pinyin", "ipa", a registered
    name or an inventory ``.json`` path."""
    if name == "pinyin":
        return PINYIN_TO_ID
    if name == "ipa":
        return IPA_TO_ID
    return {s: i for i, s in enumerate(get_symbols(name))}
