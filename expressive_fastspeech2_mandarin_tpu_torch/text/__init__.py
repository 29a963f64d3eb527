"""Mandarin text front-end: hanzi or ``{phone ...}`` strings → phoneme IDs.

``text_to_ids`` is the synthesis entry point: pinyin table (hanzi through
pinyin, or explicit phones, unknown phones mapped to pad) or the IPA table
(explicit phones, unknown phones mapped to ``@spn``). ``phonemes_to_ids``
skips unknown phones unless told otherwise, as the training data wants.
"""

from __future__ import annotations

import logging

from . import symbols
from .cleaners import clean_text
from .hanzi import hanzi_to_pinyin
from .pinyin import pinyin_sequence_to_phonemes, pinyin_to_phonemes

logger = logging.getLogger(__name__)

__all__ = [
    "symbols",
    "clean_text",
    "phonemes_to_ids",
    "ids_to_phonemes",
    "chinese_text_to_phonemes",
    "chinese_text_to_ids",
    "text_to_ids",
    "text_to_sequence_ipa",
    "pinyin_to_phonemes",
    "pinyin_sequence_to_phonemes",
    "hanzi_to_pinyin",
]


def phonemes_to_ids(phonemes: list[str], table: str = "pinyin",
                    unknown: str = "skip") -> list[int]:
    """Map phoneme symbols to IDs. Unknown symbols are dropped
    (``unknown="skip"``, the training-data policy), map to pad (``"pad"``,
    the inference-time policy) or raise ``KeyError`` (``"error"``, or any
    other policy)."""
    sym_to_id = symbols.get_symbol_table(table)
    ids: list[int] = []
    for ph in phonemes:
        if ph in sym_to_id:
            ids.append(sym_to_id[ph])
        elif unknown == "skip":
            logger.debug("skipping unknown phoneme %r", ph)
        elif unknown == "pad":
            logger.warning("unknown phoneme %r mapped to pad", ph)
            ids.append(sym_to_id[symbols.PAD])
        else:
            raise KeyError(f"unknown phoneme: {ph!r}")
    return ids


def ids_to_phonemes(ids: list[int], table: str = "pinyin") -> list[str]:
    """IDs → symbols of the pinyin table, or of the IPA table for any other
    ``table``; IDs outside the table are dropped (the JAX package's
    ``text/__init__.py:71-75``)."""
    id_to_sym = (
        symbols.ID_TO_PINYIN if table == "pinyin" else symbols.ID_TO_IPA
    )
    return [id_to_sym[i] for i in ids if i in id_to_sym]


def chinese_text_to_phonemes(text: str) -> list[str]:
    """Hanzi text or ``{b a ...}`` phone string → phoneme list."""
    if text.startswith("{") and text.endswith("}"):
        return text[1:-1].split()
    return pinyin_sequence_to_phonemes(hanzi_to_pinyin(text))


def chinese_text_to_ids(text: str) -> list[int]:
    """Hanzi or phones → pinyin-table IDs, unknown phones mapped to pad."""
    return phonemes_to_ids(chinese_text_to_phonemes(text), "pinyin",
                           unknown="pad")


def text_to_sequence_ipa(text: str) -> list[int]:
    """IPA phoneme string → IDs with ``@spn`` for unknown phones."""
    if text.startswith("{") and text.endswith("}"):
        text = text[1:-1]
    sequence = []
    for ph in text.split():
        key = "@" + ph
        if key in symbols.IPA_TO_ID:
            sequence.append(symbols.IPA_TO_ID[key])
        else:
            logger.warning("unknown IPA phoneme %r, using @spn", ph)
            sequence.append(symbols.IPA_TO_ID["@spn"])
    return sequence


def text_to_ids(text: str, table: str = "pinyin") -> list[int]:
    """Dispatch by symbol inventory: pinyin or IPA."""
    if table == "ipa":
        return text_to_sequence_ipa(text)
    return chinese_text_to_ids(text)
