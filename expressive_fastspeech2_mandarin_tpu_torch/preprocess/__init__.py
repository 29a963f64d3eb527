"""Offline preprocessing: ESD corpus preparation, TextGrid I/O, feature
extraction (F0 on the host, mel and energy on the card) and harvested
phone inventories."""

from .esd import discover_esd, prepare_esd, text_to_lab
from .ipa_harvest import (
    harvest_phones,
    reencode_metadata,
    textgrid_phones,
    write_inventory,
)
from .preprocessor import (
    Preprocessor,
    extract_utterance,
    get_alignment,
    interpolate_unvoiced,
    phoneme_average,
    remove_outlier,
)
from .textgrid import (
    Interval,
    TextGrid,
    Tier,
    parse_textgrid,
    read_textgrid,
    write_textgrid,
)

__all__ = [
    "Preprocessor",
    "extract_utterance",
    "get_alignment",
    "remove_outlier",
    "interpolate_unvoiced",
    "phoneme_average",
    "TextGrid",
    "Tier",
    "Interval",
    "parse_textgrid",
    "read_textgrid",
    "write_textgrid",
    "discover_esd",
    "text_to_lab",
    "prepare_esd",
    "harvest_phones",
    "write_inventory",
    "textgrid_phones",
    "reencode_metadata",
]
