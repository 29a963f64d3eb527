"""Offline preprocessing: ESD, IEMOCAP and AIHub-MMV corpus preparation,
TextGrid I/O, feature extraction (F0 on the host, mel and energy on the
card) and harvested phone inventories."""

from ..data.metadata import EMOTION_AROUSAL_VALENCE
from .aihub_mmv import create_dataset as create_aihub_dataset
from .aihub_mmv import extract_audio as extract_aihub_audio
from .aihub_mmv import prepare_aihub_mmv
from .esd import discover_esd, prepare_esd, text_to_lab
from .iemocap import prepare_iemocap
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
    "prepare_iemocap",
    "prepare_aihub_mmv",
    "create_aihub_dataset",
    "extract_aihub_audio",
    "EMOTION_AROUSAL_VALENCE",
    "harvest_phones",
    "write_inventory",
    "textgrid_phones",
    "reencode_metadata",
]
