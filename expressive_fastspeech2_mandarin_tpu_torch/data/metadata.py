"""The maps of a reference-format preprocessed directory that synthesis
needs; the JAX package's ``data/metadata.py:PreprocessedCorpus`` without the
per-utterance readers.

``speakers.json`` ({speaker: id}), ``emotions.json`` (``emotion_dict``,
``arousal_dict``, ``valence_dict``) and ``stats.json`` ([min, max, mean,
std] of pitch and energy).
"""

from __future__ import annotations

import json
import os


def _read_json(root: str, name: str):
    with open(os.path.join(root, name), encoding="utf-8") as f:
        return json.load(f)


class PreprocessedCorpus:
    def __init__(self, preprocessed_path: str):
        self.root = preprocessed_path
        self.speaker_map: dict[str, int] = _read_json(self.root,
                                                      "speakers.json")
        emotions = _read_json(self.root, "emotions.json")
        self.emotion_map: dict[str, int] = emotions["emotion_dict"]
        self.arousal_map: dict[str, int] = emotions["arousal_dict"]
        self.valence_map: dict[str, int] = emotions["valence_dict"]
        self.stats: dict[str, list[float]] = _read_json(self.root,
                                                        "stats.json")

    @property
    def emotion_maps(self) -> dict[str, dict[str, int]]:
        """The three maps under the keys ``Synthesizer`` takes."""
        return {"emotion": self.emotion_map, "arousal": self.arousal_map,
                "valence": self.valence_map}
