"""Reference-format preprocessed corpus: the JAX package's
``data/metadata.py``.

``train.txt`` / ``val.txt`` lines
``basename|speaker|{phones}|raw_text|speaker|text|emotion|arousal|valence``;
``speakers.json`` ({speaker: id}), ``emotions.json`` (``emotion_dict``,
``arousal_dict``, ``valence_dict``), ``stats.json`` ([min, max, mean, std]
of pitch and energy), and per utterance ``<kind>/<speaker>-<kind>-<basename>
.npy`` for kind in mel (T, 80), pitch and energy (S,), duration (S,) int.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..text import phonemes_to_ids

# Emotion → (arousal, valence) value strings, keys of the arousal/valence maps.
EMOTION_AROUSAL_VALENCE = {
    "Angry": ("0.9", "0.1"),
    "Happy": ("0.8", "0.8"),
    "Neutral": ("0.5", "0.5"),
    "Sad": ("0.3", "0.2"),
    "Surprise": ("0.8", "0.6"),
}


def _read_json(root: str, name: str):
    with open(os.path.join(root, name), encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Utterance:
    basename: str
    speaker: str
    phone_text: str  # "{b a n ...}"
    raw_text: str
    emotion: str
    arousal: str
    valence: str
    # The corpus filelist's speaker (the fifth field), where it is given:
    # the name speakers.json holds when the folder's is not in it.
    corpus_speaker: str = ""

    def phone_ids(self, table: str = "pinyin") -> np.ndarray:
        phones = self.phone_text.strip("{}").split()
        if phones and all(p.isdigit() for p in phones):
            # The phones field already holds symbol IDs.
            return np.asarray([int(p) for p in phones], dtype=np.int32)
        return np.asarray(phonemes_to_ids(phones, table, unknown="skip"),
                          dtype=np.int32)


def parse_metadata_line(line: str) -> Utterance:
    parts = line.rstrip("\n").split("|")
    basename, speaker, phone_text, raw_text = parts[:4]
    aux = parts[4:]
    if len(aux) >= 3:
        emotion, arousal, valence = aux[-3], aux[-2], aux[-1]
    elif aux:
        # Emotion only: arousal and valence from the fixed table.
        emotion = aux[-1]
        arousal, valence = EMOTION_AROUSAL_VALENCE.get(emotion, ("0.5", "0.5"))
    else:
        emotion, arousal, valence = "Neutral", "0.5", "0.5"
    return Utterance(basename, speaker, phone_text, raw_text, emotion,
                     arousal, valence,
                     aux[0] if len(aux) >= 5 else speaker)


def read_metadata(path: str) -> list[Utterance]:
    with open(path, encoding="utf-8") as f:
        return [parse_metadata_line(ln) for ln in f if ln.strip()]


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

    def speaker_id(self, utt: Utterance) -> int:
        """The utterance's speaker ID: by its folder's name, or where
        speakers.json does not hold that name (IEMOCAP's dialog folders
        under ``sessions``, speakers.json holding the filelist's session
        speakers) by the filelist's speaker. The JAX package raises
        ``KeyError`` there, so it cannot train on IEMOCAP."""
        if utt.speaker in self.speaker_map:
            return self.speaker_map[utt.speaker]
        return self.speaker_map[utt.corpus_speaker]

    def metadata(self, filename: str) -> list[Utterance]:
        return read_metadata(os.path.join(self.root, filename))

    def _npy(self, kind: str, utt: Utterance) -> np.ndarray:
        return np.load(os.path.join(
            self.root, kind, f"{utt.speaker}-{kind}-{utt.basename}.npy"))

    def mel(self, utt: Utterance) -> np.ndarray:       # (T, 80)
        return self._npy("mel", utt)

    def pitch(self, utt: Utterance) -> np.ndarray:     # (S,) phoneme level
        return self._npy("pitch", utt)

    def energy(self, utt: Utterance) -> np.ndarray:
        return self._npy("energy", utt)

    def duration(self, utt: Utterance) -> np.ndarray:  # (S,) int
        return self._npy("duration", utt)

    def lengths(self, filename: str) -> dict[str, tuple[int, int]]:
        """{basename: (src_len, mel_len)}, cached beside the metadata as
        ``.lengths-<filename>.json``."""
        cache = os.path.join(self.root, f".lengths-{filename}.json")
        if os.path.exists(cache):
            with open(cache) as f:
                return {k: tuple(v) for k, v in json.load(f).items()}
        out: dict[str, tuple[int, int]] = {}
        for utt in self.metadata(filename):
            d = self.duration(utt)
            out[utt.basename] = (len(d), int(d.sum()))
        with open(cache, "w") as f:
            json.dump(out, f)
        return out
