"""ESD-Chinese corpus preparation: the dataset's layout → ``raw_data/``
ready for alignment and feature extraction; the JAX package's
``preprocess/esd.py:35-140``.

* per speaker and emotion, the wavs resampled to the target rate and
  peak-normalized to 0.95;
* the hanzi transcript (``<speaker>/<speaker>.txt``, utf-8 with or without
  a BOM, tab-separated ``basename, text, emotion``) → toneless pinyin
  ``.lab`` files;
* a seeded per-(speaker, emotion) split into val, test and train;
* ``filelist.txt`` and ``filelist_{train,val,test}.txt`` lines
  ``basename|pinyin|spk|dataset|default|emotion|arousal|valence`` and
  ``speaker_info.txt``.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

from ..data.metadata import EMOTION_AROUSAL_VALENCE
from ..text.hanzi import hanzi_to_pinyin
from ..utils.wav import load_wav, peak_normalize, save_wav


@dataclass
class EsdUtterance:
    speaker: str
    basename: str
    wav_path: str
    text: str
    emotion: str


def discover_esd(esd_root: str) -> list[EsdUtterance]:
    """Walk the ESD layout: <root>/<speaker>/<Emotion>/*.wav with a
    <speaker>/<speaker>.txt transcript file (tab-separated)."""
    utts: list[EsdUtterance] = []
    for speaker in sorted(os.listdir(esd_root)):
        spk_dir = os.path.join(esd_root, speaker)
        if not os.path.isdir(spk_dir):
            continue
        transcripts: dict[str, tuple[str, str]] = {}
        txt = os.path.join(spk_dir, f"{speaker}.txt")
        if os.path.exists(txt):
            with open(txt, encoding="utf-8-sig") as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 3:
                        transcripts[parts[0]] = (parts[1], parts[2])
        for emotion in sorted(os.listdir(spk_dir)):
            emo_dir = os.path.join(spk_dir, emotion)
            if not os.path.isdir(emo_dir):
                continue
            for wav in sorted(os.listdir(emo_dir)):
                if not wav.endswith(".wav"):
                    continue
                base = wav[:-4]
                text, emo = transcripts.get(base, ("", emotion))
                utts.append(EsdUtterance(speaker, base,
                                         os.path.join(emo_dir, wav),
                                         text, emo or emotion))
    return utts


def text_to_lab(text: str) -> str:
    """Hanzi → toneless pinyin transcript, syllables joined by spaces."""
    return " ".join(
        syl for syl in hanzi_to_pinyin(text) if syl.strip()
    )


def prepare_esd(
    esd_root: str,
    raw_path: str,
    sampling_rate: int = 22050,
    val_per_speaker_emotion: int = 20,
    test_per_speaker_emotion: int = 30,
    seed: int = 1234,
) -> None:
    """Write ``raw_path`` from the ESD tree at ``esd_root`` (module
    docstring); raises ``FileNotFoundError`` when it holds no utterance."""
    utts = discover_esd(esd_root)
    if not utts:
        raise FileNotFoundError(f"no ESD utterances under {esd_root}")

    os.makedirs(raw_path, exist_ok=True)
    by_speaker_emotion: dict[tuple[str, str], list[EsdUtterance]] = {}
    for u in utts:
        by_speaker_emotion.setdefault((u.speaker, u.emotion), []).append(u)

    rng = random.Random(seed)
    filelist_lines: list[str] = []
    split_lines: dict[str, list[str]] = {"train": [], "val": [], "test": []}
    speakers: list[str] = []

    for (speaker, emotion), group in sorted(by_speaker_emotion.items()):
        if speaker not in speakers:
            speakers.append(speaker)
        rng.shuffle(group)
        n_val, n_test = val_per_speaker_emotion, test_per_speaker_emotion
        splits = (("val", group[:n_val]),
                  ("test", group[n_val:n_val + n_test]),
                  ("train", group[n_val + n_test:]))
        spk_dir = os.path.join(raw_path, speaker)
        os.makedirs(spk_dir, exist_ok=True)
        for split, members in splits:
            for u in members:
                audio, _ = load_wav(u.wav_path, sampling_rate)
                audio = peak_normalize(audio)
                save_wav(os.path.join(spk_dir, f"{u.basename}.wav"),
                         audio, sampling_rate)
                lab = text_to_lab(u.text)
                with open(os.path.join(spk_dir, f"{u.basename}.lab"),
                          "w", encoding="utf-8") as f:
                    f.write(lab + "\n")
                aro, val = EMOTION_AROUSAL_VALENCE.get(
                    u.emotion, ("0.5", "0.5"))
                line = (f"{u.basename}|{lab}|{speaker}|ESD-Chinese|default|"
                        f"{u.emotion}|{aro}|{val}")
                filelist_lines.append(line)
                split_lines[split].append(line)

    with open(os.path.join(raw_path, "filelist.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(filelist_lines) + "\n")
    for split, lines in split_lines.items():
        with open(os.path.join(raw_path, f"filelist_{split}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(raw_path, "speaker_info.txt"), "w",
              encoding="utf-8") as f:
        for s in speakers:
            f.write(f"{s}|zh|unknown\n")
