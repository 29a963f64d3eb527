"""IEMOCAP corpus preparation → ``raw_data`` layout; the JAX package's
``preprocess/iemocap.py``.

Walks the IEMOCAP release
(``Session*/sentences/wav/<dialog>/*.wav`` with per-dialog transcription and
EmoEvaluation files under ``Session*/dialog/``), renames utterances from
``<spk>_<dialogtype>_<turn>`` to ``<turn>_<spk>_<dialogtype>``, peak-
normalizes + resamples the audio, writes per-dialog wav+lab pairs plus the
emotion filelist (``base|text|spk|emotion|arousal|valence`` — the EN 6-field
variant, reference preprocessor_en.py) and ``speaker_info.txt``.

The transcript/EmoEvaluation parsers accept the release's native formats:
``Ses01F_impro01_F000 [6.2901-8.2357]: Excuse me.`` and
``[6.2901 - 8.2357]\tSes01F_impro01_F000\tneu\t[2.5, 2.5, 2.5]`` (the
bracketed triple is [valence, arousal, dominance] — reference
iemocap.py:63-70 reads valence first, arousal second).
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..text import clean_text
from ..utils.wav import load_wav, peak_normalize, save_wav

_SQUARE_BRACKETS = re.compile(r"\[[\w\d\s]+\]")


def parse_transcriptions(path: str) -> dict[str, str]:
    """``<base> [start-end]: text`` lines → {base: text}."""
    out: dict[str, str] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if "[" not in line or "]:" not in line:
                continue
            base = line.split("[")[0].strip()
            out[base] = line.split("]:")[-1].strip()
    return out


def parse_emo_evaluation(path: str) -> dict[str, tuple[str, str, str]]:
    """EmoEvaluation summary lines → {base: (emotion, arousal, valence)}.

    Line shape: ``[start - end]  base  emo  [val, act, dom]`` (reference
    iemocap.py:59-70 — note the swap: the file stores valence first)."""
    out: dict[str, tuple[str, str, str]] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f.readlines()[1:]:
            if "[" not in line or "%" in line:
                continue
            m = re.match(r"(.*?)\](.+?)\[(.*)", " ".join(line.split()))
            if not m:
                continue
            fields = m.group(2).strip().split(" ")
            if len(fields) != 2:
                continue
            base, emo = fields
            vals = [v.strip().rstrip("]") for v in m.group(3).split(",")]
            if len(vals) < 2:
                continue
            valence, arousal = vals[0], vals[1]
            out[base] = (emo, arousal, valence)
    return out


def _split_base(base: str) -> tuple[str, str, str] | None:
    """``Ses01F_impro01_F000`` → (spk, dialog_type, turn); 4-part scripted
    names (``Ses01F_script01_1_F000``) keep the middle joined (reference
    iemocap.py:76-80)."""
    parts = base.split("_")
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    if len(parts) == 4:
        return parts[0], "_".join(parts[1:3]), parts[3]
    return None


def prepare_iemocap(
    corpus_path: str,
    raw_path: str,
    sampling_rate: int = 22050,
    sub_dir_name: str = "sessions",
    fixed_text_path: str | None = None,
    cleaners: tuple[str, ...] = ("english_cleaners",),
) -> int:
    """Prepare the IEMOCAP release into the raw_data contract.  Returns the
    number of utterances written."""
    fixed: dict[str, str] = {}
    if fixed_text_path and os.path.exists(fixed_text_path):
        with open(fixed_text_path, encoding="utf-8") as f:
            for line in f:
                if "|" in line:
                    wav, text = line.split("|")[:2]
                    fixed[wav] = text.rstrip("\n")

    os.makedirs(raw_path, exist_ok=True)
    n_written = 0
    speakers: dict[str, str] = {}
    filelist: list[str] = []
    session_key = sub_dir_name[:-1].lower() if sub_dir_name else "session"
    for sep_dir in sorted(next(os.walk(corpus_path))[1]):
        if session_key not in sep_dir.lower():
            continue
        wav_root = os.path.join(corpus_path, sep_dir, "sentences", "wav")
        if not os.path.isdir(wav_root):
            continue
        for dialog in sorted(next(os.walk(wav_root))[1]):
            texts = parse_transcriptions(os.path.join(
                corpus_path, sep_dir, "dialog", "transcriptions",
                f"{dialog}.txt"))
            emos = parse_emo_evaluation(os.path.join(
                corpus_path, sep_dir, "dialog", "EmoEvaluation",
                f"{dialog}.txt"))
            for file_name in sorted(os.listdir(os.path.join(wav_root,
                                                            dialog))):
                if file_name.startswith(".") or not file_name.endswith(".wav"):
                    continue
                base = file_name[:-4]
                split = _split_base(base)
                if split is None or base not in emos:
                    continue
                spk, dialog_type, turn = split
                new_base = "_".join([turn, spk, dialog_type])
                speakers.setdefault(spk, spk[-1])

                text = fixed.get(base, texts.get(base, ""))
                text = re.sub(_SQUARE_BRACKETS, "", text)
                text = clean_text(" ".join(text.split()), list(cleaners))
                if not text:
                    continue

                wav, _ = load_wav(os.path.join(wav_root, dialog, file_name),
                                  sampling_rate)
                out_dir = os.path.join(raw_path, sub_dir_name, dialog)
                os.makedirs(out_dir, exist_ok=True)
                save_wav(os.path.join(out_dir, f"{new_base}.wav"),
                         peak_normalize(np.asarray(wav), 1.0), sampling_rate)
                with open(os.path.join(out_dir, f"{new_base}.lab"), "w",
                          encoding="utf-8") as f:
                    f.write(text)
                emo, aro, val = emos[base]
                filelist.append("|".join([new_base, text, spk, emo, aro,
                                          val]))
                n_written += 1

    with open(os.path.join(raw_path, "filelist.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(filelist) + "\n")
    with open(os.path.join(raw_path, "speaker_info.txt"), "w",
              encoding="utf-8") as f:
        for spk in sorted(speakers):
            f.write(f"{spk}|{speakers[spk]}\n")
    return n_written
