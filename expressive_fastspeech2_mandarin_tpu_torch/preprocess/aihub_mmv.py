"""AIHub multimodal-video (KR) corpus preparation; the JAX package's
``preprocess/aihub_mmv.py``.

Two stages:

1. ``extract_audio`` + ``create_dataset`` (reference:
   preparation/aihub_mmv.py:39-166): demux each clip's audio track
   (ffmpeg, replacing the reference's moviepy dependency — gated on the
   binary being present), read the per-clip annotation JSON
   (``nr_frame``, ``actor``, ``data[frame][sub]{text, emotion,
   person_id}``), slice utterance segments by script frame range, and write
   per-clip wav+txt pairs plus the 17-field filelist
   (``base|script|spk|intent|strategy|e_text×3|e_sound×3|e_image×3|
   e_multimodal×3``) and ``speaker_info.txt``.

2. ``prepare_aihub_mmv`` (reference: preprocessor/aihub_mmv.py:12-72):
   dataset dir → ``raw_data`` layout (peak-normalized resampled wav +
   cleaned ``.lab``), filelist copied with fixed-text overrides applied.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np

from ..text import clean_text
from ..utils.wav import load_wav, peak_normalize, save_wav


def _refine_text(text: str) -> str:
    """Reference: preparation/aihub_mmv.py:144-151."""
    for bad, good in (("…", ","), ("\t", ""), ("-", ","), ("–", ",")):
        text = text.replace(bad, good)
    return " ".join(text.split())


def _pad_spk_id(speaker_id: str) -> str:
    return "p" + "0" * (3 - len(speaker_id)) + speaker_id


def _emotion_triplet(d: dict) -> tuple:
    if "emotion" in d:
        return d["emotion"], d["arousal"], d["valence"]
    return 0, 0, 0


def extract_audio(corpus_path: str, audio_dir: str) -> int:
    """Demux ``**/*.mp4`` → wav via ffmpeg (reference used moviepy,
    preparation/aihub_mmv.py:154-166).  Returns the number of files."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found — video→audio extraction needs it; "
            "pre-extract the wavs (same relative paths) and skip this stage")
    n = 0
    for root, _, files in os.walk(corpus_path):
        for name in sorted(files):
            if not name.endswith(".mp4"):
                continue
            src = os.path.join(root, name)
            dst = src.replace(corpus_path, audio_dir, 1)[:-4] + ".wav"
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            subprocess.run(["ffmpeg", "-y", "-i", src, "-vn", dst],
                           check=True, capture_output=True)
            n += 1
    return n


def create_dataset(corpus_path: str, audio_dir: str, out_dir: str,
                   sampling_rate: int = 22050) -> int:
    """Annotation JSONs + extracted audio → per-clip utterance dataset
    (reference: preparation/aihub_mmv.py:39-141).  Clips are located by
    their annotation files so pre-extracted wav-only fixtures work (no
    video needed).  Returns the number of utterances written."""
    os.makedirs(out_dir, exist_ok=True)
    filelist: list[str] = []
    speaker_info: dict[str, dict] = {}
    n_utts = 0
    for root, _, files in os.walk(corpus_path):
        for name in sorted(files):
            if not name.endswith(".json"):
                continue
            json_path = os.path.join(root, name)
            try:
                with open(json_path, encoding="utf-8") as f:
                    annotation = json.load(f)
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
            if "nr_frame" not in annotation:
                continue
            file_name = name[:-5]
            wav_path = os.path.join(root.replace(corpus_path, audio_dir, 1),
                                    file_name + ".wav")
            if not os.path.exists(wav_path):
                continue
            audio, _ = load_wav(wav_path, sampling_rate)
            fps = float(annotation["nr_frame"]) / (len(audio)
                                                   / sampling_rate)
            for spk_id, spk_info in annotation.get("actor", {}).items():
                speaker_info.setdefault(spk_id, spk_info)

            clip = file_name.replace("clip_", "c")
            turn_id = 0
            done: set[str] = set()
            frames = sorted(annotation.get("data", {}).items(),
                            key=lambda kv: int(kv[0]))
            for _, frame_data in frames:
                for info in frame_data.values():
                    if "text" not in info:
                        continue
                    td = info["text"]
                    start, end = td["script_start"], td["script_end"]
                    framename = f"{start}-{end}"
                    if framename in done:
                        continue
                    done.add(framename)
                    spk = _pad_spk_id(str(info["person_id"]))
                    base = f"{turn_id}_{spk}_{clip}_{framename}"
                    turn_id += 1
                    a = int(float(start) / fps * sampling_rate)
                    z = int(float(end) / fps * sampling_rate)
                    seg = audio[a:z]
                    if not seg.size:
                        continue
                    clip_dir = os.path.join(out_dir, clip)
                    os.makedirs(clip_dir, exist_ok=True)
                    save_wav(os.path.join(clip_dir, base + ".wav"), seg,
                             sampling_rate)
                    script = _refine_text(td["script"])
                    with open(os.path.join(clip_dir, base + ".txt"), "w",
                              encoding="utf-8") as f:
                        f.write(script)
                    emo = info.get("emotion", {})
                    triples = [v for key in ("text", "sound", "image",
                                             "multimodal")
                               for v in _emotion_triplet(emo.get(key, {}))]
                    filelist.append("|".join(
                        [base, script, spk, str(td.get("intent", "")),
                         str(td.get("strategy", ""))]
                        + [str(v) for v in triples]))
                    n_utts += 1

    with open(os.path.join(out_dir, "filelist.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(filelist) + "\n")
    with open(os.path.join(out_dir, "speaker_info.txt"), "w",
              encoding="utf-8") as f:
        for spk_id in sorted(speaker_info):
            info = speaker_info[spk_id]
            gender = "F" if info.get("gender") == "female" else "M"
            f.write(f"{_pad_spk_id(str(spk_id))}|{gender}|"
                    f"{info.get('age', '')}\n")
    return n_utts


def prepare_aihub_mmv(
    corpus_path: str,
    raw_path: str,
    sampling_rate: int = 22050,
    sub_dir_name: str = "clips",
    fixed_text_path: str | None = None,
    cleaners: tuple[str, ...] = ("korean_cleaners",),
) -> int:
    """Prepared dataset dir (``create_dataset`` output) → raw_data layout
    (reference: preprocessor/aihub_mmv.py:12-72).  Returns #utterances."""
    fixed: dict[str, str] = {}
    if fixed_text_path and os.path.exists(fixed_text_path):
        with open(fixed_text_path, encoding="utf-8") as f:
            for line in f:
                if "|" in line:
                    wav, text = line.split("|")[:2]
                    fixed[wav] = text.rstrip("\n")

    os.makedirs(raw_path, exist_ok=True)
    n = 0
    for clip in sorted(next(os.walk(corpus_path))[1]):
        clip_dir = os.path.join(corpus_path, clip)
        for file_name in sorted(os.listdir(clip_dir)):
            if not file_name.endswith(".wav"):
                continue
            base = file_name[:-4]
            if base in fixed:
                text = fixed[base]
            else:
                with open(os.path.join(clip_dir, base + ".txt"),
                          encoding="utf-8") as f:
                    text = f.readline().strip("\n")
            text = clean_text(text, list(cleaners))
            out_dir = os.path.join(raw_path, sub_dir_name, clip)
            os.makedirs(out_dir, exist_ok=True)
            wav, _ = load_wav(os.path.join(clip_dir, file_name),
                              sampling_rate)
            save_wav(os.path.join(out_dir, base + ".wav"),
                     peak_normalize(np.asarray(wav), 1.0), sampling_rate)
            with open(os.path.join(out_dir, base + ".lab"), "w",
                      encoding="utf-8") as f:
                f.write(text)
            n += 1

    # Filelist with fixed-text overrides; speaker info copied verbatim.
    src_filelist = os.path.join(corpus_path, "filelist.txt")
    if os.path.exists(src_filelist):
        with open(src_filelist, encoding="utf-8") as f_in, \
                open(os.path.join(raw_path, "filelist.txt"), "w",
                     encoding="utf-8") as f_out:
            for line in f_in:
                parts = line.rstrip("\n").split("|")
                if parts and parts[0] in fixed:
                    parts[1] = fixed[parts[0]]
                f_out.write("|".join(parts) + "\n")
    src_spk = os.path.join(corpus_path, "speaker_info.txt")
    if os.path.exists(src_spk):
        shutil.copyfile(src_spk,
                        os.path.join(raw_path, "speaker_info.txt"))
    return n
