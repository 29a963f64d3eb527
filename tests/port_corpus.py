"""A raw corpus with TextGrids for the port's feature-extraction tests,
written with the port alone (no JAX), so the card's tests can use it.

tests/test_pipeline.py's corpus (2 speakers × 6 utterances of 0.8-1 s at
22050 Hz, two harmonics and noise, a leading ``sil``, five phones and a
trailing ``sp``), plus one utterance with an empty gap mark inside (kept,
the gap becoming ``sp``), one digitally silent utterance (no voiced frame:
rejected) and one whose tier holds only silences (an empty alignment:
rejected).

Also the IEMOCAP and AIHub-MMV release layouts of tests/test_corpus_prep.py
(``write_iemocap``, ``write_aihub``) and a lexicon of a corpus' lab words
spelled by letter (``write_letter_lexicon``).
"""

import os

import numpy as np

from expressive_fastspeech2_mandarin_tpu_torch.preprocess import textgrid as ttg
from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

SR = 22050
PHONES = ["b", "a", "n", "h", "ao"]


def _make_wav(rng, duration_s, f0):
    t = np.arange(int(SR * duration_s)) / SR
    sig = 0.4 * np.sin(2 * np.pi * f0 * t)
    sig += 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
    sig += 0.02 * rng.standard_normal(len(t))
    return np.clip(sig, -1, 1).astype(np.float32)


def _write(tg_root, raw, speaker, base, wav, marks, filelist, emo="Happy"):
    """A wav, its lab, its TextGrid (``marks`` as (start, end, text)) and
    its filelist line."""
    save_wav(str(raw / speaker / f"{base}.wav"), wav, SR)
    with open(raw / speaker / f"{base}.lab", "w") as f:
        f.write("ban hao\n")
    dur = len(wav) / SR
    tg = ttg.TextGrid(0.0, dur, [ttg.Tier("phones", [
        ttg.Interval(s, e, p) for s, e, p in marks])])
    ttg.write_textgrid(tg, str(tg_root / speaker / f"{base}.TextGrid"))
    aro, val = {"Happy": ("0.8", "0.8"), "Sad": ("0.3", "0.2")}[emo]
    filelist.append(f"{base}|ban hao|{speaker}|T|default|{emo}|{aro}|{val}")


def write_pipeline_corpus(root):
    """The corpus under ``root`` (a ``pathlib.Path``); returns (raw dir,
    TextGrid dir)."""
    raw, tg_root = root / "raw_data", root / "TextGrid"
    rng = np.random.default_rng(0)
    filelist = []
    for spk_i, speaker in enumerate(["0001", "0002"]):
        os.makedirs(raw / speaker)
        os.makedirs(tg_root / speaker)
        for k in range(6):
            dur_s = 0.8 + 0.2 * k / 6
            seg = (dur_s - 0.2) / len(PHONES)
            marks = ([(0.0, 0.1, "sil")]
                     + [(0.1 + i * seg, 0.1 + (i + 1) * seg, p)
                        for i, p in enumerate(PHONES)]
                     + [(dur_s - 0.1, dur_s, "sp")])
            _write(tg_root, raw, speaker, f"{speaker}_{k:06d}",
                   _make_wav(rng, dur_s, 150 + 40 * spk_i + 10 * k), marks,
                   filelist, ["Happy", "Sad"][k % 2])
    gap = [(0.0, 0.1, "sil"), (0.1, 0.25, "b"), (0.25, 0.4, "a"),
           (0.4, 0.47, ""), (0.47, 0.6, "n"), (0.6, 0.75, "h"),
           (0.75, 0.85, "ao"), (0.85, 0.9, "sp"), (0.9, 0.95, "")]
    _write(tg_root, raw, "0001", "0001_000006", _make_wav(rng, 0.95, 210),
           gap, filelist)
    _write(tg_root, raw, "0002", "0002_000006", np.zeros(SR, np.float32),
           [(0.0, 0.1, "sil")] + gap[1:7] + [(0.85, 1.0, "sp")], filelist,
           "Sad")
    _write(tg_root, raw, "0002", "0002_000007", _make_wav(rng, 0.9, 200),
           [(0.0, 0.4, "sil"), (0.4, 0.5, ""), (0.5, 0.9, "sp")], filelist)
    with open(raw / "filelist.txt", "w") as f:
        f.write("\n".join(filelist) + "\n")
    with open(raw / "speaker_info.txt", "w") as f:
        f.write("0001|zh|f\n0002|zh|m\n")
    return raw, tg_root


def preprocess_config(mod, raw, pre):
    return mod.PreprocessConfig(
        path=mod.PathConfig(raw_path=str(raw), preprocessed_path=str(pre)),
        val_size=2)


# ---------------------------------------------------------------------------
# IEMOCAP and AIHub-MMV release layouts (tests/test_corpus_prep.py's
# fixtures, written with the port alone).

CORPUS_SR = 16000
# Sentences whose cleaned words the tests' lexicons cover.
IEMOCAP_UTTS = [
    ("F000", "The acoustic corpus is good.", "neu", "2.5", "2.5"),
    ("M001", "Forced aligner errors happened!", "ang", "3.5", "2.0"),
    ("F002", "Welcome to the montreal games.", "hap", "3.0", "4.0"),
    ("M003", "Nothing else should fail.", "sad", "1.5", "2.0"),
]


def speech(rng, seconds=1.2, f0=150.0, sr=CORPUS_SR):
    """Five harmonics of ``f0`` under a 3 Hz envelope, and a little
    noise."""
    t = np.arange(int(sr * seconds)) / sr
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    return (0.3 * sig * env / np.abs(sig).max()
            + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def write_iemocap(root, utts=IEMOCAP_UTTS, seed=0):
    """IEMOCAP's release layout under ``root``:
    Session1/sentences/wav/<dialog>/<base>.wav and
    Session1/dialog/{transcriptions,EmoEvaluation}/<dialog>.txt; returns
    the dialog's name."""
    rng = np.random.default_rng(seed)
    dialog = "Ses01F_impro01"
    wav_dir = os.path.join(root, "Session1", "sentences", "wav", dialog)
    dlg_dir = os.path.join(root, "Session1", "dialog")
    os.makedirs(wav_dir)
    os.makedirs(os.path.join(dlg_dir, "transcriptions"))
    os.makedirs(os.path.join(dlg_dir, "EmoEvaluation"))
    trans, emo = [], ["% header line"]
    for i, (who, text, e, a, v) in enumerate(utts):
        base = f"Ses01F_impro01_{who}"
        save_wav(os.path.join(wav_dir, base + ".wav"), speech(rng),
                 CORPUS_SR)
        t0, t1 = i * 2.0, i * 2.0 + 1.2
        trans.append(f"{base} [{t0:.4f}-{t1:.4f}]: {text}")
        # EmoEvaluation stores [valence, activation (arousal), dominance].
        emo.append(f"[{t0:.4f} - {t1:.4f}]\t{base}\t{e}\t[{v}, {a}, 2.5]")
    with open(os.path.join(dlg_dir, "transcriptions", dialog + ".txt"),
              "w") as f:
        f.write("\n".join(trans) + "\n")
    with open(os.path.join(dlg_dir, "EmoEvaluation", dialog + ".txt"),
              "w") as f:
        f.write("\n".join(emo) + "\n")
    return dialog


def write_aihub(root, audio_root, seed=1, numbers=False):
    """AIHub-MMV's layout: a clip's annotation JSON under ``root`` and its
    audio, pre-extracted, under ``audio_root``; with ``numbers`` each
    script ends in a number for the Korean cleaner to read."""
    import json

    rng = np.random.default_rng(seed)
    clip_dir = os.path.join(root, "part1")
    os.makedirs(clip_dir)
    os.makedirs(os.path.join(audio_root, "part1"))
    n_frames, fps = 300, 30.0
    save_wav(os.path.join(audio_root, "part1", "clip_0001.wav"),
             speech(rng, seconds=n_frames / fps), CORPUS_SR)

    def turn(script, start, end, intent, emotion, arousal, valence, who):
        triple = {"emotion": emotion, "arousal": arousal,
                  "valence": valence}
        return {"sub1": {
            "text": {"script": script, "script_start": start,
                     "script_end": end, "intent": intent,
                     "strategy": "none"},
            "emotion": {"text": triple, "sound": {}, "image": {},
                        "multimodal": triple},
            "person_id": who}}

    annotation = {
        "nr_frame": n_frames,
        "actor": {"1": {"gender": "female", "age": "20대"},
                  "2": {"gender": "male", "age": "30대"}},
        "data": {
            "30": turn("안녕하세요 – 반갑습니다" + (" 3번" if numbers else ""),
                       "30", "90", "greet", "happy", "0.7", "0.8", "1"),
            "120": turn("네…\t안녕히 가세요" + (" 25일" if numbers else ""),
                        "120", "200", "farewell", "neutral", "0.4", "0.5",
                        "2"),
        },
    }
    with open(os.path.join(clip_dir, "clip_0001.json"), "w",
              encoding="utf-8") as f:
        json.dump(annotation, f, ensure_ascii=False)


def write_letter_lexicon(lab_root, path):
    """An MFA-format lexicon for every token of the labs under
    ``lab_root``: a token's phones are its letters, which the pinyin
    symbol table holds, so alignment, features and the dataset agree on
    every phone."""
    words = set()
    for dirpath, _, files in os.walk(lab_root):
        for name in files:
            if name.endswith(".lab"):
                with open(os.path.join(dirpath, name)) as f:
                    words.update(f.read().split())
    with open(path, "w") as f:
        for w in sorted(words):
            letters = [c for c in w.lower() if "a" <= c <= "z"]
            if letters:
                f.write(f"{w}\t{' '.join(letters)}\n")
    return path
