"""A raw corpus with TextGrids for the port's feature-extraction tests,
written with the port alone (no JAX), so the card's tests can use it.

tests/test_pipeline.py's corpus (2 speakers × 6 utterances of 0.8-1 s at
22050 Hz, two harmonics and noise, a leading ``sil``, five phones and a
trailing ``sp``), plus one utterance with an empty gap mark inside (kept,
the gap becoming ``sp``), one digitally silent utterance (no voiced frame:
rejected) and one whose tier holds only silences (an empty alignment:
rejected).
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
