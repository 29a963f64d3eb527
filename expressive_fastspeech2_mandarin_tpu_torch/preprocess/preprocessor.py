"""Offline feature extraction: TextGrid alignments and wavs → per-utterance
duration/pitch/energy/mel ``.npy`` files, corpus statistics and metadata;
the JAX package's ``preprocess/preprocessor.py:62-331``.

Per utterance: the "phones" tier with leading and trailing silences
(sil/sp/spn, and the empty gap mark) trimmed and durations quantized as
round(e·sr/hop) − round(s·sr/hop); the wav trimmed to the phones; F0 by DIO
+ StoneMask at the hop period, truncated to the total duration and rejected
with one voiced frame or none; mel and energy by the mel STFT, truncated
alike; unvoiced frames filled by linear interpolation; pitch and energy
averaged per phoneme. Over the corpus: z-normalization with
outlier-trimmed statistics, ``speakers.json``, ``emotions.json``,
``stats.json`` and a seeded shuffle into ``train.txt``/``val.txt``.

The work is split between the host and the card. A spawn-context pool
does the CPU half of every utterance (TextGrid, trimmed wav, F0:
``extract_utterance``); its workers never initialize CUDA (the pool's
initializer hides the card from them, and nothing they are sent holds a
tensor). The parent takes the results in job order as they arrive and
runs ``MelSTFT.mel_energy`` on ``device`` for each, one utterance at a time
(padding a batch of ragged wavs on the right would change each utterance's
reflect padding at its end), then drops its wav, so the card's work
overlaps the pool's and the parent holds a few utterances' audio, not the
corpus'. The JAX package does both halves in its workers on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing as mp
import os
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import PreprocessConfig
from ..device import resolve_device
from ..dsp.pitch import estimate_f0
from ..dsp.stft import MelSTFT
from ..utils.wav import load_wav
from .textgrid import Tier, read_textgrid

SILENCE_PHONES = ("sil", "sp", "spn")


@dataclass
class AlignmentResult:
    phones: list[str]
    durations: list[int]
    start: float
    end: float


def get_alignment(tier: Tier, sampling_rate: int, hop_length: int
                  ) -> AlignmentResult:
    """Phones and frame durations of a phones tier with its leading and
    trailing silences trimmed (JAX ``:62-93``). The empty mark of a gap
    interval counts as silence and becomes ``sp`` inside the utterance.
    Durations round end positions in float64, half to even."""
    phones: list[str] = []
    durations: list[int] = []
    start_time = 0.0
    end_time = 0.0
    end_idx = 0
    for iv in tier.intervals:
        s, e, p = iv.start, iv.end, iv.text
        if not phones:
            if p in SILENCE_PHONES or p == "":
                continue
            start_time = s
        if p not in SILENCE_PHONES and p != "":
            phones.append(p)
            end_time = e
            end_idx = len(phones)
        else:
            phones.append(p or "sp")
        durations.append(int(
            np.round(e * sampling_rate / hop_length)
            - np.round(s * sampling_rate / hop_length)))
    return AlignmentResult(phones[:end_idx], durations[:end_idx],
                           start_time, end_time)


def remove_outlier(values: np.ndarray) -> np.ndarray:
    """The values inside 1.5 interquartile ranges of the quartiles
    (JAX ``:96``)."""
    values = np.asarray(values)
    if values.size == 0:
        return values
    p25, p75 = np.percentile(values, [25, 75])
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[np.logical_and(values > lower, values < upper)]


def interpolate_unvoiced(pitch: np.ndarray) -> np.ndarray:
    """Zeros filled by linear interpolation, held flat past the ends
    (JAX ``:107``)."""
    nonzero = np.nonzero(pitch)[0]
    if len(nonzero) == 0:
        return pitch
    return np.interp(np.arange(len(pitch)), nonzero, pitch[nonzero])


def phoneme_average(values: np.ndarray, durations: list[int]) -> np.ndarray:
    """Frame values → per-phoneme means, 0 for an empty phoneme
    (JAX ``:117``)."""
    out = np.zeros(len(durations), dtype=values.dtype)
    pos = 0
    for i, d in enumerate(durations):
        if d > 0 and pos < len(values):
            out[i] = np.mean(values[pos: pos + d])
        else:
            out[i] = 0
        pos += d
    return out


@dataclass
class Extracted:
    """The CPU half of one utterance."""

    phones: list[str]
    durations: list[int]
    raw_text: str
    wav: np.ndarray    # float32, trimmed to the phones
    pitch: np.ndarray  # float64 F0, truncated to the total duration


def _hide_card() -> None:
    """Pool initializer: the workers run on the CPU and must not
    initialize CUDA beside the parent."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def extract_utterance(cfg: PreprocessConfig, speaker: str, basename: str
                      ) -> Extracted | None:
    """Alignment, trimmed wav, transcript and F0 of one utterance (JAX
    ``:226-262``); None when the alignment is empty or at most one frame
    is voiced. Reads ``<raw_path>/<sub_dir_name>/<speaker>/<basename>
    .{wav,lab}`` and ``<preprocessed_path>/TextGrid/<speaker>/<basename>
    .TextGrid``."""
    sr, hop = cfg.audio.sampling_rate, cfg.stft.hop_length
    in_dir = os.path.join(cfg.path.raw_path, cfg.path.sub_dir_name, speaker)
    tg = read_textgrid(os.path.join(cfg.path.preprocessed_path, "TextGrid",
                                    speaker, f"{basename}.TextGrid"))
    align = get_alignment(tg.get_tier_by_name("phones"), sr, hop)
    if align.start >= align.end or not align.phones:
        return None
    wav, _ = load_wav(os.path.join(in_dir, f"{basename}.wav"), sr)
    wav = wav[int(sr * align.start): int(sr * align.end)]
    raw_text = ""
    lab_path = os.path.join(in_dir, f"{basename}.lab")
    if os.path.exists(lab_path):
        with open(lab_path, encoding="utf-8") as f:
            raw_text = f.readline().strip("\n")
    pitch = estimate_f0(wav.astype(np.float64), sr,
                        hop)[:sum(align.durations)]
    if np.sum(pitch != 0) <= 1:
        return None
    return Extracted(align.phones, align.durations, raw_text, wav, pitch)


def _extract_job(job: tuple) -> Extracted | None:
    return extract_utterance(*job)


class Preprocessor:
    """Feature extraction of the corpus under ``cfg.path.raw_path`` (wavs,
    labs, ``speaker_info.txt``, ``filelist.txt``) with TextGrids under
    ``cfg.path.preprocessed_path/TextGrid``, into
    ``cfg.path.preprocessed_path``. The mel STFT runs on ``device``, the
    card unless the caller asks for the CPU; the rest in ``num_workers``
    pool workers (the CPUs less one by default; the pool is used past 8
    utterances). After ``build_from_path``, ``timings`` holds the seconds
    until the first utterance's extraction arrived (``first_s``: the pool's
    start and one job) and until the last (``extract_s``), the mel STFT's
    seconds within them (``mel_s``) and the kept audio's length
    (``audio_s``)."""

    def __init__(self, cfg: PreprocessConfig, num_workers: int | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.in_dir = os.path.join(cfg.path.raw_path, cfg.path.sub_dir_name)
        self.out_dir = cfg.path.preprocessed_path
        self.sr = cfg.audio.sampling_rate
        self.hop = cfg.stft.hop_length
        self.stft = MelSTFT(cfg.stft, cfg.mel, self.sr, self.device)
        self.num_workers = num_workers or max(1, (os.cpu_count() or 2) - 1)
        self.speakers = self._load_speaker_dict()
        self.filelist, self.emotions = self._load_filelist_dict()
        self.timings: dict[str, float] = {}

    # -- corpus-level metadata (JAX :143-185) --------------------------------

    def _load_speaker_dict(self) -> dict[str, int]:
        path = os.path.join(self.cfg.path.raw_path, "speaker_info.txt")
        spk: dict[str, int] = {}
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    spk[line.split("|")[0].strip()] = i
        return spk

    def _load_filelist_dict(self):
        path = os.path.join(self.cfg.path.raw_path, "filelist.txt")
        filelist: dict[str, str] = {}
        emotions, arousals, valences = set(), set(), set()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split("|")
                    if len(parts) >= 8:
                        # base|text|spk|dataset|default|emotion|arousal|valence
                        base, text, spk = parts[0], parts[1], parts[2]
                        emotion, arousal, valence = parts[5], parts[6], parts[7]
                    elif len(parts) == 6:
                        # base|text|spk|emotion|arousal|valence
                        base, text, spk = parts[0], parts[1], parts[2]
                        emotion, arousal, valence = parts[3], parts[4], parts[5]
                    else:
                        continue
                    filelist[base] = f"{spk}|{text}|{emotion}|{arousal}|{valence}"
                    emotions.add(emotion)
                    arousals.add(arousal)
                    valences.add(valence)
        emo_maps = {
            "emotion_dict": {e: i for i, e in enumerate(sorted(emotions))},
            "arousal_dict": {a: i for i, a in enumerate(sorted(arousals))},
            "valence_dict": {v: i for i, v in enumerate(sorted(valences))},
        }
        return filelist, emo_maps

    # -- per utterance (JAX :187-236) ----------------------------------------

    def process_utterance(self, speaker: str, basename: str):
        """(metadata line, outlier-trimmed pitch and energy, frames) of one
        utterance with its four arrays saved, or None when rejected."""
        return self._features(speaker, basename,
                              extract_utterance(self.cfg, speaker, basename))

    @torch.inference_mode()
    def _mel_energy(self, wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        x = torch.from_numpy(np.clip(wav, -1, 1)[None, :].astype(np.float32))
        mel, energy = self.stft.mel_energy(x.to(self.device))
        return mel[0].cpu().numpy(), energy[0].cpu().numpy()

    def _features(self, speaker: str, basename: str, ex: Extracted | None):
        if ex is None:
            return None
        total = sum(ex.durations)
        t0 = time.perf_counter()
        mel, energy = self._mel_energy(ex.wav)
        self.timings["mel_s"] = (self.timings.get("mel_s", 0.0)
                                 + time.perf_counter() - t0)
        mel, energy = mel[:total], energy[:total]
        pitch = ex.pitch
        if len(pitch) < total:
            pitch = np.pad(pitch, (0, total - len(pitch)))
        pitch = interpolate_unvoiced(pitch)
        if self.cfg.pitch.feature == "phoneme_level":
            pitch = phoneme_average(pitch, ex.durations)
        if self.cfg.energy.feature == "phoneme_level":
            energy = phoneme_average(energy, ex.durations)

        self._save(speaker, basename, "duration",
                   np.asarray(ex.durations, np.int64))
        self._save(speaker, basename, "pitch", pitch)
        self._save(speaker, basename, "energy", energy)
        self._save(speaker, basename, "mel", mel)

        text = "{" + " ".join(ex.phones) + "}"
        aux = self.filelist.get(basename,
                                f"{speaker}|{ex.raw_text}|Neutral|0.5|0.5")
        meta = "|".join([basename, speaker, text, ex.raw_text, aux])
        return meta, remove_outlier(pitch), remove_outlier(energy), mel.shape[0]

    def _save(self, speaker, basename, kind, arr):
        np.save(os.path.join(self.out_dir, kind,
                             f"{speaker}-{kind}-{basename}.npy"), arr)

    # -- corpus build (JAX :238-331) -----------------------------------------

    def build_from_path(self, val_size: int | None = None, seed: int = 1234):
        """Extract every utterance that has a TextGrid, normalize, and
        write the metadata; returns the shuffled metadata lines."""
        for kind in ("mel", "pitch", "energy", "duration"):
            os.makedirs(os.path.join(self.out_dir, kind), exist_ok=True)
        val_size = self.cfg.val_size if val_size is None else val_size

        jobs = []
        speakers = dict(self.speakers)
        for speaker in sorted(os.listdir(self.in_dir)):
            if not os.path.isdir(os.path.join(self.in_dir, speaker)):
                continue
            if not self.speakers and speaker not in speakers:
                speakers[speaker] = len(speakers)
            for wav_name in sorted(os.listdir(os.path.join(self.in_dir,
                                                           speaker))):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[:-4]
                tg = os.path.join(self.out_dir, "TextGrid", speaker,
                                  f"{basename}.TextGrid")
                if os.path.exists(tg):
                    jobs.append((self.cfg, speaker, basename))

        # In job order either way (the seeded shuffle below must see the
        # same list); each utterance's mel is taken as its extraction
        # arrives, and its wav dropped.
        self.timings = {"mel_s": 0.0, "audio_s": 0.0}
        results = []
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if self.num_workers > 1 and len(jobs) > 8:
                pool = stack.enter_context(mp.get_context("spawn").Pool(
                    self.num_workers, initializer=_hide_card))
                extracted = pool.imap(_extract_job, jobs, chunksize=max(
                    1, len(jobs) // (8 * self.num_workers)))
            else:
                extracted = map(_extract_job, jobs)
            for (_, s, b), ex in zip(jobs, extracted):
                if not results:
                    self.timings["first_s"] = time.perf_counter() - t0
                if ex is not None:
                    self.timings["audio_s"] += len(ex.wav) / self.sr
                results.append(self._features(s, b, ex))
        self.timings["extract_s"] = time.perf_counter() - t0

        out, n_frames = [], 0
        pitch_vals, energy_vals = [], []
        for ret in results:
            if ret is None:
                continue
            meta, pitch, energy, n = ret
            out.append(meta)
            if len(pitch):
                pitch_vals.append(pitch)
            if len(energy):
                energy_vals.append(energy)
            n_frames += n

        pitch_all = np.concatenate(pitch_vals) if pitch_vals else np.zeros(1)
        energy_all = np.concatenate(energy_vals) if energy_vals else np.zeros(1)
        p_mean, p_std = ((pitch_all.mean(), pitch_all.std())
                         if self.cfg.pitch.normalization else (0.0, 1.0))
        e_mean, e_std = ((energy_all.mean(), energy_all.std())
                         if self.cfg.energy.normalization else (0.0, 1.0))
        p_std = p_std or 1.0
        e_std = e_std or 1.0

        p_min, p_max = self._normalize_dir("pitch", p_mean, p_std)
        e_min, e_max = self._normalize_dir("energy", e_mean, e_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        if self.emotions["emotion_dict"]:
            with open(os.path.join(self.out_dir, "emotions.json"), "w") as f:
                json.dump(self.emotions, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(p_min), float(p_max), float(p_mean),
                          float(p_std)],
                "energy": [float(e_min), float(e_max), float(e_mean),
                           float(e_std)],
            }, f)

        print(f"Total time: {n_frames * self.hop / self.sr / 3600:.2f} hours")

        random.Random(seed).shuffle(out)
        with open(os.path.join(self.out_dir, "train.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(out[val_size:]) + "\n")
        with open(os.path.join(self.out_dir, "val.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(out[:val_size]) + "\n")
        return out

    def _normalize_dir(self, kind: str, mean: float, std: float):
        """z-normalize every file of ``<out>/<kind>`` in place; returns the
        normalized min and max."""
        d = os.path.join(self.out_dir, kind)
        vmin, vmax = np.inf, -np.inf
        for name in os.listdir(d):
            p = os.path.join(d, name)
            values = (np.load(p) - mean) / std
            np.save(p, values)
            if values.size:
                vmin = min(vmin, values.min())
                vmax = max(vmax, values.max())
        return vmin, vmax
