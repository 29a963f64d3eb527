"""Offline and streaming synthesis: text → phoneme IDs → FastSpeech2 mel →
HiFi-GAN waveform, trimmed to the predicted lengths; the JAX package's
``synth/synthesizer.py``.

Emotion names map through the emotion maps and the fixed arousal/valence
table; texts are padded to static source buckets and the mel length to a
bucket guessed from the text length, or to ``max_mel_len``. The vocoder runs
in ``VocoderConfig.compute_dtype`` (bfloat16 by default) and every MRF
resblock goes through the CUDA kernel on the card; past 2048 frames the
decoder's attention goes through the flash kernel there
(``attention_impl="auto"``).
"""

from __future__ import annotations

import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch
from scipy.io import wavfile

from ..config import Config
from ..data import PreprocessedCorpus
from ..device import resolve_device
from ..interop.torch_ckpt import (
    fastspeech2_checkpoint_state,
    load_torch_state_dict,
    load_vocoder_state,
)
from ..models import FastSpeech2, Generator
from ..text import text_to_ids
from .streaming import vocode_streaming

SRC_BUCKETS = (16, 32, 64, 128, 256)
MEL_BUCKETS = (250, 500, 1000, 2000)

# Emotion → (arousal, valence) value strings, keys of the arousal/valence maps.
EMOTION_AROUSAL_VALENCE = {
    "Angry": ("0.9", "0.1"),
    "Happy": ("0.8", "0.8"),
    "Neutral": ("0.5", "0.5"),
    "Sad": ("0.3", "0.2"),
    "Surprise": ("0.8", "0.6"),
}

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def save_wav(path: str, audio: np.ndarray, sr: int,
             max_wav_value: float = 32768.0) -> None:
    """Float audio in [-1, 1] → int16 wav."""
    data = np.clip(audio * max_wav_value, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, data)


@dataclass
class SynthesisResult:
    basename: str
    wav: np.ndarray           # float32 [-1, 1]
    mel: np.ndarray           # (T, n_mels)
    durations: np.ndarray     # (S,)
    sampling_rate: int


class Synthesizer:
    """``fs2_state`` and ``vocoder_state`` are state dicts under the
    reference's torch names (``interop.from_jax`` makes them from JAX
    params). Runs on ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(
        self,
        cfg: Config,
        fs2_state: dict[str, torch.Tensor],
        vocoder_state: dict[str, torch.Tensor] | None = None,
        stats: dict | None = None,
        speaker_map: dict[str, int] | None = None,
        emotion_maps: dict[str, dict[str, int]] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = FastSpeech2(cfg.model, cfg.preprocess, stats)
        model.load_state_dict(fs2_state, strict=True)
        self.model = model.to(self.device).eval()
        self.vocoder = None
        if vocoder_state is not None:
            gen = Generator(cfg.model.vocoder,
                            cfg.preprocess.mel.n_mel_channels)
            gen.load_state_dict(vocoder_state, strict=True)
            dtype = getattr(torch, cfg.model.vocoder.compute_dtype)
            self.vocoder = gen.to(self.device, dtype).eval()
        self.speaker_map = speaker_map or {}
        self.emotion_maps = emotion_maps or {}

    @classmethod
    def from_torch_checkpoint(
        cls,
        cfg: Config,
        model_ckpt: str,
        vocoder_ckpt: str | None = None,
        preprocessed_path: str | None = None,
        device: str | torch.device = "cuda",
    ) -> "Synthesizer":
        """The reference's FastSpeech2 checkpoint (``{"model": state_dict}``)
        and a HiFi-GAN generator, either a reference checkpoint
        (``{"generator": state_dict}``, weight norm folded) or a native
        ``generator.npz``; speaker and emotion maps and stats from the
        preprocessed directory when it exists."""
        stats = speaker_map = emotion_maps = None
        path = preprocessed_path or cfg.preprocess.path.preprocessed_path
        if path and os.path.isdir(path):
            corpus = PreprocessedCorpus(path)
            stats = corpus.stats
            speaker_map = corpus.speaker_map
            emotion_maps = corpus.emotion_maps
        fs2 = fastspeech2_checkpoint_state(
            load_torch_state_dict(model_ckpt, key="model"), cfg.model, stats)
        voc = load_vocoder_state(vocoder_ckpt) if vocoder_ckpt else None
        return cls(cfg, fs2, voc, stats, speaker_map, emotion_maps,
                   device=device)

    def resolve_ids(self, speaker: str | int, emotion: str | int):
        spk = (self.speaker_map.get(str(speaker), 0)
               if isinstance(speaker, str) else int(speaker))
        if isinstance(emotion, str) and self.emotion_maps:
            emo = self.emotion_maps["emotion"].get(emotion, 0)
            aro_s, val_s = EMOTION_AROUSAL_VALENCE.get(emotion, ("0.5", "0.5"))
            aro = self.emotion_maps["arousal"].get(aro_s, 0)
            val = self.emotion_maps["valence"].get(val_s, 0)
        else:
            emo = int(emotion) if not isinstance(emotion, str) else 0
            aro = val = 0
        return spk, emo, aro, val

    @torch.inference_mode()
    def synthesize(
        self,
        texts: list[str],
        speakers: list[str | int] | None = None,
        emotions: list[str | int] | None = None,
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        basenames: list[str] | None = None,
        vocoder: str | None = None,
        max_mel_len: int | None = None,
    ) -> list[SynthesisResult]:
        """``texts`` may be hanzi or ``{phone ...}`` strings."""
        n = len(texts)
        speakers = speakers or [0] * n
        emotions = emotions or ["Neutral"] * n
        basenames = basenames or [f"utt_{i}" for i in range(n)]
        sr = self.cfg.preprocess.audio.sampling_rate
        hop = self.cfg.preprocess.stft.hop_length
        vocoder = vocoder or ("hifigan" if self.vocoder is not None
                              else "griffin_lim")
        if vocoder not in ("hifigan", "none"):
            raise NotImplementedError(f"vocoder {vocoder!r} {_NOT_PORTED}")
        if vocoder == "hifigan" and self.vocoder is None:
            raise ValueError("no HiFi-GAN weights loaded")

        id_lists = [text_to_ids(t, self.cfg.preprocess.symbol_table)
                    for t in texts]
        longest = max(len(i) for i in id_lists)
        max_src = _bucket(longest, SRC_BUCKETS)
        max_mel = max_mel_len or _bucket(
            int(longest * 10 * duration_control) + 16, MEL_BUCKETS)

        texts_arr = np.zeros((n, max_src), np.int64)
        src_lens = np.zeros((n,), np.int64)
        for i, ids in enumerate(id_lists):
            s = min(len(ids), max_src)
            texts_arr[i, :s] = ids[:s]
            src_lens[i] = s
        ids4 = np.asarray([self.resolve_ids(s, e)
                           for s, e in zip(speakers, emotions)], np.int64)
        spk, emo, aro, val = (torch.from_numpy(ids4[:, j]).to(self.device)
                              for j in range(4))

        out = self.model(
            spk, emo, aro, val, torch.from_numpy(texts_arr).to(self.device),
            torch.from_numpy(src_lens).to(self.device),
            max_mel_len=max_mel, p_control=pitch_control,
            e_control=energy_control, d_control=duration_control)
        mel = out.postnet_mel

        if vocoder == "hifigan":
            dtype = next(self.vocoder.parameters()).dtype
            wavs = self.vocoder(mel.to(dtype)).float().cpu().numpy()
        else:
            # Mel only (e.g. for an external vocoder).
            wavs = np.zeros((n, mel.shape[1] * hop), np.float32)

        mel_np = mel.float().cpu().numpy()
        lens_np = out.mel_lens.cpu().numpy()
        dur_np = out.durations_rounded.cpu().numpy()
        results = []
        for i in range(n):
            t = int(lens_np[i])
            n_samples = min(t * hop, wavs.shape[1])
            results.append(SynthesisResult(
                basename=basenames[i],
                wav=wavs[i, :n_samples].astype(np.float32),
                mel=mel_np[i, :t],
                durations=dur_np[i, : src_lens[i]],
                sampling_rate=sr,
            ))
        return results

    def synthesize_streaming(
        self,
        text: str,
        speaker: str | int = 0,
        emotion: str | int = "Neutral",
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        chunk_frames: int = 100,
        max_mel_len: int | None = None,
    ) -> Iterator[np.ndarray]:
        """Yield float32 waveform chunks of one utterance as they are
        vocoded: the first audio after one chunk of ``chunk_frames`` mel
        frames instead of the whole utterance. The concatenation is
        ``mel_frames * hop`` samples and equals the HiFi-GAN output of the
        trimmed mel (``synth/streaming.py``)."""
        if self.vocoder is None:
            raise ValueError("streaming requires HiFi-GAN weights")
        [result] = self.synthesize(
            [text], [speaker], [emotion], pitch_control, energy_control,
            duration_control, vocoder="none", max_mel_len=max_mel_len)
        hop = self.cfg.preprocess.stft.hop_length
        dtype = next(self.vocoder.parameters()).dtype
        mel = torch.from_numpy(result.mel)[None].to(self.device, dtype)
        total = result.mel.shape[0] * hop
        emitted = 0
        for chunk in vocode_streaming(self.vocoder, mel,
                                      chunk_frames=chunk_frames):
            wav = chunk[0].float().cpu().numpy()
            take = min(len(wav), max(total - emitted, 0))
            emitted += take
            if take:
                yield wav[:take]

    def save_results(self, results: list[SynthesisResult], out_dir: str,
                     tag: str | None = None,
                     save_mel: bool = False) -> list[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for r in results:
            name = f"{r.basename}{f'_{tag}' if tag else ''}.wav"
            p = os.path.join(out_dir, name)
            save_wav(p, r.wav, r.sampling_rate)
            paths.append(p)
            if save_mel:
                np.save(p[:-4] + "_mel.npy", r.mel)
        return paths
