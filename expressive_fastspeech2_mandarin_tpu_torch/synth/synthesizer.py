"""Offline and streaming synthesis: text → phoneme IDs → FastSpeech2 mel →
waveform, trimmed to the predicted lengths; the JAX package's
``synth/synthesizer.py``.

Emotion names map through the emotion maps and the fixed arousal/valence
table; texts are padded to static source buckets and the mel length to a
bucket guessed from the text length, or to ``max_mel_len``. Past 2048
frames the decoder's attention goes through the flash kernel on the card
(``attention_impl="auto"``).

On the card the FastSpeech2 forward and the vocoders replay CUDA graphs
(``graphs.Graphs``), as the JAX package jits them: ``_synth_fn`` per
(source bucket, mel bucket, controls), an LRU of 32 as the JAX package's
``lru_cache``, each with a graph per batch size; ``_vocoder_fn`` per
vocoder, a graph per mel shape and compute dtype; streaming's full
windows one graph. Griffin-Lim runs eagerly. The graphs read the weights
at the addresses they were captured with: loading MelGAN drops them, and
so does any weight written in place, before the next call.

Vocoders (``synthesize(vocoder=...)``):
* ``"hifigan"``, the default when HiFi-GAN weights are loaded: in
  ``VocoderConfig.compute_dtype`` (bfloat16 by default), every MRF
  resblock through the CUDA kernel on the card;
* ``"griffin_lim"``, the default without them: 60 Griffin-Lim iterations
  from the mel (``dsp.MelSTFT.mel_to_audio``) on the synthesizer's device
  — the JAX package pins it to the CPU only because remote TPU backends
  lack complex FFTs — each utterance over 0.95 peak scaled down to 0.95;
* ``"melgan"``: MelGAN weights (``melgan_state`` or ``load_melgan``), in
  float32;
* ``"none"``: mels only.
"""

from __future__ import annotations

import functools
import os
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..data import EMOTION_AROUSAL_VALENCE, PreprocessedCorpus, pick_bucket
from ..device import resolve_device
from ..dsp.stft import MelSTFT
from ..graphs import Compiled, Graphs, module_tensors
from ..interop.torch_ckpt import (
    fastspeech2_checkpoint_state,
    load_torch_state_dict,
    load_vocoder_state,
    melgan_from_state_dict,
)
from ..models import FastSpeech2, Generator, MelGAN
from ..text import text_to_ids
from ..utils.wav import save_wav
from .streaming import vocode_streaming

SRC_BUCKETS = (16, 32, 64, 128, 256)
MEL_BUCKETS = (250, 500, 1000, 2000)
VOCODERS = ("hifigan", "griffin_lim", "melgan", "none")
GRIFFIN_LIM_ITERS = 60
GRIFFIN_LIM_PEAK = 0.95
# Compiled FastSpeech2 forwards kept, and vocoders, as the JAX package's
# lru_cache sizes (synth/synthesizer.py:193, :204 there).
SYNTH_FN_CACHE = 32
VOCODER_FN_CACHE = 8


def rescale_peaks(wavs: np.ndarray, peak: float = GRIFFIN_LIM_PEAK
                  ) -> np.ndarray:
    """Each row over ``peak`` scaled down to it: Griffin-Lim's phase
    reconstruction has no absolute scale, and the int16 write must not
    clip."""
    peaks = np.abs(wavs).max(axis=1, keepdims=True)
    scale = np.where(peaks > peak, peak / np.maximum(peaks, 1e-9), 1.0)
    return (wavs * scale).astype(np.float32)


@dataclass
class SynthesisResult:
    basename: str
    wav: np.ndarray           # float32 [-1, 1]
    mel: np.ndarray           # (T, n_mels)
    durations: np.ndarray     # (S,)
    sampling_rate: int


def _corpus_maps(cfg: Config, preprocessed_path: str | None):
    """(stats, speaker map, emotion maps) of the preprocessed corpus, or
    Nones when its directory does not exist."""
    path = preprocessed_path or cfg.preprocess.path.preprocessed_path
    if not (path and os.path.isdir(path)):
        return None, None, None
    corpus = PreprocessedCorpus(path)
    return corpus.stats, corpus.speaker_map, corpus.emotion_maps


class Synthesizer:
    """``fs2_state``, ``vocoder_state`` (HiFi-GAN) and ``melgan_state`` are
    state dicts under the port's names (``interop.from_jax`` makes them from
    JAX params, ``interop.torch_ckpt`` from the reference's checkpoints).
    Runs on ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(
        self,
        cfg: Config,
        fs2_state: dict[str, torch.Tensor],
        vocoder_state: dict[str, torch.Tensor] | None = None,
        stats: dict | None = None,
        speaker_map: dict[str, int] | None = None,
        emotion_maps: dict[str, dict[str, int]] | None = None,
        device: str | torch.device = "cuda",
        melgan_state: dict[str, torch.Tensor] | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._graphs = Graphs(state=self._weights)
        self._synth_fn = functools.lru_cache(SYNTH_FN_CACHE)(
            self._compile_synth)
        self._vocoder_fn = functools.lru_cache(VOCODER_FN_CACHE)(
            self._compile_vocoder)
        self.vocoder = self.melgan = None
        model = FastSpeech2(cfg.model, cfg.preprocess, stats)
        model.load_state_dict(fs2_state, strict=True)
        self.model = model.to(self.device).eval()
        if vocoder_state is not None:
            gen = Generator(cfg.model.vocoder,
                            cfg.preprocess.mel.n_mel_channels)
            gen.load_state_dict(vocoder_state, strict=True)
            dtype = getattr(torch, cfg.model.vocoder.compute_dtype)
            self.vocoder = gen.to(self.device, dtype).eval()
        if melgan_state is not None:
            self._set_melgan(melgan_state)
        pre = cfg.preprocess
        self.stft = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate,
                            self.device)
        self.speaker_map = speaker_map or {}
        self.emotion_maps = emotion_maps or {}

    def _weights(self) -> list[torch.Tensor]:
        """What the graphs read besides their inputs: every parameter and
        buffer of the models."""
        return module_tensors(*(m for m in (self.model, self.vocoder,
                                            self.melgan) if m is not None))

    def drop_graphs(self) -> None:
        """Forget every compiled function and its graphs."""
        self._graphs.drop()
        self._synth_fn.cache_clear()
        self._vocoder_fn.cache_clear()

    def _compile_synth(self, max_src: int, max_mel: int, p_c: float,
                       e_c: float, d_c: float) -> Compiled:
        """The FastSpeech2 inference forward at a source bucket, a mel
        bucket and controls, compiled: (speakers, emotions, arousals,
        valences, texts, src_lens) → (postnet mel, mel_lens, durations).
        ``max_src`` is the texts' width, in the key as the JAX package's."""

        def forward(spk, emo, aro, val, texts, src_lens):
            out = self.model(spk, emo, aro, val, texts, src_lens,
                             max_mel_len=max_mel, p_control=p_c,
                             e_control=e_c, d_control=d_c)
            return out.postnet_mel, out.mel_lens, out.durations_rounded

        return self._graphs.jit(forward)

    def _compile_vocoder(self, kind: str) -> Compiled:
        """``kind``'s vocoder ("hifigan" or "melgan"), compiled: (mel,
        dtype=compute dtype) → the float32 waveform of the mel cast to the
        compute dtype."""
        module = self.vocoder if kind == "hifigan" else self.melgan

        def vocode(mel, dtype):
            return module(mel.to(dtype)).float()

        return self._graphs.jit(vocode)

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
        stats, speaker_map, emotion_maps = _corpus_maps(cfg,
                                                        preprocessed_path)
        fs2 = fastspeech2_checkpoint_state(
            load_torch_state_dict(model_ckpt, key="model"), cfg.model, stats)
        voc = load_vocoder_state(vocoder_ckpt) if vocoder_ckpt else None
        return cls(cfg, fs2, voc, stats, speaker_map, emotion_maps,
                   device=device)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: Config,
        ckpt_dir: str,
        vocoder_ckpt: str | None = None,
        preprocessed_path: str | None = None,
        step: int | None = None,
        device: str | torch.device = "cuda",
    ) -> "Synthesizer":
        """A checkpoint of the port's own trainer (``<ckpt_dir>/<step>.pt``
        of ``train.CheckpointManager``, the latest unless ``step`` is
        given; the JAX package's ``from_orbax``) and a HiFi-GAN generator
        as ``from_torch_checkpoint`` takes it; maps and stats from the
        preprocessed directory when it exists."""
        from ..train.state import CheckpointManager

        stats, speaker_map, emotion_maps = _corpus_maps(cfg,
                                                        preprocessed_path)
        fs2 = CheckpointManager(ckpt_dir).load(step)["model"]
        voc = load_vocoder_state(vocoder_ckpt) if vocoder_ckpt else None
        return cls(cfg, fs2, voc, stats, speaker_map, emotion_maps,
                   device=device)

    def _set_melgan(self, state: dict[str, torch.Tensor]) -> None:
        melgan = MelGAN(self.cfg.preprocess.mel.n_mel_channels)
        melgan.load_state_dict(state, strict=True)
        self.melgan = melgan.to(self.device).eval()
        self.drop_graphs()

    def load_melgan(self, ckpt_path: str) -> None:
        """Load a melgan-neurips generator checkpoint (a torch state dict
        of its ``mel2wav`` Sequential, weight norm folded at load)."""
        self._set_melgan(melgan_from_state_dict(
            load_torch_state_dict(ckpt_path)))

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
        if vocoder not in VOCODERS:
            raise ValueError(f"vocoder must be one of {VOCODERS}, got "
                             f"{vocoder!r}")
        if vocoder == "hifigan" and self.vocoder is None:
            raise ValueError("no HiFi-GAN weights loaded")
        if vocoder == "melgan" and self.melgan is None:
            raise ValueError("no MelGAN weights loaded")

        id_lists = [text_to_ids(t, self.cfg.preprocess.symbol_table)
                    for t in texts]
        longest = max(len(i) for i in id_lists)
        max_src = pick_bucket(longest, SRC_BUCKETS)
        max_mel = max_mel_len or pick_bucket(
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

        mel, mel_lens, durations = self._synth_fn(
            max_src, max_mel, pitch_control, energy_control,
            duration_control)(
            spk, emo, aro, val, torch.from_numpy(texts_arr).to(self.device),
            torch.from_numpy(src_lens).to(self.device))

        if vocoder == "hifigan":
            dtype = next(self.vocoder.parameters()).dtype
            wavs = self._vocoder_fn("hifigan")(mel, dtype=dtype)
            wavs = wavs.cpu().numpy()
        elif vocoder == "melgan":
            wavs = self._vocoder_fn("melgan")(mel, dtype=torch.float32)
            wavs = wavs.cpu().numpy()
        elif vocoder == "griffin_lim":
            wavs = rescale_peaks(self.stft.mel_to_audio(
                mel.float(), n_iters=GRIFFIN_LIM_ITERS).cpu().numpy())
        else:
            # Mel only (e.g. for an external vocoder).
            wavs = np.zeros((n, mel.shape[1] * hop), np.float32)

        mel_np = mel.float().cpu().numpy()
        lens_np = mel_lens.cpu().numpy()
        dur_np = durations.cpu().numpy()
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
        for chunk in vocode_streaming(
                self.vocoder, mel, chunk_frames=chunk_frames,
                full_window=functools.partial(self._vocoder_fn("hifigan"),
                                              dtype=dtype)):
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
