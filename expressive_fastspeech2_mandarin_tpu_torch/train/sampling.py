"""Sample vocoding for the train loop; the JAX package's
``train/sampling.py:30-120``.

A HiFi-GAN generator from ``cfg.model.vocoder.ckpt_path`` (a native
``generator.npz`` or a reference checkpoint) when the file exists, else
Griffin-Lim (20 iterations, the 0.95-peak rescale), both on the loop's
device: on the card the generator's resblocks run the float32 MRF kernel,
and Griffin-Lim runs there too (the JAX package pins it to the CPU only
because remote TPU backends lack complex FFTs). The generator is compiled
as the JAX package's ``_voc_fn`` (an ``lru_cache`` of 8 jits, one per
padded length): on the card a CUDA graph per padded length, 8 kept.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..dsp.stft import MelSTFT
from ..graphs import Graphs, module_tensors
from ..interop.torch_ckpt import load_vocoder_state
from ..models import Generator
from ..synth.synthesizer import rescale_peaks

SAMPLE_GRIFFIN_LIM_ITERS = 20
VOC_FN_CACHE = 8  # padded lengths compiled, as JAX's _voc_fn lru_cache


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class SampleVocoder:
    """mel (T, n_mels) → waveform for the loop's samples: HiFi-GAN if its
    weights are configured, Griffin-Lim otherwise."""

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.hop = cfg.preprocess.stft.hop_length
        self.generator = None
        voc = cfg.model.vocoder
        if (voc.ckpt_path and os.path.exists(voc.ckpt_path)
                and voc.model == "HiFi-GAN"):
            gen = Generator(voc, cfg.preprocess.mel.n_mel_channels)
            gen.load_state_dict(load_vocoder_state(voc.ckpt_path),
                                strict=True)
            self.generator = gen.to(device).eval()
            self._generator = Graphs(
                state=lambda: module_tensors(self.generator)).jit(
                    self.generator, max_graphs=VOC_FN_CACHE)
        pre = cfg.preprocess
        self.stft = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate,
                            device)

    @property
    def kind(self) -> str:
        return "hifigan" if self.generator is not None else "griffin_lim"

    @torch.inference_mode()
    def vocode(self, mel: np.ndarray, mel_len: int | None = None
               ) -> np.ndarray:
        """mel: (T, n_mels) log-mel as stored on disk. Returns the float32
        waveform, ``mel_len * hop`` samples."""
        mel = np.asarray(mel, np.float32)
        t = mel.shape[0] if mel_len is None else int(mel_len)
        if self.generator is not None:
            # Padded to few shapes with spectral silence (log 1e-5, the mel
            # floor): the generator's receptive field bleeds the padding
            # into the tail, and silence bleeds least audibly.
            t_pad = _ceil_to(max(t, 8), 32)
            mel_in = np.full((1, t_pad, mel.shape[1]), np.log(1e-5),
                             np.float32)
            mel_in[0, :t] = mel[:t]
            wav = self._generator(torch.from_numpy(mel_in).to(self.device))
            return wav[0, : t * self.hop].float().cpu().numpy()
        wav = self.stft.mel_to_audio(
            torch.from_numpy(mel[None, :t]).to(self.device),
            n_iters=SAMPLE_GRIFFIN_LIM_ITERS)[0].cpu().numpy()
        wav = wav[: t * self.hop]
        if wav.shape[0] < t * self.hop:  # the iSTFT gives (t-1)·hop samples
            wav = np.pad(wav, (0, t * self.hop - wav.shape[0]))
        return rescale_peaks(wav[None])[0]
