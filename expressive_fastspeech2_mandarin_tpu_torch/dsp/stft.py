"""The mel STFT, its inverse and Griffin-Lim; the JAX package's
``dsp/stft.py:30-137``.

The reference's TacotronSTFT numerics: reflect padding by n_fft/2, a
periodic Hann window, hop-strided frames, magnitude spectra, the Slaney mel
projection, ``log(clamp(x, 1e-5))`` compression, and energy as the L2 norm
of the magnitudes over frequency. The FFTs are ``torch.fft`` (cuFFT on the
card): the JAX package computes them outside any Pallas kernel too.

Griffin-Lim's initial phase: the JAX package draws it with
``jax.random.uniform(PRNGKey(0))``. Here it is an argument; without one it
is drawn uniformly in [-π, π) on the CPU from ``generator`` (a
``torch.Generator`` seeded 0 by default) and moved to the module's device,
so a run on the card and one on the CPU start from the same phase. The two
packages' default phases differ; a test that holds one against the other
passes JAX's phase in.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MelConfig, STFTConfig
from ..ops.conv import reflect_pad
from .mel import mel_filterbank


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann, zero-padded centred to n_fft (float32)."""
    w = scipy.signal.get_window("hann", win_length, fftbins=True)
    if n_fft > win_length:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w.astype(np.float32)


class MelSTFT(nn.Module):
    """The window, the mel filterbank and its pseudo-inverse as buffers on
    ``device``; every method runs on the device of its input, which is the
    module's."""

    def __init__(self, stft: STFTConfig, mel: MelConfig, sampling_rate: int,
                 device: str | torch.device = "cpu"):
        super().__init__()
        self.n_fft = stft.filter_length
        self.hop = stft.hop_length
        self.win = stft.win_length
        self.sampling_rate = sampling_rate
        basis = mel_filterbank(sampling_rate, self.n_fft, mel.n_mel_channels,
                               mel.mel_fmin, mel.mel_fmax)
        self.register_buffer("window", torch.from_numpy(
            hann_window(self.win, self.n_fft)).to(device))
        self.register_buffer("mel_basis", torch.from_numpy(basis).to(device))
        # float32 in, float32 out, as the JAX package computes it.
        self.register_buffer("mel_pinv", torch.from_numpy(
            np.linalg.pinv(basis)).to(device))
        self._wss: dict[tuple[int, torch.device], torch.Tensor] = {}

    # -- forward ------------------------------------------------------------

    def frame(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) → (B, n_frames, n_fft) reflect-padded hop-strided
        frames."""
        pad = self.n_fft // 2
        x = reflect_pad(audio, pad, pad, dim=1)
        return x.unfold(1, self.n_fft, self.hop)

    def frames_magnitude(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, n_frames, n_fft) frames → (B, n_frames, n_fft//2+1) linear
        magnitudes of the windowed frames, in the frames' precision."""
        return torch.fft.rfft(frames * self.window, dim=-1).abs()

    def log_mel(self, magnitude: torch.Tensor) -> torch.Tensor:
        """Linear magnitudes → log-mel clipped at 1e-5."""
        basis = self.mel_basis.to(magnitude.dtype)
        return torch.log(torch.clamp(magnitude @ basis.T, min=1e-5))

    def magnitude(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) → (B, n_frames, n_fft//2+1) linear magnitude spectra."""
        return self.frames_magnitude(self.frame(audio))

    def mel_energy(self, audio: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T) in [-1, 1] → (log-mel (B, T', n_mels), energy (B, T'))."""
        mag = self.magnitude(audio)
        return self.log_mel(mag), torch.linalg.vector_norm(mag, dim=-1)

    # -- inverse ------------------------------------------------------------

    def _window_sumsquare(self, n_frames: int) -> torch.Tensor:
        """The squared window overlap-added over ``n_frames``, in float64
        on the host as the JAX package computes it (``:75-98``), with the
        entries at or below float32's tiny set to 1; float32 on the
        module's device, kept per frame count."""
        key = (n_frames, self.window.device)
        cached = self._wss.get(key)
        if cached is None:
            win_sq = hann_window(self.win, self.n_fft).astype(np.float64) ** 2
            n = self.n_fft + self.hop * (n_frames - 1)
            x = np.zeros(n)
            for i in range(n_frames):
                s = i * self.hop
                x[s: s + self.n_fft] += win_sq[: max(0, min(self.n_fft,
                                                            n - s))]
            x = np.where(x > np.finfo(np.float32).tiny, x, 1.0)
            cached = torch.from_numpy(x.astype(np.float32)).to(
                self.window.device)
            self._wss[key] = cached
        return cached

    def istft(self, magnitude: torch.Tensor,
              phase: torch.Tensor) -> torch.Tensor:
        """(B, T', F) magnitude and phase → (B, (T'-1)·hop) waveform, the
        overlap-added frames divided by the window-sumsquare and trimmed by
        n_fft/2 at both ends."""
        n_frames = magnitude.shape[1]
        spec = torch.polar(magnitude.float(), phase.float())
        frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1) * self.window
        n = self.n_fft + self.hop * (n_frames - 1)
        out = F.fold(frames.transpose(1, 2), output_size=(1, n),
                     kernel_size=(1, self.n_fft),
                     stride=(1, self.hop))[:, 0, 0]
        out = out / self._window_sumsquare(n_frames)
        pad = self.n_fft // 2
        return out[:, pad: n - pad]

    def griffin_lim(self, magnitude: torch.Tensor, n_iters: int = 30,
                    phase: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
        """(B, T', F) linear magnitudes → waveform by ``n_iters`` rounds of
        phase reconstruction from ``phase`` (drawn as the module docstring
        says when None)."""
        if phase is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            u = torch.rand(magnitude.shape, generator=generator)
            phase = (-math.pi + 2 * math.pi * u).to(magnitude.device)
        signal = self.istft(magnitude, phase)
        for _ in range(n_iters):
            spec = torch.fft.rfft(self.frame(signal) * self.window, dim=-1)
            signal = self.istft(magnitude, torch.angle(spec))
        return signal

    def mel_to_audio(self, log_mel: torch.Tensor, n_iters: int = 60,
                     phase: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """(B, T', n_mels) log-mel → waveform by Griffin-Lim, the
        magnitudes projected back through the filterbank's pseudo-inverse
        (clamped at 0)."""
        mel = torch.exp(log_mel.float())
        mag = torch.clamp(mel @ self.mel_pinv.T, min=0.0)
        return self.griffin_lim(mag, n_iters, phase, generator)
