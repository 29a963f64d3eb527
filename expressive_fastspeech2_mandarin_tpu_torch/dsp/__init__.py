"""Signal processing: the Slaney mel filterbank, the mel STFT with its
inverse and Griffin-Lim, and F0 estimation (DIO + StoneMask, numpy)."""

from .mel import hz_to_mel, mel_filterbank, mel_to_hz
from .pitch import dio, estimate_f0, pitch_backend, stonemask
from .stft import MelSTFT, hann_window

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank", "MelSTFT",
           "hann_window", "dio", "stonemask", "estimate_f0",
           "pitch_backend"]
