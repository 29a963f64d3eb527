"""Signal processing: the Slaney mel filterbank and the mel STFT with its
inverse and Griffin-Lim."""

from .mel import hz_to_mel, mel_filterbank, mel_to_hz
from .stft import MelSTFT, hann_window

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank", "MelSTFT",
           "hann_window"]
