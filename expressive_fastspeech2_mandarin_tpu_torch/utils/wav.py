"""WAV reading, writing and resampling on scipy; the JAX package's
``utils/wav.py:1-51``.

``load_wav`` gives what ``librosa.load`` gives the reference's
preprocessor: float32 in [-1, 1], mixed to mono, resampled to the target
rate (22050 Hz by default).
"""

from __future__ import annotations

import numpy as np
import scipy.signal
from scipy.io import wavfile


def load_wav(path: str, sr: int | None = 22050) -> tuple[np.ndarray, int]:
    """(float32 mono audio in [-1, 1], sampling rate); ``sr`` None keeps
    the file's rate."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if sr is not None and file_sr != sr:
        audio = resample(audio, file_sr, sr)
        file_sr = sr
    return audio, file_sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling by the reduced ratio target/orig."""
    if orig_sr == target_sr:
        return audio
    g = np.gcd(int(orig_sr), int(target_sr))
    return scipy.signal.resample_poly(
        audio, target_sr // g, orig_sr // g).astype(np.float32)


def save_wav(path: str, audio: np.ndarray, sr: int,
             max_wav_value: float = 32768.0) -> None:
    """Float audio in [-1, 1] → int16 wav."""
    data = np.clip(audio * max_wav_value, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, data)


def peak_normalize(audio: np.ndarray, peak: float = 0.95) -> np.ndarray:
    m = np.abs(audio).max()
    return audio if m == 0 else (audio / m * peak).astype(np.float32)
