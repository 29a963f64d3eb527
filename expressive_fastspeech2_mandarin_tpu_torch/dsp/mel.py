"""Slaney-style mel filterbank, as ``librosa.filters.mel`` computes it by
default (htk=False, norm="slaney"); a numpy copy of the JAX package's
``dsp/mel.py:21-69``.

Mel is linear below 1 kHz (f / (200/3)) and logarithmic above (log-step
log(6.4)/27); the triangles are area-normalized by 2/(f[i+2]-f[i]).
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        mel)


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    return np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mel, _MIN_LOG_MEL)
                                         - _MIN_LOG_MEL)),
        freq)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None = None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32 filter matrix; ``fmax`` None is
    sr/2."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization.
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
