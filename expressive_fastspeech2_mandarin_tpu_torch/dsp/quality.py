"""Objective audio-quality metrics: MCD, F0-RMSE and V/UV error; the JAX
package's ``dsp/quality.py``.

* **MCD (mel-cepstral distortion)**: cepstra are the orthonormal DCT-II
  coefficients c1..c_K of a natural-log mel (c0, the energy, dropped),
  frame-aligned (or DTW-aligned) between reference and test:
  ``(10/ln 10) · sqrt(2 Σₖ (cᵣ−cₜ)²)`` averaged over frames.
* **F0-RMSE (Hz)** over the frames both signals voice, and
* **V/UV error**: the share of frames whose voicing decisions disagree,
  voiced meaning a nonzero DIO + StoneMask F0 (``dsp.pitch``) and a
  normalized autocorrelation at the F0 lag above a threshold.

numpy on the host; callers pass the log-mel as a function (the
``MelSTFT`` of the CPU in ``cli.validate``).
"""

from __future__ import annotations

import numpy as np

_LOG10 = float(np.log(10.0))


def _dct2_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n_out, n_in) — rows are cepstral bases."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= np.sqrt(0.5)
    return mat


def mel_cepstra(log_mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(T, n_mels) natural-log mel → (T, n_coeffs) cepstra c1..c_K (c0,
    the energy, dropped; in the ln domain, as the 10/ln 10 scale
    assumes)."""
    mat = _dct2_matrix(log_mel.shape[1], n_coeffs + 1)
    return (np.asarray(log_mel, np.float64) @ mat.T)[:, 1:]


def _dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The monotone DTW path of least summed frame cost (O(T²): for
    utterances up to model.yaml's max_seq_len of 2000 frames)."""
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        # acc[i, j] depends on acc[i, j-1] → sequential over j
        for j in range(1, t2 + 1):
            acc[i, j] = cost[i - 1, j - 1] + min(
                acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
    i, j, path_i, path_j = t1, t2, [], []
    while i > 0 and j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        step = int(np.argmin([acc[i - 1, j - 1], acc[i - 1, j],
                              acc[i, j - 1]]))
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(path_i[::-1]), np.asarray(path_j[::-1])


def mcd(ref_log_mel: np.ndarray, test_log_mel: np.ndarray,
        n_coeffs: int = 13, use_dtw: bool = False) -> float:
    """Mel-cepstral distortion (dB) between two (T, n_mels) ln-mel arrays.

    ``use_dtw=False`` truncates to the shorter length (copy-synthesis /
    teacher-forced comparisons where frames already align);
    ``use_dtw=True`` aligns with DTW over cepstra first (free-running
    synthesis where durations differ).
    """
    c_ref = mel_cepstra(ref_log_mel, n_coeffs)
    c_test = mel_cepstra(test_log_mel, n_coeffs)
    if use_dtw:
        cost = np.sqrt(
            ((c_ref[:, None, :] - c_test[None, :, :]) ** 2).sum(-1))
        pi, pj = _dtw_path(cost)
        c_ref, c_test = c_ref[pi], c_test[pj]
    else:
        t = min(len(c_ref), len(c_test))
        c_ref, c_test = c_ref[:t], c_test[:t]
    d = np.sqrt(2.0 * ((c_ref - c_test) ** 2).sum(-1))
    return float((10.0 / _LOG10) * d.mean()) if len(d) else float("nan")


def _periodicity(wav: np.ndarray, f0: np.ndarray, sr: int,
                 hop: int) -> np.ndarray:
    """Per-frame normalized autocorrelation at the F0 lag: the voicing
    confidence DIO's track alone lacks (StoneMask gives a nonzero F0 even
    to frames of noise)."""
    out = np.zeros(len(f0))
    n = len(wav)
    for i, f in enumerate(f0):
        if f <= 0:
            continue
        lag = int(round(sr / f))
        c = i * hop
        w = max(2 * lag, int(0.03 * sr))
        a = wav[max(c - w // 2, 0): c + w // 2]
        if len(a) <= lag + 8:
            continue
        x0, x1 = a[:-lag], a[lag:]
        denom = np.sqrt((x0 * x0).sum() * (x1 * x1).sum())
        if denom > 0:
            out[i] = (x0 * x1).sum() / denom
    return out


def f0_metrics(ref_wav: np.ndarray, test_wav: np.ndarray, sr: int,
               hop_length: int = 256, f0_floor: float = 50.0,
               f0_ceil: float = 500.0,
               periodicity_thresh: float = 0.35) -> dict:
    """F0-RMSE (Hz, over frames both signals voice) and the V/UV
    disagreement share, through the preprocessor's DIO + StoneMask at the
    reference's 50-500 Hz. Voiced = a nonzero F0 and a normalized
    autocorrelation at its lag above ``periodicity_thresh`` (which tells
    noise from harmonics)."""
    from .pitch import estimate_f0

    ref_wav = np.asarray(ref_wav, np.float64)
    test_wav = np.asarray(test_wav, np.float64)
    f0_r = estimate_f0(ref_wav, sr, hop_length,
                       f0_floor=f0_floor, f0_ceil=f0_ceil)
    f0_t = estimate_f0(test_wav, sr, hop_length,
                       f0_floor=f0_floor, f0_ceil=f0_ceil)
    t = min(len(f0_r), len(f0_t))
    f0_r, f0_t = f0_r[:t], f0_t[:t]
    voiced_r = (f0_r > 0) & (_periodicity(ref_wav, f0_r, sr, hop_length)
                             > periodicity_thresh)
    voiced_t = (f0_t > 0) & (_periodicity(test_wav, f0_t, sr, hop_length)
                             > periodicity_thresh)
    both = voiced_r & voiced_t
    rmse = (float(np.sqrt(np.mean((f0_r[both] - f0_t[both]) ** 2)))
            if both.any() else float("nan"))
    return {
        "f0_rmse_hz": rmse,
        "vuv_error": float(np.mean(voiced_r != voiced_t)) if t else 1.0,
        "voiced_fraction_ref": float(voiced_r.mean()) if t else 0.0,
        "voiced_fraction_test": float(voiced_t.mean()) if t else 0.0,
        "frames": int(t),
    }


def wav_quality(ref_wav: np.ndarray, test_wav: np.ndarray, sr: int,
                log_mel_fn, hop_length: int = 256,
                use_dtw: bool = False) -> dict:
    """MCD and the F0 metrics between two waveforms. ``log_mel_fn`` maps a
    (T,) float waveform to its (frames, n_mels) natural-log mel."""
    out = {"mcd_db": mcd(log_mel_fn(ref_wav), log_mel_fn(test_wav),
                         use_dtw=use_dtw)}
    out.update(f0_metrics(ref_wav, test_wav, sr, hop_length))
    return out
