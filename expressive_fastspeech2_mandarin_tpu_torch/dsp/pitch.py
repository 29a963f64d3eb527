"""Fundamental-frequency estimation, DIO candidate search and StoneMask
refinement in numpy; the JAX package's ``dsp/pitch.py:33-259``.

The reference calls PyWORLD (``pw.dio`` at frame period hop/sr·1000 ms,
then ``pw.stonemask``); the JAX package reimplements the scheme in numpy,
and this is a copy of that implementation:

* DIO: per-octave-channel low-pass filtering (Nuttall-windowed FIR), four
  event-interval estimators (negative/positive zero crossings, peaks,
  dips), candidate = their mean, reliability = their deviation; the best
  channel per frame wins, unstable frames are unvoiced.
* StoneMask: each voiced frame refined by harmonic-weighted instantaneous
  frequency (the one-sample-shift DFT phase method).

It is an offline CPU path in both packages: the feature extractor runs it
in its pool workers. The optional C++ extractor ``native/pitch/
libefs2pitch.so`` (the same scheme, thread-parallel) is loaded through
ctypes when it is built, under the same knobs as in the JAX package:
``EFS2_PITCH_LIB`` names another library, ``EFS2_PITCH_BACKEND=numpy``
keeps the numpy path. The repo ships it unbuilt, so both packages run
numpy by default.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib

import numpy as np
import scipy.signal


def _nuttall(n: int) -> np.ndarray:
    return scipy.signal.windows.nuttall(n, sym=True)


def _lowpass(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """FFT low-pass with a Nuttall-windowed FIR at ``cutoff`` Hz."""
    half = max(int(round(fs / cutoff / 2.0)), 1)
    n = 4 * half + 1
    t = np.arange(n) - 2 * half
    h = np.sinc(2 * cutoff / fs * t) * (2 * cutoff / fs) * _nuttall(n)
    h /= h.sum()
    return scipy.signal.fftconvolve(x, h, mode="same")


def _event_intervals(signal: np.ndarray, fs: float, negative: bool):
    """(event_times, interval_f0s) from zero crossings of ``signal``."""
    s = -signal if negative else signal
    # Gate filter round-off in digitally silent regions to exact zero so
    # silence yields no events (kept in sync with native/pitch/pitch.cc).
    gate = 1e-10 * np.max(np.abs(s)) if len(s) else 0.0
    s = np.where(np.abs(s) <= gate, 0.0, s)
    crossing = np.where((s[:-1] < 0) & (s[1:] >= 0))[0]
    if len(crossing) < 3:
        return np.array([]), np.array([])
    # Linear-interpolated crossing times (samples).
    frac = -s[crossing] / (s[crossing + 1] - s[crossing])
    times = (crossing + frac) / fs
    intervals = np.diff(times)
    centers = 0.5 * (times[:-1] + times[1:])
    with np.errstate(divide="ignore"):
        f0 = 1.0 / intervals
    return centers, f0


def _candidate_track(filtered: np.ndarray, fs: float, frame_times: np.ndarray,
                     f0_floor: float, f0_ceil: float):
    """Four-interval candidate F0 + reliability for one channel."""
    d = np.gradient(filtered)
    tracks = []
    for sig, neg in ((filtered, True), (filtered, False), (d, True), (d, False)):
        centers, f0 = _event_intervals(sig, fs, neg)
        if len(centers) < 2:
            return None
        tracks.append(np.interp(frame_times, centers, f0,
                                left=0.0, right=0.0))
    tracks = np.stack(tracks)  # (4, T)
    mean = tracks.mean(axis=0)
    dev = np.sqrt(np.mean((tracks - mean) ** 2, axis=0) + 1e-12)
    bad = (mean < f0_floor) | (mean > f0_ceil) | np.any(tracks <= 0, axis=0)
    mean = np.where(bad, 0.0, mean)
    dev = np.where(bad, np.inf, dev / np.maximum(mean, 1e-6))
    return mean, dev


def dio(
    x: np.ndarray,
    fs: int,
    frame_period: float = 5.805,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Estimate F0 per frame. Returns (f0, frame_times_seconds).

    Frame count matches PyWORLD: ``floor(len(x)/fs*1000/frame_period) + 1``.
    Unvoiced frames are 0.
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    frame_times = np.arange(n_frames) * frame_period / 1000.0

    # Remove DC / very low rumble below the floor.
    base = _lowpass(x, fs, f0_ceil * 2.0)
    base = base - _lowpass(base, fs, max(f0_floor * 0.5, 10.0))

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave))
    best_f0 = np.zeros(n_frames)
    best_dev = np.full(n_frames, np.inf)
    for i in range(n_bands + 1):
        boundary = f0_floor * 2.0 ** ((i + 1) / channels_in_octave)
        filtered = _lowpass(base, fs, boundary)
        res = _candidate_track(filtered, fs, frame_times, f0_floor, f0_ceil)
        if res is None:
            continue
        cand, dev = res
        better = dev < best_dev
        best_f0 = np.where(better, cand, best_f0)
        best_dev = np.where(better, dev, best_dev)

    f0 = np.where(best_dev < allowed_range * 2.0, best_f0, 0.0)

    # Contour fix: kill isolated jumps > allowed_range between neighbors.
    for _ in range(2):
        prev = np.roll(f0, 1)
        prev[0] = f0[0]
        jump = (f0 > 0) & (prev > 0) & (
            np.abs(f0 - prev) / np.maximum(f0, 1e-6) > allowed_range * 2.0)
        # A jump that immediately returns is an outlier point.
        nxt = np.roll(f0, -1)
        nxt[-1] = f0[-1]
        outlier = jump & (np.abs(nxt - prev) / np.maximum(prev, 1e-6)
                          < allowed_range)
        f0 = np.where(outlier, 0.5 * (prev + nxt), f0)
    # Drop very short voiced islands (< 3 frames).
    voiced = f0 > 0
    edges = np.flatnonzero(np.diff(np.concatenate(([0], voiced.view(np.int8), [0]))))
    for start, end in zip(edges[::2], edges[1::2]):
        if end - start < 3:
            f0[start:end] = 0.0
    return f0, frame_times


def stonemask(x: np.ndarray, f0: np.ndarray, frame_times: np.ndarray,
              fs: int) -> np.ndarray:
    """Refine DIO's F0 with harmonic-weighted instantaneous frequency."""
    x = np.asarray(x, dtype=np.float64)
    refined = f0.copy()
    for it in range(2):
        for t_idx, (t, f) in enumerate(zip(frame_times, refined)):
            if f <= 0:
                continue
            half = int(round(1.5 * fs / f))
            c = int(round(t * fs))
            lo, hi = c - half, c + half + 1
            if lo < 0 or hi + 1 > len(x):
                continue
            seg = x[lo:hi]
            win = np.blackman(len(seg))
            sw = seg * win
            sw1 = x[lo + 1: hi + 1] * win
            n_fft = 1 << int(np.ceil(np.log2(len(seg) * 2)))
            spec = np.fft.rfft(sw, n_fft)
            spec1 = np.fft.rfft(sw1, n_fft)
            freqs_hz = np.fft.rfftfreq(n_fft, 1.0 / fs)
            # Instantaneous frequency via one-sample phase advance.
            dphi = np.angle(spec1 * np.conj(spec))
            inst = dphi * fs / (2 * np.pi)
            num = 0.0
            den = 0.0
            for k in range(1, 7):
                target = k * f
                if target > fs / 2 - 100:
                    break
                bin_idx = int(round(target / (fs / n_fft)))
                amp = np.abs(spec[bin_idx])
                inst_k = inst[bin_idx] / k
                if inst_k <= 0:
                    continue
                num += amp * inst_k
                den += amp
            if den > 0:
                new_f = num / den
                if 0.5 * f < new_f < 2.0 * f:
                    refined[t_idx] = new_f
    return refined


@functools.cache
def _native_lib() -> ctypes.CDLL | None:
    """Load the C++ extractor (native/pitch/libefs2pitch.so) if built.

    The native library implements the identical DIO+StoneMask scheme
    thread-parallel in C++; ``EFS2_PITCH_LIB`` overrides the search path and
    ``EFS2_PITCH_BACKEND=numpy`` disables it.
    """
    if os.environ.get("EFS2_PITCH_BACKEND", "auto") == "numpy":
        return None
    candidates = []
    if "EFS2_PITCH_LIB" in os.environ:
        candidates.append(pathlib.Path(os.environ["EFS2_PITCH_LIB"]))
    repo = pathlib.Path(__file__).resolve().parents[2]
    candidates.append(repo / "native" / "pitch" / "libefs2pitch.so")
    for path in candidates:
        if not path.exists():
            continue
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            continue
        lib.efs2_estimate_f0.restype = ctypes.c_int
        lib.efs2_estimate_f0.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        return lib
    return None


def _estimate_f0_native(lib: ctypes.CDLL, x: np.ndarray, fs: int,
                        frame_period: float, f0_floor: float,
                        f0_ceil: float) -> np.ndarray | None:
    x = np.ascontiguousarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    out = np.zeros(n_frames, dtype=np.float64)
    got = lib.efs2_estimate_f0(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x), fs,
        frame_period, f0_floor, f0_ceil,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_frames)
    if got < 0:
        return None
    return out[:got]


def estimate_f0(
    x: np.ndarray,
    fs: int,
    hop_length: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
) -> np.ndarray:
    """DIO + StoneMask at the reference's hop period
    (frame_period = hop/fs*1000, preprocessor/preprocessor.py:256-261).

    Uses the native C++ extractor when available (same algorithm,
    thread-parallel), the numpy implementation otherwise
    (``pitch_backend``).
    """
    frame_period = hop_length / fs * 1000.0
    lib = _native_lib()
    if lib is not None:
        f0 = _estimate_f0_native(lib, x, fs, frame_period, f0_floor, f0_ceil)
        if f0 is not None:
            return f0
    f0, t = dio(x, fs, frame_period=frame_period,
                f0_floor=f0_floor, f0_ceil=f0_ceil)
    return stonemask(x, f0, t, fs)


def pitch_backend() -> str:
    """"native" when ``estimate_f0`` takes the C++ extractor, else
    "numpy"."""
    return "native" if _native_lib() is not None else "numpy"
