"""The port's ``dsp/quality.py`` against the JAX package's on seeded
signals: MCD (frame-aligned and by DTW) on the same log-mels, F0-RMSE and
the V/UV error on the same waveforms, and ``wav_quality`` through the
port's ``MelSTFT`` on the CPU. Bounds: every metric within 1e-6 relative,
the voiced and disagreeing frame counts exact; the port's log-mel against
JAX's within tests/test_torch_dsp.py's 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.config import Config as JaxConfig
from expressive_fastspeech2_mandarin_tpu.dsp import quality as jq
from expressive_fastspeech2_mandarin_tpu.dsp.stft import MelSTFT as JaxMelSTFT
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.dsp import quality as tq
from expressive_fastspeech2_mandarin_tpu_torch.dsp.stft import MelSTFT

SR = 22050
HOP = 256
REL = 1e-6


def _harmonic(f0: float, seconds: float, seed: int) -> np.ndarray:
    """A vibrato harmonic tone between silent edges (voiced and unvoiced
    frames both)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
                                  ) / SR
    x = sum((0.6 / k) * np.sin(k * phase + rng.uniform(0, 6))
            for k in range(1, 9))
    x = x / np.abs(x).max() * 0.7
    edge = 1e-3 * rng.standard_normal(int(0.2 * SR))
    return np.concatenate([edge, x, edge])


def _port_log_mel():
    pre = tcfg.Config().preprocess
    stft = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate, "cpu")

    def fn(w):
        m, _ = stft.mel_energy(torch.as_tensor(w, dtype=torch.float32)[None])
        return m[0].numpy()

    return fn


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1e-30) or (
        np.isnan(a) and np.isnan(b))


@pytest.fixture(scope="module")
def signals():
    ref = _harmonic(150.0, 1.2, 0)
    rng = np.random.default_rng(1)
    return {"ref": ref,
            "detuned": _harmonic(171.0, 1.2, 2),
            "noisy": ref + 0.05 * rng.standard_normal(ref.shape),
            "noise": 0.2 * rng.standard_normal(ref.shape)}


def test_port_log_mel_matches_jax(signals):
    pre = JaxConfig().preprocess
    jstft = JaxMelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate)
    ours = _port_log_mel()(signals["noisy"])
    ref, _ = jstft.mel_energy(jnp.asarray(signals["noisy"], jnp.float32)[None])
    np.testing.assert_allclose(ours, np.asarray(ref)[0], atol=1e-4)


@pytest.mark.parametrize("use_dtw", [False, True])
@pytest.mark.parametrize("other", ["detuned", "noisy", "noise"])
def test_mcd_matches_jax(signals, other, use_dtw):
    log_mel = _port_log_mel()
    a = log_mel(signals["ref"])
    b = log_mel(signals[other])
    if use_dtw:  # a length change the DTW has to absorb
        b = np.repeat(b, 2, axis=0)[::3][:60]
        a = a[:50]
    ours = tq.mcd(a, b, use_dtw=use_dtw)
    ref = jq.mcd(a, b, use_dtw=use_dtw)
    assert ours > 0 and _close(ours, ref), (ours, ref)
    np.testing.assert_allclose(tq.mel_cepstra(a), jq.mel_cepstra(a),
                               rtol=REL, atol=0)
    assert tq.mcd(a, a) == 0.0


@pytest.mark.parametrize("other", ["ref", "detuned", "noisy", "noise"])
def test_f0_metrics_match_jax(signals, other):
    ours = tq.f0_metrics(signals["ref"], signals[other], SR, HOP)
    ref = jq.f0_metrics(signals["ref"], signals[other], SR, HOP)
    assert ours["frames"] == ref["frames"] > 0
    n = ref["frames"]
    for key in ("vuv_error", "voiced_fraction_ref", "voiced_fraction_test"):
        assert round(ours[key] * n) == round(ref[key] * n), key  # counts
        assert _close(ours[key], ref[key]), key
    assert _close(ours["f0_rmse_hz"], ref["f0_rmse_hz"]), (ours, ref)
    if other == "ref":
        assert ours["f0_rmse_hz"] == 0.0 and ours["vuv_error"] == 0.0
    if other == "noise":
        assert ours["voiced_fraction_test"] < 0.2  # the negative control


def test_wav_quality_matches_jax(signals):
    log_mel = _port_log_mel()
    for other in ("detuned", "noisy"):
        ours = tq.wav_quality(signals["ref"], signals[other], SR, log_mel,
                              HOP)
        ref = jq.wav_quality(signals["ref"], signals[other], SR, log_mel,
                             HOP)
        assert ours.keys() == ref.keys()
        for key in ours:
            assert _close(ours[key], ref[key]), (key, ours[key], ref[key])

