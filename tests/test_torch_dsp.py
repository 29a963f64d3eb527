"""The port's DSP (dsp/mel.py, dsp/stft.py, utils/wav.py) against the JAX
package's, on the CPU in float32.

Bounds: the filterbank atol 1e-7; frames exact (the same samples); mel
atol 1e-4 and energy rtol 1e-4 (tests/test_dsp.py's bounds, tightened to
what holds: the two packages' FFTs round differently); the iSTFT 1e-5 ·
peak; Griffin-Lim from JAX's own initial phase (drawn here with
``jax.random.uniform(PRNGKey(0))``) 1e-5 · peak after 5 iterations and
1e-4 · peak after 60 (round-off grows with the iterations: ~3e-6 and
~1.3e-5 · peak measured), with the spectral convergence at 60 within
1e-5 relative.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.config import (
    MelConfig as JaxMelConfig,
    STFTConfig as JaxSTFTConfig,
)
from expressive_fastspeech2_mandarin_tpu.dsp.mel import (
    mel_filterbank as jax_mel_filterbank,
)
from expressive_fastspeech2_mandarin_tpu.dsp.stft import MelSTFT as JaxMelSTFT
from expressive_fastspeech2_mandarin_tpu.utils import wav as jax_wav
from expressive_fastspeech2_mandarin_tpu_torch.config import (
    MelConfig,
    STFTConfig,
)
from expressive_fastspeech2_mandarin_tpu_torch.dsp import (
    MelSTFT,
    mel_filterbank,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import reflect_pad
from expressive_fastspeech2_mandarin_tpu_torch.utils import wav as port_wav

torch.set_num_threads(2)
SR = 22050


@pytest.fixture(scope="module")
def stfts():
    return (MelSTFT(STFTConfig(), MelConfig(), SR),
            JaxMelSTFT(JaxSTFTConfig(), JaxMelConfig(), SR))


@pytest.fixture(scope="module")
def audio():
    """Two 1 s signals: harmonics with vibrato, plus noise."""
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    out = []
    for f0 in (180.0, 260.0):
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(
            2 * np.pi * 5 * t))) / SR
        sig = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
        out.append(sig + 0.02 * rng.standard_normal(len(t)))
    return np.clip(np.stack(out), -1, 1).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,fmax", [(22050, 1024, 8000.0),
                                           (22050, 1024, None),
                                           (16000, 256, None)])
def test_mel_filterbank_matches_jax(sr, n_fft, fmax):
    ours = mel_filterbank(sr, n_fft, 80, 0.0, fmax)
    ref = jax_mel_filterbank(sr, n_fft, 80, 0.0, fmax)
    assert ours.shape == ref.shape == (80, n_fft // 2 + 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,left,right", [(1, 3, 3), (5, 4, 4), (5, 9, 13),
                                          (1000, 512, 512)])
def test_reflect_pad_matches_numpy(n, left, right):
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    out = reflect_pad(torch.from_numpy(x), left, right, dim=1).numpy()
    np.testing.assert_array_equal(
        out, np.pad(x, ((0, 0), (left, right)), mode="reflect"))


def test_frame_magnitude_and_mel_energy_match_jax(stfts, audio):
    port, ref = stfts
    x = torch.from_numpy(audio)
    np.testing.assert_array_equal(port.frame(x).numpy(),
                                  np.asarray(ref.frame(jnp.asarray(audio))))
    mag = port.magnitude(x).numpy()
    ref_mag = np.asarray(ref.magnitude(jnp.asarray(audio)))
    assert mag.shape == ref_mag.shape
    np.testing.assert_allclose(mag, ref_mag, rtol=1e-4, atol=1e-4)
    mel, energy = port.mel_energy(x)
    ref_mel, ref_energy = ref.mel_energy(jnp.asarray(audio))
    assert mel.shape == ref_mel.shape and energy.shape == ref_energy.shape
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=1e-4)
    np.testing.assert_allclose(energy.numpy(), np.asarray(ref_energy),
                               rtol=1e-4)
    assert mel.min() >= np.log(1e-5) - 1e-6


def test_istft_matches_jax(stfts, audio):
    port, ref = stfts
    mag = np.asarray(ref.magnitude(jnp.asarray(audio)))
    phase = np.random.default_rng(1).uniform(
        -np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.asarray(ref.istft(jnp.asarray(mag), jnp.asarray(phase)))
    got = port.istft(torch.from_numpy(mag), torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape == (2, (mag.shape[1] - 1) * 256)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_istft_of_the_analysis_phase_gives_the_signal_back(stfts, audio):
    """iSTFT(|X|, ∠X) of the STFT X of a signal is the signal (within 1e-3,
    tests/test_dsp.py's round-trip bound) where full frames overlap."""
    port, _ = stfts
    x = torch.from_numpy(audio)
    spec = torch.fft.rfft(port.frame(x) * port.window, dim=-1)
    back = port.istft(spec.abs(), torch.angle(spec)).numpy()
    n = back.shape[1]
    np.testing.assert_allclose(back[:, 1024: n - 1024],
                               audio[:, 1024: n - 1024], atol=1e-3)


def _jax_phase(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                         minval=-np.pi, maxval=np.pi))


def _spectral_convergence(stft: JaxMelSTFT, wav, target) -> float:
    mag = np.asarray(stft.magnitude(jnp.asarray(wav)))
    return float(np.linalg.norm(mag - target) / np.linalg.norm(target))


@pytest.mark.parametrize("n_iters,rel", [(5, 1e-5), (60, 1e-4)])
def test_mel_to_audio_matches_jax_from_its_phase(stfts, audio, n_iters, rel):
    port, ref = stfts
    log_mel = np.asarray(ref.mel_energy(jnp.asarray(audio))[0])
    phase = _jax_phase(log_mel.shape[:2] + (513,))
    want = np.asarray(ref.mel_to_audio(jnp.asarray(log_mel),
                                       n_iters=n_iters))
    got = port.mel_to_audio(torch.from_numpy(log_mel), n_iters,
                            phase=torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())
    if n_iters == 60:
        target = np.clip(np.exp(log_mel) @ np.linalg.pinv(
            np.asarray(ref.mel_basis)).T, 0, None)
        sc = _spectral_convergence(ref, got, target)
        sc_ref = _spectral_convergence(ref, want, target)
        assert abs(sc - sc_ref) <= 1e-5 * sc_ref


def test_griffin_lim_matches_jax_from_its_phase(stfts, audio):
    port, ref = stfts
    mag = np.asarray(ref.magnitude(jnp.asarray(audio[:, :8000])))
    want = np.asarray(ref.griffin_lim(jnp.asarray(mag), n_iters=5))
    got = port.griffin_lim(torch.from_numpy(mag), 5, phase=torch.from_numpy(
        _jax_phase(mag.shape))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_default_phase_is_drawn_on_the_cpu_from_seed_0(stfts):
    """Without a phase Griffin-Lim draws one from torch.Generator seeded 0
    on the CPU (the same on every device)."""
    port, _ = stfts
    mag = torch.rand(1, 12, 513, generator=torch.Generator().manual_seed(2))
    u = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0))
    explicit = port.griffin_lim(mag, 3, phase=-np.pi + 2 * np.pi * u)
    torch.testing.assert_close(port.griffin_lim(mag, 3), explicit, rtol=0,
                               atol=0)
    other = port.griffin_lim(mag, 3,
                             generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other, explicit)


@pytest.mark.parametrize("channels,dtype", [(1, np.int16), (2, np.int16),
                                            (1, np.float32)])
def test_load_wav_and_resample_match_jax(tmp_path, channels, dtype):
    rng = np.random.default_rng(channels)
    data = rng.uniform(-0.5, 0.5, (1600, channels)).squeeze()
    if dtype == np.int16:
        data = (data * 32767).astype(np.int16)
    else:
        data = data.astype(np.float32)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 16000, data)
    for sr in (None, 16000, 22050):
        ours, ours_sr = port_wav.load_wav(path, sr)
        ref, ref_sr = jax_wav.load_wav(path, sr)
        assert ours_sr == ref_sr and ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


def test_save_wav_round_trips_and_stays_importable_from_synth(tmp_path):
    from expressive_fastspeech2_mandarin_tpu_torch.synth.synthesizer import (
        save_wav,
    )

    assert save_wav is port_wav.save_wav
    x = np.linspace(-1.2, 1.2, 500).astype(np.float32)
    path = str(tmp_path / "y.wav")
    port_wav.save_wav(path, x, 16000)
    jax_wav.save_wav(str(tmp_path / "z.wav"), x, 16000)
    a, _ = port_wav.load_wav(path, None)
    b, _ = port_wav.load_wav(str(tmp_path / "z.wav"), None)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - np.clip(x, -1, 1)).max() <= 1 / 32768 + 1e-7
