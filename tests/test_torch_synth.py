"""The synth-golden flow (tests/test_synth_golden.py) through both
Synthesizers, with the JAX package's PRNGKey(0)/(1) weights carried across.

Griffin-Lim (the default without HiFi-GAN weights) and MelGAN: the port
against the JAX Synthesizer on the same mels, Griffin-Lim from JAX's own
initial phase (PRNGKey(0)), after the 0.95-peak rescale; waveforms within
1e-4 · peak (60 iterations, tests/test_torch_dsp.py) and MelGAN's within
tests/test_melgan.py's rtol 1e-4, atol 2e-4.

float32 vocoder: the port against the JAX Synthesizer — durations and
mel_len exact, mel within 1e-4, waveform within 1e-5.

bfloat16 vocoder (the default): the port against the committed fixture
tests/fixtures/synth_golden.npz — durations and mel_len exact, mel head as
tight as the fixture's own test (the acoustic model runs in float32 in
both), waveform head within 1e-3 and RMS within 1 %: the two frameworks
round the bf16 generator at different places (XLA's fused packed path vs
the port's per-op rounding), a few bf16 units of the ~0.02 waveform peak.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from expressive_fastspeech2_mandarin_tpu.config import Config as JaxConfig
from expressive_fastspeech2_mandarin_tpu.models import init_generator
from expressive_fastspeech2_mandarin_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
)
from expressive_fastspeech2_mandarin_tpu.synth import (
    Synthesizer as JaxSynthesizer,
)
from expressive_fastspeech2_mandarin_tpu_torch.config import Config
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    hifigan_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "synth_golden.npz")
TEXT = "{b a n h ao sh i j ie}"


def _with_dtype(cfg, dtype):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocoder=dataclasses.replace(cfg.model.vocoder,
                                               compute_dtype=dtype)))


@pytest.fixture(scope="module")
def jax_weights():
    cfg = JaxConfig()
    model = JaxFastSpeech2(cfg.model, cfg.preprocess)
    params, bn_state = model.init(jax.random.PRNGKey(0))
    dp = params["variance_adaptor"]["duration_predictor"]["linear"]
    dp["b"] = dp["b"] + 2.0
    voc = init_generator(jax.random.PRNGKey(1), cfg.model.vocoder)
    consts = {k: np.asarray(v) for k, v in model.consts.items()}
    return params, bn_state, voc, consts


def _port_result(jax_weights, dtype):
    params, bn_state, voc, consts = jax_weights
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    synth = Synthesizer(
        _with_dtype(Config(), dtype),
        fastspeech2_from_jax(to_np(params), to_np(bn_state), consts),
        hifigan_from_jax(to_np(voc)), device="cpu")
    (res,) = synth.synthesize([TEXT], [0], ["Neutral"], vocoder="hifigan",
                              max_mel_len=250)
    return res


def test_float32_synthesis_matches_jax(jax_weights):
    params, bn_state, voc, _ = jax_weights
    jsynth = JaxSynthesizer(_with_dtype(JaxConfig(), "float32"), params,
                            bn_state, voc)
    (ref,) = jsynth.synthesize([TEXT], [0], ["Neutral"], vocoder="hifigan",
                               max_mel_len=250)
    res = _port_result(jax_weights, "float32")
    np.testing.assert_array_equal(res.durations, ref.durations)
    assert res.mel.shape == ref.mel.shape and res.mel.shape[0] > 0
    assert res.wav.shape == ref.wav.shape
    assert np.abs(res.mel - ref.mel).max() < 1e-4
    assert np.abs(res.wav - ref.wav).max() < 1e-5


def test_bfloat16_synthesis_matches_golden_fixture(jax_weights):
    res = _port_result(jax_weights, "bfloat16")
    ref = np.load(FIXTURE)
    assert np.isfinite(res.wav).all() and np.isfinite(res.mel).all()
    assert int(ref["mel_len"]) == res.mel.shape[0]
    np.testing.assert_array_equal(ref["durations"],
                                  res.durations.astype(np.int64))
    np.testing.assert_allclose(ref["mel_head"], res.mel[:40], atol=2e-4,
                               rtol=2e-3)
    assert np.abs(ref["wav_head"] - res.wav[:2000]).max() < 1e-3
    rms = float(np.sqrt(np.mean(res.wav ** 2)))
    np.testing.assert_allclose(float(ref["wav_rms"]), rms, rtol=1e-2)


def test_mel_only_and_unported_vocoders(jax_weights, tmp_path):
    params, bn_state, _, consts = jax_weights
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    synth = Synthesizer(Config(), fastspeech2_from_jax(
        to_np(params), to_np(bn_state), consts), device="cpu")
    (res,) = synth.synthesize([TEXT], vocoder="none", max_mel_len=250)
    assert res.wav.shape == (res.mel.shape[0] * 256,)
    assert not res.wav.any()
    paths = synth.save_results([res], str(tmp_path), tag="x")
    assert os.path.basename(paths[0]) == "utt_0_x.wav"
    # Without HiFi-GAN weights the default is Griffin-Lim, at most 0.95
    # peak; MelGAN and HiFi-GAN need their weights; no other vocoder.
    (gl,) = synth.synthesize([TEXT], max_mel_len=250)
    assert gl.wav.shape == res.wav.shape and np.abs(gl.wav).max() > 0
    assert np.abs(gl.wav).max() <= 0.95 + 1e-6
    for vocoder in ("melgan", "hifigan", "wavenet"):
        with pytest.raises(ValueError):
            synth.synthesize([TEXT], vocoder=vocoder)


def test_resolve_ids_uses_the_arousal_valence_table(jax_weights):
    params, bn_state, _, consts = jax_weights
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    maps = {"emotion": {"Angry": 3, "Sad": 1},
            "arousal": {"0.9": 4, "0.3": 0},
            "valence": {"0.1": 2, "0.2": 1}}
    synth = Synthesizer(Config(), fastspeech2_from_jax(
        to_np(params), to_np(bn_state), consts), speaker_map={"spk7": 7},
        emotion_maps=maps, device="cpu")
    assert synth.resolve_ids("spk7", "Angry") == (7, 3, 4, 2)
    assert synth.resolve_ids(2, "Sad") == (2, 1, 0, 1)
    assert synth.resolve_ids("nobody", 4) == (0, 4, 0, 0)


def test_griffin_lim_synthesis_matches_jax(jax_weights, monkeypatch):
    """The default without HiFi-GAN weights: 60 Griffin-Lim iterations and
    the 0.95-peak rescale, as the JAX Synthesizer does, from its phase."""
    params, bn_state, _, consts = jax_weights
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    texts = [TEXT, "{n i h ao}"]
    jsynth = JaxSynthesizer(JaxConfig(), params, bn_state)
    ref = jsynth.synthesize(texts, [0, 1], ["Neutral", "Happy"],
                            max_mel_len=250)
    synth = Synthesizer(Config(), fastspeech2_from_jax(
        to_np(params), to_np(bn_state), consts), device="cpu")
    phase = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (2, 250, 513), minval=-np.pi, maxval=np.pi))
    griffin_lim = synth.stft.griffin_lim
    monkeypatch.setattr(synth.stft, "griffin_lim",
                        lambda mag, n_iters, *_: griffin_lim(
                            mag, n_iters, phase=torch.from_numpy(phase)))
    out = synth.synthesize(texts, [0, 1], ["Neutral", "Happy"],
                           max_mel_len=250)
    for r, o in zip(ref, out, strict=True):
        np.testing.assert_array_equal(o.durations, r.durations)
        assert o.wav.shape == r.wav.shape and o.wav.size > 0
        peak = np.abs(r.wav).max()
        assert 0 < np.abs(o.wav).max() <= 0.95 + 1e-6
        np.testing.assert_allclose(o.wav, r.wav, atol=1e-4 * peak)


def test_melgan_synthesis_matches_jax(jax_weights, tmp_path):
    """vocoder="melgan" through both Synthesizers' load_melgan on one
    melgan-neurips checkpoint (tests/test_melgan.py's replica)."""
    from .test_melgan import _build_torch_melgan

    params, bn_state, _, consts = jax_weights
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    torch.manual_seed(4)
    path = str(tmp_path / "melgan.pt")
    torch.save(_build_torch_melgan().state_dict(), path)
    jsynth = JaxSynthesizer(JaxConfig(), params, bn_state)
    jsynth.load_melgan(path)
    (ref,) = jsynth.synthesize([TEXT], vocoder="melgan", max_mel_len=250)
    synth = Synthesizer(Config(), fastspeech2_from_jax(
        to_np(params), to_np(bn_state), consts), device="cpu")
    synth.load_melgan(path)
    (out,) = synth.synthesize([TEXT], vocoder="melgan", max_mel_len=250)
    assert out.wav.shape == ref.wav.shape and out.wav.size > 0
    np.testing.assert_allclose(out.wav, ref.wav, rtol=1e-4, atol=2e-4)
