"""The port's FastSpeech2 against the JAX package's, free-running with
controls ≠ 1, under both ``padding_inert`` settings, on the CPU in float32:
durations and mel lengths exactly equal, mel within 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import FastSpeech2

torch.set_num_threads(2)
MEL_ATOL = 1e-4


def _config(mod, small: bool, padding_inert: bool):
    """The same configuration in either package's dataclasses."""
    if small:
        model = mod.ModelConfig(
            transformer=mod.TransformerConfig(
                encoder_layer=2, decoder_layer=2, encoder_hidden=64,
                decoder_hidden=64, conv_filter_size=128),
            variance_predictor=mod.VariancePredictorConfig(filter_size=64),
            variance_embedding=mod.VarianceEmbeddingConfig(n_bins=32),
            max_seq_len=48,  # below max_mel_len: the table is regrown
            padding_inert=padding_inert)
    else:
        model = mod.ModelConfig(padding_inert=padding_inert)
    return mod.Config(model=model)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_both(small: bool, padding_inert: bool, controls, max_mel: int):
    jc = _config(jcfg, small, padding_inert)
    tc = _config(tcfg, small, padding_inert)
    jmodel = JaxFastSpeech2(jc.model, jc.preprocess)
    params, bn = jmodel.init(jax.random.PRNGKey(0))
    lin = params["variance_adaptor"]["duration_predictor"]["linear"]
    lin["b"] = lin["b"] + 1.5
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}

    rng = np.random.default_rng(0)
    b, s = 3, 12
    src_lens = np.array([12, 7, 3], np.int32)
    texts = rng.integers(1, 100, size=(b, s)).astype(np.int32)
    texts[np.arange(s)[None, :] >= src_lens[:, None]] = 0
    ids = [rng.integers(0, 5, size=(b,)).astype(np.int32) for _ in range(4)]
    p_c, e_c, d_c = controls

    jout, _ = jmodel.apply(
        params, bn, *map(jnp.asarray, ids), jnp.asarray(texts),
        jnp.asarray(src_lens), max_mel_len=max_mel, p_control=p_c,
        e_control=e_c, d_control=d_c, deterministic=True)

    model = FastSpeech2(tc.model, tc.preprocess)
    model.load_state_dict(fastspeech2_from_jax(
        _numpy_tree(params), _numpy_tree(bn), consts), strict=True)
    model.eval()
    with torch.inference_mode():
        tout = model(*(torch.from_numpy(i).long() for i in ids),
                     torch.from_numpy(texts).long(),
                     torch.from_numpy(src_lens).long(), max_mel_len=max_mel,
                     p_control=p_c, e_control=e_c, d_control=d_c)
    return jout, tout


def _assert_match(jout, tout):
    np.testing.assert_array_equal(tout.durations_rounded.numpy(),
                                  np.asarray(jout.durations_rounded))
    np.testing.assert_array_equal(tout.mel_lens.numpy(),
                                  np.asarray(jout.mel_lens))
    assert int(tout.mel_lens.max()) > 0
    for name in ("mel", "postnet_mel"):
        ref = np.asarray(getattr(jout, name))
        out = getattr(tout, name).numpy()
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() < MEL_ATOL, name


@pytest.mark.parametrize("padding_inert", [True, False])
@pytest.mark.parametrize("controls", [(1.0, 1.0, 1.0), (1.2, 0.8, 1.5)])
def test_small_fastspeech2_matches_jax(padding_inert, controls):
    _assert_match(*_run_both(True, padding_inert, controls, max_mel=80))


@pytest.mark.parametrize("padding_inert", [True, False])
def test_full_width_fastspeech2_matches_jax(padding_inert):
    """Config() width: 4 + 6 FFT blocks, hidden 256, filter 1024."""
    _assert_match(*_run_both(False, padding_inert, (0.9, 1.1, 1.3),
                             max_mel=120))


def test_energy_control_quirk_flag():
    """replicate_energy_control_bug=False scales energy by e_control."""
    tc = _config(tcfg, True, True)
    fixed = dataclasses.replace(tc, model=dataclasses.replace(
        tc.model, replicate_energy_control_bug=False))
    torch.manual_seed(0)
    quirk = FastSpeech2(tc.model, tc.preprocess).eval()
    plain = FastSpeech2(fixed.model, fixed.preprocess).eval()
    plain.load_state_dict(quirk.state_dict())
    args = [torch.zeros(1, dtype=torch.long)] * 4 + [
        torch.arange(1, 9)[None], torch.tensor([8])]
    with torch.inference_mode():
        a = quirk(*args, max_mel_len=40, p_control=1.0, e_control=2.0)
        b = plain(*args, max_mel_len=40, p_control=1.0, e_control=2.0)
    assert torch.equal(a.energy_predictions, b.energy_predictions / 2.0)
