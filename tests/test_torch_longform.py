"""The long-form and streaming slice as a whole: the port's Synthesizer
against the JAX package's, on the CPU in float32.

Small width with the real attention shape (hidden 256, 2 heads so D = 128;
1 encoder and 2 decoder layers), B = 2 with one long (2144 frames) and one
short utterance, ``max_mel_len=2176``: past 2048 frames and past
``max_seq_len`` = 2000, so the position table is regrown.

* ``attention_impl="flash"``: the port (its plain version on the CPU)
  against the JAX Synthesizer with the TPU kernel in interpret mode,
  ``vocoder="none"``: durations exact, mel within 1e-4 (the bound of
  tests/test_torch_fastspeech2.py).
* ``synthesize_streaming`` against the JAX package's at a short
  ``max_mel_len`` (as tests/test_streaming.py does): the same number of
  samples, within 1e-4.

Weights come from torch's seeded initialisation and reach the JAX package
through its own ``convert_fastspeech2`` / ``convert_hifigan``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.interop.torch_ckpt import (
    convert_fastspeech2,
    convert_hifigan,
)
from expressive_fastspeech2_mandarin_tpu.synth import (
    Synthesizer as JaxSynthesizer,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.models import (
    FastSpeech2,
    Generator,
)
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

torch.set_num_threads(2)
LONG = "{" + " ".join(["b a n h ao sh i j ie n i h ao"] * 10) + "}"
SHORT = "{n i h ao sh i j ie}"
MAX_MEL = 2176
DURATION_BIAS = 2.75  # ≈ 16.5 frames a phone: 2144 frames for LONG


def _config(mod, attention_impl: str):
    model = mod.ModelConfig(
        transformer=mod.TransformerConfig(
            encoder_layer=1, decoder_layer=2, conv_filter_size=256,
            attention_impl=attention_impl),
        variance_predictor=mod.VariancePredictorConfig(filter_size=64),
        vocoder=dataclasses.replace(mod.VocoderConfig(),
                                    upsample_initial_channel=64,
                                    compute_dtype="float32"))
    return mod.Config(model=model)


@pytest.fixture(scope="module")
def weights():
    cfg = _config(tcfg, "auto")
    torch.manual_seed(0)
    fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += (
        DURATION_BIAS)
    voc = Generator(cfg.model.vocoder).state_dict()
    params, bn_state, consts = convert_fastspeech2(
        {k: v.numpy() for k, v in fs2.items()})
    jvoc = convert_hifigan({k: v.numpy() for k, v in voc.items()})
    return fs2, voc, (params, bn_state, consts, jvoc)


def test_long_form_flash_matches_jax_flash_kernel(weights):
    fs2, _, (params, bn_state, consts, _) = weights
    port = Synthesizer(_config(tcfg, "flash"), fs2, device="cpu")
    res = port.synthesize([LONG, SHORT], vocoder="none", max_mel_len=MAX_MEL)
    jsynth = JaxSynthesizer(_config(jcfg, "flash"), params, bn_state,
                            consts_override=consts)
    with pltpu.force_tpu_interpret_mode():
        ref = jsynth.synthesize([LONG, SHORT], vocoder="none",
                                max_mel_len=MAX_MEL)
    lens = [r.mel.shape[0] for r in res]
    assert 2048 < lens[0] < MAX_MEL and lens[1] < 500
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.durations, b.durations)
        assert a.mel.shape == b.mel.shape
        assert np.isfinite(a.mel).all()
        assert np.abs(a.mel - b.mel).max() < 1e-4


def test_streaming_matches_jax_streaming(weights):
    fs2, voc, (params, bn_state, consts, jvoc) = weights
    port = Synthesizer(_config(tcfg, "auto"), fs2, voc, device="cpu")
    jsynth = JaxSynthesizer(_config(jcfg, "auto"), params, bn_state, jvoc,
                            consts_override=consts)
    kwargs = dict(speaker=1, emotion=2, chunk_frames=32, max_mel_len=64)
    chunks = list(port.synthesize_streaming(SHORT, **kwargs))
    ref = np.concatenate(list(jsynth.synthesize_streaming(SHORT, **kwargs)))
    out = np.concatenate(chunks)
    assert len(chunks) == 2 and out.shape == ref.shape == (64 * 256,)
    assert np.abs(out - ref).max() < 1e-4
    # The concatenation is the generator's output on the trimmed mel.
    (res,) = port.synthesize([SHORT], [1], [2], vocoder="none",
                             max_mel_len=64)
    with torch.inference_mode():
        full = port.vocoder(torch.from_numpy(res.mel)[None])[0].numpy()
    assert np.abs(out - full).max() < 2e-5
