"""``Synthesizer.from_torch_checkpoint`` on the CPU: the reference's
checkpoint formats, written by the JAX package's own exporters, give the
same synthesis as weights carried across with ``fastspeech2_from_jax`` /
``hifigan_from_jax``.

* FastSpeech2: ``export_fastspeech2`` + ``save_torch_checkpoint`` (key
  "model"), plus the reference's ``encoder/decoder.position_enc`` tables,
  which the port drops (it rebuilds them as non-persistent buffers).
* HiFi-GAN: a reference ``{"generator": state_dict}`` with weight norm
  (``weight_g``, ``weight_v``), built here, and a native ``generator.npz``
  from ``save_generator_npz``.

Mel equal (same float32 weights); waveform equal for the npz and within
1e-5 for weight norm (folding rounds g · v / ‖v‖ in float32).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu.interop.torch_ckpt import (
    convert_fastspeech2,
    convert_hifigan,
    export_fastspeech2,
    save_torch_checkpoint,
)
from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
    save_generator_npz,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    fold_weight_norm,
    hifigan_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import (
    FastSpeech2,
    Generator,
)
from expressive_fastspeech2_mandarin_tpu_torch.models.variance import (
    make_variance_bins,
)
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

torch.set_num_threads(2)
TEXT = "{b a n h ao sh i j ie}"
STATS = {"pitch": [-1.5, 6.0, 0.0, 1.0], "energy": [-1.0, 7.0, 0.0, 1.0]}
MAPS = {"emotion_dict": {"Angry": 0, "Happy": 1, "Neutral": 2},
        "arousal_dict": {"0.5": 3, "0.9": 1},
        "valence_dict": {"0.5": 4, "0.1": 0}}


def _config():
    model = tcfg.ModelConfig(
        transformer=tcfg.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=64,
            decoder_hidden=64, conv_filter_size=128),
        variance_predictor=tcfg.VariancePredictorConfig(filter_size=64),
        vocoder=dataclasses.replace(tcfg.VocoderConfig(),
                                    upsample_initial_channel=64,
                                    compute_dtype="float32"))
    return tcfg.Config(model=model)


@pytest.fixture(scope="module")
def trees():
    """JAX parameter trees, made from torch's seeded initialisation."""
    cfg = _config()
    torch.manual_seed(0)
    fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    voc = Generator(cfg.model.vocoder).state_dict()
    params, bn_state, consts = convert_fastspeech2(
        {k: v.numpy() for k, v in fs2.items()})
    return params, bn_state, consts, convert_hifigan(
        {k: v.numpy() for k, v in voc.items()})


def _weight_normed(sd):
    """A folded generator state dict → the reference's weight-norm form:
    v = w · c (c > 0 per output row), g = ‖w‖ over every dim but 0."""
    rng = np.random.default_rng(0)
    out = {}
    for k, w in sd.items():
        if not k.endswith(".weight"):
            out[k] = w
            continue
        shape = (-1,) + (1,) * (w.ndim - 1)
        c = torch.from_numpy(rng.uniform(0.5, 2.0, w.shape[0]).astype(
            np.float32)).reshape(shape)
        out[k[:-len("weight")] + "weight_v"] = w * c
        out[k[:-len("weight")] + "weight_g"] = (
            w.reshape(w.shape[0], -1).norm(dim=1).reshape(shape))
    return out


def _synth(s):
    (res,) = s.synthesize([TEXT], [1], ["Happy"], vocoder="hifigan",
                          max_mel_len=250)
    return res


def test_from_torch_checkpoint_matches_carried_weights(trees, tmp_path):
    params, bn_state, consts, voc = trees
    cfg = _config()
    sd = export_fastspeech2(params, bn_state, consts)
    d = cfg.model.transformer.encoder_hidden
    for name in ("encoder", "decoder"):  # present in reference checkpoints
        sd[f"{name}.position_enc"] = np.zeros((1, 2001, d), np.float32)
    model_ckpt = str(tmp_path / "900000.pth.tar")
    save_torch_checkpoint(model_ckpt, sd)
    gen_sd = hifigan_from_jax(voc)
    wn_ckpt = str(tmp_path / "generator_universal.pth.tar")
    torch.save({"generator": _weight_normed(gen_sd)}, wn_ckpt)
    npz = str(tmp_path / "generator.npz")
    save_generator_npz(npz, voc)

    ref = _synth(Synthesizer(cfg, fastspeech2_from_jax(params, bn_state,
                                                       consts),
                             gen_sd, device="cpu"))
    from_npz = _synth(Synthesizer.from_torch_checkpoint(
        cfg, model_ckpt, npz, device="cpu"))
    from_wn = _synth(Synthesizer.from_torch_checkpoint(
        cfg, model_ckpt, wn_ckpt, device="cpu"))
    assert ref.mel.shape[0] > 0
    for res in (from_npz, from_wn):
        np.testing.assert_array_equal(res.durations, ref.durations)
        np.testing.assert_array_equal(res.mel, ref.mel)
    np.testing.assert_array_equal(from_npz.wav, ref.wav)
    assert np.abs(from_wn.wav - ref.wav).max() < 1e-5


def test_fold_weight_norm_restores_the_weights(trees):
    gen_sd = hifigan_from_jax(trees[3])
    folded = fold_weight_norm(_weight_normed(gen_sd))
    assert set(folded) == set(gen_sd)
    for k, w in gen_sd.items():
        torch.testing.assert_close(folded[k], w, rtol=1e-6, atol=1e-6)


def test_preprocessed_maps_and_stats_bins(trees, tmp_path):
    """The corpus's maps are used, and a checkpoint without bin boundaries
    gets them from the corpus's stats.json."""
    params, bn_state, _, _ = trees
    cfg = _config()
    model_ckpt = str(tmp_path / "no_bins.pth.tar")
    save_torch_checkpoint(model_ckpt, export_fastspeech2(params, bn_state))
    corpus = tmp_path / "preprocessed"
    corpus.mkdir()
    for name, obj in (("speakers.json", {"spk3": 3}),
                      ("emotions.json", MAPS), ("stats.json", STATS)):
        (corpus / name).write_text(json.dumps(obj))
    s = Synthesizer.from_torch_checkpoint(cfg, model_ckpt,
                                          preprocessed_path=str(corpus),
                                          device="cpu")
    assert s.vocoder is None
    assert s.resolve_ids("spk3", "Angry") == (3, 0, 1, 0)
    ve = cfg.model.variance_embedding
    torch.testing.assert_close(
        s.model.variance_adaptor.pitch_bins,
        make_variance_bins(*STATS["pitch"][:2], ve.n_bins,
                           ve.pitch_quantization), rtol=0, atol=0)
    (res,) = s.synthesize([TEXT], ["spk3"], ["Neutral"], vocoder="none",
                          max_mel_len=250)
    assert res.mel.shape[0] > 0 and np.isfinite(res.mel).all()
