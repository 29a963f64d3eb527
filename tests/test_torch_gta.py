"""The vocoder's paired (GTA) mode in the port against the JAX package's,
on the CPU in float32: ``PairedSegmentSampler``, ``load_paired_corpus``,
one paired GAN step and the paired val step, ``export_gta_mels`` and
``train_vocoder(pairs=...)``.

The GAN step runs at tests/test_torch_vocoder_train.py's small
configuration and bounds (losses 1e-5 relative, gradients 1e-3·max|g|
read from JAX's first moments, parameters 1e-6 where the gradient is not
round-off), from a numpy state moved on by one JAX step. The export runs a
small FastSpeech2 (1 + 1 blocks, hidden 32) from a port checkpoint made by
``interop.train_state_from_jax`` on tests/port_corpus.py's corpus,
against the JAX model's teacher-forced forward on the same parameters
(``export_gta_mels``' ``model.apply``, JAX ``train/vocoder.py:633-641``)
within tests/test_torch_fastspeech2.py's mel bound, 1e-4.

The corpus' gap utterance keeps an interior ``sp``, which the pinyin table
lacks: both packages' datasets skip its ID and cut the last duration to
match, so its teacher-forced mel is shorter than its ground truth
(56 rows, not 64) in both. Every other export has the ground truth's rows.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.data import (
    BucketedDataset as JaxBucketedDataset,
    PreprocessedCorpus as JaxCorpus,
)
from expressive_fastspeech2_mandarin_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
)
from expressive_fastspeech2_mandarin_tpu.train import vocoder as jvoc
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.dsp import MelSTFT
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    train_state_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import Generator
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import Preprocessor
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    CheckpointManager,
    vocoder as tvoc,
)

from .port_corpus import preprocess_config, write_pipeline_corpus
from .test_torch_vocoder_train import (
    GRAD_REL,
    LOSS_REL,
    PARAM_ATOL,
    _cfg,
    _checkpoint,
    _jax_grads,
    _jax_state,
    _np,
    _port_params,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
MEL_ATOL = 1e-4


def _pairs(seed: int, frames=(40, 9, 25)):
    """(mel, wav) pairs at the small configuration (16 kHz, hop 64): two
    harmonics and noise, and the port's log-mel of each wav (rows k·hop),
    as ``load_paired_corpus`` pairs them; one shorter than a 16-frame
    segment. On random N(-4, 2) mels instead, a few ``conv_pre`` elements
    end 1.1-1.5e-6 from JAX's after the step, where JAX's own float32
    step is 6e-7 from a float64 one: tests/paired_step_witness.py."""
    pre = _cfg(tcfg).preprocess
    stft = MelSTFT(pre.stft, pre.mel, pre.audio.sampling_rate)
    rng = np.random.default_rng(seed)
    out = []
    for i, f in enumerate(frames):
        n = (f - 1) * 64 - 5 * i
        t = np.arange(n) / 16000
        f0 = 150 + 60 * i
        wav = (0.4 * np.sin(2 * np.pi * f0 * t)
               + 0.2 * np.sin(4 * np.pi * f0 * t)
               + 0.05 * rng.normal(size=n)).astype(np.float32)
        mel, _ = stft.mel_energy(torch.from_numpy(wav)[None])
        out.append((mel[0].numpy(), wav))
    return out


def test_paired_sampler_matches_jax_and_pads_short_utterances():
    pc, jc = _cfg(tcfg), _cfg(jcfg)
    pairs = _pairs(0)
    ours = tvoc.PairedSegmentSampler(pc, pairs, seed=7)
    ref = jvoc.PairedSegmentSampler(jc, pairs, seed=7)
    assert tvoc.LOG_MEL_PAD == jvoc.LOG_MEL_PAD == float(np.log(1e-5))
    for _ in range(4):
        batch, want = ours.sample(5), ref.sample(5)
        assert batch.keys() == want.keys() == {"mel", "wav"}
        assert batch["mel"].shape == (5, 16, 80)
        assert batch["wav"].shape == (5, 1024)
        for k in batch:
            assert batch[k].dtype == np.float32
            np.testing.assert_array_equal(batch[k], want[k])
    mel, wav = ours.pairs[1]  # 8 frames, 7·64 - 5 samples: padded
    assert pairs[1][0].shape == (8, 80)
    assert mel.shape == (16, 80) and len(wav) == 1024
    np.testing.assert_array_equal(mel[8:], np.float32(tvoc.LOG_MEL_PAD))
    np.testing.assert_array_equal(wav[len(pairs[1][1]):], 0.0)


@pytest.fixture(scope="module")
def gan_steps():
    """One paired JAX step from a numpy state (non-zero moments), then one
    paired step of each package from that state on the same batch."""
    jc, pc = _cfg(jcfg), _cfg(tcfg)
    sampler = jvoc.PairedSegmentSampler(jc, _pairs(1), seed=3)
    batch_a, batch_b = sampler.sample(2), sampler.sample(2)
    step = jvoc.make_vocoder_train_step(jc, donate=False, paired=True)
    js1, _ = step(_jax_state(jc, 0), jax.tree.map(jnp.asarray, batch_a))
    js2, report = step(js1, jax.tree.map(jnp.asarray, batch_b))
    ps = tvoc.init_vocoder_train_state(pc, CPU)
    tvoc.load_vocoder_checkpoint(ps, _checkpoint(js1))
    torch_batch = {k: torch.from_numpy(v) for k, v in batch_b.items()}
    port_report = tvoc.make_vocoder_train_step(pc, CPU)(ps, torch_batch)
    return dict(jc=jc, pc=pc, js1=js1, js2=js2, report=report, ps=ps,
                port_report=port_report, batch=batch_b)


def test_paired_gan_step_losses_match_jax(gan_steps):
    ref = gan_steps["report"]
    out = gan_steps["port_report"].as_dict()
    assert gan_steps["ps"].step == int(gan_steps["js2"].step) == 2
    for name in ref._fields:
        r = float(getattr(ref, name))
        assert np.isfinite(out[name])
        assert abs(out[name] - r) <= LOSS_REL * abs(r), (name, out[name], r)


def test_paired_gan_step_gradients_and_parameters_match_jax(gan_steps):
    b1 = gan_steps["jc"].vocoder_train.adam_betas[0]
    ref = _jax_grads(gan_steps["js1"], gan_steps["js2"], b1)
    js2 = _np(gan_steps["js2"])
    ref_params = _checkpoint(js2)
    port = _port_params(gan_steps["ps"])
    for part in ("gen", "mpd", "msd"):
        assert port[part].keys() == ref[part].keys()
        for name, p in port[part].items():
            r = ref[part][name].numpy()
            g = p.grad.numpy()
            assert np.abs(g - r).max() <= GRAD_REL * np.abs(r).max(), (
                part, name)
            big = np.abs(g) > 1e-3 * np.abs(g).max()
            diff = np.abs(p.detach().numpy()
                          - ref_params[part][name].numpy())[big]
            assert diff.size == 0 or diff.max() <= PARAM_ATOL, (part, name)


def test_paired_val_step_matches_jax(gan_steps):
    jc, pc = gan_steps["jc"], gan_steps["pc"]
    batch = gan_steps["batch"]
    ref = float(jvoc.make_vocoder_val_step(jc, paired=True)(
        gan_steps["js1"].gen, jax.tree.map(jnp.asarray, batch)))
    gen = Generator(pc.model.vocoder, weight_norm=True)
    gen.load_state_dict(_checkpoint(gan_steps["js1"])["gen"], strict=True)
    out = tvoc.make_vocoder_val_step(pc, CPU)(
        gen, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(out - ref) <= LOSS_REL * abs(ref)


def test_train_vocoder_on_pairs_resumes(tmp_path):
    cfg = _cfg(tcfg, log_step=1, save_step=2, val_step=2, lr_decay_steps=2)
    out = str(tmp_path / "voc")
    state = tvoc.train_vocoder(cfg, None, out, total_steps=2,
                               pairs=_pairs(2), device="cpu",
                               log=lambda *_: None)
    assert state.step == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 2]
    assert all(np.isfinite(r["mel_l1"]) for r in records[:2])
    assert np.isfinite(records[2]["val_mel_l1"])
    resumed = tvoc.train_vocoder(cfg, None, out, total_steps=3,
                                 pairs=_pairs(2), device="cpu",
                                 log=lambda *_: None)
    assert resumed.step == 3
    assert int(resumed.opt_g.count) == int(resumed.opt_d.count) == 3
    assert os.path.exists(os.path.join(out, "generator.npz"))


# ---------------------------------------------------------------------------
# A preprocessed corpus, a FastSpeech2 checkpoint, and the GTA export.


def _fs2_config(mod, pre_cfg):
    return mod.Config(
        preprocess=pre_cfg,
        model=mod.ModelConfig(
            transformer=mod.TransformerConfig(
                encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                decoder_hidden=32, conv_filter_size=64, encoder_head=2,
                decoder_head=2),
            variance_predictor=mod.VariancePredictorConfig(filter_size=32),
            n_speakers=2, n_emotions=2, n_arousals=2, n_valences=2,
            max_seq_len=256))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/port_corpus.py's corpus preprocessed by the port on the CPU,
    the JAX model's parameters, and a port checkpoint made from them."""
    root = tmp_path_factory.mktemp("gta")
    raw, tg_root = write_pipeline_corpus(root)
    pre = root / "pre"
    shutil.copytree(tg_root, pre / "TextGrid")
    Preprocessor(preprocess_config(tcfg, raw, pre), num_workers=1,
                 device="cpu").build_from_path()
    jc = _fs2_config(jcfg, preprocess_config(jcfg, raw, pre))
    tc = _fs2_config(tcfg, preprocess_config(tcfg, raw, pre))
    model = JaxFastSpeech2(jc.model, jc.preprocess, JaxCorpus(str(pre)).stats)
    params, bn = model.init(jax.random.PRNGKey(0))
    opt_state = optax.adam(1e-3).init(params)
    consts = {k: np.asarray(v) for k, v in model.consts.items()}
    ckpt = train_state_from_jax(_np(params), _np(bn), _np(opt_state), 7,
                                consts=consts)
    CheckpointManager(str(root / "ckpt")).save_dict(7, ckpt)
    return dict(root=root, pre=str(pre), jc=jc, tc=tc, model=model,
                params=params, bn=bn)


def _jax_gta(corpus) -> dict[str, np.ndarray]:
    """JAX's teacher-forced postnet mels of every utterance."""
    jc, model = corpus["jc"], corpus["model"]

    @jax.jit
    def forward(batch):
        out, _ = model.apply(
            corpus["params"], corpus["bn"], batch["speakers"],
            batch["emotions"], batch["arousals"], batch["valences"],
            batch["texts"], batch["src_lens"],
            max_mel_len=batch["mels"].shape[1], mel_lens=batch["mel_lens"],
            p_targets=batch["pitches"], e_targets=batch["energies"],
            d_targets=batch["durations"], deterministic=True)
        return out.postnet_mel

    out = {}
    for filename in ("train.txt", "val.txt"):
        ds = JaxBucketedDataset(JaxCorpus(corpus["pre"]), filename, 8,
                                jcfg.BucketConfig(),
                                max_seq_len=jc.model.max_seq_len)
        for batch, examples in ds.epoch_with_examples(shuffle=False):
            mels = np.asarray(forward(batch))
            for i, e in enumerate(examples):
                out[f"{e.utt.speaker}-mel-{e.utt.basename}.npy"] = (
                    mels[i, :int(batch["mel_lens"][i])])
    return out


GAP_MEL = "0001-mel-0001_000006.npy"  # the utterance with an interior sp


def test_export_gta_mels_matches_jax(corpus):
    out_dir = str(corpus["root"] / "gta")
    n = tvoc.export_gta_mels(corpus["tc"], str(corpus["root"] / "ckpt"),
                             out_dir, device="cpu", log=lambda *_: None)
    ref = _jax_gta(corpus)
    assert n == len(ref) == 13
    assert sorted(os.listdir(out_dir)) == sorted(ref)
    for name, r in ref.items():
        ours = np.load(os.path.join(out_dir, name))
        gt = np.load(os.path.join(corpus["pre"], "mel", name))
        assert ours.shape == r.shape, name
        assert (ours.shape[0] < gt.shape[0] if name == GAP_MEL
                else ours.shape == gt.shape), name
        np.testing.assert_allclose(ours, r, rtol=0, atol=MEL_ATOL)


def test_load_paired_corpus_matches_jax(corpus):
    """Ground-truth mels and a mel directory (the GTA export); each wav
    trimmed so that mel row k sits at sample k·hop."""
    gta = str(corpus["root"] / "gta_pairs")
    tvoc.export_gta_mels(corpus["tc"], str(corpus["root"] / "ckpt"), gta,
                         device="cpu", log=lambda *_: None)
    for kwargs in ({}, {"mel_dir": gta, "filenames": ("train.txt",
                                                      "val.txt")}):
        ours = tvoc.load_paired_corpus(corpus["tc"], **kwargs)
        ref = jvoc.load_paired_corpus(corpus["jc"], **kwargs)
        assert len(ours) == len(ref) == (11 if not kwargs else 13)
        for (m, w), (rm, rw) in zip(ours, ref):
            assert w.dtype == rw.dtype == np.float32
            np.testing.assert_array_equal(m, rm)
            np.testing.assert_array_equal(w, rw)
            if not kwargs:  # ground truth: frames of the trimmed wav
                assert abs(len(w) // 256 + 1 - m.shape[0]) <= 2
    with pytest.raises(FileNotFoundError):
        tvoc.load_paired_corpus(corpus["tc"], mel_dir=str(corpus["root"]))


def test_gta_export_needs_the_card_unless_asked_for_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvoc.export_gta_mels(corpus["tc"], str(corpus["root"] / "ckpt"),
                             str(tmp_path / "gta"))
