"""The port's training entry point, ``train(cfg, total_steps=...)``, on the
CPU over a synthetic preprocessed corpus (tests/corpus_util.py): losses,
checkpoints and resume, the sample-synthesis cadence and its audio, the NaN
abort, the TPU-only settings (``steps_per_call`` > 1 is not one since it
runs chunks: tests/test_torch_train_chunks.py), the bucketed batches
against the JAX package's, ``Synthesizer.from_checkpoint`` on ``train()``'s
checkpoints; ``SampleVocoder`` (Griffin-Lim, and HiFi-GAN from a
``generator.npz``) against the JAX package's, in float32: Griffin-Lim from
JAX's phase within 1e-5 · peak (20 iterations, tests/test_torch_dsp.py),
HiFi-GAN within 5e-4 (tests/test_torch_hifigan.py)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from expressive_fastspeech2_mandarin_tpu.config import BucketConfig
from expressive_fastspeech2_mandarin_tpu.data import (
    BucketedDataset as JaxBucketedDataset,
    PreprocessedCorpus as JaxCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.data import (
    BucketedDataset,
    PreprocessedCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    CheckpointManager,
    noam_schedule,
    train,
)

from .corpus_util import make_synthetic_corpus

torch.set_num_threads(2)


def _cfg(corpus: str, out: str, **train_kw) -> tcfg.Config:
    """tests/corpus_util.py:tiny_train_config in the port's dataclasses."""
    model = tcfg.ModelConfig(
        transformer=tcfg.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=32,
            decoder_hidden=32, conv_filter_size=64, encoder_head=2,
            decoder_head=2),
        variance_predictor=tcfg.VariancePredictorConfig(filter_size=32),
        n_speakers=4, n_emotions=3, n_arousals=3, n_valences=3,
        max_seq_len=128)
    train_cfg = tcfg.TrainConfig(
        path=tcfg.PathConfig(ckpt_path=os.path.join(out, "ckpt"),
                             log_path=os.path.join(out, "log"),
                             result_path=os.path.join(out, "result")),
        optimizer=tcfg.OptimizerConfig(batch_size=4, warm_up_step=10),
        step=tcfg.StepConfig(total_step=8, log_step=2, synth_step=4,
                             val_step=4, save_step=8),
        buckets=tcfg.BucketConfig(src_buckets=(16, 24),
                                  mel_buckets=(64, 96, 128)))
    return tcfg.Config(
        preprocess=tcfg.PreprocessConfig(
            path=tcfg.PathConfig(preprocessed_path=corpus)),
        model=model, train=dataclasses.replace(train_cfg, **train_kw))


def _metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_checkpoints_resumes_and_writes_samples(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=24)
    cfg = _cfg(corpus, str(tmp_path / "out"))
    state = train(cfg, total_steps=6, device="cpu")
    assert state.step == 6 and state.optimizer.count == 6
    train_log = _metrics(str(tmp_path / "out/log/train/metrics.jsonl"))
    assert [r["step"] for r in train_log] == [2, 4, 6]
    assert all(np.isfinite(r["total_loss"]) for r in train_log)
    val_log = _metrics(str(tmp_path / "out/log/val/metrics.jsonl"))
    assert [r["step"] for r in val_log] == [4]
    ckpt = CheckpointManager(str(tmp_path / "out/ckpt"))
    assert ckpt.steps() == [6]

    samples = tmp_path / "out/result/train_samples"
    mel = np.load(samples / "step4_mel.npy")
    lens = np.load(samples / "step4_mel_lens.npy")
    assert mel.shape[0] == lens.shape[0] == 4 and mel.shape[2] == 80
    assert np.isfinite(mel).all() and (lens <= mel.shape[1]).all()
    # The first utterance's audio through the sample vocoder (Griffin-Lim
    # here: no HiFi-GAN weights are configured).
    sr, wav = wavfile.read(samples / "step4_predicted.wav")
    assert sr == 22050 and wav.shape == (int(lens[0]) * 256,)
    _, gt = wavfile.read(samples / "step4_reconstructed.wav")
    assert gt.size > 0 and np.abs(gt).max() > 0

    # Resume: the step, the update count and so the learning rate go on.
    resumed = train(cfg, total_steps=8, device="cpu")
    assert resumed.step == 8 and resumed.optimizer.count == 8
    sched = noam_schedule(32, 10, cfg.train.optimizer.anneal_steps, 0.3)
    assert resumed.optimizer.lr == sched(8)
    assert ckpt.steps() == [6, 8]
    train_log = _metrics(str(tmp_path / "out/log/train/metrics.jsonl"))
    assert [r["step"] for r in train_log] == [2, 4, 6, 8]
    assert (samples / "step8_mel.npy").exists()


def test_nan_loss_writes_emergency_checkpoint_and_raises(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=16)
    for name in os.listdir(os.path.join(corpus, "mel")):
        path = os.path.join(corpus, "mel", name)
        np.save(path, np.full_like(np.load(path), np.nan))
    cfg = _cfg(corpus, str(tmp_path / "out"), transfer_dtype="float32",
               step=tcfg.StepConfig(total_step=8, log_step=1, synth_step=100,
                                    val_step=100, save_step=100))
    with pytest.raises(FloatingPointError, match="emergency checkpoint"):
        train(cfg, device="cpu")
    assert CheckpointManager(str(tmp_path / "out/ckpt")).steps() == [1]


@pytest.mark.parametrize("field,value", [
    ("matmul_precision", "highest"),
    ("profile_start_step", 10),
    ("mesh", tcfg.MeshConfig(model_parallel_size=2))])
def test_tpu_only_train_settings_raise(field, value, tmp_path):
    """The settings once refused as TPU-only (hence the name) are taken:
    matmul precision and the profiler window (run by the tests below), and
    the model-parallel mesh, whose size must divide the world size, so
    that a one-process ``train()`` raises, naming the key
    (tests/test_torch_parallel.py runs it on two processes)."""
    cfg = tcfg.TrainConfig(**{field: value})
    assert getattr(cfg, field) == value
    if field == "mesh":
        corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=12)
        run = _cfg(corpus, str(tmp_path / "out"), mesh=value)
        with pytest.raises(ValueError, match="mesh.model_parallel_size=2"):
            train(run, device="cpu")


def test_train_entry_point_needs_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_cfg(corpus, str(tmp_path / "out")), total_steps=1)


def test_bucketed_batches_match_jax(tmp_path):
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=30)
    buckets = (16, 24), (64, 96, 128)
    ours = BucketedDataset(PreprocessedCorpus(corpus), "train.txt", 4,
                           tcfg.BucketConfig(*buckets), 128, drop_last=True,
                           seed=3)
    ref = JaxBucketedDataset(JaxCorpus(corpus), "train.txt", 4,
                             BucketConfig(*buckets), 128, drop_last=True,
                             seed=3)
    for epoch in (0, 1):
        pairs = list(zip(ours.epoch(epoch), ref.epoch(epoch), strict=True))
        assert len(pairs) == len(ours) // 4
        for a, b in pairs:
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_lengths_cache_is_whole_to_a_reader_while_it_is_written(
        tmp_path, monkeypatch):
    """Two ranks of one host share the corpus: one calls ``lengths`` while
    the other is still writing ``.lengths-<filename>.json``. The reader
    gets the whole dict (it saw no file, or a whole one), never a
    ``JSONDecodeError``, and the cache left behind is whole."""
    from expressive_fastspeech2_mandarin_tpu_torch.data import metadata

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=12)
    writer, reader = PreprocessedCorpus(corpus), PreprocessedCorpus(corpus)
    dump = json.dump
    seen = []

    def dump_with_a_reader_inside(obj, f, **kw):
        text = json.dumps(obj, **kw)
        f.write(text[:len(text) // 2])
        f.flush()
        if not seen:
            seen.append(None)
            seen[0] = reader.lengths("val.txt")
        f.write(text[len(text) // 2:])

    monkeypatch.setattr(metadata.json, "dump", dump_with_a_reader_inside)
    written = writer.lengths("val.txt")
    monkeypatch.setattr(metadata.json, "dump", dump)
    expected = {u.basename: (len(writer.duration(u)),
                             int(writer.duration(u).sum()))
                for u in writer.metadata("val.txt")}
    assert written == expected
    assert seen == [expected]
    assert PreprocessedCorpus(corpus).lengths("val.txt") == expected
    assert not [n for n in os.listdir(corpus) if n.endswith(".tmp")]


def _sample_cfgs(ckpt_path: str = ""):
    from expressive_fastspeech2_mandarin_tpu.config import (
        Config as JaxConfig,
        ModelConfig as JaxModelConfig,
        VocoderConfig as JaxVocoderConfig,
    )

    def cfg(mod_cfg, mod_model, mod_voc):
        return mod_cfg(model=mod_model(vocoder=mod_voc(
            upsample_initial_channel=32, compute_dtype="float32",
            ckpt_path=ckpt_path)))

    return (cfg(tcfg.Config, tcfg.ModelConfig, tcfg.VocoderConfig),
            cfg(JaxConfig, JaxModelConfig, JaxVocoderConfig))


def test_sample_vocoder_griffin_lim_matches_jax(monkeypatch):
    import jax

    from expressive_fastspeech2_mandarin_tpu.train.sampling import (
        SampleVocoder as JaxSampleVocoder,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        SampleVocoder,
    )

    port_cfg, jax_cfg = _sample_cfgs()
    mel = np.random.default_rng(0).normal(-5, 1.5, (60, 80)).astype(
        np.float32)
    ref = JaxSampleVocoder(jax_cfg).vocode(mel, 50)
    sampler = SampleVocoder(port_cfg, torch.device("cpu"))
    assert sampler.kind == "griffin_lim"
    phase = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (1, 50, 513), minval=-np.pi, maxval=np.pi))
    griffin_lim = sampler.stft.griffin_lim
    monkeypatch.setattr(sampler.stft, "griffin_lim",
                        lambda mag, n_iters, *_: griffin_lim(
                            mag, n_iters, phase=torch.from_numpy(phase)))
    out = sampler.vocode(mel, 50)
    assert out.shape == ref.shape == (50 * 256,)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_sample_vocoder_hifigan_from_generator_npz_matches_jax(tmp_path):
    import jax

    from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
        init_generator,
        save_generator_npz,
    )
    from expressive_fastspeech2_mandarin_tpu.train.sampling import (
        SampleVocoder as JaxSampleVocoder,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        SampleVocoder,
    )

    path = str(tmp_path / "generator.npz")
    port_cfg, jax_cfg = _sample_cfgs(path)
    rng = np.random.default_rng(2)
    save_generator_npz(path, jax.tree.map(
        lambda a: rng.uniform(-0.15, 0.15, a.shape).astype(np.float32),
        jax.eval_shape(lambda: init_generator(jax.random.PRNGKey(2),
                                              jax_cfg.model.vocoder))))
    mel = np.random.default_rng(1).normal(-5, 1.5, (40, 80)).astype(
        np.float32)
    ref = JaxSampleVocoder(jax_cfg).vocode(mel, 37)
    sampler = SampleVocoder(port_cfg, torch.device("cpu"))
    assert sampler.kind == "hifigan"
    out = sampler.vocode(mel, 37)
    assert out.shape == ref.shape == (37 * 256,)
    assert np.abs(out - ref).max() < 5e-4


def test_synthesizer_from_checkpoint_equals_the_state_dict(tmp_path):
    """``Synthesizer.from_checkpoint`` on ``train()``'s checkpoints (the
    latest, and one by ``step``) synthesizes exactly what a Synthesizer
    built from the same state dict does, HiFi-GAN from a ``generator.npz``
    either way."""
    from expressive_fastspeech2_mandarin_tpu_torch.interop import (
        load_vocoder_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.models import Generator
    from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import (
        save_generator_npz,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=16)
    cfg = _cfg(corpus, str(tmp_path / "out"),
               step=tcfg.StepConfig(total_step=4, log_step=100,
                                    synth_step=100, val_step=100,
                                    save_step=2))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocoder=tcfg.VocoderConfig(upsample_initial_channel=32,
                                              compute_dtype="float32")))
    state = train(cfg, device="cpu")
    torch.manual_seed(3)
    npz = str(tmp_path / "generator.npz")
    save_generator_npz(npz, Generator(cfg.model.vocoder).state_dict())
    ckpt_dir = cfg.train.path.ckpt_path
    corp = PreprocessedCorpus(corpus)
    texts = ["{b a n zh ong}", "{i a n}"]

    def run(synth):
        return synth.synthesize(texts, ["0001", "0002"], ["Happy", "Sad"],
                                max_mel_len=64)

    loaded = run(Synthesizer.from_checkpoint(cfg, ckpt_dir, npz,
                                             device="cpu"))
    ref = run(Synthesizer(cfg, state.model.state_dict(),
                          load_vocoder_state(npz), corp.stats,
                          corp.speaker_map, corp.emotion_maps, device="cpu"))
    for a, b in zip(loaded, ref, strict=True):
        assert a.mel.shape[0] > 0
        np.testing.assert_array_equal(a.durations, b.durations)
        np.testing.assert_array_equal(a.mel, b.mel)
        np.testing.assert_array_equal(a.wav, b.wav)
    at_two = Synthesizer.from_checkpoint(cfg, ckpt_dir, npz, step=2,
                                         device="cpu")
    sd = at_two.model.state_dict()
    saved = CheckpointManager(ckpt_dir).load(2)["model"]
    assert all(torch.equal(sd[k], saved[k]) for k in saved)
    assert not all(torch.equal(sd[k], v) for k, v in
                   state.model.state_dict().items())


def test_profiler_window_writes_a_trace_and_synth_step_writes_figures(
        tmp_path):
    """profile_start_step 3, profile_stop_step 5: the group reaching step 3
    opens the window, the one reaching step 5 closes it and writes a Chrome
    trace under <log_path>/profile; synth_step 4 writes step4.png and the
    predicted-against-ground-truth figure beside the .npy/.wav samples."""
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=16)
    cfg = _cfg(corpus, str(tmp_path / "out"), profile_start_step=3,
               profile_stop_step=5)
    train(cfg, total_steps=6, device="cpu")
    profile = tmp_path / "out/log/profile"
    assert sorted(p.name for p in profile.iterdir()) == [
        "trace_steps3-5.json"]
    trace = json.loads((profile / "trace_steps3-5.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv1d" in n or "addmm" in n or "mm" in n for n in names)
    samples = tmp_path / "out/result/train_samples"
    png = (samples / "step4.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    fig = tmp_path / "out/log/train/figures/train_spectrogram_step4.png"
    assert fig.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (samples / "step4_mel.npy").exists()


def test_profiler_window_crossed_by_a_chunk(tmp_path):
    """With steps_per_call 2 the groups end at steps 2, 4, 6: a start at
    step 3 opens at the group from 2 to 4 and a stop at 5 closes at the
    group ending at 6, as the JAX loop's crossing checks do."""
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=16)
    cfg = _cfg(corpus, str(tmp_path / "out"), profile_start_step=3,
               profile_stop_step=5, steps_per_call=2,
               step=tcfg.StepConfig(total_step=6, log_step=2, synth_step=100,
                                    val_step=100, save_step=100))
    train(cfg, device="cpu")
    assert os.listdir(tmp_path / "out/log/profile") == ["trace_steps2-6.json"]


@pytest.mark.parametrize("name,tf32", sorted(tcfg.MATMUL_PRECISIONS.items()))
def test_matmul_precision_maps_jax_names_to_tf32_and_restores(name, tf32):
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        matmul_precision,
    )

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for before in (True, False):
            for f in flags:
                f.allow_tf32 = before
            with matmul_precision(name):
                assert [f.allow_tf32 for f in flags] == [tf32, tf32]
            assert [f.allow_tf32 for f in flags] == [before, before]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_train_sets_tf32_while_it_runs_and_restores_it(tmp_path,
                                                       monkeypatch):
    """matmul_precision "high" turns TF32 on for train()'s steps; when
    train() returns the switches are as they were. The steps are read
    through the step ``loop.make_train_step`` makes, which train() calls."""
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop

    seen = []
    real_make = loop.make_train_step

    def make(state, cfg):
        real_step = real_make(state, cfg)

        def step(batch):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real_step(batch)

        return step

    monkeypatch.setattr(loop, "make_train_step", make)
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=12)
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = False
        train(_cfg(corpus, str(tmp_path / "out"), matmul_precision="high"),
              total_steps=2, device="cpu")
        assert seen == [(True, True)] * 2
        assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
