"""The port's training entry point, ``train(cfg, total_steps=...)``, on the
CPU over a synthetic preprocessed corpus (tests/corpus_util.py): losses,
checkpoints and resume, the sample-synthesis cadence, the NaN abort, the
TPU-only settings, and the bucketed batches against the JAX package's."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

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
    ("steps_per_call", 4), ("matmul_precision", "highest"),
    ("profile_start_step", 10),
    ("mesh", tcfg.MeshConfig(model_parallel_size=2))])
def test_tpu_only_train_settings_raise(field, value):
    with pytest.raises(ValueError, match="TPU setting"):
        tcfg.TrainConfig(**{field: value})


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
