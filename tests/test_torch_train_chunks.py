"""``train()`` with ``steps_per_call`` > 1 against the JAX package's, on the
CPU at the toy width of tests/corpus_util.py: consecutive same-bucket
batches run as chunks, the cadences are checked at chunk ends, a chunk
logs its steps' mean, and the last chunk is cut at ``total_steps``.

Both packages start from one initial state (the JAX init, moved into a
port checkpoint at step 0) and keep every unit in dropout (both packages'
keep-masks all true; the postnet still scales by 2), so the two runs
differ only by float32 rounding, at the reference's 4000-step warm-up
(``_warm``). Bounds, tests/test_torch_train.py's:
logged losses 1e-5 relative; after the run, the parameters' total
movement 1e-4 relative and the postnet's BatchNorm statistics 2e-2 of
their largest value.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.data import (
    PreprocessedCorpus as JaxCorpus,
)
from expressive_fastspeech2_mandarin_tpu.models import FastSpeech2 as JaxFS2
from expressive_fastspeech2_mandarin_tpu.train import (
    create_train_state as jax_create_train_state,
    make_optimizer,
)
from expressive_fastspeech2_mandarin_tpu.train.loop import train as jax_train
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    train_state_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import dropout as dropout_mod
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    CheckpointManager,
    train,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import chunks

from .corpus_util import make_synthetic_corpus, tiny_train_config

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
SPC = 3
TOTAL = 8
# Every cadence falls inside a chunk of three: log 2 → logged at 3, 6 and
# the trimmed end; val 5 → at 6; save 4 → at 6, and at the end.
CADENCE = dict(log_step=2, val_step=5, save_step=4, synth_step=1000)


def _warm(c):
    """The reference recipe's 4000-step warm-up: Adam moves a parameter
    whose gradient is float32 noise around 0 by lr · sign(noise), which
    the toy warm-up of 10 makes large enough to part the runs by 1e-2 in
    the loss after a few steps (measured); at 4000 it stays in the noise."""
    return dataclasses.replace(c, train=dataclasses.replace(
        c.train, optimizer=dataclasses.replace(c.train.optimizer,
                                               warm_up_step=4000)))


def _port_config(jc) -> tcfg.Config:
    """The JAX config's values in the port's dataclasses."""
    return tcfg.Config(
        preprocess=tcfg.PreprocessConfig(path=tcfg.PathConfig(
            preprocessed_path=jc.preprocess.path.preprocessed_path)),
        model=tcfg.ModelConfig(
            transformer=tcfg.TransformerConfig(
                **dataclasses.asdict(jc.model.transformer)),
            variance_predictor=tcfg.VariancePredictorConfig(
                **dataclasses.asdict(jc.model.variance_predictor)),
            n_speakers=4, n_emotions=3, n_arousals=3, n_valences=3,
            max_seq_len=jc.model.max_seq_len),
        train=tcfg.TrainConfig(
            path=tcfg.PathConfig(**dataclasses.asdict(jc.train.path)),
            optimizer=tcfg.OptimizerConfig(
                **dataclasses.asdict(jc.train.optimizer)),
            step=tcfg.StepConfig(**dataclasses.asdict(jc.train.step)),
            buckets=tcfg.BucketConfig(
                **dataclasses.asdict(jc.train.buckets)),
            steps_per_call=jc.train.steps_per_call))


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_chunked_train_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(
        dropout_mod, "keep_mask",
        lambda shape, keep_prob, generator, device: torch.ones(
            tuple(shape), dtype=torch.bool, device=device))
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_utts=24)
    jc = tiny_train_config(corpus, str(tmp_path / "jax"), total_step=TOTAL,
                           steps_per_call=SPC)
    jc = _warm(dataclasses.replace(jc, train=dataclasses.replace(
        jc.train, step=dataclasses.replace(jc.train.step, **CADENCE))))
    tc = _port_config(tiny_train_config(corpus, str(tmp_path / "port"),
                                        total_step=TOTAL,
                                        steps_per_call=SPC))
    tc = _warm(dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, step=dataclasses.replace(tc.train.step, **CADENCE))))

    # The initial state JAX's train() draws, as the port's step-0
    # checkpoint, which the port's train() resumes.
    jmodel = JaxFS2(jc.model, jc.preprocess, JaxCorpus(corpus).stats)
    params, bn = jmodel.init(jax.random.PRNGKey(jc.train.seed))
    tx = make_optimizer(jc.train.optimizer, 32)
    jstate0 = jax_create_train_state(params, bn, tx,
                                     jax.random.PRNGKey(jc.train.seed + 1))
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}
    CheckpointManager(tc.train.path.ckpt_path).save_dict(
        0, train_state_from_jax(_np(params), _np(bn),
                                _np(jstate0.opt_state), 0, consts=consts))

    jstate = jax_train(jc)
    state = train(tc, device="cpu")
    assert state.step == int(jstate.step) == TOTAL

    logs = {}
    for name, root in (("jax", tmp_path / "jax"), ("port", tmp_path / "port")):
        logs[name] = {kind: _records(str(root / "log" / kind /
                                         "metrics.jsonl"))
                      for kind in ("train", "val")}
    steps = [r["step"] for r in logs["port"]["train"]]
    assert steps == [r["step"] for r in logs["jax"]["train"]]
    # Cadences cross inside chunks: log_step 2 is read at chunk ends.
    assert steps[:2] == [3, 6] and steps[-1] == TOTAL, steps
    assert ([r["step"] for r in logs["port"]["val"]]
            == [r["step"] for r in logs["jax"]["val"]] == [6])
    for kind in ("train", "val"):
        for ours, ref in zip(logs["port"][kind], logs["jax"][kind],
                             strict=True):
            for key in ("total_loss", "mel_loss", "mel_postnet_loss",
                        "pitch_loss", "energy_loss", "duration_loss"):
                np.testing.assert_allclose(ours[key], ref[key],
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{kind} {key}")
    assert CheckpointManager(tc.train.path.ckpt_path).steps() == [0, 6, 8]

    ref = fastspeech2_from_jax(_np(jstate.params), _np(jstate.bn_state))
    ref0 = fastspeech2_from_jax(_np(params), _np(bn))
    sd = state.model.state_dict()
    names = [n for n, _ in state.model.named_parameters()]

    def movement(p):
        return float(sum(((p[n] - ref0[n]) ** 2).sum() for n in names)
                     ** 0.5)

    assert abs(movement(sd) - movement(ref)) < 1e-4 * movement(ref)
    for i in range(5):
        for stat in ("running_mean", "running_var"):
            key = f"postnet.convolutions.{i}.1.{stat}"
            bound = 2e-2 * ref[key].abs().max()
            assert (sd[key] - ref[key]).abs().max() <= bound, key


def _batch(bucket: int, i: int) -> dict:
    return {"texts": np.zeros((4, 16)), "mels": np.zeros((4, bucket, 80)),
            "i": i}


def test_chunks_group_same_bucket_runs():
    """Runs of one bucket make chunks; a bucket change lets the pending
    batches through one at a time (JAX ``train/loop.py:166-188``)."""
    stream = [_batch(b, i) for i, b in enumerate(
        (64, 64, 64, 64, 96, 96, 96, 96, 64))]
    got = [[b["i"] for b in g] for g in chunks(stream, 3)]
    assert got == [[0, 1, 2], [3], [4, 5, 6], [7], [8]]
    assert [[b["i"] for b in g] for g in chunks(stream, 1)] == [
        [i] for i in range(9)]


def test_steps_per_call_is_taken_and_the_vocoders_still_raises():
    """Both trainers take steps_per_call > 1 (the vocoder's raised until
    it ran chunks, hence the name: tests/test_torch_vocoder_train.py)."""
    assert tcfg.TrainConfig(steps_per_call=10).steps_per_call == 10
    with pytest.raises(ValueError, match="steps_per_call must be"):
        tcfg.TrainConfig(steps_per_call=0)
    assert tcfg.VocoderTrainConfig(steps_per_call=10).steps_per_call == 10
