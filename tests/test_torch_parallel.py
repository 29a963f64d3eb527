"""The port's data-parallel training (``parallel/``) on the CPU over gloo,
against the JAX package's multi-process and mesh training; the ranks are
real OS processes (tests/torch_parallel_worker.py), spawned with a
timeout.

(a) ``BucketedDataset`` shards against JAX's row mode;
(b) one data-parallel step on 2 ranks against JAX's step on a 2-device
    mesh, from one init and one set of dropout masks: losses 2e-4
    relative, gradients at tests/test_parallel.py's bound;
(c) 2 ranks against 1 over the same global batches, at
    tests/test_distributed.py's bounds, by hand and through ``train()``
    with ``steps_per_call=2`` (one checkpoint, one log); the ranks
    bit-equal;
(d) ``mesh.model_parallel_size=2`` on 2 ranks bit-equal to 1 rank, and a
    size that does not divide the world refused;
(e) a resumed run on 2 ranks whose checkpoint only rank 0's directory
    holds against a resumed 1-rank run; a restore that fails on rank 0
    raises on every rank.
The command line on 2 processes is in tests/test_torch_cli.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.config import BucketConfig
from expressive_fastspeech2_mandarin_tpu.data import (
    BucketedDataset as JaxBucketedDataset,
    PreprocessedCorpus as JaxCorpus,
)
from expressive_fastspeech2_mandarin_tpu.parallel import make_mesh
from expressive_fastspeech2_mandarin_tpu.parallel.mesh import (
    shard_batch as jax_shard_batch,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops.dropout import dropout
from expressive_fastspeech2_mandarin_tpu.train import (
    make_train_step,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch import parallel
from expressive_fastspeech2_mandarin_tpu_torch.data import (
    BucketedDataset,
    PreprocessedCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
)

from .corpus_util import make_synthetic_corpus
from .test_torch_train import _both, _jax_grads, _np
from .test_train import _synthetic_batch
from .torch_parallel_worker import (
    MaskFeed,
    jax_step_config,
    n_dropouts,
    run_workers,
)

STEPS = 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # tests/test_distributed.py's corpus: 64 utterances, seed 3.
    return make_synthetic_corpus(
        str(tmp_path_factory.mktemp("dp_corpus")), n_utts=64, seed=3)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Every multi-rank run of (c) and (d), and the 1-rank runs they are
    held against, launched together."""
    out = str(tmp_path_factory.mktemp("dp_runs"))

    def spec(n, mode, work, **kw):
        return n, dict(mode=mode, corpus=corpus, steps=STEPS,
                       outdir=os.path.join(out, work), **kw)

    return run_workers(out, {
        "steps_1": spec(1, "steps", "s1"),
        "steps_2": spec(2, "steps", "s2"),
        "model_parallel_2": spec(2, "steps", "m2", model_parallel=2),
        "train_1": spec(1, "train", "t1", steps_per_call=2),
        "train_2": spec(2, "train", "t2", steps_per_call=2),
    }) | {"out": out}


@pytest.fixture(scope="module")
def resumed(runs, corpus):
    """From the 1-rank ``train()`` run's last checkpoint: 2 more steps on
    1 rank and on 2 ranks (rank 0's directory alone holds it), and a
    restore of a step that is not there on 2 ranks."""
    out, ckpt = runs["out"], os.path.join(runs["out"], "t1", "ckpt")

    def spec(n, work, **kw):
        return n, dict(mode="train", corpus=corpus, steps=STEPS + 2,
                       steps_per_call=2, resume_from=ckpt,
                       outdir=os.path.join(out, work), **kw)

    return run_workers(out, {
        "resume_1": spec(1, "r1"),
        "resume_2": spec(2, "r2"),
        "missing_2": spec(2, "x2", restore_step=99, expect_error=1),
    })


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataset_shards_match_jax(corpus, drop_last):
    """Both shards of a 6-row batch (3 rows each), the tail dropped
    (train mode) or filled (val mode), two epochs, against the JAX
    package's row mode."""
    jbuckets = BucketConfig(src_buckets=(16, 24), mel_buckets=(64, 96))
    buckets = tcfg.BucketConfig(src_buckets=(16, 24), mel_buckets=(64, 96))
    jcorpus, tcorpus = JaxCorpus(corpus), PreprocessedCorpus(corpus)
    rows = []
    for index in range(2):
        kw = dict(drop_last=drop_last, seed=5, num_shards=2,
                  shard_index=index)
        ref = JaxBucketedDataset(jcorpus, "train.txt", 6, jbuckets,
                                 shard_rows=True, **kw)
        ours = BucketedDataset(tcorpus, "train.txt", 6, buckets, **kw)
        for epoch in (0, 1):
            assert ours.host_rows(epoch) == ref.host_rows(epoch)
            got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        rows.append(ours.host_rows(0))
    # 56 train utterances: 9 whole batches of 6 (a tenth filled), shared.
    assert len(rows[0]) == len(rows[1]) == (27 if drop_last else 30)
    if drop_last:
        assert not set(rows[0]) & set(rows[1])
    with pytest.raises(ValueError, match="not divisible"):
        BucketedDataset(tcorpus, "train.txt", 5, buckets, num_shards=2)


def test_dp_step_matches_jax_mesh_step(tmp_path, monkeypatch):
    """A global batch of 8 over 2 gloo ranks against JAX's jitted step on
    a 2-device mesh: the first step's gradients (summed over the ranks,
    BatchNorm's moments global) at tests/test_parallel.py's bound, and
    three steps' losses within 2e-4."""
    jc, tc, jmodel, tx, jstate, state = _both()
    assert tcfg.config_to_dict(tc) == tcfg.config_to_dict(jax_step_config())
    batch = _synthetic_batch(np.random.default_rng(5), b=8)
    feed = MaskFeed(n_dropouts(tc))
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p=0.5, shape=None: jnp.asarray(feed(shape, p)))
    mesh = make_mesh(devices=jax.devices()[:2])
    jbatch = jax_shard_batch(mesh, batch)
    jgrads = jax.jit(lambda p, b: _jax_grads(jmodel, jc, p,
                                             jstate.bn_state, b))(
        jstate.params, jbatch)
    step_fn = make_train_step(jmodel, tx, jc, donate=False)
    jst, losses = jstate, []
    for _ in range(3):
        jst, report = step_fn(jst, jbatch)
        losses.append(float(report.total))

    state_path, batch_path = tmp_path / "state.pt", tmp_path / "batch.npz"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "step": 0},
               state_path)
    np.savez(batch_path, **batch)
    ranks = run_workers(str(tmp_path), {"dp": (2, dict(
        mode="jax_step", state=state_path, batch=batch_path, steps=3))})["dp"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-4)
    ref = fastspeech2_from_jax(_np(jgrads), _np(jstate.bn_state))
    for rank in range(2):
        with np.load(str(tmp_path / f"dp_{rank}.json.grads.npz")) as g:
            assert set(g.files) <= set(ref)
            for name in g.files:
                np.testing.assert_allclose(g[name], ref[name].numpy(),
                                           rtol=1e-3, atol=1e-5,
                                           err_msg=name)


def test_two_ranks_match_one_rank(runs):
    """tests/test_distributed.py's bounds: steps 1-3 within 2e-4, all six
    within 5e-2, the parameters' sum 5e-3, evaluation at the initial
    parameters 2e-4; the two ranks bit-equal; their rows tile the global
    batches."""
    (single,), multi = runs["steps_1"], runs["steps_2"]
    assert multi[0]["losses"] == multi[1]["losses"]
    assert multi[0]["param_sum"] == multi[1]["param_sum"]
    assert multi[0]["eval"] == multi[1]["eval"]
    np.testing.assert_allclose(single["losses"][:3], multi[0]["losses"][:3],
                               rtol=2e-4)
    np.testing.assert_allclose(single["losses"], multi[0]["losses"],
                               rtol=5e-2)
    np.testing.assert_allclose(single["param_sum"], multi[0]["param_sum"],
                               rtol=5e-3)
    for k, v in single["eval0"].items():
        np.testing.assert_allclose(v, multi[0]["eval0"][k], rtol=2e-4,
                                   err_msg=k)
    for k, v in single["eval"].items():
        np.testing.assert_allclose(v, multi[0]["eval"][k], rtol=0.5,
                                   err_msg=k)
    r0, r1 = multi[0]["host_rows"], multi[1]["host_rows"]
    assert len(r0) == len(r1) > 0 and not set(r0) & set(r1)
    assert set(r0) | set(r1) == set(single["host_rows"])


def test_train_loop_two_ranks_match_one_rank(runs):
    """``train()`` in chunks of 2 steps on 2 ranks against 1 rank, at the
    same bounds; rank 0 alone writes the checkpoint, logs and samples."""
    (single,), multi = runs["train_1"], runs["train_2"]
    assert single["final_step"] == multi[0]["final_step"] == \
        multi[1]["final_step"] == STEPS
    assert multi[0]["losses"] == multi[1]["losses"]
    assert multi[0]["param_sum"] == multi[1]["param_sum"]
    np.testing.assert_allclose(single["losses"][:3], multi[0]["losses"][:3],
                               rtol=2e-4)
    np.testing.assert_allclose(single["losses"], multi[0]["losses"],
                               rtol=5e-2)
    np.testing.assert_allclose(single["param_sum"], multi[0]["param_sum"],
                               rtol=5e-3)
    work = os.path.join(runs["out"], "t2")
    assert os.listdir(os.path.join(work, "ckpt")) == [f"{STEPS}.pt"]
    for name, steps in (("train", [2, 4, 6]), ("val", [4])):
        with open(os.path.join(work, "log", name, "metrics.jsonl")) as f:
            assert [json.loads(line)["step"] for line in f] == steps, name


def test_model_parallel_ranks_equal_one_rank(runs):
    """Two ranks of one model group collate the same rows and compute them
    alike: bit-equal to one rank."""
    (single,), pair = runs["steps_1"], runs["model_parallel_2"]
    for r in pair:
        for key in ("losses", "param_sum", "eval0", "eval", "host_rows"):
            assert r[key] == single[key], key


def test_resume_from_rank_zero_checkpoint(runs, resumed):
    """Rank 1's directory holds no checkpoint: it takes rank 0's restored
    state (step, counts, parameters, moments, generator), and the two
    ranks match the resumed 1-rank run at the first steps' bounds."""
    (single,), multi = resumed["resume_1"], resumed["resume_2"]
    assert single["final_step"] == multi[0]["final_step"] == \
        multi[1]["final_step"] == STEPS + 2
    assert multi[0]["losses"] == multi[1]["losses"]
    assert multi[0]["param_sum"] == multi[1]["param_sum"]
    assert len(single["losses"]) == len(multi[0]["losses"]) == 2
    np.testing.assert_allclose(single["losses"], multi[0]["losses"],
                               rtol=2e-4)
    np.testing.assert_allclose(single["param_sum"], multi[0]["param_sum"],
                               rtol=5e-3)
    assert os.listdir(os.path.join(runs["out"], "r2")) == ["rank0"]


def test_failed_restore_raises_on_every_rank(resumed):
    """A restore step missing from rank 0's directory: rank 0 raises its
    error and rank 1 learns of it, neither waits in a collective."""
    r0, r1 = resumed["missing_2"]
    assert r0["error"] == "FileNotFoundError"
    assert r1["error"] == "RuntimeError" and "rank 0" in r1["message"]


def test_model_parallel_size_must_divide_the_world():
    assert parallel.make_layout(1) is None
    with pytest.raises(ValueError, match="mesh.model_parallel_size=2"):
        parallel.make_layout(2)


def test_shard_batch_takes_contiguous_rows():
    """A rank's rows of the global batch are its data index's contiguous
    slice, and its dropout masks are those rows of the global batch's."""
    layout = parallel.Layout(world_size=4, rank=3, model_parallel=2)
    assert (layout.data_parallel, layout.data_index) == (2, 1)
    assert layout.rows(8) == slice(4, 8)
    x = torch.arange(1.0, 8 * 3 * 5 + 1).reshape(8, 3, 5)
    want = dropout(x, 0.5, torch.Generator().manual_seed(3))[4:]
    got = dropout(x[4:], 0.5, torch.Generator().manual_seed(3), layout)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flat_collectives_write_back_every_bucket(monkeypatch):
    """The flat all-reduce and broadcast cut same-dtype runs of at most
    BUCKET_ELEMENTS elements (a larger tensor alone) and write each
    bucket's result back into its tensors."""
    from expressive_fastspeech2_mandarin_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "BUCKET_ELEMENTS", 8)
    ts = [torch.ones(3), torch.ones(5), torch.ones(2, 2), torch.ones(12),
          torch.ones(2, dtype=torch.float64), torch.ones(1)]
    assert [[t.numel() for t in b] for b in mesh._buckets(ts)] == [
        [3, 5], [4], [12], [2], [1]]
    seen = []

    def double(flat):
        seen.append(flat.numel())
        flat.mul_(2)

    mesh._flat_apply(ts, double)
    assert seen == [8, 4, 12, 2, 1]
    for t in ts:
        torch.testing.assert_close(t, torch.full_like(t, 2.0))
