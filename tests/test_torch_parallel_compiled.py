"""The port's data-parallel steps compiled (``train.step`` under a
``parallel.Layout`` whose collectives can be captured), on the CPU.

(a) the layout records its process group's backend; NCCL's collectives
    can be captured, gloo's cannot; the makers choose from the layout
    before they are called: eager bodies under gloo, ``graphs.Compiled``
    on the state's graphs under NCCL, and the samples' synth step on
    graphs of its own under either;
(b) a capture is never a process's first collective: driven through the
    real ``Compiled._capture`` with CUDA's capture calls stood in for,
    the data-parallel step's warm-up runs its collectives eagerly before
    the capture issues the same ones, and the state is put back;
(c) the chunk body a capturable layout compiles (``make_train_multi_step``)
    on 2 gloo ranks against JAX's scanned multi step on a 2-device mesh,
    from one init and one set of dropout masks, two micro-steps an update:
    mean losses 2e-4 relative, each parameter's change at
    tests/test_parallel.py's bound, the ranks bit-equal;
(d) ``train()`` on 2 gloo ranks with the layout marked capturable, chunks
    of 2, an evaluation and rank-0 samples crossing the run, on a corpus
    whose val batch lies past ``max_seq_len``: both ranks issue the same
    collectives and the same compiled calls on the train graphs, and no
    sample changes what the train graphs read (the position table).

The ranks are OS processes (tests/torch_parallel_worker.py) under its
timeout. The card's side, NCCL in a world of one, is in
tests/test_torch_parallel_gpu.py.
"""

import contextlib
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.parallel import make_mesh
from expressive_fastspeech2_mandarin_tpu.parallel.mesh import (
    shard_batch_chunk,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    create_train_state as jax_create_train_state,
    make_optimizer,
    make_train_multi_step as jax_multi_step,
)
from expressive_fastspeech2_mandarin_tpu_torch import graphs, parallel
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
    make_eval_step,
    make_synth_step,
    make_train_multi_step,
    make_train_step,
)

from .corpus_util import make_synthetic_corpus
from .test_torch_train import _both, _np, _zero_in_exact_arithmetic
from .test_train import _synthetic_batch
from .torch_parallel_worker import (
    MaskFeed,
    n_dropouts,
    run_workers,
)

CPU = torch.device("cpu")
LOCKSTEP_STEPS = 6


def _layout(backend):
    return parallel.Layout(world_size=1, rank=0, backend=backend)


def test_layout_records_its_backend():
    """``make_layout`` in a gloo group records "gloo", which cannot be
    captured; NCCL can; a layout made by hand without a backend cannot."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        layout = parallel.make_layout()
    finally:
        dist.destroy_process_group()
    assert layout == parallel.Layout(1, 0, 1, "gloo")
    assert not layout.capturable
    assert _layout("nccl").capturable
    assert not parallel.Layout(world_size=2, rank=1).capturable


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_makers_choose_from_the_layout(backend):
    """Made, not called: under gloo the train, multi and eval steps are
    their eager bodies and the state holds no graphs; under NCCL each is
    compiled on the state's graphs. The synth step, which one rank alone
    calls, is compiled on graphs of its own under either."""
    _, tc, _, _, _, state = _both()
    state = dataclasses.replace(state, layout=_layout(backend))
    steps = make_train_step(state, tc), make_train_multi_step(state, tc, 2)
    evaluate = make_eval_step(state, tc)
    synth = make_synth_step(state)
    assert all(callable(s) for s in steps)
    assert isinstance(synth, graphs.Compiled)
    if backend == "gloo":
        assert state.graphs is None
        assert not isinstance(evaluate, graphs.Compiled)
        return
    assert isinstance(evaluate, graphs.Compiled)
    assert evaluate.owner is state.graphs
    assert len(state.graphs.compiled) == 3
    assert all(c.mutates for c in state.graphs.compiled
               if c is not evaluate)
    assert synth.owner is not state.graphs
    assert synth not in state.graphs.compiled


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        pass


@pytest.mark.parametrize("maker", ["train", "eval"])
def test_a_capture_is_never_the_first_collective(maker, monkeypatch):
    """The data-parallel step's first capture through
    ``Compiled._capture``, ``torch.cuda``'s stream and graph calls stood
    in for (the body runs, as the card's capture records it): every
    collective of the ``WARMUP_CALLS`` eager calls comes before the
    capture, which issues the same ones; the train step's state is put
    back after the warm-up."""
    _, tc, _, _, _, state = _both()
    state = dataclasses.replace(state, layout=_layout("nccl"))
    inside, log = [False], []

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None):
        inside[0] = True
        try:
            yield
        finally:
            inside[0] = False

    def all_reduce(tensor, *args, **kwargs):  # a world of one: in place
        log.append((inside[0], tensor.numel()))

    for name, value in (
            ("CUDAGraph", _Graph), ("graph", graph),
            ("Stream", lambda device=None: _Stream()),
            ("current_stream", lambda device=None: _Stream()),
            ("stream", lambda stream: contextlib.nullcontext()),
            ("graph_pool_handle", lambda: "pool")):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    made = (make_train_step if maker == "train" else make_eval_step)(
        state, tc)
    (compiled,) = state.graphs.compiled
    assert callable(made)
    batch = stage_batch(_synthetic_batch(np.random.default_rng(3), b=2),
                        CPU)
    before = copy.deepcopy(state.model.state_dict())
    tensors, _ = graphs._flatten((batch,))
    compiled._capture("key", (batch,), {}, tensors, CPU)
    assert len(compiled.graphs) == 1 and state.graphs.count() == 1
    per_call = len(log) // (graphs.WARMUP_CALLS + 1)
    assert per_call > 0 and len(log) == per_call * (graphs.WARMUP_CALLS + 1)
    warm, captured = log[:-per_call], log[-per_call:]
    assert not any(in_capture for in_capture, _ in warm)
    assert all(in_capture for in_capture, _ in captured)
    assert [n for _, n in captured] == [n for _, n in warm[:per_call]]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(state.optimizer.count) == 0


def test_dp_chunk_matches_jax_scanned_chunk(tmp_path, monkeypatch):
    """A chunk of two global batches of 8: the port's multi-step body on 2
    gloo ranks against JAX's ``make_train_multi_step`` (``lax.scan``) on
    a 2-device mesh, the chunk sharded by ``shard_batch_chunk``, with the
    same dropout masks, ``grad_acc_step`` 2: two micro-steps, their
    gradients' mean one update. The chunk's mean losses within 2e-4
    relative; each parameter's change within tests/test_parallel.py's
    bound, 1e-3 relative and 1e-5 an element (in norm), but for the two
    whose gradients are zero in exact arithmetic; the ranks bit-equal.
    One update, because a second one turns float noise into Adam sign
    flips: one process against JAX differs by 2 % after two updates of a
    chunk of 1, as test_parallel.py's comment on post-Adam parameters
    says."""
    jc, tc, jmodel, _, jstate, state = _both()
    jc = dataclasses.replace(jc, train=dataclasses.replace(
        jc.train, optimizer=dataclasses.replace(jc.train.optimizer,
                                                grad_acc_step=2)))
    tx = make_optimizer(jc.train.optimizer,
                        jc.model.transformer.encoder_hidden)
    jstate = jax_create_train_state(jstate.params, jstate.bn_state, tx,
                                    jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    batches = [_synthetic_batch(rng, b=8) for _ in range(2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    feed = MaskFeed(n_dropouts(tc))
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p=0.5, shape=None: jnp.asarray(feed(shape, p)))
    mesh = make_mesh(devices=jax.devices()[:2])
    jst, jreport = jax_multi_step(jmodel, tx, jc, 2, donate=False)(
        jstate, shard_batch_chunk(mesh, stacked))

    state_path, batch_path = tmp_path / "state.pt", tmp_path / "chunk.npz"
    tc = dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, optimizer=dataclasses.replace(tc.train.optimizer,
                                                grad_acc_step=2)))
    fresh = create_train_state(tc, None, CPU).optimizer  # moments 0
    torch.save({"model": state.model.state_dict(),
                "optimizer": fresh.state_dict(), "step": 0}, state_path)
    np.savez(batch_path, **stacked)
    ranks = run_workers(str(tmp_path), {"chunk": (2, dict(
        mode="jax_chunk", state=state_path, batch=batch_path,
        grad_acc_step=2))})["chunk"]
    assert ranks[0]["mean_loss"] == ranks[1]["mean_loss"]
    assert ranks[0]["param_sum"] == ranks[1]["param_sum"]
    assert ranks[0]["step"] == int(jst.step) == 2
    assert ranks[0]["updates"] == 1
    np.testing.assert_allclose(ranks[0]["mean_loss"],
                               [float(x) for x in jreport], rtol=2e-4)
    ref = fastspeech2_from_jax(_np(jst.params), _np(jst.bn_state))
    init = state.model.state_dict()
    with np.load(str(tmp_path / "chunk_0.json.params.npz")) as p0, \
            np.load(str(tmp_path / "chunk_1.json.params.npz")) as p1:
        for name, _ in state.model.named_parameters():
            np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
            if _zero_in_exact_arithmetic(name):
                continue
            moved = p0[name] - init[name].numpy()
            want = ref[name].numpy() - init[name].numpy()
            assert np.linalg.norm(moved - want) <= (
                1e-3 * np.linalg.norm(want) + 1e-5 * want.size ** 0.5), name


def _long_val_corpus(root: str) -> tuple[str, int, tuple[int, int]]:
    """tests/test_torch_parallel.py's synthetic corpus with its 4 longest
    utterances as the val set; ``max_seq_len`` the longest of them and
    mel buckets (the longest train utterance, past ``max_seq_len``), so
    that the train batches stay under ``max_seq_len`` and the val batch,
    the samples' batch, lies past it."""
    corpus = make_synthetic_corpus(root, n_utts=40, seed=3)
    lines = []
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(corpus, name)) as f:
            lines += [line for line in f.read().splitlines() if line]

    def frames(line):
        base, spk = line.split("|")[:2]
        return int(np.load(os.path.join(
            corpus, "duration", f"{spk}-duration-{base}.npy")).sum())

    lines.sort(key=frames)
    train_lines, val_lines = lines[:-4], lines[-4:]
    longest_train = frames(train_lines[-1])
    max_seq_len = frames(val_lines[-1])
    assert max_seq_len > longest_train
    for name, part in (("train.txt", train_lines), ("val.txt", val_lines)):
        with open(os.path.join(corpus, name), "w") as f:
            f.write("\n".join(part) + "\n")
    return corpus, max_seq_len, (longest_train, max_seq_len + 16)


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lockstep"))
    corpus, max_seq_len, buckets = _long_val_corpus(
        os.path.join(out, "corpus"))
    ranks = run_workers(out, {"lockstep": (2, dict(
        mode="lockstep", corpus=corpus, steps=LOCKSTEP_STEPS,
        steps_per_call=2, outdir=os.path.join(out, "work"),
        max_seq_len=max_seq_len,
        mel_buckets=",".join(map(str, buckets))))})["lockstep"]
    return ranks, max_seq_len


def test_ranks_issue_the_same_collectives_and_compiled_calls(lockstep):
    """Both ranks: the same collectives in the same order (op, elements),
    the first of them ``broadcast_state``'s, before any step; the same
    compiled calls on the train graphs (function, input shapes) — the
    chunks, the evaluation — and rank 0's samples alone on graphs of
    their own; the same final state."""
    (r0, r1), _ = lockstep
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["capturable"] and r1["capturable"]
    assert r0["collectives"] == r1["collectives"]
    assert r0["collectives"][0] == ["broadcast", 5]
    ops = {op for op, _ in r0["collectives"]}
    assert ops == {"broadcast", "all_reduce", "barrier"}
    train0 = [c for c in r0["calls"] if c[1] == "train"]
    assert train0 == r1["calls"]
    kinds = [c[0].split(".")[0] for c in train0]
    assert kinds.count("make_train_multi_step") == LOCKSTEP_STEPS // 2
    assert "make_eval_step" in kinds
    own = [c for c in r0["calls"] if c[1] == "own"]
    assert [c[0].split(".")[0] for c in own] == ["make_synth_step"] * 3
    assert r0["final_step"] == r1["final_step"] == LOCKSTEP_STEPS
    assert r0["param_sum"] == r1["param_sum"]


def test_rank_zero_samples_keep_the_train_graphs(lockstep):
    """Each rank-0 sample, past ``max_seq_len``, leaves the tensors the
    train graphs read as they were (``Graphs.check`` is False): no sample
    regrows a position table, so rank 0 never drops its graphs alone."""
    (r0, r1), max_seq_len = lockstep
    assert len(r0["samples"]) == 3 and not r1["samples"]
    for sample in r0["samples"]:
        assert sample["max_mel_len"] > max_seq_len
        assert sample["changed"] is False
