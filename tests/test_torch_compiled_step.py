"""The port's compiled steps against the JAX package's, on the CPU: the
optimizer with its counts on the device (the update ``optax.MultiSteps``
masks, ``grad_acc_step`` 1, 2 and 3) against JAX's optax chain, the multi
step against JAX's ``make_train_multi_step``, the Synthesizer's compiled
forwards against JAX's ``_synth_fn`` cache, and ``graphs``' launch-counter
bookkeeping. On CPU tensors a compiled function runs as it is, as
``jax.jit`` does on the CPU; the graphs themselves are held against the
eager path on the card (``tests/test_torch_compiled_step_gpu.py``).

Bounds: the optimizer's parameters and Adam moments 1e-6 (float32); the
multi step at tests/test_torch_train.py's bounds for steps after the
first: losses 1e-5 relative, the parameters' total movement 1e-4
relative, BatchNorm's running statistics 2e-2 of their largest value.
"""

import contextlib
import copy
import dataclasses
import gc
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.synth.synthesizer import (
    Synthesizer as JaxSynthesizer,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    make_optimizer,
    make_train_multi_step as jax_multi_step,
    noam_schedule as jax_noam,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch import graphs
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import (
    FastSpeech2,
    MelGAN,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
    stage_batch,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.schedule import (
    Optimizer,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
    make_train_multi_step,
    make_train_step,
    mean_report,
    stack_batches,
    train_step,
)

from .test_torch_train import _both, _config, _np, shared_masks  # noqa: F401
from .test_train import _synthetic_batch

torch.set_num_threads(2)
CPU = torch.device("cpu")
UPDATES = 12


def _find(node, attr):
    """The first node of an optax state tree that has ``attr``."""
    if hasattr(node, attr):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find(child, attr)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("acc", [1, 2, 3])
def test_device_count_optimizer_matches_optax(acc):
    """Clip (some gradients past the threshold), Adam, decoupled weight
    decay and Noam with an anneal step crossed, over 12 updates, with the
    running mean of ``acc`` micro-steps an update (``optax.MultiSteps``):
    after every call the parameters, μ and ν within 1e-6 of optax's, the
    parameters still between updates, the count on the device."""
    kw = dict(weight_decay=0.01, grad_clip_thresh=1.0, warm_up_step=4,
              anneal_steps=(6, 100), anneal_rate=0.3, grad_acc_step=acc)
    tx = make_optimizer(jcfg.OptimizerConfig(**kw), 256)
    rng = np.random.default_rng(acc)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt = Optimizer([(k, torch.from_numpy(v.copy()))
                     for k, v in params.items()],
                    tcfg.OptimizerConfig(**kw), 256)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(grads, state, p):
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    clipped = 0
    for call in range(UPDATES * acc):
        scale = rng.uniform(0.05, 3.0)
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        clipped += np.sqrt(sum((g ** 2).sum() for g in grads.values())) > 1
        before = [p.clone() for p in opt.params]
        opt.step([torch.from_numpy(g) for g in grads.values()])
        jparams, jstate = jstep({k: jnp.asarray(g)
                                 for k, g in grads.items()}, jstate, jparams)
        adam = _find(jstate, "mu")
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(opt.params[i].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"call {call} {k}")
            np.testing.assert_allclose(opt.mu[i].numpy(),
                                       np.asarray(adam.mu[k]), atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(opt.nu[i].numpy(),
                                       np.asarray(adam.nu[k]), atol=1e-6,
                                       rtol=0)
        emitted = (call + 1) % acc == 0
        assert all(torch.equal(p, q) for p, q in zip(opt.params, before)
                   ) == (not emitted)
        assert int(opt.count) == int(adam.count) == (call + 1) // acc
        assert int(opt.mini_step) == (call + 1) % acc
    assert opt.count.device == opt.params[0].device and clipped
    # Past the anneal step (the 7th update): the next update's rate.
    lr = jax_noam(256, 4, (6, 100), 0.3)(UPDATES)
    assert opt.lr == pytest.approx(float(lr), rel=1e-6)
    state = opt.state_dict()
    assert state["count"] == UPDATES and isinstance(state["count"], int)


def test_optimizer_state_dict_round_trip_keeps_its_tensors():
    """Loading a state writes the counts and moments in place (a graph
    keeps reading them), and the checkpoint's counts stay integers."""
    cfg = tcfg.OptimizerConfig(grad_acc_step=2)
    opt = Optimizer([("w", torch.zeros(4))], cfg, 256)
    count, mu = opt.count, opt.mu[0]
    opt.load_state_dict({"count": 7, "mini_step": 1,
                         "mu": {"w": torch.ones(4)},
                         "nu": {"w": torch.ones(4)},
                         "acc": {"w": torch.full((4,), 2.0)}})
    assert opt.count is count and opt.mu[0] is mu
    assert int(opt.count) == 7 and int(opt.mini_step) == 1
    assert opt.state_dict()["count"] == 7
    assert opt.lr == pytest.approx(float(opt.schedule(7)))


def test_multi_step_matches_jax_multi_step(shared_masks):  # noqa: F811
    """Three stacked batches through the port's multi step (the CPU path)
    and through JAX's jitted ``lax.scan`` multi step: the mean report, the
    parameters and the postnet's BatchNorm statistics."""
    jc, tc, jmodel, tx, jstate, state = _both()
    shared_masks(tc)
    rng = np.random.default_rng(5)
    batches = [_synthetic_batch(rng, b=4) for _ in range(3)]
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    params0 = jstate.params
    jstate, jrep = jax_multi_step(jmodel, tx, jc, 3, donate=False)(
        jstate, stacked)
    rep = make_train_multi_step(state, tc, 3)(
        stack_batches([stage_batch(b, CPU) for b in batches]))
    np.testing.assert_allclose([float(x) for x in rep],
                               [float(x) for x in jrep], rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    assert int(state.optimizer.count) == 3
    ref = fastspeech2_from_jax(_np(jstate.params), _np(jstate.bn_state))
    ref0 = fastspeech2_from_jax(_np(params0), _np(jstate.bn_state))
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


def test_multi_step_is_the_chunk_of_single_steps():
    """On the CPU the multi step is the steps one by one: the same
    parameters, generator state and step count, and ``mean_report`` of
    their reports; the single step is ``train_step``."""
    _, tc, _, _, _, state = _both()
    rng = np.random.default_rng(9)
    batches = [stage_batch(_synthetic_batch(rng, b=4), CPU)
               for _ in range(3)]
    eager = copy.deepcopy(state)
    single = copy.deepcopy(state)
    reports = [train_step(eager, b, tc) for b in batches]
    rep = make_train_multi_step(state, tc, 3)(stack_batches(batches))
    for x, y in zip(rep, mean_report(reports)):
        assert torch.equal(x, y)
    step = make_train_step(single, tc)
    one = [step(b) for b in batches]
    for s in (state, single):
        assert s.step == eager.step == 3
        assert torch.equal(s.generator.get_state(),
                           eager.generator.get_state())
        for p, q in zip(s.model.state_dict().values(),
                        eager.model.state_dict().values()):
            assert torch.equal(p, q)
    for x, y in zip(one[-1], reports[-1]):
        assert torch.equal(x, y)


def _tiny_synth():
    cfg = _config(tcfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    return Synthesizer(cfg, fs2, device="cpu"), fs2


def test_synth_fn_cache_is_jax_s_and_a_weight_load_drops_it():
    """``_synth_fn`` takes JAX's key (source bucket, mel bucket, three
    controls) into an LRU of JAX's size; loading MelGAN drops every
    compiled function, and a weight written in place every graph (the
    next call sees it)."""
    synth, fs2 = _tiny_synth()
    params = list(inspect.signature(synth._synth_fn).parameters)
    jax_params = list(inspect.signature(JaxSynthesizer._synth_fn).parameters)
    assert jax_params == ["self"] + params
    assert params == ["max_src", "max_mel", "p_c", "e_c", "d_c"]
    assert (synth._synth_fn.cache_parameters()["maxsize"]
            == JaxSynthesizer._synth_fn.cache_parameters()["maxsize"] == 32)

    def run(dc):
        return synth.synthesize(["{n i h ao}"], vocoder="none",
                                duration_control=dc, max_mel_len=64)[0]

    first = run(1.0)
    run(2.0)
    assert synth._synth_fn.cache_info().currsize == 2
    synth._set_melgan(MelGAN(80).state_dict())
    assert synth._synth_fn.cache_info().currsize == 0
    run(1.0)
    run(2.0)
    assert not synth._graphs.check()
    fs2 = {k: v.clone() for k, v in fs2.items()}
    fs2["mel_linear.bias"] += 1.0
    synth.model.load_state_dict(fs2)
    assert synth._graphs.check()
    moved = run(1.0)
    run(2.0)
    assert not synth._graphs.check()
    assert moved.mel.shape == first.mel.shape
    assert np.abs(moved.mel - first.mel).min() > 0.5


def test_capture_counts_what_the_capture_launched_once_per_replay():
    """Counters: the warm-up and the capture leave them as found; each
    replay adds what the capture counted."""
    before = graphs.read_counters()
    assert len(before) == 15  # 12 flash counters, 3 MRF

    def launch(n_flash, n_mrf):
        fa.launch_count += n_flash
        fa.bwd_dq_launch_count += n_flash
        mrf.tc_launch_count += n_mrf
        mrf.launch_count += n_mrf

    out, launches = graphs.counted_capture(lambda: launch(12, 144),
                                           lambda: launch(6, 72) or "out")
    assert out == "out" and graphs.read_counters() == before
    assert sum(launches) == 2 * 6 + 2 * 72

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    g = graphs._Graph(FakeGraph(), [torch.zeros(2)],
                      (torch.ones(2), torch.full((2,), 2.0)), launches)
    x = torch.tensor([3.0, 4.0])
    for n in (1, 2, 3):
        out = graphs.Compiled._replay(g, [x])
        assert FakeGraph.replays == n
        assert fa.launch_count == before[0] + 6 * n
        assert mrf.tc_launch_count == before[-2] + 72 * n
    assert torch.equal(g.inputs[0], x) and torch.equal(out[1], g.outputs[1])
    assert out[0] is not g.outputs[0]
    graphs.set_counters(before)


def test_graphs_drop_on_a_replaced_or_written_tensor():
    """The owner's fingerprint: the same tensors at the same versions keep
    the graphs; a tensor written in place or replaced drops them."""
    state = [torch.zeros(3), torch.ones(2)]
    owner = graphs.Graphs(state=lambda: state)
    fn = owner.jit(lambda x: x + state[0])
    fn.graphs["key"] = "a graph"
    assert not owner.check() and owner.count() == 1
    assert not owner.check() and owner.count() == 1
    state[0].add_(1.0)
    assert owner.check() and owner.count() == 0
    fn.graphs["key"] = "a graph"
    state[1] = torch.ones(2)
    assert owner.check() and owner.count() == 0
    assert torch.equal(fn(torch.zeros(3)), torch.ones(3))


def test_a_capture_that_regrows_the_position_table_drops_older_graphs():
    """The Synthesizer's state after a capture: a warm-up that grows the
    decoder's first position table past max_seq_len adds a tensor and
    keeps the graphs; one that regrows it for a longer key replaces the
    table the older graphs read, so they are dropped, never replayed."""
    synth, _ = _tiny_synth()
    owner, decoder = synth._graphs, synth.model.decoder
    fn = owner.jit(lambda x: x)
    x = torch.zeros(1, 1, decoder.d_model)
    for t, kept in ((decoder.max_seq_len + 10, 1),
                    (decoder.max_seq_len + 10, 2),
                    (decoder.max_seq_len + 20, 0)):
        assert not owner.check()  # a call's start
        fn.graphs[t, kept] = "a graph captured before"
        decoder.positions(t, x)  # the capture's warm-up
        owner.captured()
        assert owner.count() == kept, t
    assert decoder._regrown.shape[0] == decoder.max_seq_len + 20


def test_no_garbage_collection_inside_a_capture(monkeypatch):
    """An owner and its graphs form a cycle, so the cyclic collector frees
    a dead owner's graphs, and destroying a graph inside another's capture
    invalidates that capture: no collection runs inside ``capturing``
    (``torch.cuda.graph`` stood in for here), and one runs after it."""
    inside, seen = [False], []

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None):
        inside[0] = True
        try:
            yield
        finally:
            inside[0] = False

    def on_collect(phase, info):
        if phase == "start":
            seen.append(inside[0])

    monkeypatch.setattr(torch.cuda, "graph", graph)
    thresholds = gc.get_threshold()
    gc.callbacks.append(on_collect)
    gc.set_threshold(1)
    try:
        with graphs.capturing(None):
            junk = [[i] for i in range(1000)]
        before = len(seen)
        junk = [[i] for i in range(1000)]
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(on_collect)
    assert len(junk) == 1000 and len(seen) > before and not any(seen)
    assert gc.isenabled()


def test_train_step_under_a_layout_stays_eager():
    """``make_train_step`` under a gloo data-parallel layout is the eager
    step (gloo's collectives cannot be captured): it makes no graphs."""
    from expressive_fastspeech2_mandarin_tpu_torch.parallel import Layout

    _, tc, _, _, _, state = _both()
    layout_state = dataclasses.replace(
        copy.deepcopy(state), layout=Layout(2, 0, backend="gloo"))
    assert layout_state.graphs is None
    make_train_step(layout_state, tc)
    assert layout_state.graphs is None
    make_train_step(state, tc)
    assert state.graphs is not None


def test_a_capture_takes_a_new_pool_once_every_graph_died(monkeypatch):
    """An owner's pool is shared while one of its graphs lives; once the
    functions compiled for it are gone (a train loop's, when it returns)
    a later capture takes a new pool: CUDA's caching allocator refuses a
    capture into a pool whose every graph was released (an internal
    assert on the card, seen when a synth step was compiled on a train
    state after ``train()`` returned)."""
    handles = iter(range(1, 10))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    owner = graphs.Graphs()
    assert owner.capture_pool() == 1
    first = owner.jit(lambda x: x)
    first.graphs["key"] = object()  # a live graph
    second = owner.jit(lambda x: x)
    assert owner.capture_pool() == 1
    del first
    gc.collect()
    assert owner.count() == 0
    assert owner.capture_pool() == 2
    second.graphs["key"] = object()
    assert owner.capture_pool() == 2
    owner.drop()
    assert owner.capture_pool() == 3
