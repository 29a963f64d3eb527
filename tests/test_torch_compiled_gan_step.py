"""The port's compiled vocoder steps and FastSpeech2 eval step against the
JAX package's, on the CPU, at tests/test_torch_vocoder_train.py's toy
widths (batch 2, segment 1024, MPD (2, 3), MSD ×2, 32 initial channels).

* ``VocoderAdamW``, the AdamW whose count, moments and learning rate live
  on the parameters' device, against optax's ``adamw`` with the staircase
  ``exponential_decay`` that JAX's ``make_vocoder_optimizers`` builds;
* its state made before any step, and the capture protocol of
  ``graphs.Graphs`` (save, warm-up steps, restore, then the captured
  step) leaving one step's worth, where torch's lazily made AdamW state
  keeps the warm-up's moments;
* the checkpoint round trip through ``vocoder_train_state_from_jax``;
* ``make_vocoder_multi_step`` against JAX's ``make_vocoder_multi_step``
  and against the single steps one by one;
* the val step's 0-d tensor against JAX's ``make_vocoder_val_step``;
* ``make_eval_step`` against JAX's ``make_eval_step``.

On CPU tensors a compiled function runs as it is, as ``jax.jit`` does on
the CPU; the graphs themselves are held against the eager path on the
card (``tests/test_torch_compiled_gan_step_gpu.py``).

Bounds: the optimizer's parameters and moments 1e-6 (float32); the multi
step's mean losses 1e-5 relative (float32 sums in another order, the
one-step test's ``LOSS_REL``); its parameters 1e-6 where the gradient is
large (``PARAM_ATOL``). Over three steps "large" must hold at each of the
three (|g| > 1e-3 · max|g| of its tensor at every step): AdamW moves a
parameter by about lr · sign(g) for a gradient that is float-order noise,
and a noise step in the first update stays in the parameter whatever the
later gradients. The multi step against the single steps: bit for bit.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.train import vocoder as jvoc
from expressive_fastspeech2_mandarin_tpu.train.step import (
    make_eval_step as jax_make_eval_step,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    discriminator_from_jax,
    wn_generator_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tvoc
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
    eval_step,
    make_eval_step,
)

from .test_torch_train import _both
from .test_torch_vocoder_train import (
    LOSS_REL,
    PARAM_ATOL,
    _cfg,
    _checkpoint,
    _jax_state,
    _np,
    _port_params,
    _wavs,
)
from .test_train import _synthetic_batch

torch.set_num_threads(2)
CPU = torch.device("cpu")
OPT_ATOL = 1e-6
N_MULTI = 3
EVAL_RTOL = 1e-5  # tests/test_torch_train.py's teacher-forced eval bound


def _adam_moments(opt_state):
    """(mu, nu) of an optax adamw state (``scale_by_adam``'s)."""
    for node in jax.tree.leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no scale_by_adam state")


@pytest.mark.parametrize("decay_steps", [1, 2])
def test_device_adamw_matches_optax(decay_steps):
    """Six updates crossing two decay steps (lr 0.1 halved every
    ``decay_steps`` updates, so that the schedule shows) against JAX's
    ``make_vocoder_optimizers`` optax chain: parameters, μ and ν within
    1e-6 after every update; the count on the parameters' device."""
    over = dict(learning_rate=0.1, lr_decay=0.5, lr_decay_steps=decay_steps)
    jc, pc = _cfg(jcfg, **over), _cfg(tcfg, **over)
    rng = np.random.default_rng(decay_steps)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx, _ = jvoc.make_vocoder_optimizers(jc)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    ours = {k: torch.tensor(v) for k, v in params.items()}
    opt = tvoc.VocoderAdamW(ours.items(), pc)
    assert opt.count.device == CPU and int(opt.count) == 0
    for i in range(6):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update({k: jnp.asarray(v)
                                     for k, v in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in opt.names])
        mu, nu = _adam_moments(jstate)
        for j, k in enumerate(opt.names):
            for got, ref in ((ours[k], jparams[k]), (opt.mu[j], mu[k]),
                             (opt.nu[j], nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=0, atol=OPT_ATOL,
                                           err_msg=f"update {i}, {k}")
            # .grad holds the update's gradient.
            np.testing.assert_array_equal(ours[k].grad.numpy(), grads[k])
        assert int(opt.count) == i + 1
    sched = optax.exponential_decay(0.1, decay_steps, 0.5, staircase=True)
    assert opt.lr == pytest.approx(float(sched(6)), rel=1e-6)


def _values(state):
    return [t.detach().clone() for t in tvoc.vocoder_graphs(state).state()]


def test_optimizer_state_exists_before_any_step():
    """The counts, moments and ``.grad`` tensors are made with the state,
    zero, and stay the same tensors through a step, so that a graph's
    capture saves them before its warm-up. ``Graphs``' capture protocol
    (save; two warm-up steps; restore; the captured step) then leaves the
    state one step from where it was, equal to one step of a state built
    afresh; with torch's AdamW, whose state a first step makes, the warm-up
    steps' moments and counts stay behind (the fault this pins)."""
    cfg = _cfg(tcfg)
    ctx = [torch.from_numpy(tvoc.SegmentSampler(cfg, _wavs(5), seed=s)
                            .sample(2)) for s in (1, 2, 3)]
    state = tvoc.init_vocoder_train_state(cfg, CPU)
    for opt in (state.opt_g, state.opt_d):
        assert int(opt.count) == 0 and opt.count.device == CPU
        assert all(not t.any() for t in opt.mu + opt.nu + opt.grads)
        assert all(p.grad is g for p, g in zip(opt.params, opt.grads))
    graphs = tvoc.vocoder_graphs(state)
    before = [id(t) for t in graphs.state()]
    step = tvoc.make_vocoder_train_step(cfg, CPU)

    ref = tvoc.init_vocoder_train_state(cfg, CPU)
    step(ref, ctx[2])
    saved = graphs._save()
    step(state, ctx[0])
    step(state, ctx[1])
    graphs._restore(saved)
    step(state, ctx[2])
    assert [id(t) for t in graphs.state()] == before
    for a, b in zip(_values(state), _values(ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # The parent's lazy state under the same protocol: the moments that
    # the warm-up made are not among the saved tensors.
    lazy = tvoc.init_vocoder_train_state(cfg, CPU)
    adam = functools.partial(torch.optim.AdamW, lr=2e-4, betas=(0.8, 0.99),
                             eps=1e-8, weight_decay=0.01)
    opt = adam(lazy.gen.parameters())

    def lazy_tensors():
        return [*(p for p in lazy.gen.parameters()),
                *(t for st in opt.state.values() for t in st.values())]

    def lazy_step(batch):
        mel = tvoc.logmel_from_context(batch, tvoc.vocoder_mels(cfg, CPU)[0],
                                       16)
        opt.zero_grad()
        lazy.gen(mel, fast=False).square().mean().backward()
        opt.step()

    fresh = [p.detach().clone() for p in lazy.gen.parameters()]
    saved = [(t, t.detach().clone()) for t in lazy_tensors()]
    lazy_step(ctx[0])
    lazy_step(ctx[1])
    for t, v in saved:
        t.data.copy_(v)
    lazy_step(ctx[2])
    leaked = [p.detach().clone() for p in lazy.gen.parameters()]
    with torch.no_grad():
        for p, v in zip(lazy.gen.parameters(), fresh):
            p.copy_(v)
    opt.state.clear()
    lazy_step(ctx[2])
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(leaked, lazy.gen.parameters()))


@pytest.fixture(scope="module")
def multi_steps():
    """From a JAX numpy state: JAX's multi step of three over stacked
    windows; the port's multi step, and its single steps one by one with
    each step's gradients, from that state."""
    jc, pc = _cfg(jcfg), _cfg(tcfg)
    wavs = _wavs(5)
    ctx = [jvoc.SegmentSampler(jc, wavs, seed=s).sample(2)
           for s in range(1, 2 + N_MULTI)]
    js0 = _jax_state(jc, 0)
    stacked = np.stack(ctx[1:])
    js_n, jreport = jvoc.make_vocoder_multi_step(jc, N_MULTI)(
        js0, jnp.asarray(stacked))
    multi = tvoc.init_vocoder_train_state(pc, CPU)
    tvoc.load_vocoder_checkpoint(multi, _checkpoint(js0))
    report = tvoc.make_vocoder_multi_step(multi, pc, CPU, N_MULTI)(
        torch.from_numpy(stacked))
    single = tvoc.init_vocoder_train_state(pc, CPU)
    tvoc.load_vocoder_checkpoint(single, _checkpoint(js0))
    step = tvoc.make_vocoder_train_step(pc, CPU)
    reports, grads = [], []
    for c in ctx[1:]:
        reports.append(step(single, torch.from_numpy(c)))
        grads.append({part: {n: p.grad.clone() for n, p in params.items()}
                      for part, params in _port_params(single).items()})
    return dict(jc=jc, pc=pc, js_n=js_n, jreport=jreport, multi=multi,
                report=report, single=single, reports=reports, grads=grads,
                ctx=ctx)


def test_checkpoint_round_trip_from_jax(multi_steps):
    """A JAX state with non-zero counts and moments through
    ``vocoder_train_state_from_jax`` into the port (the counts on the
    parameters' device) and out through ``vocoder_checkpoint``: the same
    dict. The load writes every state tensor, so the state's graphs are
    dropped at their next call."""
    ckpt = _checkpoint(multi_steps["js_n"])
    state = tvoc.init_vocoder_train_state(multi_steps["pc"], CPU)
    graphs = tvoc.vocoder_graphs(state)
    graphs.check()
    tvoc.load_vocoder_checkpoint(state, ckpt)
    assert graphs.check()  # the fingerprint saw the writes
    for opt in (state.opt_g, state.opt_d):
        assert opt.count.device == opt.params[0].device
        assert int(opt.count) == N_MULTI
    out = tvoc.vocoder_checkpoint(state)
    assert out.keys() == ckpt.keys()
    assert out["step"] == ckpt["step"] == N_MULTI
    for part in ("gen", "mpd", "msd"):
        assert out[part].keys() == ckpt[part].keys()
        for k, v in ckpt[part].items():
            torch.testing.assert_close(out[part][k], v, rtol=0, atol=0)
    for part in ("opt_g", "opt_d"):
        assert out[part]["count"] == ckpt[part]["count"] == N_MULTI
        for key in ("exp_avg", "exp_avg_sq"):
            assert out[part][key].keys() == ckpt[part][key].keys()
            for k, v in ckpt[part][key].items():
                torch.testing.assert_close(out[part][key][k], v, rtol=0,
                                           atol=0)


def test_multi_step_matches_jax(multi_steps):
    ref, out = multi_steps["jreport"], multi_steps["report"].as_dict()
    assert multi_steps["multi"].step == int(multi_steps["js_n"].step) == 3
    for name in ref._fields:
        r = float(getattr(ref, name))
        assert abs(out[name] - r) <= LOSS_REL * abs(r), (name, out[name], r)
    js = _np(multi_steps["js_n"])
    want = {"gen": wn_generator_from_jax(js.gen),
            "mpd": discriminator_from_jax(js.mpd),
            "msd": discriminator_from_jax(js.msd)}
    checked = 0
    for part, params in _port_params(multi_steps["multi"]).items():
        for name, p in params.items():
            big = torch.ones_like(p, dtype=torch.bool)
            for g in multi_steps["grads"]:
                a = g[part][name].abs()
                big &= a > 1e-3 * a.max()
            diff = (p.detach() - want[part][name]).abs()[big]
            checked += diff.numel()
            assert diff.numel() == 0 or diff.max() <= PARAM_ATOL, (
                part, name, float(diff.max()))
    assert checked > 0


def test_multi_step_is_the_single_steps(multi_steps):
    """Bit for bit on the CPU: the parameters, the optimizers' state, the
    last step's gradients, and the report (``chunk_mean`` of the steps')."""
    multi, single = multi_steps["multi"], multi_steps["single"]
    assert multi.step == single.step
    for a, b in zip(tvoc.vocoder_graphs(multi).state(),
                    tvoc.vocoder_graphs(single).state()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mean = tvoc.chunk_mean(multi_steps["reports"])
    for a, b in zip(multi_steps["report"], mean):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_val_step_returns_a_tensor_equal_to_jax(multi_steps):
    """The val step's 0-d device tensor against JAX's float; the compiled
    one on the state's graphs (eager on CPU tensors) equal to it."""
    jc, pc = multi_steps["jc"], multi_steps["pc"]
    batch = multi_steps["ctx"][0]
    state = tvoc.init_vocoder_train_state(pc, CPU)
    tvoc.load_vocoder_checkpoint(state, _checkpoint(multi_steps["js_n"]))
    ref = float(jvoc.make_vocoder_val_step(jc)(multi_steps["js_n"].gen,
                                               jnp.asarray(batch)))
    out = tvoc.make_vocoder_val_step(pc, CPU)(state.gen,
                                              torch.from_numpy(batch))
    assert isinstance(out, torch.Tensor) and out.ndim == 0
    assert abs(float(out) - ref) <= LOSS_REL * abs(ref)
    compiled = tvoc.make_vocoder_val_step(pc, CPU, state)(
        state.gen, torch.from_numpy(batch))
    torch.testing.assert_close(compiled, out, rtol=0, atol=0)


def test_eval_step_matches_jax():
    """``make_eval_step`` on one bucket against JAX's jitted
    ``make_eval_step``, at the existing eval comparison's bound; equal to
    the eager ``eval_step``."""
    jc, tc, jmodel, _, jstate, state = _both()
    batch = _synthetic_batch(np.random.default_rng(4))
    ref = jax_make_eval_step(jmodel, jc)(
        jstate.params, jstate.bn_state,
        {k: jnp.asarray(v) for k, v in batch.items()})
    staged = stage_batch(batch, CPU)
    out = make_eval_step(state, tc)(staged)
    np.testing.assert_allclose([float(x) for x in out],
                               [float(x) for x in ref], rtol=EVAL_RTOL)
    for a, b in zip(out, eval_step(state.model, staged, tc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
