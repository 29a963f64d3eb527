"""Flash attention in bf16 at head dim 256, on the CPU.

The JAX package's amp step casts its parameters to bf16
(``train/step.py:50-60``), so at one head of 256 ("h1d256") it feeds its
TPU flash kernel bf16 q, k, v at D = 256. The port's kernels for that are
``csrc/flash_mha_bf16_d256.cu``; on CPU tensors its plain versions stand in
for them. Here, with the JAX kernel in Pallas interpret mode:

* ``flash_mha`` on bf16 inputs at (2, 1, T, 256), T ∈ {256, 300}, ragged
  key lengths, dO zero at padded query rows, against the JAX ``flash_mha``:
  out within 2⁻⁷ and the gradients within 2⁻⁶ of max|ref|
  (tests/test_torch_flash_head_dims.py's D = 64 bounds);
* the slice: one amp-bf16 train step of FastSpeech2 at hidden 256 with one
  head (D = 256), 1 encoder and 1 decoder block, under
  ``attention_impl="flash"``, against the JAX step under
  ``amp_dtype="bfloat16"`` with the same dropout masks
  (tests/test_torch_flash_bf16.py's bounds at two heads of 128), and no
  launch counter moves on the CPU;
* the kernels' design, emulated in plain torch: the output's head dim split
  in halves of 128 columns, each half computing S (and dP) over all 256
  columns and its own 64-key online softmax, with LSE and Δ from the whole
  row. On float64 inputs it is the blocked plain forward on 64-key tiles and
  the plain backward, half by half, within 1e-12; on bf16 inputs, rounding
  where the kernels round, within 2⁻⁷ (out) and 2⁻⁶ (gradients). Both
  halves form the same P and dS bit for bit; a Δ taken over one half's
  columns only is far off.

The CUDA kernels' own tests are in tests/test_torch_kernels_gpu.py.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.models import FastSpeech2 as JaxFS2
from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    create_train_state as jax_create_train_state,
    make_optimizer,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    train_state_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
    loss_and_grads,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
    load_checkpoint,
)

from .test_torch_flash_bf16 import (
    ATTN_GRAD_REL,
    GRAD_COS,
    LOSS_REL,
    _amp,
    _jax_amp_loss_and_grads,
)
from .test_torch_train import (  # noqa: F401  (shared_masks: a fixture)
    CPU,
    _config,
    _np,
    _zero_in_exact_arithmetic,
    shared_masks,
)
from .test_train import _synthetic_batch

torch.set_num_threads(2)
D = 256
HALF = 128        # csrc/flash_mha_bf16_d256.cu: kHalf, a consumer's columns
TILE = 64         # its key tile (forward, dQ) and query tile (dK/dV)
SCALE = D ** -0.5
OUT_REL = 2.0 ** -7
GRAD_REL = 2.0 ** -6
EXACT_REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def settled_torch():
    """One discarded plain forward at the tested shape, as
    tests/test_torch_flash_head_dims.py's: a thread's first ``torch.exp``
    sometimes runs in oneMKL's low-accuracy EP mode (PERF.md §7), which no
    comparison here should see."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1, 300, D)).astype(np.float32))
    fm.flash_mha_plain(x, x, x, torch.zeros(2, 300, dtype=torch.bool), SCALE)


def _inputs(t, lens, seed):
    """q, k, v, dO (2, 1, T, 256) float32 numpy arrays of bf16 values and
    the (B, T) key mask; dO is zero at padded query rows."""
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.normal(size=(len(lens), 1, t, D))
                               .astype(np.float32)).bfloat16().float()
              .numpy() for _ in range(4)]
    q, k, v, dout = arrays
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    dout[np.broadcast_to(mask[:, None, :, None], dout.shape)] = 0.0
    return q, k, v, dout, mask


def _rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("t,lens", [(256, (256, 100)), (300, (300, 137))])
def test_bf16_d256_op_matches_jax_tpu_kernel(t, lens):
    q, k, v, dout, mask = _inputs(t, lens, seed=t + 21)
    jdout = jnp.asarray(dout, jnp.bfloat16).astype(jnp.float32)

    def loss(q, k, v):
        out = jax_flash_mha(q, k, v, jnp.asarray(mask), SCALE)
        return jnp.sum(out.astype(jnp.float32) * jdout), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), jgrads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    jgrads = [np.asarray(g.astype(jnp.float32)) for g in jgrads]

    counts = tuple(getattr(fm, c) for c in fm.COUNTERS)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = fm.flash_mha(tq, tk, tv, torch.from_numpy(mask), SCALE)
    out.backward(torch.from_numpy(dout).bfloat16())
    assert tuple(getattr(fm, c) for c in fm.COUNTERS) == counts
    assert out.dtype == tq.grad.dtype == torch.bfloat16
    out = out.detach().float().numpy()
    dq, dk, dv = (x.grad.float().numpy() for x in (tq, tk, tv))
    rows = list(enumerate(lens))  # out and dq at the valid query rows
    assert max(np.abs(out[i, :, :n] - ref[i, :, :n]).max()
               for i, n in rows) <= OUT_REL * np.abs(ref).max()
    assert max(np.abs(dq[i, :, :n] - jgrads[0][i, :, :n]).max()
               for i, n in rows) <= GRAD_REL * np.abs(jgrads[0]).max()
    assert _rel(dk, jgrads[1]) <= GRAD_REL
    assert _rel(dv, jgrads[2]) <= GRAD_REL
    assert np.abs(dq).max() > 1e-2 and np.abs(dk).max() > 1e-2


# The slice: one amp-bf16 train step at one head of 256.


def test_amp_bf16_h1d256_flash_train_step_matches_jax_tpu_kernel(
        shared_masks):
    """tests/test_torch_flash_bf16.py::
    test_amp_bf16_flash_train_step_matches_jax_tpu_kernel's loss, cosine
    and attention-gradient bounds, at hidden 256 with one head."""

    def config(mod):
        base = _config(mod, hidden=D, attention_impl="flash")
        return dataclasses.replace(base, model=dataclasses.replace(
            base.model, transformer=dataclasses.replace(
                base.model.transformer, encoder_head=1, decoder_head=1)))

    jc, tc = config(jcfg), _amp(config(tcfg))
    jmodel = JaxFS2(jc.model, jc.preprocess)
    params, bn = jmodel.init(jax.random.PRNGKey(0))
    tx = make_optimizer(jc.train.optimizer, D)
    jstate = jax_create_train_state(params, bn, tx, jax.random.PRNGKey(1))
    state = create_train_state(tc, None, CPU)
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}
    load_checkpoint(state, train_state_from_jax(
        _np(params), _np(bn), _np(jstate.opt_state), 0, consts=consts))
    shared_masks(tc)
    batch = _synthetic_batch(np.random.default_rng(6), b=2)
    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = _jax_amp_loss_and_grads(jmodel, jstate.params,
                                                jstate.bn_state, jbatch)
    counts = tuple(getattr(fm, c) for c in fm.COUNTERS)
    report, grads = loss_and_grads(copy.deepcopy(state.model),
                                   stage_batch(batch, CPU), tc,
                                   state.generator)
    assert tuple(getattr(fm, c) for c in fm.COUNTERS) == counts  # plain
    wq = state.model.state_dict()["encoder.layer_stack.0.slf_attn.w_qs.weight"]
    assert wq.shape == (D, D)  # one head of 256
    loss, jloss = float(report.total), float(jloss)
    assert np.isfinite(loss) and abs(loss - jloss) <= LOSS_REL * abs(jloss)
    ref = fastspeech2_from_jax(_np(jgrads), _np(jstate.bn_state))
    names = [n for n, _ in state.model.named_parameters()]
    assert all(g.dtype == torch.float32 for g in grads)
    flat = torch.cat([g.double().flatten() for g in grads])
    jflat = torch.cat([ref[n].double().flatten() for n in names])
    cos = float(flat @ jflat / (flat.norm() * jflat.norm()))
    worst = max(float((g - ref[n]).abs().max() / ref[n].abs().max())
                for n, g in zip(names, grads)
                if "slf_attn" in n and not _zero_in_exact_arithmetic(n))
    assert cos >= GRAD_COS, cos
    assert worst <= ATTN_GRAD_REL, worst


# The kernels' design, emulated: the output's head dim in halves of 128
# columns, each half recomputing S (and dP) over all 256 columns. In the
# working dtype dt (float32 for bf16 inputs, float64 for float64), rounding
# to the inputs' dtype where the kernels round to bf16.


def _round(x, dtype, dt):
    return x.to(dtype).to(dt)


def _low(x):
    """The dtype the kernels round P and dS to: bf16, or nothing (float64
    stays float64)."""
    return torch.bfloat16 if x.dtype != torch.float64 else torch.float64


def _split_forward(q, k, v, mask, scale):
    """(out, lse, P of each half): per half the 64-key online softmax of
    csrc/flash_mha_bf16_d256.cu's forward (running max and sum of the
    unrounded P, the unnormalised P rounded before P V of the half's
    columns, O rescaled by alpha, divided by the sum at the end; wholly
    padded tiles skipped)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    low = _low(q)
    q, k, v = (x.to(dt) for x in (q, k, v))
    t = q.shape[-2]
    halves, lses, ps = [], [], []
    for c in range(D // HALF):
        cols = slice(HALF * c, HALF * (c + 1))
        m = torch.full(q.shape[:-1] + (1,), float("-inf"), dtype=dt)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape[:-1] + (HALF,), dtype=dt)
        p_all = []
        for k0 in range(0, t, TILE):
            keys = slice(k0, k0 + TILE)
            valid = ~mask[:, None, None, keys]
            if not bool(valid.any()):
                continue
            s = torch.matmul(q, k[..., keys, :].transpose(-1, -2)) * scale
            s = s.masked_fill(~valid, float("-inf"))  # S over all 256
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            shift = torch.where(torch.isfinite(m_new), m_new,
                                torch.zeros_like(m_new))
            p = torch.exp(s - shift)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.matmul(_round(p, low, dt),
                                         v[..., keys, cols])
            m = m_new
            p_all.append(p)
        halves.append(o / torch.where(l == 0, torch.ones_like(l), l))
        lses.append(torch.where(l == 0, torch.full_like(l, float("inf")),
                                m + torch.log(l)))
        ps.append(torch.cat(p_all, -1))
    return torch.cat(halves, -1), lses, ps


def _split_backward(q, k, v, mask, out, dout, lse, scale, delta_cols=None):
    """(dq, dk, dv, dS of each half): per half, P = exp(S - lse) and dP over
    all 256 columns, Δ = rowsum(dO ∘ out) over ``delta_cols`` (all columns
    by default, as the kernel's dQ block computes it), dS = P (dP - Δ);
    dq, dk, dv of the half's columns from bf16-rounded dS·scale and P^T,
    summed tile by tile in float32 (query tiles of 64 for dk, dv)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    low = _low(q)
    q, k, v, out, dout = (x.to(dt) for x in (q, k, v, out, dout))
    cols_d = slice(None) if delta_cols is None else delta_cols
    delta = (dout[..., cols_d] * out[..., cols_d]).sum(-1, keepdim=True)
    dq, dk, dv, dss = [], [], [], []
    t = q.shape[-2]
    for c in range(D // HALF):
        cols = slice(HALF * c, HALF * (c + 1))
        # Each half's own S, P, dP and dS, over all 256 columns.
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        s = s.masked_fill(mask[:, None, None, :], float("-inf"))
        p = torch.exp(s - lse)  # lse +inf for a row with no valid key
        dp = torch.matmul(dout, v.transpose(-1, -2))
        ds = p * (dp - delta)
        pr, dsr = _round(p, low, dt), _round(ds * scale, low, dt)
        dq.append(torch.matmul(dsr, k[..., cols]))
        dk_c = torch.zeros(k.shape[:-1] + (HALF,), dtype=dt)
        dv_c = torch.zeros_like(dk_c)
        for q0 in range(0, t, TILE):
            rows = slice(q0, q0 + TILE)
            dk_c = dk_c + torch.matmul(dsr[..., rows, :].transpose(-1, -2),
                                       q[..., rows, cols])
            dv_c = dv_c + torch.matmul(pr[..., rows, :].transpose(-1, -2),
                                       dout[..., rows, cols])
        dk.append(dk_c)
        dv.append(dv_c)
        dss.append(ds)
    return (torch.cat(dq, -1), torch.cat(dk, -1), torch.cat(dv, -1), dss)


def _design_inputs(dtype):
    q, k, v, dout, mask = _inputs(300, (300, 137), seed=31)
    # A row whose first 64-key tile is wholly padded, and a row of one key.
    mask = np.concatenate([mask, np.arange(300)[None] < 64,
                           np.arange(300)[None] != 299])
    q, k, v, dout = (np.concatenate([x, x[:2]]) for x in (q, k, v, dout))
    dout[np.broadcast_to(mask[:, None, :, None], dout.shape)] = 0.0
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v, dout)] + [
        torch.from_numpy(mask)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_column_split_design_matches_the_plain_versions(dtype):
    q, k, v, dout, mask = _design_inputs(dtype)
    out, lses, ps = _split_forward(q, k, v, mask, SCALE)
    # Each half's running max and sum, hence its P and LSE, the same bits.
    assert torch.equal(lses[0], lses[1])
    assert all(torch.equal(p, ps[0]) for p in ps[1:])
    ref = fm.flash_mha_blocked_plain(q, k, v, mask, SCALE, TILE)
    exact = dtype == torch.float64
    bound = EXACT_REL if exact else OUT_REL
    assert _rel(out.to(dtype).double(), ref.double()) <= bound
    lse = lses[0]
    lse_ref = fm.flash_mha_lse_plain(q, k, mask, SCALE)[..., None]
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isposinf(lse), ~finite)
    assert _rel(lse[finite], lse_ref[finite].double()) <= (
        EXACT_REL if exact else 1e-6)

    o = out.to(dtype)
    *grads, dss = _split_backward(q, k, v, mask, o, dout, lse, SCALE)
    assert all(torch.equal(ds, dss[0]) for ds in dss[1:])
    refs = fm.flash_mha_bwd_plain(q, k, v, mask, o, dout, SCALE)
    bound = EXACT_REL if exact else GRAD_REL
    for g, r in zip(grads, refs):
        for c in range(D // HALF):  # each half against the plain columns
            cols = slice(HALF * c, HALF * (c + 1))
            assert _rel(g[..., cols].to(dtype).double(),
                        r[..., cols].double()) <= bound
    for i in (2, 3):  # rows of padded keys: dk, dv exactly 0 there
        for g in grads[1:]:
            assert torch.count_nonzero(g[i][..., mask[i], :]) == 0
    # Δ must come from the whole row: over one half's columns dq is off by
    # more than four times the bf16 bound.
    wrong = _split_backward(q, k, v, mask, o, dout, lse, SCALE,
                            delta_cols=slice(0, HALF))
    assert (_rel(wrong[0].to(dtype).double(), refs[0].double())
            > 4 * GRAD_REL)
