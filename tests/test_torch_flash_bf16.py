"""The port's flash attention in bf16 against the JAX package's, on the CPU.

The JAX package's bf16 mixed-precision step feeds its TPU flash kernel bf16
q, k, v (``train/step.py:52-60``); the kernel rounds P to bf16 before P·V,
Pᵀ and dS·sm_scale to bf16 before their products, and stores its outputs in
bf16. On CPU tensors the port runs its plain versions, which round at the
same points (the CUDA kernels' own tests are in
tests/test_torch_kernels_gpu.py).

* ``flash_mha`` on bf16 inputs against the JAX ``flash_mha`` (the stock TPU
  Pallas kernel, interpret mode) at (2, 2, T, 128), T ∈ {256, 640}, ragged
  key lengths, dO zero at padded query rows (the FFT block's masked_fill):
  out within 2⁻⁷·max|ref| and dq within 2⁻⁶·max|g| at the valid query rows,
  dk and dv within 2⁻⁶·max|g| at every row. Measured: out 4.3e-3 and
  3.6e-3 (about one bf16 ulp of the largest value), dq 4.4e-3 and 1.5e-3,
  dk 4.4e-3 and 2.1e-3, dv 1.0e-3 and 2.0e-3.
* The CPU "flash" forward on bf16 inputs (``flash_mha_blocked_plain`` on
  the TPU kernel's 128-key blocks) against the TPU kernel: at least 99 %
  of the output elements bit-equal in bf16 (rounding the normalised
  probabilities, as the math path does, leaves about half); the blocked
  version in float64 is the softmax.
* The plain versions' bf16 rounding points, and float32 unchanged.
* One amp-bf16 train step under ``attention_impl="flash"`` at hidden 256
  (two heads of 128) against the JAX step under ``amp_dtype="bfloat16"``
  through the TPU kernel in interpret mode, with the same dropout masks.
* The port's amp-bf16 "flash" tracking its amp-bf16 "xla" over 25 steps,
  within ``test_amp_bf16_tracks_float32``'s bounds.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    fastspeech2_loss as jax_loss,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
    loss_and_grads,
    train_step,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch

from .test_torch_train import (  # noqa: F401  (shared_masks: a fixture)
    CPU,
    _both,
    _config,
    _np,
    _zero_in_exact_arithmetic,
    shared_masks,
)
from .test_train import _synthetic_batch

torch.set_num_threads(2)
SCALE = 128 ** -0.5
OUT_REL = 2.0 ** -7
GRAD_REL = 2.0 ** -6


def _inputs(t: int, lens, seed: int):
    """bf16 q, k, v, dO (as float32 numpy arrays of bf16 values) and the key
    mask; dO is zero at padded query rows."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    arrays = [rng.normal(size=(b, 2, t, 128)).astype(np.float32)
              for _ in range(4)]
    q, k, v, dout = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in arrays)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    dout[mask[:, None, :, None].repeat(2, 1).repeat(128, 3)] = 0.0
    return q, k, v, dout, mask


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("t,lens", [(256, (256, 100)), (640, (640, 333))])
def test_bf16_op_matches_jax_tpu_kernel(t, lens):
    q, k, v, dout, mask = _inputs(t, lens, seed=t)
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

    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = fm.flash_mha(tq, tk, tv, torch.from_numpy(mask), SCALE)
    out.backward(torch.from_numpy(dout).bfloat16())
    assert out.dtype == tq.grad.dtype == torch.bfloat16
    out = out.detach().float().numpy()
    dq, dk, dv = (x.grad.float().numpy() for x in (tq, tk, tv))
    rows = [(i, n) for i, n in enumerate(lens)]
    assert max(np.abs(out[i, :, :n] - ref[i, :, :n]).max()
               for i, n in rows) <= OUT_REL * np.abs(ref).max()
    assert max(np.abs(dq[i, :, :n] - jgrads[0][i, :, :n]).max()
               for i, n in rows) <= GRAD_REL * np.abs(jgrads[0]).max()
    assert _rel(dk, jgrads[1]) <= GRAD_REL
    assert _rel(dv, jgrads[2]) <= GRAD_REL
    assert np.abs(dq).max() > 1e-2 and np.abs(dk).max() > 1e-2


# The CPU "flash" forward on bf16 inputs against the TPU kernel: the share
# of output elements (valid query rows) equal in bf16 bit for bit. The TPU
# kernel rounds the unnormalised p of each 128-key block to bf16 before
# P·V (flash_attention.py:447, :473-474); rounding the normalised
# probabilities instead, as the math path does, leaves about half of the
# elements one bf16 ulp off (measured 0.511, 0.516, 0.511 at T = 256, 300,
# 640); the blocked plain version on the TPU kernel's blocks leaves 0.999,
# 0.999, 0.998 equal, the rest within float32 sums in another order.
FLASH_BF16_EQUAL_SHARE = 0.99


@pytest.mark.parametrize("t,lens", [(256, (256, 100)), (300, (300, 171)),
                                    (640, (640, 333))])
def test_bf16_cpu_flash_rounds_p_where_the_tpu_kernel_does(t, lens):
    q, k, v, _, mask = _inputs(t, lens, seed=t)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_mha(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (q, k, v)), jnp.asarray(mask), SCALE)
    ref = np.asarray(ref.astype(jnp.float32))
    out = fm.flash_mha(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                       torch.from_numpy(mask), SCALE)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    rows = [(i, n) for i, n in enumerate(lens)]
    equal = (sum(int((out[i, :, :n] == ref[i, :, :n]).sum()) for i, n in rows)
             / sum(out[i, :, :n].size for i, n in rows))
    assert equal >= FLASH_BF16_EQUAL_SHARE, equal
    assert max(np.abs(out[i, :, :n] - ref[i, :, :n]).max()
               for i, n in rows) <= OUT_REL * np.abs(ref).max()


@pytest.mark.parametrize("block", [64, 128])
def test_blocked_plain_is_the_softmax_in_exact_arithmetic(block):
    """flash_mha_blocked_plain on float64 inputs is the masked softmax
    attention (no rounding to undo), for blocks wholly padded at the start
    of a row (and, at 64 keys, in its middle), a row of one valid key and
    one of none; on bf16 inputs it rounds p per block, and its output is
    bf16."""
    t = 300
    rng = np.random.default_rng(block)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 2, t, 128)))
               for _ in range(3))
    mask = torch.ones(4, t, dtype=torch.bool)
    mask[0, 140:150] = False  # keys [0, 128) and [192, 256) padded
    mask[0, 270:300] = False
    mask[1, :] = False
    mask[2, 299] = False
    out = fm.flash_mha_blocked_plain(q, k, v, mask, SCALE, block)
    ref = fm.flash_mha_plain(q, k, v, mask, SCALE)
    assert out.dtype == torch.float64
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert torch.count_nonzero(out[3]) == 0
    low = fm.flash_mha_blocked_plain(*(x.bfloat16() for x in (q, k, v)),
                                     mask, SCALE, block)
    assert low.dtype == torch.bfloat16
    assert (low.double() - ref).abs().max() <= OUT_REL * ref.abs().max()


def test_bf16_plain_rounds_where_the_tpu_kernel_does():
    """flash_mha_plain (the math path: the normalised P rounded) and
    flash_mha_bwd_plain (the TPU kernel's points) on bf16 inputs against
    the formulas with those bf16 roundings, written out in float64; on
    float32 inputs the same calls are bit for bit the float32 formulas,
    unrounded."""
    lens = (40, 0, 17)
    q, k, v, dout, mask = _inputs(40, lens, seed=5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tmask = torch.from_numpy(mask)

    def bf16(x):
        return x.to(torch.bfloat16).double()

    d = [x.double() for x in (tq, tk, tv, tdo)]
    s = (d[0] @ d[1].transpose(-1, -2) * SCALE).masked_fill(
        tmask[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out_ref = bf16(bf16(p) @ d[2])
    args = [x.bfloat16() for x in (tq, tk, tv)]
    out = fm.flash_mha_plain(*args, tmask, SCALE)
    assert out.dtype == torch.bfloat16
    assert (out.double() - out_ref).abs().max() <= OUT_REL * out_ref.abs().max()

    dp = d[3] @ d[2].transpose(-1, -2)
    ds = bf16(p * (dp - (d[3] * out.double()).sum(-1, keepdim=True)) * SCALE)
    refs = (bf16(ds @ d[1]), bf16(ds.transpose(-1, -2) @ d[0]),
            bf16(bf16(p).transpose(-1, -2) @ d[3]))
    grads = fm.flash_mha_bwd_plain(*args, tmask, out, tdo.bfloat16(), SCALE)
    for g, r in zip(grads, refs):
        assert g.dtype == torch.bfloat16
        assert (g.double() - r).abs().max() <= GRAD_REL * r.abs().max()
        assert torch.count_nonzero(g[1]) == 0  # the row of length 0

    # float32: the formulas of the float32 kernels' reference, unchanged.
    out32 = fm.flash_mha_plain(tq, tk, tv, tmask, SCALE)
    p32 = fm._probabilities(tq, tk, tmask, SCALE, torch.float32)
    assert torch.equal(out32, p32 @ tv)
    g32 = fm.flash_mha_bwd_plain(tq, tk, tv, tmask, out32, tdo, SCALE)
    ds32 = p32 * (tdo @ tv.transpose(-1, -2)
                  - (tdo * out32).sum(-1, keepdim=True))
    for g, r in zip(g32, (ds32 @ tk * SCALE,
                          ds32.transpose(-1, -2) @ tq * SCALE,
                          p32.transpose(-1, -2) @ tdo)):
        assert torch.equal(g, r)


def test_bf16_cpu_gradient_is_the_plain_backward_without_launches():
    lens = (40, 9)
    q, k, v, dout, mask = _inputs(40, lens, seed=2)
    counts = (fm.bf16_launch_count, fm.bf16_bwd_dq_launch_count,
              fm.bf16_bwd_dkv_launch_count, fm.launch_count,
              fm.bwd_dq_launch_count, fm.bwd_dkv_launch_count)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(dout).bfloat16()
    out = fm.flash_mha(tq, tk, tv, tmask, SCALE)
    out.backward(tdo)
    assert (fm.bf16_launch_count, fm.bf16_bwd_dq_launch_count,
            fm.bf16_bwd_dkv_launch_count, fm.launch_count,
            fm.bwd_dq_launch_count, fm.bwd_dkv_launch_count) == counts
    args = [x.detach() for x in (tq, tk, tv)]
    assert torch.equal(out.detach(), fm.flash_mha_blocked_plain(
        *args, tmask, SCALE, fm.JAX_BLOCK))
    ref = fm.flash_mha_bwd_plain(*args, tmask, out.detach(), tdo, SCALE)
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        assert torch.equal(g, r)


def _amp(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, amp_dtype="bfloat16"))


# One amp-bf16 step, port against JAX (the JAX loss and gradient jitted, as
# make_train_step is: its loss equals the step's report bit for bit). bf16
# rounds at other points in XLA's and PyTorch's layers, so the float32
# master gradients part by bf16 noise everywhere (up to half of max|g| in
# the energy predictor's last conv); what is held: the loss within LOSS_REL
# (measured 4.1e-4; the port's own bf16-vs-float32 first-step bound is 5 %,
# tests/test_torch_train.py:test_amp_bf16_tracks_float32), the cosine of
# the whole gradient at least GRAD_COS (measured 0.9942), and each
# attention projection's gradient, which the flash backward forms, within
# ATTN_GRAD_REL · max|g| of its tensor (measured 0.134).
LOSS_REL = 1e-3
GRAD_COS = 0.98
ATTN_GRAD_REL = 0.25


def _jax_amp_loss_and_grads(jmodel, params, bn, batch):
    """The loss of make_train_step under amp_dtype="bfloat16" and its
    gradient (train/step.py:52-80: the float32 masters cast to bf16 inside
    the differentiated function)."""

    def loss_fn(p):
        p = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x, p)
        out, _ = jmodel.apply(
            p, bn, batch["speakers"], batch["emotions"], batch["arousals"],
            batch["valences"], batch["texts"], batch["src_lens"],
            max_mel_len=batch["mels"].shape[1], mel_lens=batch["mel_lens"],
            p_targets=batch["pitches"], e_targets=batch["energies"],
            d_targets=batch["durations"], deterministic=False,
            rng=jax.random.PRNGKey(2))
        return jax_loss(out, batch["mels"], batch["pitches"],
                        batch["energies"], batch["durations"]).total

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def test_amp_bf16_flash_train_step_matches_jax_tpu_kernel(shared_masks):
    _, tc, jmodel, _, jstate, state = _both("flash", hidden=256)
    tc = _amp(tc)
    shared_masks(tc)
    batch = _synthetic_batch(np.random.default_rng(6), b=2)
    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = _jax_amp_loss_and_grads(jmodel, jstate.params,
                                                jstate.bn_state, jbatch)
    counts = (fm.bf16_launch_count, fm.launch_count)
    report, grads = loss_and_grads(copy.deepcopy(state.model),
                                   stage_batch(batch, CPU), tc,
                                   state.generator)
    assert (fm.bf16_launch_count, fm.launch_count) == counts  # CPU: plain
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


def test_amp_bf16_flash_tracks_amp_bf16_xla():
    """amp-bf16 "flash" against amp-bf16 "xla" on the CPU (the plain
    backward with the TPU kernel's rounding points against autograd of the
    math path): same data, init and dropout draws, 25 steps, with the
    bounds of test_amp_bf16_tracks_float32: the first losses within 5 %,
    each run's loss falling by 10 %, and the last losses within 8 %. At
    warm-up 10 the two trajectories part by float round-off (their first
    gradients have a cosine of 1 - 7e-8), and how far by step 25 depends
    on the init: 0.15-11.5 % over init seeds 0-5, as bf16 "xla" against
    float32 "xla" (0.2-12.6 %; test_amp_bf16_tracks_float32 pins seed 0,
    where that pair is 0.2 % apart and this one 10.5 %). So the last losses
    are held on their mean over seeds 0-5 (measured 4.9 %)."""
    base = _config(tcfg)
    batch = stage_batch(_synthetic_batch(np.random.default_rng(3)), CPU)

    def run(seed, impl):
        c = _amp(dataclasses.replace(
            base, train=dataclasses.replace(base.train, seed=seed),
            model=dataclasses.replace(base.model, transformer=dataclasses
                                      .replace(base.model.transformer,
                                               attention_impl=impl))))
        state = create_train_state(c, None, CPU)
        losses = [float(train_step(state, batch, c).total)
                  for _ in range(25)]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
        return losses

    gaps = []
    for seed in range(6):
        xla, flash = run(seed, "xla"), run(seed, "flash")
        assert abs(flash[0] - xla[0]) < 0.05 * abs(xla[0]), (xla[0], flash[0])
        gaps.append(abs(flash[-1] - xla[-1]) / abs(xla[-1]))
    assert np.mean(gaps) < 0.08, gaps
