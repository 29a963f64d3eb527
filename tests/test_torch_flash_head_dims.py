"""Flash attention at head dims other than 128, on the CPU.

The JAX package's ``flash_mha`` hands any head dim to JAX's TPU kernel,
which takes D < 128 and the multiples of 128 (JAX 0.9.0
``flash_attention.py:455-462``). The port's kernels take D ≤ 128 in both
dtypes (zero-padded to the D = 128 kernels: ``through_padding``) and D = 256
in float32 (the forward ``csrc/flash_mha_d256.cu`` and the backward
``csrc/flash_mha_bwd_d256.cu``, both on the TF32 tensor cores in clusters of
two blocks) and in bf16 (``csrc/flash_mha_bf16_d256.cu``;
tests/test_torch_flash_bf16_d256.py).
Here, with the
JAX kernel in Pallas interpret mode and the port's plain versions standing
in for its kernels on CPU tensors:

* ``flash_mha`` and its gradient at D = 256 (one head) and D = 64 (two
  heads), B = 2, ragged T = 300, dO zero at padded query rows: out and dq
  at the valid rows, dk and dv at every row, within 1e-5 (float32); in
  bf16 at D = 64 within 2⁻⁷ (out) and 2⁻⁶ (gradients) of max|ref|;
* the pad-and-slice helper around the plain versions equals them bit for
  bit at D = 64, forward and backward, in both dtypes;
* ``supported``: JAX's rule (D % 128 == 0, T > 2048, on the card) where the
  port has a kernel for the head dim and dtype;
* the D = 256 kernels' arithmetic emulated against float64 with the
  card's bounds: the forward (``csrc/flash_mha_d256.cu``: 3xTF32 products
  on operands split by bit masks, S as two blocks' partials over 128
  columns each, in chains of 64 columns, added in rank order; 32-key
  tiles, wholly padded tiles skipped, the row sum over the four threads
  that share a row, each block's P·V per tile in a fresh accumulator) and
  the backward pair (``csrc/flash_mha_bwd_d256.cu``: the same split, S and
  dP in chains of 32 columns; Δ formed as dP is, the diagonal of dO outᵀ;
  the dK/dV kernel's swapped chain order giving Sᵀ and dPᵀ bit for bit),
  with a row of one valid key whose output is v's TF32 parts' sum and
  whose dq and dk are exactly 0, where float32 plain leaves round-off;
  both emulations against the JAX TPU kernel at the valid rows, the
  forward's one-key row exact on small-integer v;
* the slice: FastSpeech2 at hidden 256 with one head (D = 256), 1 encoder
  and 1 decoder block, under ``attention_impl="flash"``: a long-form
  synthesis and one train step's loss and gradients against the JAX
  package's through its TPU kernel; the head count changes no parameter
  shape at ``Config()`` width, and ``fastspeech2_from_jax`` at one head
  loads with ``strict=True``.

The CUDA kernels' own tests are in tests/test_torch_kernels_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu.interop.torch_ckpt import (
    convert_fastspeech2,
)
from expressive_fastspeech2_mandarin_tpu.models import FastSpeech2 as JaxFS2
from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu.synth import (
    Synthesizer as JaxSynthesizer,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    create_train_state as jax_create_train_state,
    fastspeech2_loss as jax_loss,
    make_optimizer,
)
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    fastspeech2_from_jax,
    train_state_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import FastSpeech2
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm
from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
    loss_and_grads,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
    load_checkpoint,
)

from .test_torch_train import (  # noqa: F401  (shared_masks: a fixture)
    CPU,
    LOSS_RTOL,
    _assert_grads,
    _config,
    _named_grads,
    _np,
    shared_masks,
)
from .test_train import _synthetic_batch

torch.set_num_threads(2)
ATOL = 1e-5
OUT_REL = 2.0 ** -7    # tests/test_torch_flash_bf16.py
GRAD_REL = 2.0 ** -6
FWD_REL = 1e-5         # chip_smoke.py: FLASH_REL_BOUND, LSE_REL_BOUND
BWD_REL = 1e-4         # chip_smoke.py: FLASH_BWD_REL_BOUND
KEY_TILE = 32          # csrc/flash_mha_d256.cu: kBk (the forward's key tile)
ROW_THREADS = 4        # csrc/flash_mha_d256.cu: the threads that share a row
# kCols (head-dim columns a block of either cluster holds); the forward's
# S chains of 8 k-steps (64 columns, flash_mha_d256.cu: scores), the
# backward's of kChain = 4 (csrc/tf32_flash_bwd.cuh); kTile (the dQ
# kernel's key tile, the dK/dV kernel's query tile).
CHUNK, FWD_CHAIN_COLS, CHAIN_COLS, STREAM_TILE = 128, 64, 32, 32


@pytest.fixture(scope="module", autouse=True)
def settled_torch():
    """In some fresh processes the first float32 ``torch.exp`` of a
    thread runs in oneMKL's low-accuracy EP mode (torch's CPU build links
    oneMKL; up to 1e-4 off, every later call exact; PERF.md §7,
    reports/first_exp/first_exp_probe.py). One plain forward at the
    tested shape, discarded, keeps the comparisons below off that first
    call."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1, 300, 256)).astype(np.float32))
    fm.flash_mha_plain(x, x, x, torch.zeros(2, 300, dtype=torch.bool),
                       256 ** -0.5)


def _inputs(t, lens, h, d, seed, bf16=False):
    """q, k, v, dO (B, H, T, D) float32 numpy (bf16 values for ``bf16``),
    the (B, T) key mask; dO is zero at padded query rows."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    arrays = [rng.normal(size=(b, h, t, d)).astype(np.float32)
              for _ in range(4)]
    if bf16:
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    q, k, v, dout = arrays
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    dout[np.broadcast_to(mask[:, None, :, None], dout.shape)] = 0.0
    return q, k, v, dout, mask


def _jax_out_and_grads(q, k, v, dout, mask, scale, dtype):
    jdout = jnp.asarray(dout, dtype).astype(jnp.float32)

    def loss(q, k, v):
        out = jax_flash_mha(q, k, v, jnp.asarray(mask), scale)
        return jnp.sum(out.astype(jnp.float32) * jdout), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_out_and_grads(q, k, v, dout, mask, scale, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = fm.flash_mha(tq, tk, tv, torch.from_numpy(mask), scale)
    out.backward(torch.from_numpy(dout).to(dtype))
    assert out.dtype == tq.grad.dtype == dtype
    return [x.detach().float().numpy()
            for x in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("h,d", [(1, 256), (2, 64)])
def test_flash_mha_and_gradient_match_jax_tpu_kernel(h, d):
    lens = (300, 137)
    q, k, v, dout, mask = _inputs(300, lens, h, d, seed=d)
    scale = d ** -0.5
    ref = _jax_out_and_grads(q, k, v, dout, mask, scale, jnp.float32)
    got = _port_out_and_grads(q, k, v, dout, mask, scale, torch.float32)
    for a, r in zip(got[:2], ref[:2]):  # out, dq: the valid query rows
        for i, n in enumerate(lens):
            np.testing.assert_allclose(a[i, :, :n], r[i, :, :n], atol=ATOL,
                                       rtol=0)
    for a, r in zip(got[2:], ref[2:]):  # dk, dv: every row
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=0)
    assert all(np.abs(g).max() > 1e-2 for g in got[1:])


def test_bf16_flash_mha_and_gradient_match_jax_tpu_kernel_at_d64():
    lens = (300, 137)
    q, k, v, dout, mask = _inputs(300, lens, 2, 64, seed=5, bf16=True)
    scale = 64 ** -0.5
    ref = _jax_out_and_grads(q, k, v, dout, mask, scale, jnp.bfloat16)
    got = _port_out_and_grads(q, k, v, dout, mask, scale, torch.bfloat16)
    for idx, bound in ((0, OUT_REL), (1, GRAD_REL)):  # valid query rows
        worst = max(np.abs(got[idx][i, :, :n] - ref[idx][i, :, :n]).max()
                    for i, n in enumerate(lens))
        assert worst <= bound * np.abs(ref[idx]).max()
    for idx in (2, 3):
        assert (np.abs(got[idx] - ref[idx]).max()
                <= GRAD_REL * np.abs(ref[idx]).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_to_128_is_exact_around_the_plain_versions(dtype):
    q, k, v, dout, mask = (torch.from_numpy(a) for a in _inputs(
        200, (200, 61), 2, 64, seed=9))
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    scale = 64 ** -0.5
    forwards = [fm.flash_mha_plain]
    if dtype == torch.bfloat16:
        forwards.append(lambda *a: fm.flash_mha_blocked_plain(
            *a, fm.JAX_BLOCK))
    for fwd in forwards:
        out = fwd(q, k, v, mask, scale)
        padded = fm.through_padding(fwd, q, k, v, mask, scale)
        assert padded.shape == q.shape
        assert torch.equal(padded, out)
    grads = fm.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
    padded = fm.through_padding(fm.flash_mha_bwd_plain, q, k, v, mask, out,
                                dout, scale)
    for g, p in zip(grads, padded):
        assert p.shape == q.shape and torch.equal(p, g)
    assert fm.through_padding(lambda x, m: m, q, mask) is mask


@pytest.mark.parametrize("d", [64, 128, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2048, 2049])
def test_supported_is_the_jax_rule_where_the_port_has_a_kernel(d, dtype, t):
    kernel = d in (128, 256)
    assert fm.supported(torch.device("cuda"), t, d, dtype) is (
        kernel and t > 2048)
    assert fm.supported(torch.device("cpu"), t, d, dtype) is False
    assert fm.kernel_head_dim(d, dtype) == (128 if d <= 128 else
                                            d if kernel else None)


# The D = 256 kernels' arithmetic, emulated. A float32 fused multiply-add
# is a·b + c rounded once; in float64 the product of two float32 is exact
# and the sum rounds before the cast, which differs from one rounding only
# in rare double-rounding ties.


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _row_sum(p):
    """Sum over a tile's keys (the last axis) as the forward takes it: each
    of the four threads that share a row adds its keys 8j + 2t + e (j = 0..3,
    e = 0, 1) in that order, then two xor butterflies: (s0 + s1) + (s2 +
    s3)."""
    p = np.concatenate([p, np.zeros(p.shape[:-1] + (
        KEY_TILE - p.shape[-1],), np.float32)], -1)  # past T: p = 0
    sums = []
    for t in range(ROW_THREADS):
        acc = np.zeros(p.shape[:-1], np.float32)
        for j in range(KEY_TILE // 8):
            for e in range(2):
                acc = acc + p[..., 8 * j + 2 * t + e]
        sums.append(acc)
    return (sums[0] + sums[1]) + (sums[2] + sums[3])


def _live_tiles(mask_row):
    t = mask_row.shape[0]
    return [i for i in range(0, t, KEY_TILE)
            if (~mask_row[i:i + KEY_TILE]).any()]


def emulate_forward(q, k, v, mask, scale):
    """csrc/flash_mha_d256.cu's forward on (B, H, T, 256) float32 numpy
    arrays: (out, lse). S as the cluster forms it (rows_product, chains of
    64 columns); per live 32-key tile the online softmax, the row sum as
    the kernel takes it, and each block's P·V over its 128 columns from
    TF32 parts in a fresh accumulator, added to the rescaled output with a
    fused multiply-add; the output divided by the row sum."""
    b, h, t, d = q.shape
    scale = np.float32(scale)
    out = np.zeros_like(q)
    lse = np.full((b, h, t), np.inf, np.float32)
    for i in range(b):
        s_all = rows_product(q[i], k[i], chain=FWD_CHAIN_COLS)
        o = np.zeros((h, t, d), np.float32)
        m = np.full((h, t, 1), -np.inf, np.float32)
        l = np.zeros((h, t, 1), np.float32)
        for k0 in _live_tiles(mask[i]):
            keys = slice(k0, k0 + KEY_TILE)
            s = np.where(~mask[i, keys], s_all[..., keys] * scale,
                         np.float32(-np.inf))
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            shift = np.where(m_new == -np.inf, np.float32(0), m_new)
            alpha = np.exp(m - shift)
            p = np.exp(s - shift)
            l = _fma(l, alpha, _row_sum(p)[..., None])
            m = m_new
            pv = np.concatenate([
                third_product(p, v[i][:, keys, c:c + CHUNK])
                for c in range(0, d, CHUNK)], -1)
            o = _fma(o, alpha, pv)
        out[i] = o / np.where(l == 0, np.float32(1), l)
        lse[i] = np.where(l == 0, np.float32(np.inf),
                          m + np.log(np.where(l == 0, np.float32(1),
                                              l)))[..., 0]
    return out, lse


def _tf32(x):
    """float32 rounded to TF32, to nearest with ties away from zero, by bit
    masks (csrc/tf32_wgmma.cuh: tf32_rna)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _dot(a, b):
    """a (..., n, C) · b (..., m, C) → (..., n, m): each pair's C products
    (exact in float32 for TF32 parts) summed in float32 along C. Position-
    and order-free: (a, b) and (b, a) give each other's transposes bit for
    bit, as the tensor cores do for the same operands in either role."""
    return (a[..., :, None, :] * b[..., None, :, :]).sum(-1, dtype=np.float32)


def _partial(a, b, swapped=False, chain=CHAIN_COLS):
    """One block's partial A Bᵀ (A = a, the resident rows or Q; B = b, the
    streamed tile) over its 128 columns, as the backward's rows_product
    forms S or dP (and the forward's scores S): fresh chains of ``chain``
    columns, each chain's four TF32 products (A lo into one accumulator, A
    hi into the other, each against B's hi and lo parts) added in software,
    and the chains added in order to a sum that starts at 0. The dQ kernel
    and the forward add ((lo·lo + lo·hi) + hi·lo) + hi·hi (A's part
    first); the dK/dV kernel (``swapped``), whose A is the dQ kernel's B,
    adds ((lo·lo + hi·lo) + lo·hi) + hi·hi: the same four terms in the
    same order, so its Sᵀ and dPᵀ are the dQ kernel's S and dP."""
    out = np.float32(0)
    for c0 in range(0, a.shape[-1], chain):
        (a_hi, a_lo), (b_hi, b_lo) = (_split(x[..., c0:c0 + chain])
                                      for x in (a, b))
        lo_lo, lo_hi = _dot(a_lo, b_lo), _dot(a_lo, b_hi)
        hi_lo, hi_hi = _dot(a_hi, b_lo), _dot(a_hi, b_hi)
        out = out + ((((lo_lo + hi_lo) + lo_hi) if swapped
                      else ((lo_lo + lo_hi) + hi_lo)) + hi_hi)
    return out


def rows_product(a, b, swapped=False, chain=CHAIN_COLS):
    """a · bᵀ over the head dim as the backward pair forms S and dP (with
    ``swapped``, as the dK/dV kernel forms Sᵀ and dPᵀ; with ``chain`` 64,
    as the forward forms S): each block of the cluster's partial over its
    128 columns, added in rank order (rank 0's first)."""
    total = None
    for c in range(0, a.shape[-1], CHUNK):
        part = _partial(a[..., c:c + CHUNK], b[..., c:c + CHUNK], swapped,
                        chain)
        total = part if total is None else total + part
    return total


def third_product(a, b):
    """a @ b over the streamed tile's 32 rows from TF32 parts, the small
    products first: (lo·hi + hi·lo) + hi·hi, in a fresh accumulator (the
    kernels' dq, dk and dv products; each tile's sum is added to the
    running sum)."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulate_backward(q, k, v, mask, out, dout, lse, scale):
    """csrc/flash_mha_bwd_d256.cu's dQ kernel (with Δ) and dK/dV kernel on
    (B, H, T, 256) float32 numpy arrays: (dq, dk, dv, delta)."""
    b_, h_, t_, d_ = q.shape
    scale = np.float32(scale)
    # Δ: the diagonal of dO outᵀ, formed as dP is.
    delta = np.diagonal(rows_product(dout, out), axis1=-2,
                        axis2=-1).astype(np.float32)
    dq, dk, dv = (np.zeros(q.shape, np.float32) for _ in range(3))
    for i in range(b_):
        valid = ~mask[i]
        s_all = rows_product(q[i], k[i])
        dp_all = rows_product(dout[i], v[i])
        # The dQ kernel: the live 32-key tiles, P in float32.
        acc = np.zeros((h_, t_, d_), np.float32)
        for k0 in range(0, t_, STREAM_TILE):
            keys = slice(k0, k0 + STREAM_TILE)
            if not valid[keys].any():
                continue
            p = np.where(valid[keys], np.exp(s_all[..., keys] * scale
                                             - lse[i][..., None]),
                         np.float32(0)).astype(np.float32)
            ds = p * (dp_all[..., keys] - delta[i][..., None])
            acc = acc + third_product(ds, k[i][:, keys])
        dq[i] = acc * scale
        # The dK/dV kernel: every 32-query tile; a key block of 64 whose
        # keys are all padded writes zeros, as P = 0 at a padded key gives.
        s_all = rows_product(k[i], q[i], swapped=True).swapaxes(-1, -2)
        dp_all = rows_product(v[i], dout[i], swapped=True).swapaxes(-1, -2)
        acc_k = np.zeros((h_, t_, d_), np.float32)
        acc_v = np.zeros((h_, t_, d_), np.float32)
        for r0 in range(0, t_, STREAM_TILE):
            rows = slice(r0, r0 + STREAM_TILE)
            p = np.where(valid, np.exp(s_all[:, rows] * scale
                                       - lse[i][:, rows, None]),
                         np.float32(0)).astype(np.float32)
            p_hi, p_lo = _split(p)  # read back from its staged parts
            ds = (p_hi + p_lo) * (dp_all[:, rows] - delta[i][:, rows, None])
            acc_v = acc_v + third_product(p.swapaxes(-1, -2),
                                          dout[i][:, rows])
            acc_k = acc_k + third_product(ds.swapaxes(-1, -2), q[i][:, rows])
        dk[i], dv[i] = acc_k * scale, acc_v
    return dq, dk, dv, delta


def test_d256_kernel_emulation_matches_float64_plain():
    # A row with one valid key; a row whose first tile and a middle tile
    # [96, 128) are wholly padded; random dO at every row.
    t, scale = 300, 256 ** -0.5
    rng = np.random.default_rng(11)
    q, k, v, dout = (rng.normal(size=(2, 1, t, 256)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((2, t), bool)
    mask[0, 0] = False
    mask[1, 40:96] = mask[1, 128:300] = False
    out, lse = emulate_forward(q, k, v, mask, scale)
    tq, tk, tv, tdo, tmask = (torch.from_numpy(a)
                              for a in (q, k, v, dout, mask))
    # Row 0's one valid key: P = 1 exactly, so its output is the sum of v's
    # TF32 parts (lo·hi + hi·lo + hi·hi with P's lo 0), which keeps ~22 of
    # v's 24 significant bits: held to the bound below, not to v.
    v_hi, v_lo = _split(v[0, :, :1])
    np.testing.assert_array_equal(out[0], (v_hi + v_lo).repeat(t, 1))
    ref32 = fm.flash_mha_plain(tq, tk, tv, tmask, scale)
    ref64 = fm.flash_mha_plain(tq.double(), tk.double(), tv.double(), tmask,
                               scale).numpy()
    assert np.abs(out - ref64).max() <= FWD_REL * np.abs(ref64).max()
    lse_ref = fm.flash_mha_lse_plain(tq.double(), tk.double(), tmask,
                                     scale).numpy()
    assert np.abs(lse - lse_ref).max() <= FWD_REL * np.abs(lse_ref).max()

    grads = emulate_backward(q, k, v, mask, out, dout, lse, scale)[:3]
    plain32 = fm.flash_mha_bwd_plain(tq, tk, tv, tmask, ref32, tdo, scale)
    plain64 = fm.flash_mha_bwd_plain(tq.double(), tk.double(), tv.double(),
                                     tmask, torch.from_numpy(ref64),
                                     tdo.double(), scale)
    for g, r32, r64 in zip(grads, plain32, plain64):
        r32, r64 = r32.numpy(), r64.numpy()
        top = np.abs(r64).max()
        assert np.abs(g - r64).max() <= BWD_REL * top
        assert (np.abs(g - r64).max()
                <= 2 * np.abs(r32 - r64).max() + 1e-6 * top)
    # The one-key row: dP - Δ is 0 in exact arithmetic. Δ formed as dP is
    # keeps it 0 (out's TF32 parts are v's here), so dq and dk there are
    # exactly 0; float32 plain sums Δ in another order and leaves
    # round-off.
    assert np.count_nonzero(grads[1][0]) == 0
    assert np.count_nonzero(grads[0][0]) == 0
    assert np.count_nonzero(plain32[1][0].numpy()) > 0
    # The wholly padded 32-key tiles and 64-key blocks: dk, dv exactly 0.
    for g in grads[1:]:
        assert not g[1, :, :40].any() and not g[1, :, 96:128].any()


def test_d256_bwd_swapped_chain_order_gives_the_dq_kernels_s_and_dp():
    """The dK/dV kernel forms Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with the operands'
    roles swapped; its chain order makes them the dQ kernel's S and dP bit
    for bit (so a row of one valid key has dP - Δ = 0 in both kernels),
    which the dQ kernel's own order with the roles swapped does not."""
    rng = np.random.default_rng(21)
    a, b = (rng.normal(size=(1, 96, 256)).astype(np.float32)
            for _ in range(2))
    ref = rows_product(a, b)
    assert np.array_equal(rows_product(b, a, swapped=True).swapaxes(-1, -2),
                          ref)
    assert not np.array_equal(rows_product(b, a).swapaxes(-1, -2), ref)
    # Δ, the diagonal of dO outᵀ formed as dP: equal to dP where out = v.
    assert np.array_equal(np.diagonal(rows_product(a, b[:, :1].repeat(96, 1)),
                                      axis1=-2, axis2=-1), ref[..., 0])


def test_d256_bwd_emulation_matches_jax_tpu_kernel_at_valid_rows():
    """The backward pair's emulation against ``jax.grad`` of the JAX
    package's TPU kernel in Pallas interpret mode, dO zero at padded query
    rows (as the FFT block leaves it): dq at the valid rows, dk and dv at
    every row, within 1e-5 (tests/test_torch_flash_bwd_tc.py's D = 128
    check)."""
    lens = (300, 1, 173)
    scale = 256 ** -0.5
    q, k, v, dout, mask = _inputs(300, lens, 1, 256, seed=7)
    ref = _jax_out_and_grads(q, k, v, dout, mask, scale, jnp.float32)
    out, lse = emulate_forward(q, k, v, mask, scale)
    dq, dk, dv, _ = emulate_backward(q, k, v, mask, out, dout, lse, scale)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(dq[i, :, :n], ref[1][i, :, :n], atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(dk, ref[2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv, ref[3], atol=ATOL, rtol=0)
    assert np.count_nonzero(dk[1]) == 0  # one valid key: dS = 0


def test_d256_fwd_emulation_matches_jax_tpu_kernel_at_valid_rows():
    """The forward's emulation against the JAX package's TPU kernel in
    Pallas interpret mode at the valid rows, within 1e-5 (as the D = 128
    forward's, tests/test_torch_flash_tc.py), with a row of one valid key,
    one whose first 32-key tile is wholly padded and a middle one too; and
    on small-integer v, whose TF32 lo part is 0, the one-key row exactly
    that key's v (P = 1 exactly), as phase 16a asks of the kernel."""
    t, scale = 300, 256 ** -0.5
    q, k, v, _, _ = _inputs(t, (t,), 1, 256, seed=12)
    q, k, v = (np.concatenate([x, x[::-1]]) for x in (q, k, v))
    mask = np.ones((2, t), bool)
    mask[0, 137] = False
    mask[1, 40:96] = mask[1, 128:300] = False
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash_mha(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), scale))
    out, _ = emulate_forward(q, k, v, mask, scale)
    for i in range(2):  # the valid query rows
        np.testing.assert_allclose(out[i][:, ~mask[i]], ref[i][:, ~mask[i]],
                                   atol=ATOL, rtol=0)
    assert np.abs(out[1]).max() > 0.5
    small = np.random.default_rng(13).integers(
        -8, 9, v.shape).astype(np.float32)
    out, _ = emulate_forward(q, k, small, mask, scale)
    np.testing.assert_array_equal(out[0], small[0, :, 137:138].repeat(t, 1))


# The slice: FastSpeech2 with one head of 256.


def _h1d256(mod, attention_impl: str, layers=(1, 1), **transformer):
    """``Config()``'s widths with one encoder and one decoder head (D =
    256), at ``layers`` (encoder, decoder) FFT blocks."""
    cfg = mod.Config()
    t = dataclasses.replace(
        cfg.model.transformer, encoder_head=1, decoder_head=1,
        encoder_layer=layers[0], decoder_layer=layers[1],
        attention_impl=attention_impl, **transformer)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transformer=t))


def test_one_head_changes_no_parameter_shape_at_config_width():
    h1 = FastSpeech2(_h1d256(tcfg, "auto", layers=(4, 6)).model,
                     tcfg.PreprocessConfig()).state_dict()
    h2 = FastSpeech2(tcfg.Config().model, tcfg.PreprocessConfig()
                     ).state_dict()
    assert {n: x.shape for n, x in h1.items()} == {
        n: x.shape for n, x in h2.items()}
    assert sum(x.numel() for x in h1.values()) == sum(
        x.numel() for x in h2.values())


def test_fastspeech2_from_jax_at_one_head_loads_strict():
    cfg = _h1d256(jcfg, "flash")
    jmodel = JaxFS2(cfg.model, cfg.preprocess)
    params, bn = jmodel.init(jax.random.PRNGKey(0))
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}
    tc = _h1d256(tcfg, "flash")
    model = FastSpeech2(tc.model, tc.preprocess)
    model.load_state_dict(fastspeech2_from_jax(_np(params), _np(bn), consts),
                          strict=True)
    wq = model.state_dict()["encoder.layer_stack.0.slf_attn.w_qs.weight"]
    assert wq.shape == (256, 256)


LONG = "{" + " ".join(["b a n h ao sh i j ie n i h ao"] * 2) + "}"
SHORT = "{n i h ao sh i j ie}"
MAX_MEL = 320
DURATION_BIAS = 2.75  # ≈ 16.5 frames a phone


def test_h1d256_synthesis_under_flash_matches_jax_tpu_kernel():
    cfg = _h1d256(tcfg, "flash")
    torch.manual_seed(0)
    fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += (
        DURATION_BIAS)
    params, bn_state, consts = convert_fastspeech2(
        {k: v.numpy() for k, v in fs2.items()})
    port = Synthesizer(cfg, fs2, device="cpu")
    res = port.synthesize([LONG, SHORT], vocoder="none", max_mel_len=MAX_MEL)
    jsynth = JaxSynthesizer(_h1d256(jcfg, "flash"), params, bn_state,
                            consts_override=consts)
    with pltpu.force_tpu_interpret_mode():
        ref = jsynth.synthesize([LONG, SHORT], vocoder="none",
                                max_mel_len=MAX_MEL)
    lens = [r.mel.shape[0] for r in res]
    assert 128 < lens[0] <= MAX_MEL and lens[1] < lens[0]
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.durations, b.durations)
        assert a.mel.shape == b.mel.shape and np.isfinite(a.mel).all()
        assert np.abs(a.mel - b.mel).max() < 1e-4  # test_torch_longform


def test_h1d256_train_step_under_flash_matches_jax_tpu_kernel(shared_masks):
    """test_torch_train.py::test_flash_train_step_matches_jax_tpu_kernel's
    bounds, at one head of 256 (its toy configuration at hidden 256)."""
    def config(mod):
        base = _config(mod, hidden=256, attention_impl="flash")
        return dataclasses.replace(base, model=dataclasses.replace(
            base.model, transformer=dataclasses.replace(
                base.model.transformer, encoder_head=1, decoder_head=1)))

    jc, tc = config(jcfg), config(tcfg)
    jmodel = JaxFS2(jc.model, jc.preprocess)
    params, bn = jmodel.init(jax.random.PRNGKey(0))
    tx = make_optimizer(jc.train.optimizer, 256)
    jstate = jax_create_train_state(params, bn, tx, jax.random.PRNGKey(1))
    state = create_train_state(tc, None, CPU)
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}
    load_checkpoint(state, train_state_from_jax(
        _np(params), _np(bn), _np(jstate.opt_state), 0, consts=consts))
    shared_masks(tc)
    batch = _synthetic_batch(np.random.default_rng(6), b=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):  # the loss of _jax_grads (train/step.py:171-199)
        out, _ = jmodel.apply(
            p, jstate.bn_state, jbatch["speakers"], jbatch["emotions"],
            jbatch["arousals"], jbatch["valences"], jbatch["texts"],
            jbatch["src_lens"], max_mel_len=jbatch["mels"].shape[1],
            mel_lens=jbatch["mel_lens"], p_targets=jbatch["pitches"],
            e_targets=jbatch["energies"], d_targets=jbatch["durations"],
            deterministic=False, rng=jax.random.PRNGKey(2))
        return jax_loss(out, jbatch["mels"], jbatch["pitches"],
                        jbatch["energies"], jbatch["durations"]).total

    with pltpu.force_tpu_interpret_mode():
        jtotal, jgrads = jax.value_and_grad(jloss)(jstate.params)
    report, grads = loss_and_grads(state.model, stage_batch(batch, CPU), tc,
                                   state.generator)
    _assert_grads(_named_grads(state.model, grads), jgrads, jstate.bn_state)
    np.testing.assert_allclose(float(report.total), float(jtotal),
                               rtol=LOSS_RTOL)
