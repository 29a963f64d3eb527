"""The float32 MRF kernel's layout and arithmetic, emulated on the CPU.

The float32 kernel of ``csrc/mrf_resblock.cu`` (``mrf_conv_f32_tc_kernel``)
is an implicit GEMM on the TF32 tensor cores at float32 accuracy: every
operand x is split into hi = rna(x) and lo = rna(x - hi) (TF32, 10
explicit mantissa bits, the low 13 bits of the float32 zero) and each
product a·b becomes lo·hi + hi·lo + hi·hi (3xTF32). ``emulate_conv`` below
mirrors a launch: 128-row time blocks whose input rows (the halo
included) are staged leaky-ReLU'd and split as [channel group of 4][row]
[4]; the weights from ``pack_mrf_weights_tf32``'s image, one (hi, lo) slab
per (N tile, chunk of KC channels, tap); every wgmma operand gathered
through the kernel's descriptor arithmetic (LBO one channel group, SBO 8
rows, tap j j·d rows further); per k-step of 8 channels the three products
into the chain, each wgmma rounding its sum toward zero as the tensor
cores do, a chain closed every ``kF32ChainSteps`` k-steps (the source's
constant) and at the end of a chunk; the chains summed in float32; bias
and residual in float32; rows >= T dropped. It is held against
``mrf_resblock_plain`` in float64 and against the JAX package's
``apply_resblock`` on the same numpy-seeded inputs at 2e-5 (the bound of
tests/test_torch_mrf_pack.py), for every (BN, KC) tile the kernel takes
and at the longest K it takes at C = 32 and 64; one TF32 product misses
that bound, which is why the kernel takes three. The shared-memory plan
(KC and ring stages for a halo) is read from the source.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
    apply_resblock,
    init_resblock,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

from .ring_model import source_int

torch.set_num_threads(2)
DIL = (1, 3, 5)
BOUND = 2e-5
ROWS = 128  # time rows a block
# (C, K, T) as tests/test_torch_mrf_pack.py: BN = 128 (C = 256), 64, 32
# (C = 32 and the three-chunk C = 96); a T that is not a multiple of the
# 128-row block; a T shorter than the halo (pad 25 at K = 11, d = 5).
SHAPES = [(256, 3, 150), (128, 7, 300), (64, 11, 130), (32, 11, 20),
          (96, 3, 200), (32, 3, 1)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _round_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 → float32, rounded toward zero: the low 29 of float64's 52
    mantissa bits cleared, which leaves float32's 23 (exact in the range
    of normal float32 values)."""
    return (v.view(torch.int64) & ~((1 << 29) - 1)).view(torch.float64).float()


def _a_index(a_stride: int, tap_rows: int, ks: int) -> torch.Tensor:
    """(128, 8) float offsets of a k-step's A operand (both warpgroups'
    64-row halves) in one part of a staged buffer [KC/4][a_stride][4]:
    the descriptor starts ``tap_rows`` rows and 2·ks groups in; element
    (m, k) lies in core matrix k // 4 along K (LBO: a_stride rows) and
    m // 8 along M (SBO: 8 rows), at row m % 8 and column k % 4."""
    m = torch.arange(ROWS)[:, None]
    k = torch.arange(8)[None, :]
    byte = ((2 * ks + k // 4) * a_stride * 16 + (m // 8) * 128
            + (m % 8) * 16 + tap_rows * 16 + (k % 4) * 4)
    return byte // 4


def _b_index(bn: int, ks: int) -> torch.Tensor:
    """(8, BN) float offsets of a k-step's B operand in one part of a slab
    [KC/4][BN][4] (LBO BN · 16 bytes, SBO 128)."""
    k = torch.arange(8)[:, None]
    n = torch.arange(bn)[None, :]
    byte = ((2 * ks + k // 4) * bn * 16 + (n // 8) * 128 + (n % 8) * 16
            + (k % 4) * 4)
    return byte // 4


def emulate_conv(x, packed, bias, k, d, kc, res=None, products=3,
                 chain_steps=None):
    """[res +] conv_{k,d}(lrelu(x)) + bias on (B, T, C) float32 as the
    kernel computes it from ``packed`` (``pack_mrf_weights_tf32``'s image)
    with KC = ``kc``; ``products`` 1 takes hi·hi alone. A chain holds at
    most ``chain_steps`` k-steps (the source's ``kF32ChainSteps`` unless
    given). The 128-row blocks (and the N tiles) are independent, so they
    run side by side here."""
    chain_taps = (chain_steps or _const("kF32ChainSteps")) // (kc // 8)
    b, t, c = x.shape
    n_tiles, _, _, _, bn, _ = packed.shape
    pad = (k - 1) // 2 * d
    rows = ROWS + 2 * pad
    a_stride = rows | 1
    n_blocks = -(-t // ROWS)
    # Block i stages rows [128 i - pad, 128 i + 128 + pad), zero outside
    # [0, T): (blocks * B, rows, C).
    act = F.pad(F.leaky_relu(x, 0.1), (0, 0, pad, n_blocks * ROWS - t + pad))
    staged = torch.stack([act[:, i * ROWS:i * ROWS + rows]
                          for i in range(n_blocks)]).reshape(-1, rows, c)
    acc = torch.zeros(n_blocks * b, ROWS, c)
    for ck in range(c // kc):
        # The chunk's two parts as the kernel stores them, flat.
        parts = []
        for part in mrf.split_tf32(staged[..., ck * kc:(ck + 1) * kc]):
            buf = torch.zeros(n_blocks * b, kc // 4, a_stride, 4)
            buf[:, :, :rows] = part.reshape(-1, rows, kc // 4, 4).permute(
                0, 2, 1, 3)
            parts.append(buf.reshape(n_blocks * b, -1).double())
        a_hi, a_lo = parts
        chain = torch.zeros(n_blocks * b, ROWS, c)  # every N tile's chain
        for j in range(k):
            if j % chain_taps == 0:
                acc += chain
                chain.zero_()
            # Each N tile's (hi, lo) slab of this (chunk, tap), flat.
            slabs = packed[:, j].reshape(n_tiles, 2, -1)[
                ..., ck * kc * bn:(ck + 1) * kc * bn].double()
            for ks in range(kc // 8):
                ai, bi = _a_index(a_stride, j * d, ks), _b_index(bn, ks)
                ahi, alo = a_hi[:, ai], a_lo[:, ai]
                # (8, C): the N tiles' B operands side by side.
                bhi, blo = (torch.cat(list(slabs[:, p][:, bi]), dim=1)
                            for p in (0, 1))
                terms = ([(alo, bhi), (ahi, blo), (ahi, bhi)]
                         if products == 3 else [(ahi, bhi)])
                for a_op, b_op in terms:
                    chain = _round_toward_zero(chain.double() + a_op @ b_op)
        acc += chain
    out = acc.reshape(n_blocks, b, ROWS, c).transpose(0, 1).reshape(
        b, n_blocks * ROWS, c)[:, :t] + bias
    return out if res is None else out + res


def emulate_resblock(x, weights, k, kc, products=3, chain_steps=None):
    h = x
    for i, d in enumerate(DIL):
        (w1, b1), (w2, b2) = weights[2 * i], weights[2 * i + 1]
        y = emulate_conv(h, mrf.pack_mrf_weights_tf32(w1), b1, k, d, kc,
                         products=products, chain_steps=chain_steps)
        h = emulate_conv(y, mrf.pack_mrf_weights_tf32(w2), b2, k, 1, kc,
                         res=h, products=products, chain_steps=chain_steps)
    return h


@lru_cache(maxsize=None)
def _case(c, k, t):
    """Inputs from a seed, the JAX resblock's output, and the float64
    plain resblock's."""
    seed = c + k + t
    rng = np.random.default_rng(seed)
    rb = init_resblock(jax.random.PRNGKey(seed), c, k, DIL)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    weights = []
    for c1, c2 in zip(rb["convs1"], rb["convs2"]):
        for conv in (c1, c2):
            w = np.asarray(conv["kernel"]).transpose(2, 1, 0)
            weights.append((torch.tensor(w),
                            torch.tensor(np.asarray(conv["bias"]))))
    ref = np.asarray(apply_resblock(rb, jnp.asarray(x), k, DIL))
    ref64 = mrf.mrf_resblock_plain(
        torch.from_numpy(x).double(),
        [(w.double(), b.double()) for w, b in weights], k, DIL)
    return torch.from_numpy(x), weights, ref, ref64


@pytest.mark.parametrize("kc", [32, 16])
@pytest.mark.parametrize("c,k,t", SHAPES)
def test_emulated_kernel_matches_float64_plain_and_jax(c, k, t, kc):
    x, weights, ref, ref64 = _case(c, k, t)
    out = emulate_resblock(x, weights, k, kc)
    assert out.shape == (2, t, c) and out.dtype == torch.float32
    assert (out.double() - ref64).abs().max().item() < BOUND
    assert np.abs(out.numpy() - ref).max() < BOUND


# At the refusal limits of BN = 32 and 64 (d = 5: K = 149 and 143; KC =
# 16), on one 128-row block (T = 100, shorter than the halo): the kernel's
# chains of at most kF32ChainSteps k-steps hold the bound; one chain over
# a chunk's taps, as long as K, errs several times more.
@pytest.mark.parametrize("c,k", [(32, 149), (64, 143)])
def test_emulated_kernel_at_the_refusal_limits(c, k):
    x, weights, ref, ref64 = _case(c, k, 100)
    out = emulate_resblock(x, weights, k, 16)
    err = (out.double() - ref64).abs().max().item()
    assert err < BOUND and np.abs(out.numpy() - ref).max() < BOUND
    whole = emulate_resblock(x, weights, k, 16, chain_steps=10 ** 6)
    assert (whole.double() - ref64).abs().max().item() > 3 * err


def test_one_tf32_product_misses_the_bound():
    x, weights, ref, ref64 = _case(128, 7, 300)
    three = emulate_resblock(x, weights, 7, 32)
    one = emulate_resblock(x, weights, 7, 32, products=1)
    assert (one.double() - ref64).abs().max().item() > 10 * BOUND
    assert (three.double() - ref64).abs().max().item() < BOUND


def test_tf32_split_parts():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -30, 30, size=4096)).astype(np.float32))
    hi, lo = mrf.split_tf32(w)
    for part in (hi, lo):
        assert (_bits(part) & 0x1FFF).eq(0).all()
    # hi by the kernel's bit arithmetic (round to nearest, ties away).
    bits = w.numpy().view(np.uint32)
    want = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    assert np.array_equal(hi.numpy(), want)
    err = (hi.double() + lo.double() - w.double()).abs()
    assert (err <= 2.0 ** -21 * w.double().abs()).all()
    # Ties go away from zero: 1 + 2^-11 (half a TF32 ulp) rounds up.
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert mrf.tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def _unpack_tf32(packed):
    """The inverse of ``pack_mrf_weights_tf32``: (hi, lo), each
    (C_out, C_in, K)."""
    nt, k, _, g, bn, e = packed.shape
    full = packed.permute(2, 0, 4, 3, 5, 1).reshape(2, nt * bn, g * e, k)
    return full[0], full[1]


@pytest.mark.parametrize("c", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("k", [3, 13])
def test_tf32_pack_round_trips(c, k):
    w = torch.from_numpy(np.random.default_rng(c + k).normal(
        size=(c, c, k)).astype(np.float32))
    packed = mrf.pack_mrf_weights_tf32(w)
    bn, _ = mrf.mrf_tiles(c)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.shape == (c // bn, k, 2, c // 4, bn, 4)
    hi, lo = _unpack_tf32(packed)
    want_hi, want_lo = mrf.split_tf32(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert ((hi.double() + lo.double() - w.double()).abs()
            <= 2.0 ** -21 * w.double().abs()).all()
    # One element by the formula the producer's copies and the B
    # descriptors assume: part p of tap j, N tile nt, at channel group g.
    nt, j, g, n, e = c // bn - 1, k - 1, c // 4 - 1, 5, 3
    flat = packed.reshape(-1)
    off = ((nt * k + j) * 2 + 1) * c * bn + (g * bn + n) * 4 + e
    assert flat[off] == want_lo[nt * bn + n, 4 * g + e, j]


def test_packed_weights_take_the_kernel_of_the_weights_dtype():
    w = torch.nn.Conv1d(64, 64, 7).weight
    first = mrf.packed_weights(w)
    assert mrf.packed_weights(w) is first
    assert torch.equal(first, mrf.pack_mrf_weights_tf32(w))
    with torch.no_grad():
        w.mul_(2.0)
    moved = mrf.packed_weights(w)
    assert moved is not first
    assert torch.equal(moved, mrf.pack_mrf_weights_tf32(w))
    w16 = torch.nn.Conv1d(64, 64, 7).to(torch.bfloat16).weight
    assert torch.equal(mrf.packed_weights(w16), mrf.pack_mrf_weights(w16))


# --- the shared-memory plan, from the source's constants ------------------

SOURCE = "mrf_resblock.cu"


def _const(name: str) -> int:
    return source_int(SOURCE, rf"constexpr \w+ {name} = (\d+);")


def _source_plan(channels: int, k: int, d: int):
    """(KC, stages, bytes) by the source's constants: KC = kF32WideKC with
    the deepest ring from kF32MaxStages down to kF32MinStages that fits in
    kMaxSmem, else kF32NarrowKC likewise."""
    bn, _ = mrf.mrf_tiles(channels)
    a_stride = (_const("kTcRows") + (k - 1) // 2 * d * 2) | 1
    for kc in (_const("kF32WideKC"), _const("kF32NarrowKC")):
        for stages in range(_const("kF32MaxStages"),
                            _const("kF32MinStages") - 1, -1):
            smem = (_const("kBarrierBytes") + stages * 2 * bn * kc * 4
                    + 2 * 2 * (kc // 4) * a_stride * 16)
            if smem <= _const("kMaxSmem"):
                return kc, stages, smem
    return None


@pytest.mark.parametrize("channels", [256, 128, 64, 32, 96])
def test_f32_plan_takes_every_shape_the_parent_kernel_took(channels):
    # The CUDA-core kernel this one replaced took any odd K <= 45 at d = 5;
    # and the templated sizes at the generator's dilations.
    shapes = [(k, 5) for k in range(1, 46, 2)] + [
        (k, d) for k in mrf.KERNEL_SIZES for d in DIL]
    for k, d in shapes:
        plan = _source_plan(channels, k, d)
        assert plan is not None
        assert plan[0] in (16, 32) and 2 <= plan[1] <= 4


def test_f32_plan_at_the_stated_shapes_and_limits():
    # The plans the source's note states.
    assert _source_plan(256, 11, 5) == (32, 4, 222848)
    assert _source_plan(256, 13, 5) == (32, 4, 227968)
    assert _source_plan(256, 17, 5) == (32, 3, 205440)
    assert _source_plan(256, 45, 5) == (16, 4, 155008)
    # The refusal limits the wrapper's docstring states: (K - 1) * d up to
    # 650 at BN = 128, 714 at 64, 746 at 32 (at d = 5, K 131, 143, 149).
    for channels, halo, k5 in ((256, 650, 131), (64, 714, 143),
                               (32, 746, 149)):
        assert _source_plan(channels, halo + 1, 1) is not None
        assert _source_plan(channels, halo + 3, 1) is None
        assert _source_plan(channels, k5, 5) is not None
        assert _source_plan(channels, k5 + 2, 5) is None
    doc = " ".join(mrf.__doc__.split())
    assert ("650 at C % 128 == 0, 714 at C = 64 and 746 at C = 32 (at d = 5, "
            "K up to 131, 143 and 149)") in doc
