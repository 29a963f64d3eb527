"""The layout the MRF tensor-core kernel reads, pinned on the CPU.

``pack_mrf_weights`` lays each conv's (C_out, C_in, K) weights out as the
kernel's wgmma B descriptor reads them: one slab per (N tile, C_in chunk,
tap). ``_conv_packed`` below is the kernel's implicit GEMM written in plain
torch from that packed image: for each N tile, channel chunk and tap j it
multiplies the staged input rows shifted by j·d with the slab. Held against
``mrf_resblock_plain`` and the JAX package's ``apply_resblock`` on the same
numpy-seeded inputs: in float32 < 2e-5 (the bound of
tests/test_torch_mrf_resblock.py), in bfloat16 within 2⁻⁶·max|ref|.
"""

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

torch.set_num_threads(2)
DIL = (1, 3, 5)
BF16_REL_BOUND = 2.0 ** -6
# (C, K, T): every tile shape (BN, KC) = (128, 64), (64, 64), (32, 32) and
# the three-chunk C = 96; a T that is not a multiple of the kernel's 128-row
# tile; a T shorter than the halo (pad 25 at K = 11, d = 5).
SHAPES = [(256, 3, 150), (128, 7, 300), (64, 11, 130), (32, 11, 20),
          (96, 3, 200), (32, 3, 1)]


def _unpack(packed):
    """The inverse of ``pack_mrf_weights``: (C_out, C_in, K)."""
    nt, nk, k, g, bn, e = packed.shape
    return packed.permute(0, 4, 1, 3, 5, 2).reshape(nt * bn, nk * g * e, k)


def _conv_packed(x, packed, bias, k, d, res=None):
    """One conv of the kernel from its packed weights, (B, T, C) in x's
    dtype: lrelu in the working type, products summed in float32 over
    (N tile, chunk, tap), bias in float32, stored in the working type, the
    residual added in float32 and stored again."""
    b, t, c = x.shape
    bn, kc = mrf.mrf_tiles(c)
    pad = (k - 1) // 2 * d
    staged = F.pad(F.leaky_relu(x, 0.1), (0, 0, pad, pad))  # zero halo rows
    acc = torch.zeros(b, t, c)
    for nt in range(c // bn):
        for ck in range(c // kc):
            for j in range(k):
                rows = staged[:, j * d: j * d + t, ck * kc:(ck + 1) * kc]
                slab = packed[nt, ck, j]                   # (KC/8, BN, 8)
                w = slab.permute(0, 2, 1).reshape(kc, bn)  # (C_in, C_out)
                acc[..., nt * bn:(nt + 1) * bn] += rows.float() @ w.float()
    y = (acc + bias.float()).to(x.dtype)
    if res is not None:
        y = (y.float() + res.float()).to(x.dtype)
    return y


def _resblock_packed(x, weights, k, dtype):
    h = x
    for i, d in enumerate(DIL):
        (w1, b1), (w2, b2) = weights[2 * i], weights[2 * i + 1]
        t = _conv_packed(h, mrf.pack_mrf_weights(w1, dtype), b1, k, d)
        h = _conv_packed(t, mrf.pack_mrf_weights(w2, dtype), b2, k, 1, res=h)
    return h


def _case(c, k, t, seed):
    rng = np.random.default_rng(seed)
    rb = init_resblock(jax.random.PRNGKey(seed), c, k, DIL)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    weights = []
    for c1, c2 in zip(rb["convs1"], rb["convs2"]):
        for conv in (c1, c2):
            w = np.asarray(conv["kernel"]).transpose(2, 1, 0)
            weights.append((torch.tensor(w),
                            torch.tensor(np.asarray(conv["bias"]))))
    return rb, x, weights


@pytest.mark.parametrize("c", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_pack_round_trips(c, k):
    w = torch.from_numpy(np.random.default_rng(c + k).normal(
        size=(c, c, k)).astype(np.float32))
    packed = mrf.pack_mrf_weights(w)
    bn, kc = mrf.mrf_tiles(c)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (c // bn, c // kc, k, kc // 8, bn, 8)
    assert torch.equal(_unpack(packed), w.bfloat16())
    assert torch.equal(_unpack(mrf.pack_mrf_weights(w, torch.float32)), w)
    # One element by the formula the kernel's descriptors assume.
    nt, ck, j, g, n, e = c // bn - 1, c // kc - 1, k - 1, kc // 8 - 1, 3, 5
    assert packed[nt, ck, j, g, n, e] == w[nt * bn + n, ck * kc + 8 * g + e,
                                           j].bfloat16()


@pytest.mark.parametrize("c,k,t", SHAPES)
def test_packed_gemm_matches_plain_and_jax_float32(c, k, t):
    rb, x, weights = _case(c, k, t, seed=c + k + t)
    ref = np.asarray(apply_resblock(rb, jnp.asarray(x), k, DIL))
    xt = torch.from_numpy(x)
    out = _resblock_packed(xt, weights, k, torch.float32)
    plain = mrf.mrf_resblock_plain(xt, weights, k, DIL)
    assert out.shape == (2, t, c)
    assert (out - plain).abs().max().item() < 2e-5
    assert np.abs(out.numpy() - ref).max() < 2e-5


@pytest.mark.parametrize("c,k,t", SHAPES)
def test_packed_gemm_matches_plain_and_jax_bfloat16(c, k, t):
    rb, x, weights = _case(c, k, t, seed=c + k + t + 1)
    xb = torch.from_numpy(x).bfloat16()
    wb = [(w.bfloat16(), b.bfloat16()) for w, b in weights]
    out = _resblock_packed(xb, wb, k, torch.bfloat16)
    plain = mrf.mrf_resblock_plain(xb, wb, k, DIL)
    assert out.dtype == torch.bfloat16
    bound = BF16_REL_BOUND * plain.float().abs().max().item()
    assert (out.float() - plain.float()).abs().max().item() <= bound
    # JAX in float32 on the same bf16 values: what the bf16 rounding of
    # each conv output costs, inside the same bound.
    rb16 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16).astype(jnp.float32), rb)
    ref = np.asarray(apply_resblock(rb16, jnp.asarray(xb.float().numpy()),
                                    k, DIL))
    bound = BF16_REL_BOUND * np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= bound


def test_packed_weights_are_cached_and_repacked_after_an_update():
    w = torch.nn.Conv1d(64, 64, 7).to(torch.bfloat16).weight
    first = mrf.packed_weights(w)
    assert mrf.packed_weights(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = mrf.packed_weights(w)
    assert second is not first
    assert torch.equal(second, mrf.pack_mrf_weights(w))
    assert torch.equal(_unpack(second), w.detach().bfloat16())
    with torch.inference_mode():
        frozen = torch.randn(32, 32, 3, dtype=torch.bfloat16)
    assert torch.equal(mrf.packed_weights(frozen),
                       mrf.pack_mrf_weights(frozen))


def test_cache_entry_dies_with_its_tensor():
    w = torch.randn(32, 32, 3)
    mrf.packed_weights(w)
    key = id(w)
    assert key in mrf._packed
    del w
    assert key not in mrf._packed
