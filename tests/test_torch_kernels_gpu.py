"""The CUDA kernels (MRF resblock, flash attention) against their plain
versions on the card, and the paths of feature extraction and the GTA
export there against the CPU and the math path.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import Preprocessor
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    CheckpointManager,
    create_train_state,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.vocoder import (
    export_gta_mels,
)

from .port_corpus import preprocess_config, write_pipeline_corpus

DIL = (1, 3, 5)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,T", [(256, 1000), (128, 700), (32, 4096)])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_kernel_matches_plain_on_card(dtype, C, T, k):
    _cuda_or_skip()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(C + T + k)
    dt = getattr(torch, dtype)
    bound = 1.0 / np.sqrt(C * k)
    weights = [(((torch.rand(C, C, k, generator=gen) * 2 - 1) * bound)
                .to("cuda", dt),
                ((torch.rand(C, generator=gen) * 2 - 1) * bound).to("cuda", dt))
               for _ in range(6)]
    x = torch.randn(2, T, C, generator=gen).to("cuda", dt)
    before = mrf.launch_count
    out = mrf.mrf_resblock(x, weights, k, DIL)
    assert mrf.launch_count == before + 6
    ref = mrf.mrf_resblock_plain(x, weights, k, DIL)
    diff = (out.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * ref.float().abs().max().item()
    assert diff <= tol


def _random_resblock(b, t, c, k, seed):
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(c * k)
    weights = [(((torch.rand(c, c, k, generator=gen) * 2 - 1) * bound)
                .to("cuda", torch.bfloat16),
                ((torch.rand(c, generator=gen) * 2 - 1) * bound)
                .to("cuda", torch.bfloat16)) for _ in range(6)]
    x = torch.randn(b, t, c, generator=gen).to("cuda", torch.bfloat16)
    return x, weights


# The bfloat16 tensor-core kernel (csrc/mrf_resblock.cu, mrf_conv_tc_kernel)
# against the plain version: the same bf16 values and rounding points, f32
# sums in another order, which can flip a conv output's bf16 rounding and
# carry through the chain; bound 2^-6 · max|ref|. Every bf16 launch is the
# tensor-core kernel's; the float32 CUDA-core kernel is not launched.
@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("B,T", [(2, 256),   # two full 128-row tiles
                                 (2, 333),   # T not a multiple of the tile
                                 (2, 20),    # T shorter than the halo
                                 (1, 1040)])  # B = 1, a streaming window
def test_tc_kernel_matches_plain_on_card(C, k, B, T):
    _cuda_or_skip()
    x, weights = _random_resblock(B, T, C, k, seed=C * k + T)
    before = (mrf.launch_count, mrf.tc_launch_count, mrf.fma_launch_count)
    out = mrf.mrf_resblock(x, weights, k, DIL)
    assert (mrf.launch_count, mrf.tc_launch_count, mrf.fma_launch_count) == (
        before[0] + 6, before[1] + 6, before[2])
    ref = mrf.mrf_resblock_plain(x, weights, k, DIL)
    diff = (out.float() - ref.float()).abs().max().item()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert diff <= 2.0 ** -6 * ref.float().abs().max().item()


# The float32 CUDA-core kernel (csrc/mrf_resblock.cu, mrf_conv_f32_kernel)
# at the generator's four stage shapes (C, T) on 1000 mel frames, against
# the plain resblock in float64: its own error, within 1e-4 (chip_smoke
# phase 2's bound), every launch the CUDA-core kernel's.
@pytest.mark.gpu
@pytest.mark.parametrize("C,T", [(256, 8000), (128, 64000), (64, 128000),
                                 (32, 256000)])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_f32_kernel_matches_float64_plain_at_the_stage_shapes_on_card(
        C, T, k):
    _cuda_or_skip()
    torch.backends.cudnn.allow_tf32 = False
    x, weights = _random_resblock(1, T, C, k, seed=C + k)
    x = x.float()
    weights = [(w.float(), b.float()) for w, b in weights]
    before = (mrf.tc_launch_count, mrf.fma_launch_count)
    out = mrf.mrf_resblock(x, weights, k, DIL)
    assert (mrf.tc_launch_count, mrf.fma_launch_count) == (before[0],
                                                          before[1] + 6)
    ref64 = mrf.mrf_resblock_plain(
        x.double(), [(w.double(), b.double()) for w, b in weights], k, DIL)
    assert out.dtype == torch.float32 and out.shape == ref64.shape
    assert (out.double() - ref64).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_float32_resblock_runs_the_cuda_core_kernel_on_card():
    _cuda_or_skip()
    x, weights = _random_resblock(1, 200, 64, 7, seed=5)
    x = x.float()
    weights = [(w.float(), b.float()) for w, b in weights]
    before = (mrf.tc_launch_count, mrf.fma_launch_count)
    mrf.mrf_resblock(x, weights, 7, DIL)
    assert (mrf.tc_launch_count, mrf.fma_launch_count) == (before[0],
                                                          before[1] + 6)


@pytest.mark.gpu
def test_tc_kernel_repacks_after_an_in_place_update_on_card():
    _cuda_or_skip()
    x, weights = _random_resblock(1, 300, 128, 3, seed=9)
    first = mrf.mrf_resblock(x, weights, 3, DIL)
    with torch.no_grad():
        weights[0][0].mul_(-1.0)
    second = mrf.mrf_resblock(x, weights, 3, DIL)
    ref = mrf.mrf_resblock_plain(x, weights, 3, DIL)
    assert not torch.equal(first, second)
    assert ((second.float() - ref.float()).abs().max().item()
            <= 2.0 ** -6 * ref.float().abs().max().item())


@pytest.mark.gpu
def test_kernel_rejects_unsupported_input_on_card():
    _cuda_or_skip()
    # An even K has no 'same' padding; an odd K whose halo (K - 1) * d
    # outgrows the float32 kernel's shared memory (K > 45 at d = 5) is
    # refused by the launch.
    for k, error in ((4, ValueError), (2, ValueError), (49, RuntimeError)):
        x = torch.zeros(1, 10, 48, device="cuda")
        w = [(torch.zeros(48, 48, k, device="cuda"),
              torch.zeros(48, device="cuda"))] * 6
        with pytest.raises(error):
            mrf.mrf_resblock(x, w, k, DIL)


# An odd K past 11 runs at the kernels' run-time tap count
# (csrc/mrf_resblock.cu, template K = 0), within the bounds above, on the
# kernel of its dtype.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 256])
@pytest.mark.parametrize("k", [13, 17])
def test_odd_kernel_sizes_past_11_match_plain_on_card(dtype, C, k):
    _cuda_or_skip()
    torch.backends.cudnn.allow_tf32 = False
    x, weights = _random_resblock(2, 700, C, k, seed=C + k)
    dt = getattr(torch, dtype)
    x, weights = x.to(dt), [(w.to(dt), b.to(dt)) for w, b in weights]
    before = (mrf.tc_launch_count, mrf.fma_launch_count)
    out = mrf.mrf_resblock(x, weights, k, DIL)
    bf16 = dtype == "bfloat16"
    assert (mrf.tc_launch_count - before[0],
            mrf.fma_launch_count - before[1]) == ((6, 0) if bf16 else (0, 6))
    ref = mrf.mrf_resblock_plain(x, weights, k, DIL)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    diff = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -6 * ref.float().abs().max().item() if bf16 else 1e-4
    assert diff <= tol


# The widths the kernels are not built for run zero-padded to C = 32 and
# K = 7 (ops/mrf_resblock.py:pad_resblock), within the bounds above.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [2, 4, 8, 16])
def test_padded_widths_match_plain_on_card(dtype, C):
    _cuda_or_skip()
    torch.backends.cudnn.allow_tf32 = False
    x, weights = _random_resblock(2, 300, C, 5, seed=C)
    dt = getattr(torch, dtype)
    x, weights = x.to(dt), [(w.to(dt), b.to(dt)) for w, b in weights]
    before = mrf.launch_count
    out = mrf.mrf_resblock(x, weights, 5, DIL)
    assert mrf.launch_count == before + 6
    ref = mrf.mrf_resblock_plain(x, weights, 5, DIL)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    diff = (out.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * ref.float().abs().max().item()
    assert diff <= tol


# The kernels have no backward: with a gradient wanted the wrapper raises
# rather than return a tensor cut off from autograd; under no_grad (every
# synthesis path) it runs.
@pytest.mark.gpu
def test_kernel_raises_when_a_gradient_is_wanted_on_card():
    _cuda_or_skip()
    x, weights = _random_resblock(1, 100, 32, 3, seed=3)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf.mrf_resblock(x.clone().requires_grad_(), weights, 3, DIL)
    w_grad = [(w.clone().requires_grad_(), b) for w, b in weights]
    with pytest.raises(RuntimeError, match="no backward"):
        mrf.mrf_resblock(x, w_grad, 3, DIL)
    with torch.no_grad():
        out = mrf.mrf_resblock(x.clone().requires_grad_(), w_grad, 3, DIL)
    assert out.grad_fn is None and out.shape == x.shape


# The vocoder trainer's path: Generator.forward(fast=False) runs stock convs
# and takes gradients on the card; the default fast=True still goes through
# the kernel, which raises when a gradient is wanted.
@pytest.mark.gpu
def test_generator_plain_path_takes_gradients_on_card():
    _cuda_or_skip()
    from expressive_fastspeech2_mandarin_tpu_torch.config import VocoderConfig
    from expressive_fastspeech2_mandarin_tpu_torch.models import Generator

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    gen = Generator(VocoderConfig(upsample_initial_channel=64),
                    weight_norm=True).cuda()
    mel = torch.randn(2, 32, 80, device="cuda")
    before = mrf.launch_count
    gen(mel, fast=False).square().mean().backward()
    assert mrf.launch_count == before
    for name, p in gen.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel, fast=True)
    with torch.no_grad():
        fast = gen(mel, fast=True)
        plain = gen(mel, fast=False)
    assert mrf.launch_count == before + 6 * len(gen.resblocks)
    assert (fast - plain).abs().max().item() <= 1e-4


# The flash attention kernel (csrc/flash_mha.cu, TF32 tensor cores at float32
# accuracy) against its plain version: float32, TF32 off; bound 1e-5·max|ref|
# (summation order, expf, and the ~2^-21 the split TF32 products leave).


def _prefixes(*lens):
    """Rows of valid-key spans for valid prefixes of these lengths."""
    return [[(0, n)] for n in lens]


def _flash_inputs(t, rows, seed, d=128):
    """q, k, v (B, 2, T, d) and the (B, T) key mask, a row given as the
    [start, stop) spans of its valid keys."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(rows), 2, t, d, generator=gen).to("cuda")
               for _ in range(3))
    mask = torch.ones(len(rows), t, dtype=torch.bool)
    for i, spans in enumerate(rows):
        for start, stop in spans:
            mask[i, start:stop] = False
    return q, k, v, mask.to("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,rows", [
    (20, _prefixes(20, 1, 0, 13)),  # under one tile
    (128, _prefixes(128, 1, 0, 77)),  # the encoder's S
    (300, _prefixes(300, 37, 0, 299)),
    # Not a prefix: wholly padded key tiles of 32 at the start and in the
    # middle of rows, a row with one valid key (the last), a row with none.
    (1000, [[(0, 100), (300, 1000)], [(64, 128), (640, 700)], [(999, 1000)],
            []]),
    (2300, _prefixes(2300, 63, 0, 2049)),
    (4096, _prefixes(4096, 1, 0, 3000))])
def test_flash_kernel_matches_plain_on_card(t, rows):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(t, rows, seed=t)
    before = fa.launch_count
    out = fa.flash_mha(q, k, v, mask, 128 ** -0.5)
    assert fa.launch_count == before + 1
    ref = fa.flash_mha_plain(q, k, v, mask, 128 ** -0.5)
    ref64 = fa.flash_mha_plain(q.double(), k.double(), v.double(), mask,
                               128 ** -0.5)
    bound = 1e-5 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= bound
    assert (out.double() - ref64).abs().max().item() <= bound
    for i in range(len(rows)):
        if bool(mask[i].all()):  # no valid key → exactly 0
            assert torch.count_nonzero(out[i]).item() == 0
    again, lse = fa._flash_mha_cuda(q, k, v, mask, 128 ** -0.5, with_lse=True)
    assert torch.equal(again, out)
    lse_ref = fa.flash_mha_lse_plain(q, k, mask, 128 ** -0.5)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isposinf(lse), ~finite)
    assert ((lse - lse_ref)[finite].abs().max().item()
            <= 1e-5 * lse_ref[finite].abs().max().item())


@pytest.mark.gpu
def test_flash_kernel_rejects_unsupported_input_on_card():
    _cuda_or_skip()
    q, k, v, mask = _flash_inputs(100, _prefixes(100), seed=0)
    with pytest.raises(TypeError):
        fa.flash_mha(q.double(), k.double(), v.double(), mask, 1.0)
    with pytest.raises(TypeError):
        fa.flash_mha(q.half(), k.half(), v.half(), mask, 1.0)
    with pytest.raises(TypeError):  # one dtype for every tensor
        fa.flash_mha(q.bfloat16(), k, v.bfloat16(), mask, 1.0)
    before = fa.bf16_launch_count  # bf16 is the other dtype the kernels take
    out = fa.flash_mha(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, 1.0)
    assert out.dtype == torch.bfloat16
    assert fa.bf16_launch_count == before + 1
    q64, k64, v64, mask64 = _flash_inputs(100, _prefixes(100), seed=0, d=64)
    with pytest.raises(ValueError):
        fa.flash_mha(q64, k64, v64, mask64, 1.0)
    with pytest.raises(ValueError):
        fa.flash_mha(q.transpose(2, 3), k, v, mask, 1.0)


# The flash attention backward kernels (csrc/flash_mha_bwd.cu) against the
# plain backward: float32, TF32 off; bound 1e-4 · max|ref| for dq, dk and
# dv (the kernels recompute P from the stored log-sum-exp and sum in another
# order than cuBLAS); a rerun is bit-identical (no atomics).


def _flash_grads(q, k, v, mask, dout, scale=128 ** -0.5):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_mha(q, k, v, mask, scale)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.gpu
@pytest.mark.parametrize("t,lens", [(300, (300, 37, 0, 299)),
                                    (1000, (1000, 63, 0, 999)),
                                    (2300, (2300, 63, 0, 2049))])
def test_flash_backward_kernels_match_plain_on_card(t, lens):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(t, _prefixes(*lens), seed=t + 1)
    dout = torch.randn_like(q)
    before = (fa.launch_count, fa.bwd_dq_launch_count,
              fa.bwd_dkv_launch_count)
    out, dq, dk, dv = _flash_grads(q, k, v, mask, dout)
    assert (fa.launch_count, fa.bwd_dq_launch_count,
            fa.bwd_dkv_launch_count) == tuple(n + 1 for n in before)
    ref = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, 128 ** -0.5)
    for g, r in zip((dq, dk, dv), ref):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    for g in (dq, dk, dv):  # the row of length 0
        assert torch.count_nonzero(g[2]).item() == 0
    again = _flash_grads(q, k, v, mask, dout)
    for a, b in zip((out, dq, dk, dv), again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_forward_lse_matches_logsumexp_on_card():
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    lens = (700, 5, 0)
    q, k, v, mask = _flash_inputs(700, _prefixes(*lens), seed=11)
    out, lse = fa._flash_mha_cuda(q, k, v, mask, 128 ** -0.5, with_lse=True)
    ref = fa.flash_mha_lse_plain(q, k, mask, 128 ** -0.5)
    assert torch.isposinf(lse[2]).all()
    assert (lse[:2] - ref[:2]).abs().max().item() <= 1e-5 * ref[:2].abs().max()
    torch.testing.assert_close(out, fa.flash_mha(q, k, v, mask, 128 ** -0.5),
                               rtol=0, atol=0)


# The bf16 flash kernels (csrc/flash_mha_bf16.cu, csrc/flash_mha_bwd_bf16.cu)
# against their plain versions on the same bf16 inputs, which round where the
# TPU kernel rounds in bf16 (the unnormalised P of each key tile before P·V:
# the forward's plain version is flash_mha_blocked_plain on the kernel's
# 64-key tiles; Pᵀ and dS·sm_scale before their products; the outputs):
# out within 2^-7 · max|ref| and the float32 LSE
# within 1e-5 · max|ref| of logsumexp; dq, dk, dv within 2^-6 · max|ref|
# (float32 sums in another order flip bf16 roundings of P and dS). A rerun
# is bit-identical (no atomics), and the float32 kernels are not launched.

BF16_OUT_REL = 2.0 ** -7
BF16_GRAD_REL = 2.0 ** -6


def _recipe_lengths(b, t):
    """``b`` key lengths drawn from a seed over [T/2, T], as chip_smoke.py's
    ``recipe_lengths`` draws the tuned recipe's batch."""
    rng = np.random.default_rng(t)
    return [int(n) for n in rng.integers(t // 2, t + 1, size=b)]


def _bf16_counts():
    return (fa.bf16_launch_count, fa.bf16_bwd_dq_launch_count,
            fa.bf16_bwd_dkv_launch_count, fa.launch_count,
            fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max().item()
            / max(b.float().abs().max().item(), 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("t,rows", [
    (20, _prefixes(20, 1, 0, 13)),
    (300, _prefixes(300, 37, 0, 299)),
    # Not a prefix: wholly padded 64-key tiles at the start and in the
    # middle of rows, a row with one valid key (the last), a row with none.
    (1000, [[(0, 100), (300, 1000)], [(64, 128), (640, 700)], [(999, 1000)],
            []]),
    (2300, _prefixes(2300, 63, 0, 2049)),
    # Five streamed tiles (an odd count: the backward's two consumer
    # warpgroups take 3 and 2) and a row of one live tile.
    (320, _prefixes(320, 64, 0, 200)),
    # The tuned recipe's batch of 32, at T = 500 and at the 1000-frame
    # bucket it trains in.
    (500, _prefixes(*range(500, 244, -8))),
    (1000, _prefixes(*range(1000, 488, -16))),
    # Where the recipe launches the forward: its batch of 32 at the
    # decoder's 1000-frame bucket and the encoder's 128-phone bucket, with
    # chip_smoke.py's seeded lengths.
    (1000, _prefixes(*_recipe_lengths(32, 1000))),
    (128, _prefixes(*_recipe_lengths(32, 128)))])
def test_bf16_flash_kernels_match_plain_on_card(t, rows):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                     for x in _flash_inputs(t, rows, seed=t + 7))
    dout = torch.randn_like(q)
    scale = 128 ** -0.5
    before = _bf16_counts()
    out, dq, dk, dv = _flash_grads(q, k, v, mask, dout)
    assert _bf16_counts() == tuple(n + (i < 3) for i, n in enumerate(before))
    assert all(x.dtype == torch.bfloat16 for x in (out, dq, dk, dv))
    ref = fa.flash_mha_blocked_plain(q, k, v, mask, scale, 64)
    assert _rel(out, ref) <= BF16_OUT_REL
    refs = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
    for g, r in zip((dq, dk, dv), refs):
        assert _rel(g, r) <= BF16_GRAD_REL
    empty = [i for i in range(len(rows)) if bool(mask[i].all())]
    for i in empty:  # no valid key → exactly 0
        for x in (out, dq, dk, dv):
            assert torch.count_nonzero(x[i]).item() == 0
    _, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
    lse_ref = fa.flash_mha_lse_plain(q, k, mask, scale)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isposinf(lse), ~finite)
    assert ((lse - lse_ref)[finite].abs().max().item()
            <= 1e-5 * lse_ref[finite].abs().max().item())
    again = _flash_grads(q, k, v, mask, dout)
    for a, b in zip((out, dq, dk, dv), again):
        assert torch.equal(a, b)


def _layout_witness(t=192, lens=(192, 100), seed=3):
    """Inputs whose every product is exact in bf16 and float32: keys
    k_j = 64 e_j (j < 128) and -64 e_(j-128); each query row i scores 1024
    against exactly two valid keys a_i, b_i (q_i = 16 (e_a + e_b)), 0 or
    -1024 against the rest, so with sm_scale 1 its P is 1/2 at a_i and b_i
    and exp(-1024) = 0 elsewhere, in float64 too; v and dO in {-1, 0, 1}.
    A swizzle, descriptor or transpose bit that reads the wrong element
    moves a product by far more than round-off."""
    rng = np.random.default_rng(seed)
    b, h, d = len(lens), 2, 128
    k = np.zeros((b, h, t, d))
    for j in range(t):
        k[:, :, j, j % 128] = 64.0 if j < 128 else -64.0
    q = np.zeros((b, h, t, d))
    for i, n in enumerate(lens):
        pool = min(n, 128)
        for hh in range(h):
            for r in range(t):
                a, c = rng.choice(pool, size=2, replace=False)
                q[i, hh, r, a] = q[i, hh, r, c] = 16.0
    v, dout = (rng.choice([-1.0, 0.0, 1.0], size=(b, h, t, d),
                          p=[0.25, 0.5, 0.25]) for _ in range(2))
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, dout, mask


@pytest.mark.gpu
def test_bf16_flash_kernels_layout_witness_is_exact_on_card():
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout, mask = _layout_witness()
    ref64 = [torch.from_numpy(x) for x in (q, k, v, dout)]
    tmask = torch.from_numpy(mask)
    out64 = fa.flash_mha_plain(*ref64[:3], tmask, 1.0)
    grads64 = fa.flash_mha_bwd_plain(*ref64[:3], tmask, out64, ref64[3], 1.0)
    for x in (out64, *grads64):  # the premise: every value exact in bf16
        assert torch.equal(x, x.bfloat16().double())
    assert float(grads64[0].abs().max()) > 1 and float(
        grads64[1].abs().max()) > 1
    args = [x.to("cuda", torch.bfloat16) for x in ref64]
    out, dq, dk, dv = _flash_grads(*args[:3], tmask.to("cuda"), args[3],
                                   scale=1.0)
    for got, want in zip((out, dq, dk, dv), (out64, *grads64)):
        assert torch.equal(got.double().cpu(), want)


@pytest.mark.gpu
def test_auto_takes_the_bf16_kernels_past_2048_frames_on_card():
    """attention_impl="auto" in bf16: the math path at T = 2048, the bf16
    kernels (and no float32 kernel) past it, as the float32 rule."""
    _cuda_or_skip()
    from expressive_fastspeech2_mandarin_tpu_torch.ops import (
        multi_head_attention,
    )

    gen = torch.Generator().manual_seed(12)
    w = [(torch.randn(256, 256, generator=gen) * 0.05).to("cuda",
                                                         torch.bfloat16)
         for _ in range(3)]
    bias = torch.zeros(256, device="cuda", dtype=torch.bfloat16)
    for t, launched in ((2048, 0), (2100, 1)):
        x = torch.randn(2, t, 256, generator=gen).to("cuda", torch.bfloat16)
        mask = torch.zeros(2, t, dtype=torch.bool, device="cuda")
        mask[1, t // 2:] = True
        before = _bf16_counts()
        out = multi_head_attention(x, w[0], bias, w[1], bias, w[2], bias, 2,
                                   mask, impl="auto")
        assert out.dtype == torch.bfloat16
        assert _bf16_counts() == tuple(n + launched * (i == 0)
                                       for i, n in enumerate(before))


def _preprocess(root, tg_root, raw, name, device):
    pre = root / name
    shutil.copytree(tg_root, pre / "TextGrid")
    Preprocessor(preprocess_config(tcfg, raw, pre), num_workers=2,
                 device=device).build_from_path()
    return pre


def _read(d, name):
    with open(os.path.join(d, name)) as f:
        return f.read()


@pytest.mark.gpu
def test_preprocessor_on_card_matches_cpu(tmp_path):
    """The mel STFT on the card (cuFFT) against the CPU: the metadata,
    durations and pitch equal (F0 is host numpy in both); log-mel within
    1e-4, energy 1e-5 relative, de-normalized with each run's stats (the
    stats' mean 1e-5 relative, their std within 1e-5 of the mean)."""
    _cuda_or_skip()
    raw, tg_root = write_pipeline_corpus(tmp_path)
    card = _preprocess(tmp_path, tg_root, raw, "card", "cuda")
    cpu = _preprocess(tmp_path, tg_root, raw, "cpu", "cpu")
    for name in ("train.txt", "val.txt", "speakers.json", "emotions.json"):
        assert _read(card, name) == _read(cpu, name)
    st_card = json.loads(_read(card, "stats.json"))
    st_cpu = json.loads(_read(cpu, "stats.json"))
    assert st_card["pitch"] == st_cpu["pitch"]
    # The std relative to the mean: an error of 1e-5·e in every energy e
    # moves the std by up to 1e-5·max e, however small the std is.
    mean, std = st_cpu["energy"][2:]
    np.testing.assert_allclose(st_card["energy"][2], mean, rtol=1e-5)
    assert abs(st_card["energy"][3] - std) <= 1e-5 * mean
    names = sorted(os.listdir(cpu / "mel"))
    assert len(names) == 13
    for name in names:
        for kind in ("duration", "pitch", "mel", "energy"):
            file = name.replace("-mel-", f"-{kind}-")
            a, b = np.load(card / kind / file), np.load(cpu / kind / file)
            assert a.dtype == b.dtype and a.shape == b.shape
            if kind in ("duration", "pitch"):
                np.testing.assert_array_equal(a, b)
            elif kind == "mel":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
            else:
                e = st_card["energy"], st_cpu["energy"]
                np.testing.assert_allclose(a * e[0][3] + e[0][2],
                                           b * e[1][3] + e[1][2], rtol=1e-5)


@pytest.mark.gpu
def test_gta_export_flash_matches_xla_on_card(tmp_path):
    """export_gta_mels under attention_impl "flash" (head dim 128: the
    kernel, one launch per block and batch) against "xla" on the card,
    within 1e-4 · max(1, peak), chip_smoke phase 3b's flash-against-math
    mel bound."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw, tg_root = write_pipeline_corpus(tmp_path)
    pre = _preprocess(tmp_path, tg_root, raw, "pre", "cpu")
    stats = json.loads(_read(pre, "stats.json"))
    outs = {}
    for impl in ("xla", "flash"):
        model = tcfg.ModelConfig(
            transformer=tcfg.TransformerConfig(
                encoder_layer=1, decoder_layer=1, attention_impl=impl),
            n_speakers=2, n_emotions=2, n_arousals=2, n_valences=2)
        cfg = tcfg.Config(preprocess=preprocess_config(tcfg, raw, pre),
                          model=model)
        if impl == "xla":
            state = create_train_state(cfg, stats, torch.device("cpu"))
            CheckpointManager(str(tmp_path / "ckpt")).save(0, state)
        before = fa.launch_count
        outs[impl] = str(tmp_path / impl)
        assert export_gta_mels(cfg, str(tmp_path / "ckpt"), outs[impl],
                               device="cuda", log=lambda *_: None) == 13
        launches = fa.launch_count - before
        assert launches == (0 if impl == "xla" else 2 * 3)  # 2 + 1 batches
    for name in sorted(os.listdir(outs["xla"])):
        ref = np.load(os.path.join(outs["xla"], name))
        out = np.load(os.path.join(outs["flash"], name))
        assert out.shape == ref.shape
        bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(out - ref).max()) <= bound, name
