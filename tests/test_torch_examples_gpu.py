"""The float32 flash kernels at the convergence scripts' buckets, and
``synthesize_demo`` through the bf16 MRF kernel, on the card.

``examples_torch/convergence_*.py`` train at one (S, T) bucket, (16, 128),
at batch 16 in the deep run: the encoder's 16 keys are less than one
32-key tile of the forward and dQ kernels and a quarter of a 64-key block
of dK/dV, far below any shape the kernels were timed at. Key lengths
seeded as the corpora's (3-7 phones, 40-128 frames).

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_examples_gpu.py
"""

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
from examples_torch import synthesize_demo

from .test_torch_kernels_gpu import (
    _cuda_or_skip,
    _flash_grads,
    _flash_inputs,
    _prefixes,
)

BATCH = 16
# (T, the lengths' range): the encoder's and the decoder's bucket.
BUCKETS = [(16, (3, 7)), (128, (40, 128))]


def _lengths(t: int, lo: int, hi: int) -> tuple[int, ...]:
    rng = np.random.default_rng(t)
    return tuple(int(n) for n in rng.integers(lo, hi + 1, BATCH))


@pytest.mark.gpu
@pytest.mark.parametrize("t,span", BUCKETS)
def test_flash_forward_at_the_convergence_buckets(t, span):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(t, _prefixes(*_lengths(t, *span)), seed=t)
    before = fa.launch_count
    out = fa.flash_mha(q, k, v, mask, 128 ** -0.5)
    assert fa.launch_count == before + 1
    ref = fa.flash_mha_plain(q, k, v, mask, 128 ** -0.5)
    ref64 = fa.flash_mha_plain(q.double(), k.double(), v.double(), mask,
                               128 ** -0.5)
    bound = 1e-5 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= bound
    assert (out.double() - ref64).abs().max().item() <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("t,span", BUCKETS)
def test_flash_backward_at_the_convergence_buckets(t, span):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(t, _prefixes(*_lengths(t, *span)),
                                  seed=t + 1)
    dout = torch.randn_like(q)
    before = (fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count)
    out, dq, dk, dv = _flash_grads(q, k, v, mask, dout)
    assert (fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count) == tuple(
        n + 1 for n in before)
    ref = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, 128 ** -0.5)
    for g, r in zip((dq, dk, dv), ref):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    again = _flash_grads(q, k, v, mask, dout)
    for a, b in zip((out, dq, dk, dv), again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_synthesize_demo_on_card(tmp_path):
    """Each generator call 72 launches of the bf16 MRF kernel; duration
    control 2.0 doubles the mel length."""
    _cuda_or_skip()
    runs = [synthesize_demo.main(["--out", str(tmp_path / f"{dc}.wav"),
                                  "--duration-control", str(dc)])
            for dc in (1.0, 2.0)]
    for r in runs:
        assert r["mrf_launches"] == [72, 72]
        assert np.isfinite(r["wav"]).all()
    assert runs[1]["mel_len"] == 2 * runs[0]["mel_len"] > 0
