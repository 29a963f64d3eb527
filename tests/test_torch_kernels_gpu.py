"""The CUDA kernels (MRF resblock, flash attention) against their plain
versions on the card.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

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


@pytest.mark.gpu
def test_kernel_rejects_unsupported_input_on_card():
    _cuda_or_skip()
    x = torch.zeros(1, 10, 48, device="cuda")
    w = [(torch.zeros(48, 48, 3, device="cuda"),
          torch.zeros(48, device="cuda"))] * 6
    with pytest.raises(ValueError):
        mrf.mrf_resblock(x, w, 3, DIL)


# The flash attention kernel (csrc/flash_mha.cu) against its plain version:
# float32, TF32 off; bound 1e-5 · max|ref| (summation order and expf).


def _flash_inputs(b, t, lens, seed, d=128):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, 2, t, d, generator=gen).to("cuda")
               for _ in range(3))
    mask = (torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]).to("cuda")
    return q, k, v, mask


@pytest.mark.gpu
@pytest.mark.parametrize("t,lens", [(300, (300, 37, 0, 299)),
                                    (2300, (2300, 63, 0, 2049)),
                                    (4096, (4096, 1, 0, 3000))])
def test_flash_kernel_matches_plain_on_card(t, lens):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(len(lens), t, lens, seed=t)
    before = fa.launch_count
    out = fa.flash_mha(q, k, v, mask, 128 ** -0.5)
    assert fa.launch_count == before + 1
    ref = fa.flash_mha_plain(q, k, v, mask, 128 ** -0.5)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.count_nonzero(out[2]).item() == 0  # length-0 row → exactly 0


@pytest.mark.gpu
def test_flash_kernel_rejects_unsupported_input_on_card():
    _cuda_or_skip()
    q, k, v, mask = _flash_inputs(1, 100, (100,), seed=0)
    with pytest.raises(TypeError):
        fa.flash_mha(q.double(), k.double(), v.double(), mask, 1.0)
    q64, k64, v64, mask64 = _flash_inputs(1, 100, (100,), seed=0, d=64)
    with pytest.raises(ValueError):
        fa.flash_mha(q64, k64, v64, mask64, 1.0)
    with pytest.raises(ValueError):
        fa.flash_mha(q.transpose(2, 3), k, v, mask, 1.0)


# The flash attention backward kernels (csrc/flash_mha_bwd.cu) against the
# plain backward: float32, TF32 off; bound 1e-4 · max|ref| for dq, dk and
# dv (the kernels recompute P from the stored log-sum-exp and sum in another
# order than cuBLAS); a rerun is bit-identical (no atomics).


def _flash_grads(q, k, v, mask, dout):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_mha(q, k, v, mask, 128 ** -0.5)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.gpu
@pytest.mark.parametrize("t,lens", [(300, (300, 37, 0, 299)),
                                    (1000, (1000, 63, 0, 999)),
                                    (2300, (2300, 63, 0, 2049))])
def test_flash_backward_kernels_match_plain_on_card(t, lens):
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(len(lens), t, lens, seed=t + 1)
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
    q, k, v, mask = _flash_inputs(len(lens), 700, lens, seed=11)
    out, lse = fa._flash_mha_cuda(q, k, v, mask, 128 ** -0.5, with_lse=True)
    ref = fa.flash_mha_lse_plain(q, k, mask, 128 ** -0.5)
    assert torch.isposinf(lse[2]).all()
    assert (lse[:2] - ref[:2]).abs().max().item() <= 1e-5 * ref[:2].abs().max()
    torch.testing.assert_close(out, fa.flash_mha(q, k, v, mask, 128 ** -0.5),
                               rtol=0, atol=0)
