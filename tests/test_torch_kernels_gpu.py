"""The MRF resblock CUDA kernel against its plain version on the card.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

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
