"""The port's MRF resblock against the JAX package's fused Pallas kernel
(interpret mode) and plain resblock, on the CPU in float32 (< 2e-5, the
bound of tests/test_mrf_fused.py). The CUDA kernel's own tests are in
tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
    apply_resblock,
    init_resblock,
)
from expressive_fastspeech2_mandarin_tpu.ops.pallas.mrf_resblock import (
    pack_resblock,
    resblock_fused,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

torch.set_num_threads(2)
DIL = (1, 3, 5)
SHAPES = [(32, 4, 11, 2048), (32, 4, 3, 2048), (64, 2, 7, 1024),
          (128, 1, 11, 1024), (128, 1, 3, 700)]


def _torch_weights(rb):
    """JAX resblock params → [(weight (C, C, K), bias)] in conv order."""
    out = []
    for c1, c2 in zip(rb["convs1"], rb["convs2"]):
        for conv in (c1, c2):
            k = np.asarray(conv["kernel"]).transpose(2, 1, 0)
            out.append((torch.tensor(k), torch.tensor(np.asarray(conv["bias"]))))
    return out


@pytest.mark.parametrize("C,lam,k,T", SHAPES)
def test_plain_resblock_matches_jax(C, lam, k, T):
    rng = np.random.default_rng(0)
    rb = init_resblock(jax.random.PRNGKey(1), C, k, DIL)
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    ref = np.asarray(apply_resblock(rb, jnp.asarray(x), k, DIL))
    taps, biases, meta = pack_resblock(rb, k, DIL, lam, dtype=jnp.float32)
    xp = jnp.asarray(x).reshape(2, T // lam, lam * C)
    fused = np.asarray(resblock_fused(xp, taps, biases, meta, tile=128,
                                      interpret=True)).reshape(2, T, C)
    out = mrf.mrf_resblock(torch.from_numpy(x), _torch_weights(rb), k,
                           DIL).numpy()
    assert out.shape == (2, T, C)
    assert np.abs(out - ref).max() < 2e-5
    assert np.abs(out - fused).max() < 2e-5


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(1)
    rb = init_resblock(jax.random.PRNGKey(2), 32, 3, DIL)
    x = torch.from_numpy(rng.normal(size=(1, 50, 32)).astype(np.float32))
    before = mrf.launch_count
    out = mrf.mrf_resblock(x, _torch_weights(rb), 3, DIL)
    plain = mrf.mrf_resblock_plain(x, _torch_weights(rb), 3, DIL)
    assert mrf.launch_count == before
    assert torch.equal(out, plain)


def test_bfloat16_plain_rounds_each_conv_output():
    """bf16: every conv output is stored in bf16 and the residual sum is
    taken in f32 then cast, so the result stays within bf16 rounding of the
    f32 resblock."""
    rng = np.random.default_rng(2)
    rb = init_resblock(jax.random.PRNGKey(3), 64, 7, DIL)
    x = torch.from_numpy(rng.normal(size=(2, 300, 64)).astype(np.float32))
    w32 = _torch_weights(rb)
    w16 = [(w.bfloat16(), b.bfloat16()) for w, b in w32]
    ref = mrf.mrf_resblock_plain(x, w32, 7, DIL)
    out = mrf.mrf_resblock_plain(x.bfloat16(), w16, 7, DIL)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() < 2.0 ** -5 * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5, 9])
@pytest.mark.parametrize("C", [2, 4, 8, 16, 48])
def test_padded_resblock_equals_unpadded(C, k, dtype):
    """The widths the CUDA kernels are not built for run zero-padded
    (pad_resblock): C to a multiple of 32, K to 3, 7 or 11 with centred
    taps. The padded resblock's first C lanes equal the unpadded one's
    exactly, and its padded lanes are 0."""
    gen = torch.Generator().manual_seed(C * k)
    bound = 1.0 / np.sqrt(C * k)
    weights = [(((torch.rand(C, C, k, generator=gen) * 2 - 1) * bound)
                .to(dtype),
                ((torch.rand(C, generator=gen) * 2 - 1) * bound).to(dtype))
               for _ in range(6)]
    x = torch.randn(2, 150, C, generator=gen).to(dtype)
    xp, wp, kp = mrf.pad_resblock(x, weights, k)
    assert xp.shape[-1] % 32 == 0 and kp in mrf.KERNEL_SIZES and kp >= k
    ref = mrf.mrf_resblock_plain(x, weights, k, DIL)
    out = mrf.mrf_resblock_plain(xp, wp, kp, DIL)
    assert torch.equal(out[..., :C], ref)
    assert torch.count_nonzero(out[..., C:]) == 0


def test_pad_resblock_leaves_kernel_widths_alone():
    x = torch.zeros(1, 10, 64)
    w = [(torch.zeros(64, 64, 7), torch.zeros(64))] * 6
    xp, wp, kp = mrf.pad_resblock(x, w, 7)
    assert xp is x and kp == 7 and all(a[0] is b[0] for a, b in zip(wp, w))


@pytest.mark.parametrize("k", [2, 13])
def test_pad_resblock_names_the_kernel_size_limit(k):
    """The one limit on K is that it is odd ('same' padding); an odd K past
    11 is not padded but runs at the kernels' run-time tap count."""
    x = torch.zeros(1, 10, 32)
    w = [(torch.zeros(32, 32, k), torch.zeros(32))] * 6
    if k % 2 == 0:
        with pytest.raises(ValueError, match="odd K"):
            mrf.pad_resblock(x, w, k)
    else:
        xp, wp, kp = mrf.pad_resblock(x, w, k)
        assert xp is x and kp == k and mrf.padded_kernel_size(k) == k


@pytest.mark.parametrize("k", [13, 17])
@pytest.mark.parametrize("C", [16, 64])
def test_odd_kernel_sizes_past_11_match_jax(C, k):
    """An odd K past 11, as the JAX generator takes it (apply_resblock):
    pad_resblock leaves K as it is (the CUDA kernels read it at run time)
    and pads only C, and the resblock of its arguments equals the plain
    resblock and JAX's."""
    rng = np.random.default_rng(C + k)
    rb = init_resblock(jax.random.PRNGKey(C + k), C, k, DIL)
    x = rng.normal(size=(2, 300, C)).astype(np.float32)
    ref = np.asarray(apply_resblock(rb, jnp.asarray(x), k, DIL))
    weights = _torch_weights(rb)
    xt = torch.from_numpy(x)
    xp, wp, kp = mrf.pad_resblock(xt, weights, k)
    assert kp == k and xp.shape[-1] == 32 * -(-C // 32)
    out = mrf.mrf_resblock_plain(xp, wp, kp, DIL)
    plain = mrf.mrf_resblock_plain(xt, weights, k, DIL)
    assert torch.equal(out[..., :C], plain)
    assert torch.count_nonzero(out[..., C:]) == 0
    assert np.abs(out[..., :C].numpy() - ref).max() < 2e-5


def test_plain_resblock_gradient_flows_on_cpu():
    """On a CPU tensor the plain version runs, and its gradient reaches x
    and every weight (the CUDA kernel raises there instead)."""
    gen = torch.Generator().manual_seed(4)
    weights = [((torch.randn(8, 8, 5, generator=gen) * 0.1).requires_grad_(),
                (torch.randn(8, generator=gen) * 0.1).requires_grad_())
               for _ in range(6)]
    x = torch.randn(1, 40, 8, generator=gen, requires_grad=True)
    out = mrf.mrf_resblock(x, weights, 5, DIL)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for p in [x] + [p for pair in weights for p in pair]:
        assert p.grad is not None and p.grad.abs().sum() > 0


def test_bad_shapes_raise():
    x = torch.zeros(1, 10, 32)
    w = [(torch.zeros(32, 32, 3), torch.zeros(32))] * 5
    with pytest.raises(ValueError):
        mrf.mrf_resblock(x, w, 3, DIL)
