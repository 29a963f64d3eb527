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


def test_bad_shapes_raise():
    x = torch.zeros(1, 10, 32)
    w = [(torch.zeros(32, 32, 3), torch.zeros(32))] * 5
    with pytest.raises(ValueError):
        mrf.mrf_resblock(x, w, 3, DIL)
