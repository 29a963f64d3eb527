"""The port's ``flash_mha`` against the JAX package's, on the CPU.

* Against the JAX ``flash_mha`` (the stock TPU Pallas kernel, run in
  interpret mode) at (B, H, D) = (2, 2, 128), T ∈ {300, 2176}, ragged key
  lengths: equal at the valid query rows within 1e-5 (float32, summation
  order and ``exp``). Padded query rows differ by design: the TPU kernel's
  segment IDs let them attend to padded keys, the port masks keys only, and
  the FFT block zeroes those rows in both packages.
* The plain version against the JAX package's math path (``impl="xla"``,
  ``ops/attention.py:64-80``) at every row, with a row of length 0 giving 0.

The CUDA kernel's own tests are in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from expressive_fastspeech2_mandarin_tpu.ops.attention import (
    _softmax as jax_softmax,
)
from expressive_fastspeech2_mandarin_tpu.ops.pallas.flash_mha import (
    flash_mha as jax_flash_mha,
)
from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm

torch.set_num_threads(2)
ATOL = 1e-5
SCALE = 128 ** -0.5


def _inputs(t: int, lens, seed: int, b: int = 2, h: int = 2, d: int = 128):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, mask


def _port(q, k, v, mask):
    return fm.flash_mha(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                        SCALE).numpy()


@pytest.mark.parametrize("t,lens", [(300, (300, 37)), (2176, (2176, 1000))])
def test_matches_jax_flash_kernel_at_valid_rows(t, lens):
    q, k, v, mask = _inputs(t, lens, seed=t)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash_mha(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), SCALE))
    out = _port(q, k, v, mask)
    assert out.shape == ref.shape == q.shape
    for i, n in enumerate(lens):
        np.testing.assert_allclose(out[i, :, :n], ref[i, :, :n], atol=ATOL,
                                   rtol=0)


def test_plain_matches_jax_math_path_at_every_row():
    lens = (77, 0, 5)
    q, k, v, mask = _inputs(77, lens, seed=1, b=3)
    scores = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        preferred_element_type=jnp.float32) * SCALE
    scores = jnp.where(jnp.asarray(mask)[:, None, None, :], -jnp.inf, scores)
    ref = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", jax_softmax(scores),
                                jnp.asarray(v),
                                preferred_element_type=jnp.float32))
    out = _port(q, k, v, mask)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[1], 0.0)  # no valid key → 0
    assert np.abs(out[0]).max() > 0.1


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = (torch.from_numpy(a)
                     for a in _inputs(40, (40, 9), seed=2))
    before = fm.launch_count
    out = fm.flash_mha(q, k, v, mask, SCALE)
    assert fm.launch_count == before
    torch.testing.assert_close(out, fm.flash_mha_plain(q, k, v, mask, SCALE),
                               rtol=0, atol=0)
    # float64 inputs keep float64 (the card's float64 reference).
    out64 = fm.flash_mha_plain(q.double(), k.double(), v.double(), mask,
                               SCALE)
    assert out64.dtype == torch.float64
    assert (out64 - out.double()).abs().max() < ATOL


@pytest.mark.parametrize("device,t,d,expected", [
    ("cuda", 2049, 128, True), ("cuda", 4096, 256, True),
    ("cuda", 2048, 128, False), ("cuda", 4096, 64, False),
    ("cpu", 4096, 128, False)])
def test_supported_takes_the_kernel_head_dim_past_2048_on_the_card(
        device, t, d, expected):
    # ``expected`` in both dtypes, which have kernels at D = 128 and 256.
    # D = 64 stays on the math path, as in JAX.
    dev = torch.device(device)
    assert fm.supported(dev, t, d, torch.float32) is expected
    assert fm.supported(dev, t, d, torch.bfloat16) is expected
