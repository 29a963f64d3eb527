"""The port's ops against the JAX package's, on the CPU, at atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.models.variance import (
    bucketize as jax_bucketize,
)
from expressive_fastspeech2_mandarin_tpu.ops import (
    layer_norm as jax_layer_norm,
    length_regulate as jax_length_regulate,
    mask_from_lengths as jax_mask_from_lengths,
    multi_head_attention as jax_mha,
)
from expressive_fastspeech2_mandarin_tpu_torch.models.variance import bucketize
from expressive_fastspeech2_mandarin_tpu_torch.ops import (
    layer_norm,
    length_regulate,
    mask_from_lengths,
    multi_head_attention,
)

torch.set_num_threads(2)
ATOL = 1e-6


def test_mask_from_lengths():
    lens = np.array([0, 3, 7, 7], np.int32)
    ref = np.asarray(jax_mask_from_lengths(jnp.asarray(lens), 7))
    out = mask_from_lengths(torch.from_numpy(lens), 7).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", ["zeros", "overflow", "plain"])
def test_length_regulate(case):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    dur = rng.integers(0, 5, size=(3, 6)).astype(np.int32)
    max_mel = 40
    if case == "zeros":
        dur[0] = 0            # an utterance of zero frames
        dur[1, ::2] = 0       # zero-duration phones
    elif case == "overflow":
        dur[2] = 12           # total 72 > max_mel_len
    ref_frames, ref_lens = jax_length_regulate(
        jnp.asarray(x), jnp.asarray(dur), max_mel)
    frames, lens = length_regulate(torch.from_numpy(x),
                                   torch.from_numpy(dur), max_mel)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames),
                               atol=ATOL, rtol=0)


def test_attention_with_fully_padded_row():
    rng = np.random.default_rng(1)
    b, t, d, h = 3, 9, 16, 2
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    ws = [rng.normal(size=(d, d)).astype(np.float32) * 0.3 for _ in range(3)]
    bs = [rng.normal(size=(d,)).astype(np.float32) * 0.1 for _ in range(3)]
    lens = np.array([9, 4, 0])  # the last row is fully padded
    mask = np.arange(t)[None, :] >= lens[:, None]
    jargs = []
    targs = []
    for w, bias in zip(ws, bs):
        jargs += [jnp.asarray(w), jnp.asarray(bias)]
        targs += [torch.from_numpy(w.T.copy()), torch.from_numpy(bias)]
    ref = np.asarray(jax_mha(jnp.asarray(x), *jargs, h, jnp.asarray(mask),
                             impl="xla"))
    out = multi_head_attention(torch.from_numpy(x), *targs, h,
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[2], 0.0)


def _attention_inputs(b, t, d, lens, seed):
    """x and (weight, bias) pairs for both packages: JAX (d_in, d_out),
    torch nn.Linear (d_out, d_in)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    jargs, targs = [], []
    for _ in range(3):
        w = rng.normal(size=(d, d)).astype(np.float32) * d ** -0.5
        bias = rng.normal(size=(d,)).astype(np.float32) * 0.1
        jargs += [jnp.asarray(w), jnp.asarray(bias)]
        targs += [torch.from_numpy(w.T.copy()), torch.from_numpy(bias)]
    return x, mask, jargs, targs


def test_attention_flash_matches_jax_flash_at_valid_rows():
    """impl="flash" on the CPU (the plain version) against the JAX
    package's impl="flash" (the TPU kernel in interpret mode), at the valid
    query rows (the FFT block zeroes the others), within 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    lens = (200, 61)
    x, mask, jargs, targs = _attention_inputs(2, 200, 256, lens, seed=4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_mha(jnp.asarray(x), *jargs, 2,
                                 jnp.asarray(mask), impl="flash"))
    out = multi_head_attention(torch.from_numpy(x), *targs, 2,
                               torch.from_numpy(mask), impl="flash").numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=1e-5, rtol=0)


def test_attention_auto_on_cpu_takes_the_math_path():
    """Past 2048 frames with D = 128, "auto" still takes the math path on
    the CPU (as the JAX package's does off the TPU): no kernel launch, and
    the result equals impl="xla"."""
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha

    x, mask, _, targs = _attention_inputs(1, 2100, 256, (1900,), seed=5)
    args = (torch.from_numpy(x), *targs, 2, torch.from_numpy(mask))
    before = flash_mha.launch_count
    auto = multi_head_attention(*args, impl="auto")
    assert flash_mha.launch_count == before
    torch.testing.assert_close(auto, multi_head_attention(*args, impl="xla"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown attention_impl"):
        multi_head_attention(*args, impl="sdpa")


def test_layer_norm():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3 + 1
    g = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b)))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_bucketize_exact_hits_go_left():
    bins = np.linspace(-2.0, 8.0, 255).astype(np.float32)
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.uniform(-4, 10, 200).astype(np.float32),
                           bins[::17]])  # exact boundary hits
    ref = np.asarray(jax_bucketize(jnp.asarray(vals), jnp.asarray(bins)))
    out = bucketize(torch.from_numpy(vals), torch.from_numpy(bins)).numpy()
    np.testing.assert_array_equal(out, ref)
