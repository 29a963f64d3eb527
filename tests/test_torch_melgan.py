"""The port's MelGAN (models/melgan.py) and its loaders
(interop.torch_ckpt.melgan_from_state_dict, interop.from_jax.melgan_from_jax)
against the JAX package's ``apply_melgan`` and ``convert_melgan``, on the
CPU in float32, from a random state dict of the melgan-neurips torch
generator (tests/test_melgan.py's replica, weight norm included).

Bounds: the waveform rtol 1e-4, atol 2e-4 (tests/test_melgan.py:81); the
loaded weights 1e-6 relative (weight norm folded by each package in its
own float32 order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.models.melgan import (
    apply_melgan,
    convert_melgan,
)
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    melgan_from_jax,
    melgan_from_state_dict,
)
from expressive_fastspeech2_mandarin_tpu_torch.models import MelGAN

from .test_melgan import _build_torch_melgan

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def checkpoint():
    """A melgan-neurips state dict (``model.`` prefixed, as the hub
    module's ``mel2wav`` saves it) from a seed."""
    torch.manual_seed(0)
    ref = _build_torch_melgan().eval()
    return {f"model.{k}": v.detach().clone()
            for k, v in ref.state_dict().items()}


def _port(state):
    melgan = MelGAN()
    melgan.load_state_dict(state, strict=True)
    return melgan.eval()


@pytest.mark.parametrize("from_natural_log", [True, False])
def test_melgan_matches_jax(checkpoint, from_natural_log):
    params = convert_melgan({k: v.numpy() for k, v in checkpoint.items()})
    melgan = _port(melgan_from_state_dict(checkpoint))
    mel = np.random.default_rng(0).normal(-1, 1, (2, 19, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        apply_melgan, from_natural_log=from_natural_log))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(mel)))
    with torch.no_grad():
        out = melgan(torch.from_numpy(mel), from_natural_log).numpy()
    assert out.shape == ref.shape == (2, 19 * 256)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-4)


def test_melgan_from_state_dict_matches_convert_melgan(checkpoint):
    """Both loaders give the same weights: the reference checkpoint
    directly, and through the JAX package's convert_melgan and
    melgan_from_jax; and every prefix convert_melgan takes."""
    ours = melgan_from_state_dict(checkpoint)
    ref = melgan_from_jax(convert_melgan(
        {k: v.numpy() for k, v in checkpoint.items()}))
    assert ours.keys() == ref.keys() == MelGAN().state_dict().keys()
    for k in ours:
        torch.testing.assert_close(ours[k], ref[k], rtol=1e-6, atol=1e-7)
    bare = {k[len("model."):]: v for k, v in checkpoint.items()}
    nested = {f"mel2wav.{k}": v for k, v in checkpoint.items()}
    for sd in (bare, nested):
        other = melgan_from_state_dict(sd)
        for k in ours:
            assert torch.equal(other[k], ours[k]), k


def test_short_mel_reflect_pads_past_its_length():
    """One mel frame: the first stage's dilated convs pad by more than its
    8 samples, which numpy's reflect (and the JAX package) take."""
    melgan = MelGAN().eval()
    mel = torch.randn(1, 1, 80, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = melgan(mel)
    assert out.shape == (1, 256) and torch.isfinite(out).all()
