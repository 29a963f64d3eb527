"""The port's HiFi-GAN generator at full width against the JAX package's
plain path, on the CPU in float32: max |diff| < 5e-4 (the bound of
tests/test_mrf_fused.py)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.config import Config as JaxConfig
from expressive_fastspeech2_mandarin_tpu.models.hifigan import (
    apply_generator,
    init_generator,
)
from expressive_fastspeech2_mandarin_tpu_torch.config import Config
from expressive_fastspeech2_mandarin_tpu_torch.interop import hifigan_from_jax
from expressive_fastspeech2_mandarin_tpu_torch.models import Generator

torch.set_num_threads(2)


def test_full_width_generator_matches_jax_plain_path():
    jcfg = JaxConfig().model.vocoder
    params = init_generator(jax.random.PRNGKey(1), jcfg)
    mel = np.random.default_rng(0).normal(size=(1, 64, 80)).astype(np.float32)
    ref = np.asarray(apply_generator(params, jnp.asarray(mel), jcfg,
                                     fast=False))

    gen = Generator(Config().model.vocoder)
    gen.load_state_dict(hifigan_from_jax(jax.tree.map(np.asarray, params)),
                        strict=True)
    with torch.inference_mode():
        out = gen(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (1, 64 * 256)
    assert np.abs(out - ref).max() < 5e-4
