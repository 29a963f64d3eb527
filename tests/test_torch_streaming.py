"""The port's streaming vocoder on the CPU in float32: the receptive radius
equals the JAX package's; the concatenated chunks equal the port's
monolithic generator (< 2e-5, the bound of tests/test_streaming.py) and
the JAX package's ``vocode_streaming`` chunk for chunk at a small width
(< 5e-4, the generator bound of tests/test_torch_hifigan.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expressive_fastspeech2_mandarin_tpu.config import (
    VocoderConfig as JaxVocoderConfig,
)
from expressive_fastspeech2_mandarin_tpu.interop.torch_ckpt import (
    convert_hifigan,
)
from expressive_fastspeech2_mandarin_tpu.synth import streaming as jstream
from expressive_fastspeech2_mandarin_tpu_torch.config import VocoderConfig
from expressive_fastspeech2_mandarin_tpu_torch.models import Generator
from expressive_fastspeech2_mandarin_tpu_torch.synth.streaming import (
    generator_receptive_radius_frames,
    vocode_streaming,
)

torch.set_num_threads(2)
SMALL = {"upsample_initial_channel": 64}


def _generator(seed: int, **small):
    """The port's generator with torch's seeded initialisation, and the same
    weights as a JAX parameter tree (through the JAX package's
    ``convert_hifigan``)."""
    torch.manual_seed(seed)
    gen = Generator(dataclasses.replace(VocoderConfig(), **small)).eval()
    params = convert_hifigan({k: v.numpy()
                              for k, v in gen.state_dict().items()})
    return gen, params, dataclasses.replace(JaxVocoderConfig(), **small)


def _mel(b: int, t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, t, 80)).astype(
        np.float32)


@pytest.mark.parametrize("overrides", [
    {}, {"resblock_kernel_sizes": (3, 5, 7)},
    {"upsample_rates": (8, 8, 4), "upsample_kernel_sizes": (16, 16, 8)}])
def test_receptive_radius_matches_jax(overrides):
    port = generator_receptive_radius_frames(
        dataclasses.replace(VocoderConfig(), **overrides))
    ref = jstream.generator_receptive_radius_frames(
        dataclasses.replace(JaxVocoderConfig(), **overrides))
    assert port == ref


def test_streaming_matches_port_monolithic_full_width():
    gen, _, _ = _generator(0)
    mel = torch.from_numpy(_mel(2, 37, 0))
    with torch.inference_mode():
        full = gen(mel)
    out = torch.cat(list(vocode_streaming(gen, mel, chunk_frames=8)), dim=1)
    assert out.shape == full.shape == (2, 37 * 256)
    assert (out - full).abs().max().item() < 2e-5


def test_small_halo_shows_the_seams():
    """With a halo of 1 frame the chunks differ from the monolithic run, so
    the test above is not vacuous."""
    gen, _, _ = _generator(0, **SMALL)
    mel = torch.from_numpy(_mel(1, 30, 1))
    with torch.inference_mode():
        full = gen(mel)
    out = torch.cat(list(vocode_streaming(gen, mel, chunk_frames=8,
                                          halo_frames=1)), dim=1)
    assert (out - full).abs().max().item() > 1e-4


def test_streaming_matches_jax_chunk_for_chunk():
    gen, params, jcfg = _generator(2, **SMALL)
    mel = _mel(1, 40, 2)  # two windows of the same length, 34 frames
    ref = [np.asarray(c) for c in jstream.vocode_streaming(
        params, jnp.asarray(mel), jcfg, chunk_frames=20)]
    out = [c.numpy() for c in vocode_streaming(gen, torch.from_numpy(mel),
                                               chunk_frames=20)]
    assert [c.shape for c in out] == [c.shape for c in ref] == [(1, 5120)] * 2
    for a, b in zip(out, ref):
        assert np.abs(a - b).max() < 5e-4
