"""Streaming (chunked) vocoder inference; the JAX package's
``synth/streaming.py``.

The mel is vocoded in chunks of ``chunk_frames`` with a receptive-field
halo, so the first audio is ready after one chunk instead of the whole
utterance. HiFi-GAN is a convnet with a finite receptive field: a chunk of
frames [a, b) runs the generator on the clipped window
[max(a - h, 0), min(b + h, T)) and keeps the central slice. With ``h`` at
least the generator's receptive radius in mel frames, the result equals the
monolithic run up to summation order (window edges that fall on the true
sequence ends match too, because each conv zero-pads there exactly as the
monolithic run does). Each window goes through the port's ``Generator``,
so on the card every resblock of every window runs the MRF kernel.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterator

import torch

from ..config import VocoderConfig
from ..models import Generator


def generator_receptive_radius_frames(cfg: VocoderConfig) -> int:
    """Upper bound of the generator's one-sided receptive field in mel
    frames (the default streaming halo): conv_pre (±3 frames), per stage one
    step before the upsample plus the longest MRF chain at the stage's
    rate, and conv_post."""
    radius = 3.0  # conv_pre, k = 7
    rate = 1.0
    for u in cfg.upsample_rates:
        radius += 1.0 / rate  # the upsample reads x[t-1 .. t+1]
        rate *= u
        chain = max(sum((kr - 1) // 2 * d + (kr - 1) // 2 for d in dil)
                    for kr, dil in zip(cfg.resblock_kernel_sizes,
                                       cfg.resblock_dilation_sizes))
        radius += chain / rate
    radius += 3.0 / rate  # conv_post at the audio rate
    return int(math.ceil(radius)) + 1


def vocode_streaming(generator: Generator, mel: torch.Tensor, *,
                     chunk_frames: int = 100,
                     halo_frames: int | None = None,
                     full_window: Callable[[torch.Tensor], torch.Tensor]
                     | None = None) -> Iterator[torch.Tensor]:
    """Yield waveform chunks for ``mel`` (B, T, n_mels), in the generator's
    device and dtype. Each chunk is (B, chunk_frames * hop) samples except
    perhaps the last; their concatenation equals ``generator(mel)``.
    ``full_window``, where given, vocodes the windows of the full width
    (``chunk_frames`` + 2 halos; the Synthesizer's compiled generator,
    one CUDA graph) and the generator the clipped ones at the ends."""
    if halo_frames is None:
        halo_frames = generator_receptive_radius_frames(generator.cfg)
    t = mel.shape[1]
    up = math.prod(generator.cfg.upsample_rates)
    full = chunk_frames + 2 * halo_frames
    for a in range(0, t, chunk_frames):
        b = min(a + chunk_frames, t)
        w0 = max(a - halo_frames, 0)
        w1 = min(b + halo_frames, t)
        run = generator
        if full_window is not None and w1 - w0 == full:
            run = full_window
        with torch.inference_mode():
            wav = run(mel[:, w0:w1, :])
        yield wav[:, (a - w0) * up: (b - w0) * up]
