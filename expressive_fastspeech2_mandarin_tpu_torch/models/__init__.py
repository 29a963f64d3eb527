"""FastSpeech2 and the HiFi-GAN generator as ``nn.Module``s."""

from .fastspeech2 import FastSpeech2, FastSpeech2Output
from .hifigan import Generator, ResBlock
from .transformer import sinusoid_encoding_table

__all__ = ["FastSpeech2", "FastSpeech2Output", "Generator", "ResBlock",
           "sinusoid_encoding_table"]
