"""FastSpeech2, the HiFi-GAN generator and discriminators, and MelGAN as
``nn.Module``s."""

from .fastspeech2 import FastSpeech2, FastSpeech2Output
from .hifigan import Generator, ResBlock, save_generator_npz
from .hifigan_disc import MPD, MSD
from .melgan import MelGAN
from .transformer import sinusoid_encoding_table

__all__ = ["FastSpeech2", "FastSpeech2Output", "Generator", "ResBlock",
           "save_generator_npz", "MPD", "MSD", "MelGAN",
           "sinusoid_encoding_table"]
