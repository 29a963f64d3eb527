"""Mandarin expressive TTS (FastSpeech2 + HiFi-GAN) in PyTorch for NVIDIA
Hopper: the port of ``expressive_fastspeech2_mandarin_tpu``.

This package imports ``torch`` and nothing of JAX or of the JAX package.
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the card, the HiFi-GAN MRF resblocks run a hand-written CUDA kernel
(``csrc/mrf_resblock.cu``), built at first use.
"""

__version__ = "0.1.0"
