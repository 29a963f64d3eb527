"""Mandarin expressive TTS (FastSpeech2 + HiFi-GAN) in PyTorch for NVIDIA
Hopper: the port of ``expressive_fastspeech2_mandarin_tpu``.

This package imports ``torch`` and nothing of JAX or of the JAX package.
Its entry points — ``synth.Synthesizer`` and ``train.train`` — run on
``cuda`` unless the caller passes ``device="cpu"``. On the card the HiFi-GAN
MRF resblocks and the flash attention forward and backward run hand-written
CUDA kernels (``csrc/``), built at first use.
"""

__version__ = "0.1.0"
