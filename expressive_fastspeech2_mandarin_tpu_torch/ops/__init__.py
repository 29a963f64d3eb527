"""Compute primitives of the synthesis path. The two CUDA kernels of the
card, each with its plain version and launch counter, are in
``ops.mrf_resblock`` (the HiFi-GAN MRF resblock) and ``ops.flash_mha`` (the
attention core that ``multi_head_attention`` takes past 2048 frames)."""

from .attention import multi_head_attention
from .conv import batch_norm_inference, conv1d, conv_transpose1d, layer_norm
from .length_regulator import length_regulate
from .masking import mask_from_lengths

__all__ = [
    "multi_head_attention",
    "conv1d",
    "conv_transpose1d",
    "layer_norm",
    "batch_norm_inference",
    "length_regulate",
    "mask_from_lengths",
]
