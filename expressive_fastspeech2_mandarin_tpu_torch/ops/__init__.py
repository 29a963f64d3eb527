"""Compute primitives of the synthesis path. The MRF resblock, a CUDA kernel
on the card, is in ``ops.mrf_resblock`` with its launch counter."""

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
