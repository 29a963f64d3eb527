"""Compute primitives of synthesis and training. The CUDA kernels of the
card, each with its plain version and launch counter, are in
``ops.mrf_resblock`` (the HiFi-GAN MRF resblock) and ``ops.flash_mha`` (the
attention core, forward and backward, that ``multi_head_attention`` takes
under ``"flash"`` and, with ``"auto"``, past 2048 frames). Training's
dropout is ``ops.dropout``."""

from .attention import multi_head_attention
from .conv import (
    batch_norm_inference,
    batch_norm_train,
    conv1d,
    conv_transpose1d,
    layer_norm,
    reflect_pad,
)
from .length_regulator import length_regulate
from .masking import mask_from_lengths

__all__ = [
    "multi_head_attention",
    "conv1d",
    "conv_transpose1d",
    "layer_norm",
    "reflect_pad",
    "batch_norm_inference",
    "batch_norm_train",
    "length_regulate",
    "mask_from_lengths",
]
