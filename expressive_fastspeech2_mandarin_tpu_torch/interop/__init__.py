"""Weights carried across from the JAX package and from the reference's
checkpoints."""

from .from_jax import (
    fastspeech2_from_jax,
    hifigan_from_jax,
    train_state_from_jax,
)
from .torch_ckpt import (
    fastspeech2_checkpoint_state,
    fold_weight_norm,
    load_generator_npz,
    load_torch_state_dict,
    load_vocoder_state,
)

__all__ = ["fastspeech2_from_jax", "hifigan_from_jax", "train_state_from_jax",
           "fastspeech2_checkpoint_state", "fold_weight_norm",
           "load_generator_npz", "load_torch_state_dict",
           "load_vocoder_state"]
