"""Weights carried across from the JAX package and from the reference's
checkpoints."""

from .from_jax import (
    discriminator_from_jax,
    fastspeech2_from_jax,
    hifigan_from_jax,
    melgan_from_jax,
    train_state_from_jax,
    vocoder_train_state_from_jax,
    wn_generator_from_jax,
)
from .torch_ckpt import (
    fastspeech2_checkpoint_state,
    fold_weight_norm,
    load_generator_npz,
    load_torch_state_dict,
    load_vocoder_state,
    melgan_from_state_dict,
)

__all__ = ["discriminator_from_jax", "fastspeech2_from_jax",
           "hifigan_from_jax", "melgan_from_jax", "train_state_from_jax",
           "vocoder_train_state_from_jax", "wn_generator_from_jax",
           "fastspeech2_checkpoint_state", "fold_weight_norm",
           "load_generator_npz", "load_torch_state_dict",
           "load_vocoder_state", "melgan_from_state_dict"]
