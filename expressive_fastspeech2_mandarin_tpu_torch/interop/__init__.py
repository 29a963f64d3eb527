"""Weights carried across from the JAX package."""

from .from_jax import fastspeech2_from_jax, hifigan_from_jax

__all__ = ["fastspeech2_from_jax", "hifigan_from_jax"]
