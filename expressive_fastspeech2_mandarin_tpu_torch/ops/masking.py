"""Mask utilities. ``True`` marks *padding* positions, as in the reference."""

from __future__ import annotations

import torch


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, max_len) bool mask, True at padded positions."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] >= lengths[:, None]
