"""Vectorised length regulation: expand phoneme states by their durations.

    ends    = cumsum(durations)                  # (B, S)
    index_t = searchsorted(ends, t, right=True)  # frame t → phoneme index
    out     = x[b, index_t]                      # one batched gather

Frames past an utterance's total duration would index phoneme S; the index
is clamped to S-1 (JAX clamps gathers silently, torch asserts on the device)
and those frames are zeroed, reproducing the reference's zero padding.
"""

from __future__ import annotations

import torch


def frame_to_phoneme_index(durations: torch.Tensor,
                           max_mel_len: int) -> torch.Tensor:
    """(B, S) int durations → (B, T) index of the phoneme owning each frame."""
    ends = torch.cumsum(durations, dim=-1)
    frames = torch.arange(max_mel_len, device=durations.device,
                          dtype=ends.dtype)
    idx = torch.searchsorted(
        ends, frames.expand(ends.shape[0], -1).contiguous(), right=True)
    return idx.clamp(max=durations.shape[-1] - 1)


def length_regulate(x: torch.Tensor, durations: torch.Tensor,
                    max_mel_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, S, D) phoneme states to (B, T, D) frame states.

    Returns ``(frames, mel_lens)`` with ``mel_lens[b] = sum(durations[b])``
    clamped to ``max_mel_len``; positions past ``mel_lens`` are zero.
    """
    durations = durations.to(torch.int32)
    idx = frame_to_phoneme_index(durations, max_mel_len)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    mel_lens = durations.sum(dim=-1, dtype=torch.int32).clamp(max=max_mel_len)
    frames = torch.arange(max_mel_len, device=x.device)
    valid = frames[None, :] < mel_lens[:, None]
    return out.masked_fill(~valid[..., None], 0.0), mel_lens
