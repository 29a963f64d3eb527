"""Batched multi-head self-attention for the FFT blocks (the math path of the
JAX package's ``ops/attention.py``).

Masked keys get ``-inf`` before the softmax; a row whose keys are all masked
comes out as zeros. The projections are ``nn.Linear`` weights, ``(H*D, D_model)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FLASH_NOT_PORTED = (
    "attention_impl='flash' is not ported yet (ROADMAP.md, queue 2: "
    "flash_mha); use 'auto'")


def multi_head_attention(
    x: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    n_head: int,
    key_padding_mask: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Self-attention core: (B, T, D) → (B, T, H*Dv); ``key_padding_mask``
    is (B, T), True at padded keys. ``impl``: "auto" and "xla" (the JAX
    package's name for this math path) run it; "flash" is not ported."""
    if impl == "flash":
        raise NotImplementedError(_FLASH_NOT_PORTED)
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    b, t, _ = x.shape

    def split(h):
        return h.reshape(b, t, n_head, -1).transpose(1, 2)  # (B, H, T, D)

    q = split(F.linear(x, wq, bq))
    k = split(F.linear(x, wk, bk))
    v = split(F.linear(x, wv, bv))
    sm_scale = float(q.shape[-1]) ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                float("-inf"))
    attn = masked_softmax(scores)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.transpose(1, 2).reshape(b, t, -1).to(x.dtype)


def masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis; rows that are all ``-inf`` → 0."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)
