"""Batched multi-head self-attention for the FFT blocks (the JAX package's
``ops/attention.py``).

Masked keys get ``-inf`` before the softmax; a row whose keys are all masked
comes out as zeros. The projections are ``nn.Linear`` weights, ``(H*D, D_model)``.
``impl`` chooses the core, as the JAX package does:

* ``"xla"`` (the JAX package's name for the math path): ``flash_mha_plain``;
* ``"flash"``: ``flash_mha``, the CUDA kernels on the card, forward and,
  when a gradient is wanted, backward (``FlashMHA``); the plain versions on
  the CPU;
* ``"auto"``: flash on the card when T > 2048 and D = 128, the head dim the
  kernel takes (the JAX rule, with "on a TPU" read as "on the card" and
  "D % 128 == 0" as "D = 128"), else the math path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_mha import flash_mha, flash_mha_plain, supported


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
    is (B, T), True at padded keys."""
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    b, t, _ = x.shape

    def split(h):
        return h.reshape(b, t, n_head, -1).transpose(1, 2)  # (B, H, T, D)

    q = split(F.linear(x, wq, bq))
    k = split(F.linear(x, wk, bk))
    v = split(F.linear(x, wv, bv))
    head_dim = q.shape[-1]
    sm_scale = float(head_dim) ** -0.5
    if impl == "auto":
        impl = "flash" if supported(x.device, t, head_dim) else "xla"
    if impl == "flash":
        out = flash_mha(q.contiguous(), k.contiguous(), v.contiguous(),
                        key_padding_mask, sm_scale)
    else:
        out = flash_mha_plain(q, k, v, key_padding_mask, sm_scale)
    return out.transpose(1, 2).reshape(b, t, -1).to(x.dtype)
