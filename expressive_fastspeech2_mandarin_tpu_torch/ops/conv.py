"""1-D convolutions and normalisations on feature-last ``(B, T, C)``
activations, the layout of the JAX package's ``ops/conv.py``.

Kernels are stored as ``torch.nn.Conv1d`` keeps them, ``(C_out, C_in, K)``,
and transposed convs as ``(C_in, C_out, K)``; the convolutions themselves are
``F.conv1d`` / ``F.conv_transpose1d`` over a ``(B, C, T)`` view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """(B, T, Cin) ⊛ (Cout, Cin, K) → (B, T', Cout)."""
    out = F.conv1d(x.transpose(1, 2), weight, bias, padding=padding,
                   dilation=dilation)
    return out.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d on (B, T, Cin); weight (Cin, Cout, K).
    Output length is ``(T-1)*stride - 2*padding + K``."""
    out = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride,
                             padding=padding)
    return out.transpose(1, 2)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; the normalised
    value returns to x's dtype before the affine, as in the JAX package."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def batch_norm_inference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the channel (last) axis using running statistics."""
    inv = torch.rsqrt(running_var + eps)
    return (x - running_mean) * inv * gamma + beta


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, *,
                     momentum: float = 0.1, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over the channel (last) axis of (B, T, C):
    returns (out, new_running_mean, new_running_var), as torch's
    BatchNorm1d. Statistics are float32 over every B·T row, padded rows
    included; the biased variance normalizes, the unbiased one enters the
    running average, and ``momentum`` weighs the new observation."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean = xf.mean(dim=0)
    var = (xf - mean).square().mean(dim=0)
    n = xf.shape[0]
    unbiased = var * (n / max(n - 1, 1))
    out = (((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype)
           * gamma + beta)
    new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
    new_var = (1 - momentum) * running_var + momentum * unbiased.detach()
    return out, new_mean, new_var
