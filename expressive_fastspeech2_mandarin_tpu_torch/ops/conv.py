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


def reflect_pad(x: torch.Tensor, left: int, right: int,
                dim: int = 1) -> torch.Tensor:
    """``numpy.pad(mode="reflect")`` along ``dim``: mirrored about the end
    samples, which are not repeated, and reflected again where the pad is
    longer than the axis (``F.pad`` refuses a pad that long)."""
    n = x.shape[dim]
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx >= n, period - idx, idx)
    return x.index_select(dim, idx)


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
                     momentum: float = 0.1, eps: float = 1e-5, layout=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over the channel (last) axis of (B, T, C):
    returns (out, new_running_mean, new_running_var), as torch's
    BatchNorm1d. Statistics are float32 over every B·T row, padded rows
    included; the biased variance normalizes, the unbiased one enters the
    running average, and ``momentum`` weighs the new observation. With a
    data-parallel ``layout`` (``parallel.Layout``) the rows are the global
    batch's: the mean, then the centred variance, each a sum taken over
    the ranks through autograd (``layout.sum``), as the JAX package's
    jitted step takes them over a sharded batch."""
    xf = x.float().reshape(-1, x.shape[-1])
    n = xf.shape[0]
    replicas = 1

    def total(t: torch.Tensor) -> torch.Tensor:
        t = t.sum(dim=0)
        return t if layout is None else layout.sum(t)

    if layout is not None:
        # The sums over the world hold each of the global batch's rows
        # once per model-parallel replica.
        n *= layout.data_parallel
        replicas = layout.model_parallel
    mean = total(xf) / (n * replicas)
    var = total((xf - mean).square()) / (n * replicas)
    unbiased = var * (n / max(n - 1, 1))
    out = (((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype)
           * gamma + beta)
    new_mean = (1 - momentum) * running_mean + momentum * mean.detach()
    new_var = (1 - momentum) * running_var + momentum * unbiased.detach()
    return out, new_mean, new_var
