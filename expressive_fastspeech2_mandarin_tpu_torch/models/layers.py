"""Small layers that give the port's modules the reference's state-dict
names (``<name>.conv.weight`` for wrapped convs, BatchNorm without
``num_batches_tracked``, ``weight_v``/``weight_g`` for weight norm)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import batch_norm_inference, batch_norm_train


class WrappedConv1d(nn.Module):
    """A Conv1d held as ``.conv``, the reference's ``Conv``/``ConvNorm``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size)


class BatchNorm(nn.Module):
    """BatchNorm1d over the last axis of (B, T, C): affine parameters and
    running statistics. ``forward`` normalizes with the running statistics;
    ``forward_train`` with the batch's (the global batch's under a
    data-parallel ``layout``), updating the running ones in place."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_inference(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.eps)

    def forward_train(self, x: torch.Tensor, layout=None) -> torch.Tensor:
        out, mean, var = batch_norm_train(x, self.weight, self.bias,
                                          self.running_mean,
                                          self.running_var, eps=self.eps,
                                          layout=layout)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return out


def weight_norm_g(weight: torch.Tensor) -> torch.Tensor:
    """‖weight‖ over every dim but 0, kept as (C, 1, ...): the ``g`` that
    makes the weight-norm kernel equal ``weight`` (torch ``weight_norm``'s
    initial value)."""
    dims = tuple(range(1, weight.ndim))
    return weight.square().sum(dim=dims, keepdim=True).sqrt()


def wn_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kernel = g · v / ‖v‖, the norm over every dim but 0 (per C_out of a
    Conv1d, per C_in of a ConvTranspose1d) taken in float32 (float64 for a
    float64 v) with its square clamped at 1e-24; the JAX package's
    ``models/hifigan_disc.py:wn_kernel`` in torch layouts."""
    dims = tuple(range(1, v.ndim))
    sq = v.to(torch.promote_types(v.dtype, torch.float32)).square().sum(
        dim=dims, keepdim=True)
    norm = sq.clamp_min(1e-24).sqrt().to(v.dtype)
    return g * v / norm


class WeightNormConv(nn.Module):
    """A conv (or transposed conv) held as ``weight_v``, ``weight_g`` and
    ``bias``, the names of torch's ``weight_norm``; ``weight`` is
    ``wn_kernel(weight_v, weight_g)``, computed where it is read. Made from
    a plain weight, which it equals at first (g = ‖v‖)."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight_v = nn.Parameter(weight.detach().clone())
        self.weight_g = nn.Parameter(weight_norm_g(weight.detach()))
        self.bias = nn.Parameter(bias.detach().clone())

    @property
    def weight(self) -> torch.Tensor:
        return wn_kernel(self.weight_v, self.weight_g)
