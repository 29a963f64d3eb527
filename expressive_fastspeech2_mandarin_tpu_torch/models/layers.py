"""Small layers that give the port's modules the reference's state-dict
names (``<name>.conv.weight`` for wrapped convs, BatchNorm without
``num_batches_tracked``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import batch_norm_inference


class WrappedConv1d(nn.Module):
    """A Conv1d held as ``.conv``, the reference's ``Conv``/``ConvNorm``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size)


class BatchNormInference(nn.Module):
    """BatchNorm1d at inference: affine parameters and running statistics,
    applied over the last axis of (B, T, C)."""

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
