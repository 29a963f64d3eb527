"""Small layers that give the port's modules the reference's state-dict
names (``<name>.conv.weight`` for wrapped convs, BatchNorm without
``num_batches_tracked``)."""

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
    ``forward_train`` with the batch's, updating the running ones in
    place."""

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

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        out, mean, var = batch_norm_train(x, self.weight, self.bias,
                                          self.running_mean,
                                          self.running_var, eps=self.eps)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return out
