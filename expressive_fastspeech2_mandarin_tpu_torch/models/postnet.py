"""PostNet: 5 × conv1d(k=5) + BatchNorm, tanh on every layer but the last;
the residual add is the caller's. At inference BatchNorm uses its running
statistics; in training (a dropout generator given) it uses the batch's and
updates the running ones in place, and a fixed 0.5 dropout follows every
layer. The JAX package's ``models/postnet.py``."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import conv1d
from ..ops.dropout import dropout
from .layers import BatchNorm, WrappedConv1d

# The reference's postnet dropout, not in the configuration.
POSTNET_DROPOUT = 0.5


class PostNet(nn.Module):
    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        dims = ([(n_mel_channels, embedding_dim)]
                + [(embedding_dim, embedding_dim)] * (n_convolutions - 2)
                + [(embedding_dim, n_mel_channels)])
        self.convolutions = nn.ModuleList([
            nn.Sequential(WrappedConv1d(c_in, c_out, kernel_size),
                          BatchNorm(c_out))
            for c_in, c_out in dims])

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                layout=None) -> torch.Tensor:
        """(B, T, n_mels) → (B, T, n_mels) residual. ``mask`` (True at
        padded frames) zeroes each layer's output there. A ``generator``
        selects training mode; ``layout`` is its data-parallel layout."""
        pad = (self.kernel_size - 1) // 2
        n = len(self.convolutions)
        for i, (wrapped, bn) in enumerate(self.convolutions):
            x = conv1d(x, wrapped.conv.weight, wrapped.conv.bias, padding=pad)
            x = bn(x) if generator is None else bn.forward_train(x, layout)
            if i < n - 1:
                x = torch.tanh(x)
            x = dropout(x, POSTNET_DROPOUT, generator, layout)
            if mask is not None:
                x = x.masked_fill(mask[..., None], 0.0)
        return x
