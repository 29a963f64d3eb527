"""HiFi-GAN V1 generator at inference.

conv_pre(80→512, k7) → 4 × [leaky_relu(0.1) → ConvTranspose1d (×8, 8, 2, 2)
→ MRF: mean of 3 resblocks (k ∈ {3, 7, 11}, dilations (1, 3, 5))] →
leaky_relu(0.01) → conv_post(→1, k7) → tanh; the plain path of the JAX
package's ``apply_generator``. Activations are feature-last (B, T, C), and
every resblock goes through ``ops.mrf_resblock`` (the CUDA kernel on the
card). Parameter names are the reference's, with weight norm folded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VocoderConfig
from ..ops import conv1d, conv_transpose1d
from ..ops.mrf_resblock import mrf_resblock

LRELU_SLOPE = 0.1


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: tuple[int, ...]):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d)
            for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size)
            for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, T, C)."""
        weights = []
        for c1, c2 in zip(self.convs1, self.convs2):
            weights += [(c1.weight, c1.bias), (c2.weight, c2.bias)]
        return mrf_resblock(x, weights, self.kernel_size, self.dilations)


class Generator(nn.Module):
    def __init__(self, cfg: VocoderConfig, n_mels: int = 80):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            c_out = ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch0 // (2 ** i), c_out, k, u,
                                               padding=(k - u) // 2))
            for kr, dr in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(c_out, kr, tuple(dr)))
        self.conv_post = nn.Conv1d(ch0 // (2 ** len(cfg.upsample_rates)), 1,
                                   7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) → (B, T * prod(upsample_rates)) in [-1, 1]."""
        cfg = self.cfg
        n_kernels = len(cfg.resblock_kernel_sizes)
        x = conv1d(mel, self.conv_pre.weight, self.conv_pre.bias, padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            x = F.leaky_relu(x, LRELU_SLOPE)
            up = self.ups[i]
            x = conv_transpose1d(x, up.weight, up.bias, stride=u,
                                 padding=(k - u) // 2).contiguous()
            xs = None
            for j in range(n_kernels):
                out = self.resblocks[i * n_kernels + j](x)
                xs = out if xs is None else xs + out
            x = xs / n_kernels
        # The reference's final activation is a default-slope (0.01)
        # leaky_relu, not LRELU_SLOPE.
        x = F.leaky_relu(x, 0.01)
        x = conv1d(x, self.conv_post.weight, self.conv_post.bias, padding=3)
        return torch.tanh(x)[..., 0]
