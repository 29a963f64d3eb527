"""MelGAN generator, the reference's alternative vocoder; the JAX package's
``models/melgan.py:69-94`` (``apply_melgan``).

The melgan-neurips multi-speaker generator: reflect-padded conv7 (80→512)
→ per ratio r ∈ (8, 8, 2, 2): leaky_relu(0.2) → ConvTranspose1d (k=2r,
stride r, padding r/2) halving the channels → 3 residual blocks with
dilations 3^j (reflect-padded dilated conv3, conv1, plus a conv1 shortcut)
→ leaky_relu → reflect-padded conv7 (32→1) → tanh. Activations are
feature-last (B, T, C); the convs are stock ``F.conv1d`` and
``F.conv_transpose1d``, as the JAX package computes them outside any Pallas
kernel. Weight norm is folded when a checkpoint is loaded
(``interop.torch_ckpt.melgan_from_state_dict``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv1d, conv_transpose1d
from ..ops.conv import reflect_pad

RATIOS = (8, 8, 2, 2)
NGF = 32
N_RESIDUAL = 3
LRELU_SLOPE = 0.2


def _reflect_conv(x: torch.Tensor, conv: nn.Conv1d,
                  dilation: int = 1) -> torch.Tensor:
    pad = dilation * (conv.kernel_size[0] - 1) // 2
    return conv1d(reflect_pad(x, pad, pad, dim=1), conv.weight, conv.bias,
                  dilation=dilation)


class ResnetBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_dilated = nn.Conv1d(channels, channels, 3)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)
        self.shortcut = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        h = _reflect_conv(F.leaky_relu(x, LRELU_SLOPE), self.conv_dilated,
                          dilation)
        h = conv1d(F.leaky_relu(h, LRELU_SLOPE), self.conv_1x1.weight,
                   self.conv_1x1.bias)
        return h + conv1d(x, self.shortcut.weight, self.shortcut.bias)


class MelGAN(nn.Module):
    def __init__(self, n_mels: int = 80):
        super().__init__()
        ch = NGF * 2 ** len(RATIOS)
        self.conv_pre = nn.Conv1d(n_mels, ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for r in RATIOS:
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, 2 * r, stride=r,
                                               padding=r // 2))
            ch //= 2
            self.resblocks.append(nn.ModuleList(
                [ResnetBlock(ch) for _ in range(N_RESIDUAL)]))
        self.conv_post = nn.Conv1d(ch, 1, 7)

    def forward(self, log_mel: torch.Tensor,
                from_natural_log: bool = True) -> torch.Tensor:
        """(B, T, n_mels) log-mel → (B, T·256) waveform in [-1, 1].
        ``from_natural_log`` divides by ln 10: MelGAN was trained on log10
        mels, the acoustic model predicts natural-log ones."""
        x = log_mel / math.log(10.0) if from_natural_log else log_mel
        x = _reflect_conv(x, self.conv_pre)
        for r, up, stage in zip(RATIOS, self.ups, self.resblocks):
            x = conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), up.weight,
                                 up.bias, stride=r, padding=r // 2)
            for j, block in enumerate(stage):
                x = block(x, 3 ** j)
        x = _reflect_conv(F.leaky_relu(x, LRELU_SLOPE), self.conv_post)
        return torch.tanh(x)[..., 0]
