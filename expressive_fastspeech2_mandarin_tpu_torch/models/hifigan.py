"""HiFi-GAN V1 generator.

conv_pre(80→512, k7) → 4 × [leaky_relu(0.1) → ConvTranspose1d (×8, 8, 2, 2)
→ MRF: mean of 3 resblocks (k ∈ {3, 7, 11}, dilations (1, 3, 5))] →
leaky_relu(0.01) → conv_post(→1, k7) → tanh; the plain path of the JAX
package's ``apply_generator``. Activations are feature-last (B, T, C).

``forward(mel, fast=True)`` sends every resblock through
``ops.mrf_resblock`` (the CUDA kernel on the card, which has no backward);
``fast=False`` is the JAX package's ``apply_generator(fast=False)``: each
resblock through stock convs in the activations' dtype, differentiable
anywhere. Nothing chooses between them on its own: synthesis takes the
default, the vocoder trainer asks for ``fast=False`` as the JAX package's
trainer does. Every weight and bias is cast to the activations' dtype where
it is used, so a float32 weight-norm generator runs a bf16 forward on a
bf16 mel (the trainer's amp).

Parameter names are the reference's: with weight norm folded
(``weight``/``bias``), or, with ``weight_norm=True``, as torch's
``weight_norm`` keeps them (``weight_v``/``weight_g``/``bias``), the
vocoder trainer's parameterization. ``save_generator_npz`` writes the JAX
package's ``generator.npz`` (``models/hifigan.py:446-470`` there);
``interop.torch_ckpt.load_generator_npz`` reads it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VocoderConfig
from ..ops import conv1d, conv_transpose1d
from ..ops.mrf_resblock import mrf_resblock
from .layers import WeightNormConv

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _conv(module: nn.Module, weight_norm: bool) -> nn.Module:
    return (WeightNormConv(module.weight, module.bias) if weight_norm
            else module)


def _wb(conv: nn.Module, dtype: torch.dtype):
    return conv.weight.to(dtype), conv.bias.to(dtype)


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 dilations: tuple[int, ...], weight_norm: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList([
            _conv(nn.Conv1d(channels, channels, kernel_size, dilation=d),
                  weight_norm) for d in dilations])
        self.convs2 = nn.ModuleList([
            _conv(nn.Conv1d(channels, channels, kernel_size), weight_norm)
            for _ in dilations])

    def forward(self, x: torch.Tensor, fast: bool = True) -> torch.Tensor:
        """(B, T, C) → (B, T, C)."""
        k = self.kernel_size
        if fast:
            weights = []
            for c1, c2 in zip(self.convs1, self.convs2):
                weights += [_wb(c1, x.dtype), _wb(c2, x.dtype)]
            return mrf_resblock(x, weights, k, self.dilations)
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = conv1d(F.leaky_relu(x, LRELU_SLOPE), *_wb(c1, x.dtype),
                        padding=get_padding(k, d), dilation=d)
            xt = conv1d(F.leaky_relu(xt, LRELU_SLOPE), *_wb(c2, x.dtype),
                        padding=get_padding(k, 1))
            x = xt + x
        return x


class Generator(nn.Module):
    def __init__(self, cfg: VocoderConfig, n_mels: int = 80,
                 weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = _conv(nn.Conv1d(n_mels, ch0, 7, padding=3),
                              weight_norm)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            c_out = ch0 // (2 ** (i + 1))
            self.ups.append(_conv(nn.ConvTranspose1d(
                ch0 // (2 ** i), c_out, k, u, padding=(k - u) // 2),
                weight_norm))
            for kr, dr in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(
                    ResBlock(c_out, kr, tuple(dr), weight_norm))
        self.conv_post = _conv(nn.Conv1d(
            ch0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3),
            weight_norm)

    def forward(self, mel: torch.Tensor, fast: bool = True) -> torch.Tensor:
        """(B, T, n_mels) → (B, T * prod(upsample_rates)) in [-1, 1], in
        the mel's dtype."""
        cfg = self.cfg
        dt = mel.dtype
        n_kernels = len(cfg.resblock_kernel_sizes)
        x = conv1d(mel, *_wb(self.conv_pre, dt), padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = conv_transpose1d(x, *_wb(self.ups[i], dt), stride=u,
                                 padding=(k - u) // 2).contiguous()
            xs = None
            for j in range(n_kernels):
                out = self.resblocks[i * n_kernels + j](x, fast)
                xs = out if xs is None else xs + out
            x = xs / n_kernels
        # The reference's final activation is a default-slope (0.01)
        # leaky_relu, not LRELU_SLOPE.
        x = F.leaky_relu(x, 0.01)
        x = conv1d(x, *_wb(self.conv_post, dt), padding=3)
        return torch.tanh(x)[..., 0]


def save_generator_npz(path: str, state: dict[str, torch.Tensor]) -> None:
    """Write a folded generator state dict (``Generator`` without weight
    norm) as the JAX package's ``generator.npz``, which either package
    loads: path keys such as ``resblocks/0/convs1/1/kernel``, conv kernels
    (K, C_in, C_out) (the transposed convs' too), float32; the inverse of
    ``interop.from_jax.hifigan_from_jax``."""
    arrays = {}
    for name, t in state.items():
        a = t.detach().float().cpu().numpy()
        *parents, leaf = name.split(".")
        if leaf == "weight":
            # Conv1d (C_out, C_in, K); ConvTranspose1d (C_in, C_out, K).
            a = a.transpose(2, 0, 1) if parents[0] == "ups" else a.transpose(
                2, 1, 0)
            leaf = "kernel"
        arrays["/".join(parents + [leaf])] = np.ascontiguousarray(a)
    np.savez(path, **arrays)
