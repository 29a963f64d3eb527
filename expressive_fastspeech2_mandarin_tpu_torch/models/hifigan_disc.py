"""HiFi-GAN discriminators (MPD + MSD), their GAN losses and the weight-norm
parameterization of the generator; the JAX package's
``models/hifigan_disc.py:60-287``.

The published HiFi-GAN V1 recipe (Kong et al. 2020) whose hyperparameters
the reference ships: multi-period and multi-scale discriminators, LSGAN
losses, feature matching.

* **Weight norm** as explicit ``weight_v``/``weight_g`` parameters
  (``models.layers.WeightNormConv``): kernel = g·v/‖v‖ with the norm in
  float32, its square clamped at 1e-24, per C_out of a conv and per C_in of
  a transposed conv (dim 0 of torch's layouts). ``generator_weight_norm``
  and ``fold_weight_norm`` move a generator state dict between the folded
  and the weight-norm parameterization.
* **MPD** with the period folded into the batch: the paper's (5, 1)-kernel
  Conv2d never mixes the period axis, so each sub-discriminator runs 1-D
  convs over (B·p, C, T/p); the logits are flattened time-major, as torch's
  ``flatten`` of the (B, 1, T', p) map orders them.
* **MSD** with the first scale under weight norm like the others, not
  spectral norm: the JAX package's documented deviation
  (``train/vocoder.py:41-42`` there).

Every conv casts its kernel and bias to the input's dtype, so a bf16
waveform runs the discriminator's convs in bf16 while the weight-norm
statistics stay in float32; the losses reduce in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import reflect_pad
from .layers import WeightNormConv, weight_norm_g, wn_kernel

LRELU_SLOPE = 0.1

MPD_PERIODS = (2, 3, 5, 7, 11)
_MPD_CHANNELS = (1, 32, 128, 512, 1024)
_MSD_CONVS = (
    # (c_in, c_out, kernel, stride, groups)
    (1, 128, 15, 1, 1),
    (128, 128, 41, 2, 4),
    (128, 256, 41, 2, 16),
    (256, 512, 41, 4, 16),
    (512, 1024, 41, 4, 16),
    (1024, 1024, 41, 1, 16),
    (1024, 1024, 5, 1, 1),
)


def _wn_conv(c_in: int, c_out: int, k: int, groups: int = 1
             ) -> WeightNormConv:
    """A weight-norm conv from torch's default Conv1d init, the
    distribution of the JAX package's ``conv1d_params``."""
    conv = nn.Conv1d(c_in, c_out, k, groups=groups)
    return WeightNormConv(conv.weight, conv.bias)


def _conv(x: torch.Tensor, conv: WeightNormConv, **kw) -> torch.Tensor:
    """(B, C_in, T) → (B, C_out, T') with the kernel in x's dtype."""
    return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)


# ---------------------------------------------------------------------------
# Weight norm of the generator


def generator_weight_norm(state: dict[str, torch.Tensor]
                          ) -> dict[str, torch.Tensor]:
    """A folded generator state dict → its weight-norm state dict
    (``<p>.weight`` → ``<p>.weight_v`` = weight, ``<p>.weight_g`` =
    ‖weight‖), which ``Generator(weight_norm=True)`` loads; its kernels
    equal the folded ones."""
    out = {}
    for name, t in state.items():
        if name.endswith(".weight"):
            prefix = name[: -len(".weight")]
            out[f"{prefix}.weight_v"] = t
            out[f"{prefix}.weight_g"] = weight_norm_g(t)
        else:
            out[name] = t
    return out


def fold_weight_norm(state: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """A weight-norm generator state dict → the folded one (``weight`` =
    ``wn_kernel(weight_v, weight_g)``), which ``Generator()`` loads."""
    out = {}
    for name, t in state.items():
        if name.endswith(".weight_g"):
            continue
        if name.endswith(".weight_v"):
            prefix = name[: -len(".weight_v")]
            out[f"{prefix}.weight"] = wn_kernel(t, state[f"{prefix}.weight_g"])
        else:
            out[name] = t
    return out


# ---------------------------------------------------------------------------
# Multi-period discriminator


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int):
        super().__init__()
        self.period = period
        ch = _MPD_CHANNELS
        self.convs = nn.ModuleList(
            [_wn_conv(ch[i], ch[i + 1], 5) for i in range(len(ch) - 1)]
            + [_wn_conv(1024, 1024, 5)])
        self.conv_post = _wn_conv(1024, 1, 3)

    def forward(self, wav: torch.Tensor):
        """(B, T) → (logits (B, T'·p), feature maps (B·p, C, T'))."""
        b, t = wav.shape
        p = self.period
        n_pad = (-t) % p
        if n_pad:
            wav = reflect_pad(wav, 0, n_pad, dim=1)
            t += n_pad
        # (B, T) → (B, T/p, p) → period-major batch (B·p, 1, T/p)
        x = wav.reshape(b, t // p, p).transpose(1, 2).reshape(b * p, 1,
                                                              t // p)
        fmaps = []
        for i, c in enumerate(self.convs):
            x = F.leaky_relu(_conv(x, c, stride=3 if i < 4 else 1,
                                   padding=2), LRELU_SLOPE)
            fmaps.append(x)
        x = _conv(x, self.conv_post, padding=1)
        fmaps.append(x)
        # (B·p, 1, t') → (B, t'·p), time-major.
        logits = x.reshape(b, p, -1).transpose(1, 2).reshape(b, -1)
        return logits, fmaps


class MPD(nn.Module):
    def __init__(self, periods: tuple[int, ...] = MPD_PERIODS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [PeriodDiscriminator(p) for p in periods])

    def forward(self, wav: torch.Tensor):
        """(B, T) → (list of per-period logits, list of fmap lists)."""
        logits, fmaps = [], []
        for d in self.discriminators:
            lg, fm = d(wav)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps


# ---------------------------------------------------------------------------
# Multi-scale discriminator


class ScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            [_wn_conv(c_in, c_out, k, groups)
             for c_in, c_out, k, _s, groups in _MSD_CONVS])
        self.conv_post = _wn_conv(1024, 1, 3)

    def forward(self, wav: torch.Tensor):
        """(B, T) → (logits (B, T'), feature maps (B, C, T'))."""
        x = wav[:, None, :]
        fmaps = []
        for c, (_ci, _co, k, stride, groups) in zip(self.convs, _MSD_CONVS):
            x = F.leaky_relu(_conv(x, c, stride=stride, padding=(k - 1) // 2,
                                   groups=groups), LRELU_SLOPE)
            fmaps.append(x)
        x = _conv(x, self.conv_post, padding=1)
        fmaps.append(x)
        return x.reshape(x.shape[0], -1), fmaps


def avg_pool(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) → (B, T/2 + 1): torch AvgPool1d(4, 2, padding=2), the padding
    counted."""
    return F.avg_pool1d(wav[:, None], 4, 2, padding=2)[:, 0]


class MSD(nn.Module):
    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [ScaleDiscriminator() for _ in range(n_scales)])

    def forward(self, wav: torch.Tensor):
        """(B, T) → per-scale logits and fmaps; scales ×1, ×2, ×4
        avg-pooled."""
        logits, fmaps = [], []
        x = wav
        for i, d in enumerate(self.discriminators):
            if i > 0:
                x = avg_pool(x)
            lg, fm = d(x)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps


# ---------------------------------------------------------------------------
# GAN losses (LSGAN, feature matching), reduced in float32


def discriminator_loss(real_logits, fake_logits) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_logits, fake_logits):
        loss = (loss + torch.mean((1.0 - dr.float()) ** 2)
                + torch.mean(dg.float() ** 2))
    return loss


def generator_adv_loss(fake_logits) -> torch.Tensor:
    loss = 0.0
    for dg in fake_logits:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss


def feature_matching_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    loss = 0.0
    for sub_r, sub_g in zip(real_fmaps, fake_fmaps):
        for fr, fg in zip(sub_r, sub_g):
            loss = loss + torch.mean(torch.abs(fr.float() - fg.float()))
    return 2.0 * loss
