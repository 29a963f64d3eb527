"""FastSpeech2 training loss; the JAX package's ``train/loss.py``.

L1 on the mel and the postnet mel, MSE on pitch, energy and log(d + 1);
every term a mean over the valid (unmasked) elements, as the reference's
``masked_select`` followed by ``L1Loss``/``MSELoss``. Total = the
unweighted sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.fastspeech2 import FastSpeech2Output


class LossReport(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return (err * valid).sum() / valid.sum().clamp(min=1.0)


def fastspeech2_loss(
    out: FastSpeech2Output,
    mel_targets: torch.Tensor,       # (B, T, n_mels) float32
    pitch_targets: torch.Tensor,     # (B, S) or (B, T)
    energy_targets: torch.Tensor,
    duration_targets: torch.Tensor,  # (B, S) int
    *,
    pitch_feature_level: str = "phoneme_level",
    energy_feature_level: str = "phoneme_level",
) -> LossReport:
    src_valid = (~out.src_masks).float()
    mel_valid = (~out.mel_masks).float()
    log_d_targets = torch.log(duration_targets.float() + 1.0)
    p_valid = src_valid if pitch_feature_level == "phoneme_level" else mel_valid
    e_valid = (src_valid if energy_feature_level == "phoneme_level"
               else mel_valid)

    mel_t = mel_targets[:, :out.mel.shape[1], :]
    mel_valid3 = mel_valid[..., None].expand(mel_t.shape)
    mel_loss = _masked_mean((out.mel - mel_t).abs(), mel_valid3)
    postnet_loss = _masked_mean((out.postnet_mel - mel_t).abs(), mel_valid3)
    pitch_loss = _masked_mean((out.pitch_predictions - pitch_targets).square(),
                              p_valid)
    energy_loss = _masked_mean(
        (out.energy_predictions - energy_targets).square(), e_valid)
    duration_loss = _masked_mean(
        (out.log_duration_predictions - log_d_targets).square(), src_valid)
    total = mel_loss + postnet_loss + duration_loss + pitch_loss + energy_loss
    return LossReport(total, mel_loss, postnet_loss, pitch_loss, energy_loss,
                      duration_loss)
