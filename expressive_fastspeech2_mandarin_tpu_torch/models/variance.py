"""Variance adaptor: duration, pitch and energy prediction, quantised
pitch/energy embeddings and vectorised length regulation; the JAX package's
``models/variance.py``.

* predictor: conv(k, pad (k-1)//2) → ReLU → LN → dropout → conv(k, pad 1)
  → ReLU → LN → dropout → linear, output zeroed at padding (dropout only in
  training, when a generator is given);
* free-running: durations ``max(round(exp(log_d) - 1) * d_control, 0)``
  (round half to even, as ``jnp.round``), embeddings of the scaled
  predictions;
* teacher forcing (training, evaluation): embeddings of the pitch and
  energy targets, frames regulated by the duration targets;
* bucketize = searchsorted left into ``n_bins - 1`` boundaries;
* ``replicate_energy_control_bug`` scales the energy by ``p_control``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import conv1d, layer_norm, length_regulate, mask_from_lengths
from ..ops.dropout import dropout
from .layers import WrappedConv1d


def bucketize(values: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Index of the first boundary >= value (``torch.bucketize(right=False)``,
    i.e. searchsorted left)."""
    return torch.bucketize(values, boundaries, right=False)


def make_variance_bins(stats_min: float, stats_max: float, n_bins: int,
                       quantization: str) -> torch.Tensor:
    """Bucket boundaries from corpus stats."""
    if quantization == "log":
        return torch.exp(torch.linspace(math.log(stats_min),
                                        math.log(stats_max), n_bins - 1))
    return torch.linspace(stats_min, stats_max, n_bins - 1)


class VariancePredictor(nn.Module):
    def __init__(self, d_in: int, d_filter: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": WrappedConv1d(d_in, d_filter, kernel_size),
            "layer_norm_1": nn.LayerNorm(d_filter),
            "conv1d_2": WrappedConv1d(d_filter, d_filter, kernel_size),
            "layer_norm_2": nn.LayerNorm(d_filter),
        })
        self.linear_layer = nn.Linear(d_filter, 1)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, inert: bool,
                dropout_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, D) → (B, T), zero at padding. ``inert`` zeroes the hidden
        rows at padding before the second conv; a ``generator`` (training)
        applies dropout after each LayerNorm."""
        cl = self.conv_layer
        c1, ln1 = cl["conv1d_1"].conv, cl["layer_norm_1"]
        c2, ln2 = cl["conv1d_2"].conv, cl["layer_norm_2"]
        h = conv1d(x, c1.weight, c1.bias, padding=(self.kernel_size - 1) // 2)
        h = layer_norm(F.relu(h), ln1.weight, ln1.bias)
        if inert:
            h = h.masked_fill(pad_mask[..., None], 0.0)
        h = dropout(h, dropout_rate, generator)
        # The reference hard-codes padding=1 for the second conv.
        h = conv1d(h, c2.weight, c2.bias, padding=1)
        h = layer_norm(F.relu(h), ln2.weight, ln2.bias)
        h = dropout(h, dropout_rate, generator)
        out = self.linear_layer(h)[..., 0]
        return out.masked_fill(pad_mask, 0.0)


class VarianceAdaptor(nn.Module):
    def __init__(self, cfg: ModelConfig, pitch_feature_level: str,
                 energy_feature_level: str,
                 stats: dict[str, list[float]]):
        super().__init__()
        self.cfg = cfg
        self.pitch_feature_level = pitch_feature_level
        self.energy_feature_level = energy_feature_level
        d = cfg.transformer.encoder_hidden
        vp = cfg.variance_predictor
        ve = cfg.variance_embedding
        self.duration_predictor = VariancePredictor(d, vp.filter_size,
                                                    vp.kernel_size)
        self.pitch_predictor = VariancePredictor(d, vp.filter_size,
                                                 vp.kernel_size)
        self.energy_predictor = VariancePredictor(d, vp.filter_size,
                                                  vp.kernel_size)
        self.pitch_embedding = nn.Embedding(ve.n_bins, d)
        self.energy_embedding = nn.Embedding(ve.n_bins, d)
        self.register_buffer("pitch_bins", make_variance_bins(
            stats["pitch"][0], stats["pitch"][1], ve.n_bins,
            ve.pitch_quantization))
        self.register_buffer("energy_bins", make_variance_bins(
            stats["energy"][0], stats["energy"][1], ve.n_bins,
            ve.energy_quantization))

    def _inert(self, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.cfg.padding_inert:
            return v.masked_fill(mask[..., None], 0.0)
        return v

    def _embed(self, embedding: nn.Embedding, prediction: torch.Tensor,
               target: torch.Tensor | None, control: float,
               bins: torch.Tensor):
        if target is not None:
            return prediction, embedding(bucketize(target, bins))
        scaled = prediction * control
        return scaled, embedding(bucketize(scaled, bins))

    def forward(self, x: torch.Tensor, src_mask: torch.Tensor,
                max_mel_len: int, p_control: float = 1.0,
                e_control: float = 1.0, d_control: float = 1.0, *,
                mel_mask: torch.Tensor | None = None,
                p_targets: torch.Tensor | None = None,
                e_targets: torch.Tensor | None = None,
                d_targets: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """Returns (frames, p_pred, e_pred, log_d_pred, d_rounded, mel_lens,
        mel_mask). With ``d_targets`` the frames follow the targets and
        ``mel_mask`` is the caller's; a ``generator`` (training) turns on
        the predictors' dropout."""
        inert = self.cfg.padding_inert
        rate = self.cfg.variance_predictor.dropout
        e_ctl = (p_control if self.cfg.replicate_energy_control_bug
                 else e_control)

        def predict(predictor, inp, mask):
            return predictor(inp, mask, inert, rate, generator)

        log_d_pred = predict(self.duration_predictor, x, src_mask)

        p_pred = e_pred = None
        if self.pitch_feature_level == "phoneme_level":
            p_pred, p_emb = self._embed(
                self.pitch_embedding,
                predict(self.pitch_predictor, x, src_mask), p_targets,
                p_control, self.pitch_bins)
            x = self._inert(x + p_emb, src_mask)
        if self.energy_feature_level == "phoneme_level":
            e_pred, e_emb = self._embed(
                self.energy_embedding,
                predict(self.energy_predictor, x, src_mask), e_targets,
                e_ctl, self.energy_bins)
            x = self._inert(x + e_emb, src_mask)

        if d_targets is not None:
            frames, mel_lens = length_regulate(x, d_targets, max_mel_len)
            d_rounded = d_targets
        else:
            d_rounded = torch.clamp(
                torch.round(torch.exp(log_d_pred) - 1.0) * d_control,
                min=0.0)
            frames, mel_lens = length_regulate(x, d_rounded, max_mel_len)
            mel_mask = mask_from_lengths(mel_lens, max_mel_len)

        if "frame_level" in (self.pitch_feature_level,
                             self.energy_feature_level):
            frames = self._inert(frames, mel_mask)
        if self.pitch_feature_level == "frame_level":
            p_pred, p_emb = self._embed(
                self.pitch_embedding,
                predict(self.pitch_predictor, frames, mel_mask), p_targets,
                p_control, self.pitch_bins)
            frames = self._inert(frames + p_emb, mel_mask)
        if self.energy_feature_level == "frame_level":
            e_pred, e_emb = self._embed(
                self.energy_embedding,
                predict(self.energy_predictor, frames, mel_mask), e_targets,
                e_ctl, self.energy_bins)
            frames = self._inert(frames + e_emb, mel_mask)

        return (frames, p_pred, e_pred, log_d_pred, d_rounded, mel_lens,
                mel_mask)
