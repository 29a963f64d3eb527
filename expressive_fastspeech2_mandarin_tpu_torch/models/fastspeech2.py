"""FastSpeech2 acoustic model with speaker and emotion/arousal/valence
conditioning. At inference (the default) it is deterministic: no dropout,
BatchNorm on running statistics. With ``training=True`` and a dropout
generator it applies dropout and the postnet's BatchNorm takes batch
statistics, updating its running ones in place. With duration (and pitch,
energy) targets it is teacher-forced, as in training and evaluation.

encoder → +speaker_emb → +relu(emotion_linear(cat(emotion, arousal,
valence))) → variance adaptor → decoder → mel_linear → postnet (+residual);
the JAX package's ``models/fastspeech2.py``. Parameter names are the
reference's torch names, so ``load_state_dict`` takes a reference checkpoint
or the output of ``interop.from_jax.fastspeech2_from_jax``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..config import ModelConfig, PreprocessConfig
from ..ops import mask_from_lengths
from .postnet import PostNet
from .transformer import Decoder, Encoder
from .variance import VarianceAdaptor

DEFAULT_STATS = {"pitch": [-2.0, 8.0, 0.0, 1.0],
                 "energy": [-2.0, 8.0, 0.0, 1.0]}


@dataclass
class FastSpeech2Output:
    mel: torch.Tensor                 # (B, T, n_mels) before the postnet
    postnet_mel: torch.Tensor         # (B, T, n_mels)
    pitch_predictions: torch.Tensor   # (B, S) or (B, T)
    energy_predictions: torch.Tensor
    log_duration_predictions: torch.Tensor  # (B, S)
    durations_rounded: torch.Tensor   # (B, S)
    src_masks: torch.Tensor           # (B, S) True at padding
    mel_masks: torch.Tensor           # (B, T)
    src_lens: torch.Tensor            # (B,)
    mel_lens: torch.Tensor            # (B,)


class FastSpeech2(nn.Module):
    def __init__(self, model_cfg: ModelConfig,
                 preprocess_cfg: PreprocessConfig,
                 stats: dict[str, list[float]] | None = None):
        super().__init__()
        cfg = model_cfg
        self.cfg = cfg
        t = cfg.transformer
        d = t.encoder_hidden
        n_mels = preprocess_cfg.mel.n_mel_channels
        self.encoder = Encoder(t, cfg.vocab_size, cfg.max_seq_len)
        self.variance_adaptor = VarianceAdaptor(
            cfg, preprocess_cfg.pitch.feature, preprocess_cfg.energy.feature,
            stats or DEFAULT_STATS)
        self.decoder = Decoder(t, cfg.max_seq_len)
        self.mel_linear = nn.Linear(t.decoder_hidden, n_mels)
        self.postnet = PostNet(n_mels)
        if cfg.multi_speaker:
            self.speaker_emb = nn.Embedding(cfg.n_speakers, d)
        if cfg.multi_emotion:
            self.emotion_emb = nn.Embedding(cfg.n_emotions, d // 2)
            self.arousal_emb = nn.Embedding(cfg.n_arousals, d // 4)
            self.valence_emb = nn.Embedding(cfg.n_valences, d // 4)
            self.emotion_linear = nn.Sequential(nn.Linear(d, d), nn.ReLU())

    def forward(self, speakers: torch.Tensor, emotions: torch.Tensor,
                arousals: torch.Tensor, valences: torch.Tensor,
                texts: torch.Tensor, src_lens: torch.Tensor, *,
                max_mel_len: int,
                mel_lens: torch.Tensor | None = None,
                p_targets: torch.Tensor | None = None,
                e_targets: torch.Tensor | None = None,
                d_targets: torch.Tensor | None = None,
                p_control: float = 1.0, e_control: float = 1.0,
                d_control: float = 1.0, training: bool = False,
                generator: torch.Generator | None = None
                ) -> FastSpeech2Output:
        cfg = self.cfg
        if training and generator is None:
            raise ValueError("training mode needs a dropout generator")
        if d_targets is not None and mel_lens is None:
            raise ValueError("duration targets need the mel lengths")
        gen = generator if training else None
        src_masks = mask_from_lengths(src_lens, texts.shape[1])
        mel_masks = (mask_from_lengths(mel_lens, max_mel_len)
                     if mel_lens is not None else None)
        x = self.encoder(texts, src_masks, gen)
        if cfg.multi_speaker:
            x = x + self.speaker_emb(speakers)[:, None, :]
        if cfg.multi_emotion:
            emb = torch.cat([self.emotion_emb(emotions),
                             self.arousal_emb(arousals),
                             self.valence_emb(valences)], dim=-1)
            x = x + self.emotion_linear(emb)[:, None, :]
        if cfg.padding_inert:
            x = x.masked_fill(src_masks[..., None], 0.0)

        (frames, p_pred, e_pred, log_d_pred, d_rounded, mel_lens_out,
         mel_masks) = self.variance_adaptor(
            x, src_masks, max_mel_len, p_control, e_control, d_control,
            mel_mask=mel_masks, p_targets=p_targets, e_targets=e_targets,
            d_targets=d_targets, generator=gen)
        if d_targets is not None:
            mel_lens_out = mel_lens

        frames = self.decoder(frames, mel_masks, gen)
        mel = self.mel_linear(frames)
        if cfg.padding_inert:
            mel = mel.masked_fill(mel_masks[..., None], 0.0)
        residual = self.postnet(
            mel, mask=mel_masks if cfg.padding_inert else None,
            generator=gen)
        return FastSpeech2Output(
            mel=mel,
            postnet_mel=mel + residual,
            pitch_predictions=p_pred,
            energy_predictions=e_pred,
            log_duration_predictions=log_d_pred,
            durations_rounded=d_rounded,
            src_masks=src_masks,
            mel_masks=mel_masks,
            src_lens=src_lens,
            mel_lens=mel_lens_out,
        )
