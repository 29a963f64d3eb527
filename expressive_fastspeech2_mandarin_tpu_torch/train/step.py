"""One training, evaluation or synthesis step; the JAX package's
``train/step.py``.

``train_step``: teacher-forced forward in training mode (dropout from the
state's generator, the postnet's BatchNorm on batch statistics) → loss →
gradients → clip, Adam, Noam update, in place. With ``amp_dtype =
"bfloat16"`` the forward and backward run on a bf16 copy of the float32
master parameters; the gradient flows back through the cast, so it reaches
the masters in float32, and the loss stays float32. The flash kernels take
float32 only, so bf16 with ``attention_impl="flash"`` raises ``TypeError``.

A batch is a dict of tensors on the model's device: speakers, emotions,
arousals, valences (B,), texts (B, S), src_lens (B,), mels (B, T, 80) —
float32, bfloat16, or int16 with per-utterance ``mel_scale`` and
``mel_offset`` (B,) — mel_lens (B,), pitches, energies and durations
(B, S).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..config import Config
from ..models import FastSpeech2
from .loss import LossReport, fastspeech2_loss
from .state import TrainState

Batch = dict[str, torch.Tensor]


def _mel_targets(batch: Batch) -> torch.Tensor:
    """Float32 mel targets from the staged encoding: int16 per-utterance
    affine quantization (``mel_scale``/``mel_offset`` present), bf16, or
    float32 as it is."""
    mels = batch["mels"].float()
    if "mel_scale" in batch:
        # encode: q = rint((m - lo) / scale) - 32768; offset = lo + 32768 scale
        mels = (mels * batch["mel_scale"][:, None, None]
                + batch["mel_offset"][:, None, None])
    return mels


def _loss(model: FastSpeech2, batch: Batch, cfg: Config, *,
          training: bool, generator: torch.Generator | None = None,
          params: dict[str, torch.Tensor] | None = None) -> LossReport:
    """Teacher-forced forward and loss; ``params`` replaces the model's
    parameters (the bf16 copy)."""
    mels = _mel_targets(batch)
    args = (batch["speakers"], batch["emotions"], batch["arousals"],
            batch["valences"], batch["texts"], batch["src_lens"])
    kwargs = dict(max_mel_len=mels.shape[1], mel_lens=batch["mel_lens"],
                  p_targets=batch["pitches"], e_targets=batch["energies"],
                  d_targets=batch["durations"], training=training,
                  generator=generator)
    out = (model(*args, **kwargs) if params is None
           else functional_call(model, params, args, kwargs))
    return fastspeech2_loss(
        out, mels, batch["pitches"], batch["energies"], batch["durations"],
        pitch_feature_level=cfg.preprocess.pitch.feature,
        energy_feature_level=cfg.preprocess.energy.feature)


def check_amp(cfg: Config) -> torch.dtype:
    """The forward's parameter dtype; bf16 with the flash kernels raises."""
    amp = getattr(torch, cfg.train.amp_dtype)
    if amp != torch.float32 and cfg.model.transformer.attention_impl == "flash":
        raise TypeError("attention_impl='flash' runs the float32 flash "
                        "kernels; it cannot train with amp_dtype="
                        f"{cfg.train.amp_dtype!r}")
    return amp


def loss_and_grads(model: FastSpeech2, batch: Batch, cfg: Config,
                   generator: torch.Generator
                   ) -> tuple[LossReport, list[torch.Tensor]]:
    """The training-mode loss and the float32 gradient of every parameter,
    in ``model.named_parameters()`` order. BatchNorm's running statistics
    are updated in place."""
    amp = check_amp(cfg)
    named = dict(model.named_parameters())
    params = None
    if amp != torch.float32:
        params = {n: p.to(amp) if p.is_floating_point() else p
                  for n, p in named.items()}
    report = _loss(model, batch, cfg, training=True, generator=generator,
                   params=params)
    grads = torch.autograd.grad(report.total, list(named.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, named.values())]
    return LossReport(*(x.detach() for x in report)), grads


def train_step(state: TrainState, batch: Batch, cfg: Config) -> LossReport:
    """One call = one micro-step: gradients, then the optimizer (which
    updates on every ``grad_acc_step``-th call); ``state.step`` counts
    calls, as the JAX package's ``TrainState.step``."""
    report, grads = loss_and_grads(state.model, batch, cfg, state.generator)
    state.optimizer.step(grads)
    state.step += 1
    return report


@torch.no_grad()
def eval_step(model: FastSpeech2, batch: Batch, cfg: Config) -> LossReport:
    """Teacher-forced deterministic forward and loss."""
    return _loss(model, batch, cfg, training=False)


@torch.no_grad()
def synth_step(model: FastSpeech2, batch: Batch, max_mel_len: int,
               p_control: float = 1.0, e_control: float = 1.0,
               d_control: float = 1.0):
    """Free-running inference forward: (postnet mel, mel_lens,
    durations)."""
    out = model(batch["speakers"], batch["emotions"], batch["arousals"],
                batch["valences"], batch["texts"], batch["src_lens"],
                max_mel_len=max_mel_len, p_control=p_control,
                e_control=e_control, d_control=d_control)
    return out.postnet_mel, out.mel_lens, out.durations_rounded
