"""The FastSpeech2 training loop; the JAX package's ``train/loop.py`` on one
card.

``train(cfg, total_steps=...)`` builds the model from ``cfg.train.seed``
(or resumes the latest checkpoint under ``ckpt_path``) and runs
``train_step`` over length-bucketed batches, epoch after epoch. Cadences
(``StepConfig``): losses to ``<log_path>/train`` every ``log_step``, where a
non-finite loss writes an emergency checkpoint and raises
``FloatingPointError``; the whole val set's sample-weighted losses to
``<log_path>/val`` every ``val_step``; the first val batch synthesized
free-running every ``synth_step``, its predicted mels and lengths saved as
``<result_path>/train_samples/step<N>_{mel,mel_lens}.npy`` and its first
utterance, predicted and ground truth, vocoded by ``SampleVocoder``
(HiFi-GAN from ``model.vocoder.ckpt_path``, else Griffin-Lim) into
``step<N>_{predicted,reconstructed}.wav``; a checkpoint every
``save_step`` and at the end.

Each batch is staged ahead of the running step (``prefetch_chunks``): the
mel targets, most of a batch's bytes, are encoded on the host
(``transfer_dtype``: int16 per-utterance affine quantization, bf16 or
float32) and every array is copied host → device from pinned memory with
``non_blocking``.
"""

from __future__ import annotations

import math
import os
from collections import deque
from collections.abc import Iterator

import numpy as np
import torch

from ..config import Config
from ..data import BucketedDataset, PreprocessedCorpus
from ..device import resolve_device
from ..utils.logging import TrainLogger
from ..utils.wav import save_wav
from .loss import LossReport
from .sampling import SampleVocoder
from .state import CheckpointManager, TrainState, create_train_state
from .step import Batch, eval_step, synth_step, train_step

_LOSS_KEYS = ("total_loss", "mel_loss", "mel_postnet_loss", "pitch_loss",
              "energy_loss", "duration_loss")


def _report_dict(report: LossReport) -> dict[str, float]:
    return dict(zip(_LOSS_KEYS, (float(x) for x in report)))


def quantize_mels(batch: dict[str, np.ndarray], transfer: str) -> dict:
    """The batch with its mels encoded for the host → device copy: int16
    with per-utterance ``mel_scale``/``mel_offset`` (4× fewer bytes, about
    2e-4 absolute error on log-mels), bf16, or float32 as it is."""
    out: dict = dict(batch)
    m = batch["mels"]
    if transfer == "bfloat16":
        out["mels"] = torch.from_numpy(m).to(torch.bfloat16)
    elif transfer == "int16":
        lo = m.min(axis=(1, 2))
        hi = m.max(axis=(1, 2))
        scale = np.maximum((hi - lo) / 65535.0, 1e-12).astype(np.float32)
        q = np.rint((m - lo[:, None, None]) / scale[:, None, None]) - 32768.0
        out["mels"] = q.astype(np.int16)
        out["mel_scale"] = scale
        out["mel_offset"] = (lo + 32768.0 * scale).astype(np.float32)
    return out


def stage_batch(batch: dict[str, np.ndarray], device: torch.device,
                transfer: str = "float32") -> Batch:
    """Encode the mels and copy every array to ``device`` (pinned,
    ``non_blocking`` on the card); integer arrays become int64."""
    staged = {}
    for key, value in quantize_mels(batch, transfer).items():
        t = torch.as_tensor(value)
        if not t.is_floating_point() and key != "mels":
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        staged[key] = t
    return staged


def evaluate(model, val_ds: BucketedDataset, cfg: Config,
             device: torch.device) -> dict[str, float]:
    """Sample-weighted means of the teacher-forced losses over the whole
    val set."""
    sums = np.zeros(len(_LOSS_KEYS))
    count = 0
    for batch in val_ds.epoch(0, shuffle=False):
        b = batch["speakers"].shape[0]
        report = eval_step(model, stage_batch(batch, device), cfg)
        sums += np.array([float(x) for x in report]) * b
        count += b
    return dict(zip(_LOSS_KEYS, sums / max(count, 1)))


def save_synth_sample(model, val_ds: BucketedDataset, cfg: Config,
                      device: torch.device, step: int,
                      sampler: SampleVocoder) -> str:
    """Synthesize the first val batch free-running, at its mel bucket, and
    save the predicted mels and lengths, and the first utterance's
    predicted and ground-truth audio through ``sampler`` (when both are
    longer than 4 frames, as the JAX loop does); returns the directory."""
    batch = next(val_ds.epoch(0, shuffle=False))
    mel, mel_lens, _ = synth_step(model, stage_batch(batch, device),
                                  max_mel_len=batch["mels"].shape[1])
    out_dir = os.path.join(cfg.train.path.result_path or "output/result",
                           "train_samples")
    os.makedirs(out_dir, exist_ok=True)
    mel = mel.float().cpu().numpy()
    mel_lens = mel_lens.cpu().numpy()
    np.save(os.path.join(out_dir, f"step{step}_mel.npy"), mel)
    np.save(os.path.join(out_dir, f"step{step}_mel_lens.npy"), mel_lens)
    t_pred, t_gt = int(mel_lens[0]), int(batch["mel_lens"][0])
    if t_pred > 4 and t_gt > 4:
        sr = cfg.preprocess.audio.sampling_rate
        for name, m, t in (("predicted", mel[0], t_pred),
                           ("reconstructed", batch["mels"][0], t_gt)):
            save_wav(os.path.join(out_dir, f"step{step}_{name}.wav"),
                     sampler.vocode(m, t), sr)
    return out_dir


def train(cfg: Config, restore_step: int | None = None,
          total_steps: int | None = None,
          device: str | torch.device = "cuda") -> TrainState:
    """Train to ``total_steps`` (``cfg.train.step.total_step`` by default)
    on ``device``, the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    tc = cfg.train
    corpus = PreprocessedCorpus(cfg.preprocess.path.preprocessed_path)
    ds_args = (tc.optimizer.batch_size, tc.buckets, cfg.model.max_seq_len)
    train_ds = BucketedDataset(corpus, "train.txt", *ds_args, drop_last=True,
                               seed=tc.seed,
                               symbol_table=cfg.preprocess.symbol_table)
    val_ds = BucketedDataset(corpus, "val.txt", *ds_args, seed=tc.seed,
                             symbol_table=cfg.preprocess.symbol_table)
    if not len(train_ds) // tc.optimizer.batch_size:
        raise ValueError(f"train.txt holds fewer than one batch of "
                         f"{tc.optimizer.batch_size} usable utterances")

    state = create_train_state(cfg, corpus.stats, device)
    ckpt = CheckpointManager(tc.path.ckpt_path or "output/ckpt")
    if restore_step is not None or ckpt.latest_step() is not None:
        ckpt.restore(state, restore_step)
        print(f"restored checkpoint at step {state.step}")

    total = total_steps or tc.step.total_step
    s = tc.step
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"training: {n_params / 1e6:.1f}M params, {len(train_ds)} "
          f"utterances, device {device}")
    sampler = SampleVocoder(cfg, device)
    print(f"sample vocoder: {sampler.kind}")

    def batches() -> Iterator[Batch]:
        epoch = 0
        while True:
            for batch in train_ds.epoch(epoch):
                yield stage_batch(batch, device, tc.transfer_dtype)
            epoch += 1

    log_dir = tc.path.log_path or "output/log"
    logger = TrainLogger(os.path.join(log_dir, "train"))
    val_logger = TrainLogger(os.path.join(log_dir, "val"))
    try:
        stream = batches()
        staged: deque[Batch] = deque()
        while state.step < total:
            while len(staged) <= max(0, tc.prefetch_chunks):
                staged.append(next(stream))
            prev = state.step
            report = train_step(state, staged.popleft(), cfg)
            step = state.step
            logger.tick()

            def crossed(every: int) -> bool:
                return step // every > prev // every

            if crossed(s.log_step):
                losses = _report_dict(report)
                losses["steps_per_sec"] = logger.steps_per_sec
                logger.log_losses(step, losses)
                if not math.isfinite(losses["total_loss"]):
                    ckpt.save(step, state)
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: {losses} "
                        f"(emergency checkpoint saved)")
            if crossed(s.val_step):
                val_logger.log_losses(
                    step, evaluate(state.model, val_ds, cfg, device))
            if crossed(s.synth_step):
                save_synth_sample(state.model, val_ds, cfg, device, step,
                                  sampler)
            if crossed(s.save_step):
                ckpt.save(step, state)
        ckpt.save(state.step, state)
    finally:
        logger.close()
        val_logger.close()
    return state
