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
``step<N>_{predicted,reconstructed}.wav``, its predicted mel plotted into
``step<N>.png`` and predicted against ground truth, pitch and energy
over them, into ``<log_path>/train/figures/train_spectrogram_step<N>.png``
(where matplotlib imports; else the skip is logged once); a checkpoint
every ``save_step`` and at the end.

``matmul_precision`` sets the card's TF32 switches for float32 matmuls
and convs (``matmul_precision``) while ``train()`` runs and restores them
when it returns. ``profile_start_step``/``profile_stop_step`` record a
``torch.profiler`` trace (CPU, and CUDA on the card) of the steps from
the group that reaches the start step to the one that reaches the stop
step, written as a Chrome trace under ``<log_path>/profile``.

With ``steps_per_call`` > 1, consecutive batches of one bucket run as
chunks of that many steps (``chunks``), as the JAX package's scanned
steps do: each step stays one eager step, the cadences are checked when a
chunk ends (a crossing, since a chunk may step past a multiple), a chunk
logs its steps' mean losses, and the last group is cut so the run stops
at ``total_steps``.

Each group is staged ahead of the running one (``prefetch_chunks``): the
mel targets, most of a batch's bytes, are encoded on the host
(``transfer_dtype``: int16 per-utterance affine quantization, bf16 or
float32) and every array is copied host → device from pinned memory with
``non_blocking``.
"""

from __future__ import annotations

import contextlib
import math
import os
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from ..config import MATMUL_PRECISIONS, Config
from ..data import BucketedDataset, PreprocessedCorpus
from ..device import resolve_device
from ..utils.logging import TrainLogger
from ..utils.plotting import expand_by_duration, plot_mel, save_mel_plot
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


def chunks(batches: Iterable[dict], spc: int) -> Iterator[list[dict]]:
    """Consecutive batches of one (source, mel) bucket grouped in chunks of
    ``spc``; a bucket change lets the pending batches through one by one
    (the JAX package's ``_chunks``, ``train/loop.py:166-188``)."""
    pending: list[dict] = []

    def key(b: dict):
        return (b["texts"].shape, b["mels"].shape)

    for b in batches:
        if spc == 1:
            yield [b]
            continue
        if pending and key(pending[0]) != key(b):
            while pending:
                yield pending[:1]
                pending = pending[1:]
        pending.append(b)
        if len(pending) == spc:
            yield pending
            pending = []
    while pending:
        yield pending[:1]
        pending = pending[1:]


def chunk_report(reports: list[LossReport], spc: int) -> LossReport:
    """The report a group logs: a whole chunk's mean, as the JAX package's
    scanned step returns it; a group of one (a bucket change or the
    trimmed end) its own."""
    if spc > 1 and len(reports) == spc:
        return LossReport(*(torch.stack(xs).mean() for xs in zip(*reports)))
    return reports[-1]


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
                      sampler: SampleVocoder, stats: dict,
                      logger: TrainLogger) -> str:
    """Synthesize the first val batch free-running, at its mel bucket, and
    save the predicted mels and lengths, the first utterance's figures
    (``step<N>.png``, and to ``logger`` the predicted and ground-truth
    panels with pitch and energy, from the corpus ``stats``, as the JAX
    loop logs them) and its predicted and ground-truth audio through
    ``sampler`` (when both are longer than 4 frames, as the JAX loop
    does); returns the directory."""
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
    pred_mel = mel[0, :max(t_pred, 1)].T
    s = int(batch["src_lens"][0])
    durations = batch["durations"][0, :s]
    pitch = expand_by_duration(batch["pitches"][0, :s], durations)
    energy = expand_by_duration(batch["energies"][0, :s], durations)
    fig = plot_mel([(pred_mel, pitch, energy),
                    (batch["mels"][0, :t_gt].T, pitch, energy)],
                   list(stats["pitch"]) + list(stats["energy"][:2]),
                   ["Synthesized", "Ground truth"])
    if fig is not None:
        logger.log_figure("train/spectrogram", fig, step)
    save_mel_plot(os.path.join(out_dir, f"step{step}.png"),
                  [(pred_mel, None, None)], None, ["Synthesized"])
    if t_pred > 4 and t_gt > 4:
        sr = cfg.preprocess.audio.sampling_rate
        for name, m, t in (("predicted", mel[0], t_pred),
                           ("reconstructed", batch["mels"][0], t_gt)):
            save_wav(os.path.join(out_dir, f"step{step}_{name}.wav"),
                     sampler.vocode(m, t), sr)
    return out_dir


@contextlib.contextmanager
def matmul_precision(name: str):
    """TF32 for float32 matmuls (``torch.backends.cuda.matmul``) and convs
    (``torch.backends.cudnn``) as ``jax_default_matmul_precision``'s
    ``name`` asks (``config.MATMUL_PRECISIONS``): off for "default",
    "highest" and "float32"; on for "high", "tensorfloat32", "bfloat16"
    and "bfloat16_3x". The switches are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = MATMUL_PRECISIONS[name]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class ProfileWindow:
    """A ``torch.profiler`` trace of steps [start, stop): opened by the
    group that reaches ``start`` and closed, the device synchronized, by
    the group that reaches ``stop`` (crossings, as the JAX loop checks
    them, since a chunk may step past either), or when the run ends; the
    Chrome trace goes to ``<out_dir>/trace_steps<a>-<b>.json``."""

    def __init__(self, start: int, stop: int, out_dir: str,
                 device: torch.device):
        self.start, self.stop, self.out_dir = start, stop, out_dir
        self.device = device
        self.prof = None
        self.first = 0

    def before(self, prev: int, n_group: int) -> None:
        if self.prof is None and prev <= self.start < prev + n_group:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.first = prev

    def after(self, prev: int, step: int) -> None:
        if self.prof is not None and prev < self.stop <= step:
            self.close(step)

    def close(self, step: int) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.out_dir, f"trace_steps{self.first}-{step}.json"))
        self.prof = None
        print(f"profiler trace written to {self.out_dir}")


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

    def batches() -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while True:
            yield from train_ds.epoch(epoch)
            epoch += 1

    def staged_groups() -> Iterator[list[Batch]]:
        """Groups of staged batches, trimmed so the run stops at
        ``total``."""
        budget = total - state.step
        for group in chunks(batches(), tc.steps_per_call):
            if budget <= 0:
                return
            group = group[:budget]
            budget -= len(group)
            yield [stage_batch(b, device, tc.transfer_dtype) for b in group]

    log_dir = tc.path.log_path or "output/log"
    logger = TrainLogger(os.path.join(log_dir, "train"))
    val_logger = TrainLogger(os.path.join(log_dir, "val"))
    profile = ProfileWindow(tc.profile_start_step, tc.profile_stop_step,
                            os.path.join(log_dir, "profile"), device)
    with contextlib.ExitStack() as stack:
        stack.enter_context(matmul_precision(tc.matmul_precision))
        stack.callback(val_logger.close)
        stack.callback(logger.close)
        stack.callback(lambda: profile.close(state.step))
        stream = staged_groups()
        staged: deque[list[Batch]] = deque()
        while True:
            while len(staged) <= max(0, tc.prefetch_chunks):
                group = next(stream, None)
                if group is None:
                    break
                staged.append(group)
            if not staged:
                break
            group = staged.popleft()
            prev = state.step
            profile.before(prev, len(group))
            reports = [train_step(state, b, cfg) for b in group]
            for _ in group:
                logger.tick()
            step = state.step
            profile.after(prev, step)

            def crossed(every: int) -> bool:
                # A chunk may step past an exact multiple.
                return step // every > prev // every

            if crossed(s.log_step):
                losses = _report_dict(chunk_report(
                    reports, tc.steps_per_call))
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
                                  sampler, corpus.stats, logger)
            if crossed(s.save_step):
                ckpt.save(step, state)
        ckpt.save(state.step, state)
    return state
