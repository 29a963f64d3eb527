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

The steps are the compiled ones, as the JAX loop takes its jitted steps
(``train/loop.py:121-124`` there): ``train.step.make_train_step``, a CUDA
graph per bucket on the card, in one process and over NCCL, eager on the
CPU and over gloo (whose collectives cannot be captured); evaluation and
the samples' synthesis likewise (``make_eval_step``, ``make_synth_step``).
With
``steps_per_call`` > 1, consecutive batches of one bucket run as chunks of
that many steps (``chunks``), as the JAX package's scanned steps do: a
full chunk is one call of the multi step (``make_train_multi_step``, one
replay on the card) over the stacked batches and logs its steps' mean
losses, a shorter group (a bucket change, the trimmed end) runs the single
step batch by batch and logs its last; the cadences are checked when a
group ends (a crossing, since a chunk may step past a multiple), and the
last group is cut so the run stops at ``total_steps``.

Each group is staged ahead of the running one (``prefetch_chunks``): the
mel targets, most of a batch's bytes, are encoded on the host
(``transfer_dtype``: int16 per-utterance affine quantization, bf16 or
float32) and every array is copied host → device from pinned memory with
``non_blocking``.

In an initialized process group (``parallel.initialize_distributed``) the
run is data-parallel, as the JAX loop is over processes: ``batch_size`` is
the global batch and each rank collates its row slice of the train and
val batches; rank 0 restores the latest checkpoint and its state is
broadcast at the start; the step takes the run's ``parallel.Layout``;
the steps, ``evaluate`` and every checkpoint are collective; only rank 0
logs, profiles and synthesizes samples, none of which holds a collective.
Every rank prints its final step and parameter checksum.

Over NCCL the steps replay with their collectives inside, so every rank
must capture, replay and drop its graphs at the same calls: a rank that
captured alone would run its warm-up's collectives with no partner, and
the group would hang. The keys agree (the buckets come from the global
batch). What rank 0 does alone leaves the graphs every rank holds as they
are: its samples compile on graphs of their own (``make_synth_step``),
and before the first step every rank grows the position tables to the
longest bucket of the run (``FastSpeech2.reserve_positions``), so that no
sample longer than ``max_seq_len`` replaces a table the train graphs read.
"""

from __future__ import annotations

import contextlib
import math
import os
from collections import deque
from collections.abc import Callable, Iterable, Iterator

import numpy as np
import torch

from ..config import MATMUL_PRECISIONS, Config
from ..data import BucketedDataset, PreprocessedCorpus
from ..device import resolve_device
from ..parallel.mesh import make_layout
from ..utils.logging import TrainLogger
from ..utils.plotting import expand_by_duration, plot_mel, save_mel_plot
from ..utils.wav import save_wav
from .loss import LossReport
from .sampling import SampleVocoder
from .state import CheckpointManager, TrainState, create_train_state
from .step import (
    Batch,
    make_eval_step,
    make_synth_step,
    make_train_multi_step,
    make_train_step,
    stack_batches,
)

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


def evaluate(step: Callable[[Batch], LossReport], val_ds: BucketedDataset,
             device: torch.device) -> dict[str, float]:
    """Sample-weighted means of the teacher-forced losses of ``step`` (the
    compiled eval step, ``make_eval_step``) over the whole val set, read
    after each call; under a data-parallel layout a collective, every
    batch's losses the global ones, weighed alike on every rank."""
    sums = np.zeros(len(_LOSS_KEYS))
    count = 0
    for batch in val_ds.epoch(0, shuffle=False):
        b = batch["speakers"].shape[0]
        report = step(stage_batch(batch, device))
        sums += np.array([float(x) for x in report]) * b
        count += b
    return dict(zip(_LOSS_KEYS, sums / max(count, 1)))


def save_synth_sample(synth: Callable, val_ds: BucketedDataset,
                      cfg: Config, device: torch.device, step: int,
                      sampler: SampleVocoder, stats: dict,
                      logger: TrainLogger) -> str:
    """Synthesize the first val batch free-running through ``synth`` (the
    compiled synthesis step, ``make_synth_step``), at its mel bucket, and
    save the predicted mels and lengths, the first utterance's figures
    (``step<N>.png``, and to ``logger`` the predicted and ground-truth
    panels with pitch and energy, from the corpus ``stats``, as the JAX
    loop logs them) and its predicted and ground-truth audio through
    ``sampler`` (when both are longer than 4 frames, as the JAX loop
    does); returns the directory."""
    batch = next(val_ds.epoch(0, shuffle=False))
    mel, mel_lens, _ = synth(stage_batch(batch, device),
                             batch["mels"].shape[1])
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
    layout = make_layout(tc.mesh.model_parallel_size)
    n_data = layout.data_parallel if layout else 1
    if tc.optimizer.batch_size % n_data:
        raise ValueError(
            f"multi-host: global batch {tc.optimizer.batch_size} must "
            f"divide evenly over the {n_data}-way data axis")
    is_main = layout is None or layout.rank == 0
    corpus = PreprocessedCorpus(cfg.preprocess.path.preprocessed_path)
    ds_args = (tc.optimizer.batch_size, tc.buckets, cfg.model.max_seq_len)
    ds_kwargs = dict(seed=tc.seed, symbol_table=cfg.preprocess.symbol_table,
                     num_shards=n_data,
                     shard_index=layout.data_index if layout else 0)
    train_ds = BucketedDataset(corpus, "train.txt", *ds_args, drop_last=True,
                               **ds_kwargs)
    val_ds = BucketedDataset(corpus, "val.txt", *ds_args, **ds_kwargs)
    if not len(train_ds) // tc.optimizer.batch_size:
        raise ValueError(f"train.txt holds fewer than one batch of "
                         f"{tc.optimizer.batch_size} usable utterances")

    state = create_train_state(cfg, corpus.stats, device, layout)
    ckpt = CheckpointManager(tc.path.ckpt_path or "output/ckpt",
                             layout=layout)
    if ckpt.resume(state, restore_step):
        print(f"restored checkpoint at step {state.step}")

    total = total_steps or tc.step.total_step
    s = tc.step
    n_params = sum(p.numel() for p in state.model.parameters())
    where = (f"rank {layout.rank} of {layout.world_size}, data axis "
             f"{n_data}" if layout else "one process")
    print(f"training: {n_params / 1e6:.1f}M params, {len(train_ds)} "
          f"utterances, device {device}, {where}")
    sampler = None
    if is_main:
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
    # Rank 0 alone logs and profiles (a window that never opens elsewhere).
    logger = val_logger = None
    if is_main:
        logger = TrainLogger(os.path.join(log_dir, "train"))
        val_logger = TrainLogger(os.path.join(log_dir, "val"))
    window = ((tc.profile_start_step, tc.profile_stop_step) if is_main
              else (-1, -1))
    profile = ProfileWindow(*window, os.path.join(log_dir, "profile"),
                            device)
    state.model.reserve_positions(max(tc.buckets.src_buckets),
                                  max(tc.buckets.mel_buckets))
    spc = tc.steps_per_call
    single_step = make_train_step(state, cfg)
    multi_step = make_train_multi_step(state, cfg, spc) if spc > 1 else None
    eval_fn = make_eval_step(state, cfg)
    synth_fn = make_synth_step(state)

    def run_group(group: list[Batch]) -> LossReport:
        """The group's steps and the report it logs: a full chunk's mean,
        as the JAX package's scanned step returns it, else the last
        step's."""
        if multi_step is not None and len(group) == spc:
            return multi_step(stack_batches(group))
        return [single_step(b) for b in group][-1]

    with contextlib.ExitStack() as stack:
        stack.enter_context(matmul_precision(tc.matmul_precision))
        if is_main:
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
            report = run_group(group)
            if is_main:
                for _ in group:
                    logger.tick()
            step = state.step
            profile.after(prev, step)

            def crossed(every: int) -> bool:
                # A chunk may step past an exact multiple.
                return step // every > prev // every

            if crossed(s.log_step):
                # The losses are global: every rank sees a non-finite one.
                losses = _report_dict(report)
                if is_main:
                    losses["steps_per_sec"] = logger.steps_per_sec
                    logger.log_losses(step, losses)
                if not math.isfinite(losses["total_loss"]):
                    ckpt.save(step, state)
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: {losses} "
                        f"(emergency checkpoint saved)")
            if crossed(s.val_step):
                val_losses = evaluate(eval_fn, val_ds, device)
                if is_main:
                    val_logger.log_losses(step, val_losses)
            if crossed(s.synth_step) and is_main:
                save_synth_sample(synth_fn, val_ds, cfg, device, step,
                                  sampler, corpus.stats, logger)
            if crossed(s.save_step):
                ckpt.save(step, state)
        ckpt.save(state.step, state)
    if layout is not None:
        checksum = sum(p.double().abs().sum() for p in
                       state.model.parameters()).item()
        print(f"rank {layout.rank} of {layout.world_size}: step "
              f"{state.step}, parameter sum {checksum!r}")
    return state
