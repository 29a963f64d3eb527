"""Train state and checkpoints; the JAX package's ``train/state.py`` with
``torch.save`` in place of Orbax.

A checkpoint holds the model's state dict (parameters, the pitch/energy
bins and the postnet's BatchNorm statistics), the optimizer state (Adam
moments, the update count that places the learning-rate schedule, the
accumulated gradients), the step and the dropout generator's state, as
``<ckpt_path>/<step>.pt``. Restoring one continues the run where it
stopped; the latest ``max_to_keep`` are kept. The vocoder trainer keeps
its own dicts through the same manager (``save_dict``, ``load``).

Under a data-parallel ``layout`` (``parallel.Layout``) rank 0 alone
writes a train state's checkpoint, and every rank waits for it; rank 0
alone restores one (``CheckpointManager.resume``), and every rank then
takes rank 0's whole state (``broadcast_state``), so that a rank whose
directory holds no checkpoint, or another one, resumes alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..config import Config
from ..graphs import Graphs
from ..models import FastSpeech2
from ..parallel.mesh import Layout, replicated
from .schedule import Optimizer


@dataclass
class TrainState:
    model: FastSpeech2
    optimizer: Optimizer
    generator: torch.Generator  # dropout draws, on the model's device
    step: int = 0
    layout: Layout | None = None  # data parallelism: the step's collectives
    # The compiled steps' CUDA graphs (``train.step.make_train_step``).
    graphs: Graphs | None = field(default=None, repr=False)


def create_train_state(cfg: Config, stats: dict | None,
                       device: torch.device,
                       layout: Layout | None = None) -> TrainState:
    """A fresh model from ``cfg.train.seed`` (torch's default inits, the
    distributions the JAX package's ``models/init.py`` copies) on
    ``device``, its optimizer, and a dropout generator seeded with
    ``seed + 1``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = FastSpeech2(cfg.model, cfg.preprocess, stats)
    model.to(device)
    optimizer = Optimizer(model.named_parameters(), cfg.train.optimizer,
                          cfg.model.transformer.encoder_hidden)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.train.seed + 1)
    return TrainState(model, optimizer, generator, layout=layout)


class CheckpointManager:
    """Save ``<directory>/<step>.pt``, keep the latest ``max_to_keep``;
    under a data-parallel ``layout``, rank 0's directory alone."""

    def __init__(self, directory: str, max_to_keep: int = 10,
                 layout: Layout | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.layout = layout
        self.writer = layout is None or layout.rank == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(name[:-3]) for name in os.listdir(self.directory)
                      if name.endswith(".pt") and name[:-3].isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save_dict(self, step: int, ckpt: dict) -> None:
        """Write ``ckpt`` as ``<step>.pt`` (through a temporary file) and
        drop all but the latest ``max_to_keep``."""
        tmp = self.path(step) + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def load(self, step: int | None = None) -> dict:
        """The checkpoint dict at ``step`` (the latest by default), on the
        CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu")

    def save(self, step: int, state: TrainState) -> None:
        """Write ``state`` as ``<step>.pt``; under a layout on rank 0
        alone, behind a barrier of every rank."""
        if self.writer:
            self.save_dict(step, {"model": state.model.state_dict(),
                                  "optimizer": state.optimizer.state_dict(),
                                  "step": step,
                                  "generator": state.generator.get_state()})
        if self.layout is not None:
            dist.barrier()

    def restore(self, state: TrainState, step: int | None = None) -> None:
        """Load the checkpoint at ``step`` (the latest by default) into
        ``state`` in place."""
        load_checkpoint(state, self.load(step))

    def resume(self, state: TrainState, step: int | None = None) -> bool:
        """Restore the checkpoint at ``step``, or else the latest one if
        there is one; whether one was restored. Under a layout rank 0
        restores from its directory and every rank takes its state
        (``broadcast_state``); when rank 0 fails, every rank raises."""
        restored = False
        try:
            if self.writer and (step is not None
                                or self.latest_step() is not None):
                self.restore(state, step)
                restored = True
        except Exception:
            if self.layout is not None:
                broadcast_state(state, failed=True)
            raise
        if self.layout is not None:
            restored = broadcast_state(state, restored)
        return restored


def broadcast_state(state: TrainState, restored: bool = False,
                    failed: bool = False) -> bool:
    """Rank 0's state on every rank, in place: the step, the update and
    accumulation counts, the model's state (parameters and buffers), the
    Adam moments, the accumulated gradients and the dropout generator's
    state. Returns rank 0's ``restored``; every other rank raises when
    rank 0 reports ``failed`` (rank 0 raises its own error)."""
    opt = state.optimizer
    device = state.generator.device
    meta = torch.tensor([failed, restored, state.step, int(opt.count),
                         int(opt.mini_step)], dtype=torch.int64,
                        device=device)
    dist.broadcast(meta, src=0)
    failed, restored, state.step, count, mini_step = (
        int(v) for v in meta.tolist())
    opt.count.fill_(count)
    opt.mini_step.fill_(mini_step)
    if failed:
        if dist.get_rank() == 0:
            return False
        raise RuntimeError("rank 0 failed to restore its checkpoint")
    generator = state.generator.get_state().to(device)
    replicated([*state.model.state_dict().values(), *opt.mu, *opt.nu,
                *opt.acc, generator])
    state.generator.set_state(generator.cpu())
    return bool(restored)


def load_checkpoint(state: TrainState, ckpt: dict) -> None:
    """A checkpoint dict into ``state`` in place: the model (strictly), the
    optimizer, the step and, when the dict holds one, the generator's
    state."""
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if "generator" in ckpt:
        state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])
