"""Train state and checkpoints; the JAX package's ``train/state.py`` with
``torch.save`` in place of Orbax.

A checkpoint holds the model's state dict (parameters, the pitch/energy
bins and the postnet's BatchNorm statistics), the optimizer state (Adam
moments, the update count that places the learning-rate schedule, the
accumulated gradients), the step and the dropout generator's state, as
``<ckpt_path>/<step>.pt``. Restoring one continues the run where it
stopped; the latest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..config import Config
from ..models import FastSpeech2
from .schedule import Optimizer


@dataclass
class TrainState:
    model: FastSpeech2
    optimizer: Optimizer
    generator: torch.Generator  # dropout draws, on the model's device
    step: int = 0


def create_train_state(cfg: Config, stats: dict | None,
                       device: torch.device) -> TrainState:
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
    return TrainState(model, optimizer, generator)


class CheckpointManager:
    """Save ``<directory>/<step>.pt``, keep the latest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(name[:-3]) for name in os.listdir(self.directory)
                      if name.endswith(".pt") and name[:-3].isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: TrainState) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": step,
                    "generator": state.generator.get_state()}, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state: TrainState, step: int | None = None) -> None:
        """Load the checkpoint at ``step`` (the latest by default) into
        ``state`` in place."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        load_checkpoint(state, torch.load(self.path(step),
                                          map_location="cpu"))


def load_checkpoint(state: TrainState, ckpt: dict) -> None:
    """A checkpoint dict into ``state`` in place: the model (strictly), the
    optimizer, the step and, when the dict holds one, the generator's
    state."""
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if "generator" in ckpt:
        state.generator.set_state(ckpt["generator"])
    state.step = int(ckpt["step"])
