"""Training log: plain text and JSONL metrics, with a step timer, and
figures as PNG files; the JAX package's ``utils/logging.py:TrainLogger``
without TensorBoard."""

from __future__ import annotations

import json
import os
import time
from collections import deque


class TrainLogger:
    """``<log_dir>/log.txt`` and ``<log_dir>/metrics.jsonl``, appended to;
    ``close`` closes both."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._text = open(os.path.join(log_dir, "log.txt"), "a")
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._step_times: deque[float] = deque(maxlen=100)
        self._last_tick: float | None = None

    def tick(self) -> None:
        """Call once per step for steps/s tracking."""
        now = time.perf_counter()
        if self._last_tick is not None:
            self._step_times.append(now - self._last_tick)
        self._last_tick = now

    @property
    def steps_per_sec(self) -> float:
        if not self._step_times:
            return 0.0
        return len(self._step_times) / sum(self._step_times)

    def log_losses(self, step: int, losses: dict[str, float]) -> None:
        msg = f"Step {step}, " + ", ".join(f"{k}: {v:.4f}"
                                           for k, v in losses.items())
        self._text.write(msg + "\n")
        self._text.flush()
        record = {"step": step, "time": time.time(),
                  "steps_per_sec": round(self.steps_per_sec, 3), **losses}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_figure(self, tag: str, fig, step: int) -> str:
        """Write ``fig`` to ``<log_dir>/figures/<tag>_step<N>.png`` (a "/"
        in the tag as "_") and close it; returns the path."""
        from .plotting import save_figure

        fig_dir = os.path.join(self.log_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        path = os.path.join(fig_dir,
                            f"{tag.replace('/', '_')}_step{step}.png")
        save_figure(path, fig)
        return path

    def close(self) -> None:
        self._text.close()
        self._jsonl.close()
