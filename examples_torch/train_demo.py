"""Drive the port's training stack end to end on a synthetic batch: the
compiled train step (dropout + batch-statistics BatchNorm + gradient clip
+ Adam/Noam, one CUDA graph replay a step on the card), the loss must
drop; the counterpart of ``examples/train_demo.py``.

Usage: python examples_torch/train_demo.py [--steps 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def synthetic_batch(b: int = 4, s: int = 64, t: int = 250,
                    seed: int = 0) -> dict[str, np.ndarray]:
    """``examples/train_demo.py``'s batch: random IDs, mels, pitch and
    energy, durations of 1-4 frames a phoneme."""
    rng = np.random.default_rng(seed)
    durations = rng.integers(1, 5, (b, s)).astype(np.int32)
    return {
        "speakers": rng.integers(0, 10, b).astype(np.int32),
        "emotions": rng.integers(0, 5, b).astype(np.int32),
        "arousals": rng.integers(0, 5, b).astype(np.int32),
        "valences": rng.integers(0, 5, b).astype(np.int32),
        "texts": rng.integers(4, 107, (b, s)).astype(np.int32),
        "src_lens": np.full((b,), s, np.int32),
        "mels": rng.normal(-1, 1, (b, t, 80)).astype(np.float32),
        "mel_lens": durations.sum(1).astype(np.int32),
        "pitches": rng.normal(0, 1, (b, s)).astype(np.float32),
        "energies": rng.normal(0, 1, (b, s)).astype(np.float32),
        "durations": durations,
    }


def main(argv: list[str] | None = None) -> dict:
    """Train ``--steps`` steps on one batch; returns the first and final
    losses and the steady ms a step."""
    from expressive_fastspeech2_mandarin_tpu_torch.cli.common import (
        add_device_arg,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.device import (
        resolve_device,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_train_step,
    )

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "CPU")
    print(f"device: {device} ({name})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg = Config()
    state = create_train_state(cfg, None, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"FastSpeech2 params: {n_params / 1e6:.1f}M")
    batch = synthetic_batch()
    b = batch["speakers"].shape[0]
    staged = stage_batch(batch, device)
    step_fn = make_train_step(state, cfg)

    t0 = time.perf_counter()
    report = step_fn(staged)
    first = {"total": float(report.total), "mel": float(report.mel)}
    print(f"first step (capture): {time.perf_counter() - t0:.1f}s  "
          f"total={first['total']:.3f} mel={first['mel']:.3f}")
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        report = step_fn(staged)
    sync()
    dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)
    final = {"total": float(report.total), "mel": float(report.mel),
             "duration": float(report.duration)}
    print(f"final: total={final['total']:.3f} mel={final['mel']:.3f} "
          f"dur={final['duration']:.3f} @ step {state.step}")
    print(f"steady-state on {name}: {dt * 1000:.1f} ms/step (batch {b}) = "
          f"{1 / dt:.2f} steps/s")
    return {"first": first, "final": final, "ms_per_step": dt * 1000,
            "steps": state.step}


if __name__ == "__main__":
    main()
