"""Evaluation CLI: the teacher-forced losses over the whole val set, from a
checkpoint of the port's trainer (reference: evaluate.py:18-119)."""

from __future__ import annotations

import argparse

from ..device import resolve_device
from .common import (
    add_config_args,
    add_device_arg,
    config_from_args,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-evaluate")
    add_config_args(ap)
    ap.add_argument("--restore_step", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..data import BucketedDataset, PreprocessedCorpus
    from ..train import CheckpointManager, create_train_state
    from ..train.loop import evaluate

    cfg = config_from_args(args)
    corpus = PreprocessedCorpus(cfg.preprocess.path.preprocessed_path)
    state = create_train_state(cfg, corpus.stats, device)
    CheckpointManager(cfg.train.path.ckpt_path or "output/ckpt").restore(
        state, args.restore_step)
    val_ds = BucketedDataset(corpus, "val.txt", cfg.train.optimizer.batch_size,
                             cfg.train.buckets, cfg.model.max_seq_len,
                             symbol_table=cfg.preprocess.symbol_table)
    losses = evaluate(state.model, val_ds, cfg, device)
    print(f"Validation at step {state.step}: " + ", ".join(
        f"{k}={v:.4f}" for k, v in losses.items()))


if __name__ == "__main__":
    main()
