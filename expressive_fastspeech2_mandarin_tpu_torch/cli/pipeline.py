"""End-to-end pipeline driver: corpus prep → alignment → feature extraction
→ training (reference: train_pinyin_pipeline.py:30-150's orchestration,
with the native aligner in place of batched MFA subprocesses).

Each stage is skipped if its outputs already exist. Corpus prep is
picked by the dataset name: IEMOCAP, AIHub-MMV, or else ESD's layout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from ..device import resolve_device
from .common import (
    add_config_args,
    add_device_arg,
    config_from_args,
)

ROOT = Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-pipeline")
    add_config_args(ap)
    ap.add_argument("--esd-root", default=None,
                    help="raw ESD dataset (skip if raw_path already prepared)")
    ap.add_argument("--corpus-root", default=None,
                    help="raw corpus release for stage-1 prep; the prep "
                         "module is picked from the dataset name (IEMOCAP / "
                         "AIHub-MMV / ESD*). Defaults to "
                         "cfg.path.corpus_path when that directory exists")
    ap.add_argument("--total_steps", type=int, default=None)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--align-iters", type=int, default=8)
    ap.add_argument("--lexicon", default=None,
                    help="MFA-format pronunciation dictionary for the "
                         "aligner (default: cfg.path.lexicon_path if it "
                         "exists, else the built-in pinyin decomposition)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    raw = cfg.preprocess.path.raw_path
    # Speaker dirs live under raw/<sub_dir_name> (IEMOCAP "sessions",
    # AIHub "clips", "" for ESD): the aligner and the feature extractor
    # walk that level.
    align_root = os.path.join(raw, cfg.preprocess.path.sub_dir_name)
    pre = cfg.preprocess.path.preprocessed_path
    tg_dir = os.path.join(pre, "TextGrid")

    # Stage 1: corpus prep, picked by the dataset name.
    corpus_root = args.corpus_root or args.esd_root
    if corpus_root is None and os.path.isdir(cfg.preprocess.path.corpus_path):
        corpus_root = cfg.preprocess.path.corpus_path
    if corpus_root and not os.path.exists(os.path.join(raw, "filelist.txt")):
        name = cfg.preprocess.dataset.lower()
        sr = cfg.preprocess.audio.sampling_rate
        print(f"[1/4] preparing corpus ({cfg.preprocess.dataset}) ...")
        if "iemocap" in name or "aihub" in name:
            from ..preprocess import prepare_aihub_mmv, prepare_iemocap

            prepare, sub_dir = ((prepare_iemocap, "sessions")
                                if "iemocap" in name
                                else (prepare_aihub_mmv, "clips"))
            prepare(corpus_root, raw, sampling_rate=sr,
                    sub_dir_name=cfg.preprocess.path.sub_dir_name or sub_dir,
                    fixed_text_path=(cfg.preprocess.path.fixed_text_path
                                     or None),
                    cleaners=cfg.preprocess.text_cleaners)
        else:
            from ..preprocess import prepare_esd

            prepare_esd(corpus_root, raw, sampling_rate=sr)
    else:
        print("[1/4] corpus prep: skipped (already prepared)")

    # Stage 2: forced alignment.
    if not os.path.isdir(tg_dir) or not os.listdir(tg_dir):
        from ..align import align_corpus

        lexicon = args.lexicon
        if lexicon is None and os.path.exists(
                cfg.preprocess.path.lexicon_path):
            lexicon = cfg.preprocess.path.lexicon_path
        print("[2/4] forced alignment (native aligner) ...")
        log = align_corpus(align_root, tg_dir,
                           model_path=os.path.join(pre, "acoustic_model.bin"),
                           iters=args.align_iters, lexicon=lexicon)
        print(log.strip().splitlines()[-1])
    else:
        print("[2/4] alignment: skipped (TextGrids present)")

    # Stage 3: feature extraction, in a process of its own, as the JAX
    # package runs it.
    if not os.path.exists(os.path.join(pre, "train.txt")):
        print("[3/4] feature extraction ...")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
        subprocess.run(
            [sys.executable, "-m", f"{__package__}.preprocess", "features",
             "-p", args.preprocess_config, "-m", args.model_config,
             "-t", args.train_config, "--device", str(device)],
            check=True, env=env)
    else:
        print("[3/4] features: skipped (train.txt present)")

    # Stage 4: training.
    if not args.skip_train:
        from ..train.loop import train

        print("[4/4] training ...")
        # Read again now that stage 3 has written speakers.json and
        # emotions.json, which size the model's speaker and emotion tables
        # (the JAX pipeline trains on the tables read before stage 3, which
        # its synthesize, reading them after, cannot load).
        cfg = config_from_args(args)
        train(cfg, total_steps=args.total_steps, device=device)
    else:
        print("[4/4] training: skipped")


if __name__ == "__main__":
    main()
