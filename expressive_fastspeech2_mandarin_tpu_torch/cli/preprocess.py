"""Preprocess CLI: feature extraction from an aligned corpus (reference:
preprocess.py + prepare_align.py + prepare_esd_data*.py).

Subcommands:
  features  — TextGrids + wavs → mel/pitch/energy/duration + metadata: F0
              in a pool of host workers, the mel STFT on ``--device``
  esd       — ESD dataset layout → raw_data/ (wav+lab+filelist)
  resample  — batch-resample a raw_data tree in place or to a new dir
              (reference: resample_audio.py, resample_to_22050.py)
"""

from __future__ import annotations

import argparse
import os

from ..device import resolve_device
from .common import (
    add_config_args,
    add_device_arg,
    config_from_args,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-preprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)

    feat = sub.add_parser("features", help="extract training features")
    add_config_args(feat)
    feat.add_argument("--num-workers", type=int, default=None)
    add_device_arg(feat)

    esd = sub.add_parser("esd", help="prepare ESD corpus into raw_data/")
    esd.add_argument("--esd-root", required=True)
    esd.add_argument("--raw-path", required=True)
    esd.add_argument("--sampling-rate", type=int, default=22050)

    rs = sub.add_parser("resample",
                        help="resample every wav under a directory tree")
    rs.add_argument("--in-dir", required=True)
    rs.add_argument("--out-dir", default=None,
                    help="default: rewrite in place")
    rs.add_argument("--sampling-rate", type=int, default=22050)
    rs.add_argument("--peak-normalize", type=float, default=None,
                    help="scale so max |amplitude| equals this (e.g. 0.95)")

    args = ap.parse_args(argv)
    if args.cmd == "features":
        device = resolve_device(args.device)
        from ..preprocess import Preprocessor

        cfg = config_from_args(args)
        pre = Preprocessor(cfg.preprocess, num_workers=args.num_workers,
                           device=device)
        out = pre.build_from_path()
        print(f"wrote {len(out)} utterances to "
              f"{cfg.preprocess.path.preprocessed_path}")
    elif args.cmd == "esd":
        from ..preprocess import prepare_esd

        prepare_esd(args.esd_root, args.raw_path,
                    sampling_rate=args.sampling_rate)
        print(f"prepared ESD corpus at {args.raw_path}")
    else:
        from ..utils.wav import load_wav, save_wav

        out_root = args.out_dir or args.in_dir
        n = 0
        for dirpath, dirs, files in os.walk(args.in_dir):
            dirs.sort()
            rel = os.path.relpath(dirpath, args.in_dir)
            for f in sorted(files):
                if not f.lower().endswith(".wav"):
                    continue
                audio, _ = load_wav(os.path.join(dirpath, f),
                                    args.sampling_rate)
                if args.peak_normalize:
                    peak = float(abs(audio).max()) or 1.0
                    audio = audio * (args.peak_normalize / peak)
                dst_dir = os.path.join(out_root, rel)
                os.makedirs(dst_dir, exist_ok=True)
                save_wav(os.path.join(dst_dir, f), audio,
                         args.sampling_rate)
                n += 1
        print(f"resampled {n} wavs to {args.sampling_rate} Hz "
              f"under {out_root}")


if __name__ == "__main__":
    main()
