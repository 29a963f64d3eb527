"""Alignment CLI: the native GMM-HMM forced aligner, built from
``native/aligner`` (``align.ensure_built``)."""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-align")
    ap.add_argument("--corpus", required=True,
                    help="raw_data dir: <speaker>/<utt>.wav + .lab")
    ap.add_argument("--out", required=True, help="TextGrid output dir")
    ap.add_argument("--model", default=None,
                    help="acoustic model file (loaded if present, else saved)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--mix-up", type=int, default=4)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)

    from ..align import align_corpus

    log = align_corpus(args.corpus, args.out, args.model,
                       args.iters, args.mix_up, args.threads)
    print(log)


if __name__ == "__main__":
    main()
