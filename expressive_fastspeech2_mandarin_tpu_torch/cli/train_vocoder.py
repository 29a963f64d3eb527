"""HiFi-GAN vocoder training CLI: the generator trained on a wav corpus
(context mode), or on (mel, wav) pairs with ``--gta`` (teacher-forced mels
of a FastSpeech2 checkpoint of the port's trainer) or ``--paired_gt`` (the
corpus' ground-truth mels).

Output under --out: ``ckpt/`` (resumable), ``metrics.jsonl`` and
``generator.npz`` (folded weights: pass it as ``--vocoder_ckpt`` to
efs2-torch-synthesize or set model.yaml's ``vocoder.ckpt_path``).
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
    ap = argparse.ArgumentParser(prog="efs2-torch-train-vocoder")
    add_config_args(ap)
    ap.add_argument("--wav_dir", default=None,
                    help="wav corpus root (default: preprocess raw_path)")
    ap.add_argument("--out", default=None,
                    help="output dir (default: <ckpt_path>/../vocoder)")
    ap.add_argument("--total_steps", type=int, default=None,
                    help="override vocoder_train.total_step")
    ap.add_argument("--limit", type=int, default=None,
                    help="cap the number of wavs loaded (smoke runs)")
    ap.add_argument("--init_ckpt", default=None,
                    help="warm-start the generator for fine-tuning: a "
                         "generator.npz or a torch HiFi-GAN checkpoint")
    ap.add_argument("--gta", default=None, metavar="ACOUSTIC_CKPT_DIR",
                    help="GTA fine-tuning: export teacher-forced predicted "
                         "mels from this checkpoint directory of the port's "
                         "trainer and train on (predicted mel, real wav) "
                         "pairs")
    ap.add_argument("--paired_gt", action="store_true",
                    help="paired mode on the preprocessed GT mels "
                         "(ablation baseline for --gta)")
    ap.add_argument("--no-packed-generator", action="store_true",
                    help="accepted for the JAX CLI's command lines, without "
                         "effect: the packed generator is a TPU layout, and "
                         "the port always trains the plain one")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_from_args(args)
    wav_dir = args.wav_dir or cfg.preprocess.path.raw_path
    if not wav_dir or not os.path.isdir(wav_dir):
        ap.error(f"--wav_dir not found: {wav_dir!r}")
    out = args.out or os.path.join(
        os.path.dirname(cfg.train.path.ckpt_path or "output/ckpt"),
        "vocoder")

    from ..interop.torch_ckpt import load_vocoder_state
    from ..train.vocoder import load_corpus_wavs, train_vocoder

    init = load_vocoder_state(args.init_ckpt) if args.init_ckpt else None
    sr = cfg.preprocess.audio.sampling_rate
    if args.gta or args.paired_gt:
        from ..train.vocoder import export_gta_mels, load_paired_corpus

        mel_dir = None
        if args.gta:
            mel_dir = os.path.join(out, "gta_mels")
            if not os.path.isdir(mel_dir) or not os.listdir(mel_dir):
                export_gta_mels(cfg, args.gta, mel_dir, device=device)
        pairs = load_paired_corpus(cfg, mel_dir=mel_dir)
        if args.limit:
            pairs = pairs[:args.limit]
        print(f"vocoder training (paired{'/GTA' if args.gta else ''}): "
              f"{len(pairs)} utterances "
              f"({sum(len(w) for _m, w in pairs) / sr:.1f} s) → {out}")
        train_vocoder(cfg, None, out, total_steps=args.total_steps,
                      init_generator_params=init, pairs=pairs, device=device)
        return

    wavs = load_corpus_wavs(wav_dir, sr, limit=args.limit)
    print(f"vocoder training: {len(wavs)} utterances "
          f"({sum(len(w) for w in wavs) / sr:.1f} s), "
          f"batch {cfg.vocoder_train.batch_size} × "
          f"{cfg.vocoder_train.segment_size} samples → {out}")
    train_vocoder(cfg, wavs, out, total_steps=args.total_steps,
                  init_generator_params=init, device=device)


if __name__ == "__main__":
    main()
