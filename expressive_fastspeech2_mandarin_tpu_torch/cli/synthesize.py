"""Synthesis CLI (reference: synthesize_chinese_pinyin.py:156-307).

Modes:
  single — one hanzi/phoneme-string utterance with speaker/emotion/controls
           (``--stream_chunk_frames`` > 0 streams the vocoder)
  batch  — a metadata file (train.txt format) synthesized in batches of 8
  grid   — one text for every speaker × emotion (reference:
           generate_emotion_samples.py)

The acoustic model comes from ``--torch_ckpt`` (a reference ``.pth.tar``)
or else from the port trainer's checkpoints under the train config's
``ckpt_path`` (``--restore_step``, the latest by default).
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

BATCH = 8


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-synthesize")
    add_config_args(ap)
    ap.add_argument("--mode", choices=["single", "batch", "grid"],
                    required=True,
                    help="grid: every speaker x emotion for one text "
                         "(reference: generate_emotion_samples.py)")
    ap.add_argument("--text", default=None, help="single: hanzi or {phones}")
    ap.add_argument("--source", default=None, help="batch: metadata file")
    ap.add_argument("--speaker_id", default="0001")
    ap.add_argument("--emotion", default="Neutral",
                    choices=["Angry", "Happy", "Neutral", "Sad", "Surprise"])
    ap.add_argument("--restore_step", type=int, default=None,
                    help="checkpoint step of the port's trainer "
                         "(<ckpt_path>/<step>.pt; the latest by default)")
    ap.add_argument("--torch_ckpt", default=None,
                    help="reference .pth.tar model checkpoint to convert")
    ap.add_argument("--vocoder_ckpt", default=None,
                    help="HiFi-GAN generator: a generator.npz or a "
                         "reference .pth.tar")
    ap.add_argument("--vocoder", choices=["hifigan", "griffin_lim"],
                    default=None)
    ap.add_argument("--pitch_control", type=float, default=1.0)
    ap.add_argument("--energy_control", type=float, default=1.0)
    ap.add_argument("--duration_control", type=float, default=1.0)
    ap.add_argument("--output_name", default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--save_mel", action="store_true",
                    help="also save the predicted mel as <name>_mel.npy "
                         "(parity drills, vocoder A/B tests)")
    ap.add_argument("--stream_chunk_frames", type=int, default=0,
                    help="single mode: >0 streams the vocoder in chunks of "
                         "this many mel frames (incremental wav write)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.mode in ("single", "grid") and args.text is None:
        ap.error(f"--text is required in {args.mode} mode")
    if args.mode == "batch" and args.source is None:
        ap.error("--source is required in batch mode")
    device = resolve_device(args.device)

    from ..synth import Synthesizer

    cfg = config_from_args(args)
    if args.torch_ckpt:
        synth = Synthesizer.from_torch_checkpoint(
            cfg, args.torch_ckpt, args.vocoder_ckpt, device=device)
    else:
        synth = Synthesizer.from_checkpoint(
            cfg, cfg.train.path.ckpt_path or "output/ckpt",
            args.vocoder_ckpt, step=args.restore_step, device=device)

    out_dir = args.out_dir or cfg.train.path.result_path or "output/result"
    controls = dict(pitch_control=args.pitch_control,
                    energy_control=args.energy_control,
                    duration_control=args.duration_control)

    if args.mode == "single":
        name = (args.output_name
                or f"synthesis_{args.speaker_id}_{args.emotion}")
        if args.stream_chunk_frames > 0:
            import numpy as np

            from ..utils.wav import save_wav

            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{name}.wav")
            chunks = []
            for i, chunk in enumerate(synth.synthesize_streaming(
                    args.text, args.speaker_id, args.emotion,
                    chunk_frames=args.stream_chunk_frames, **controls)):
                chunks.append(chunk)
                print(f"chunk {i}: {len(chunk)} samples")
            save_wav(path, np.concatenate(chunks),
                     cfg.preprocess.audio.sampling_rate)
            print(path)
            return
        results = synth.synthesize(
            [args.text], [args.speaker_id], [args.emotion],
            basenames=[name], vocoder=args.vocoder, **controls)
    elif args.mode == "grid":
        speakers = sorted(synth.speaker_map) or ["0"]
        emotions = sorted(synth.emotion_maps.get("emotion", {})) or ["Neutral"]
        results = []
        for spk in speakers:
            results += synth.synthesize(
                [args.text] * len(emotions), [spk] * len(emotions), emotions,
                basenames=[f"grid_{spk}_{emo}" for emo in emotions],
                vocoder=args.vocoder, **controls)
    else:
        from ..data.metadata import read_metadata

        utts = read_metadata(args.source)
        results = []
        for i in range(0, len(utts), BATCH):
            chunk = utts[i: i + BATCH]
            results += synth.synthesize(
                [u.phone_text for u in chunk],
                [u.speaker for u in chunk],
                [u.emotion for u in chunk],
                basenames=[u.basename for u in chunk],
                vocoder=args.vocoder, **controls)

    for p in synth.save_results(results, out_dir, save_mel=args.save_mel):
        print(p)


if __name__ == "__main__":
    main()
