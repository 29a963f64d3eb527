"""Training-convergence check of the PyTorch port: build a synthetic tone
corpus, run the port's pipeline (feature extraction → train N steps) on
the card, and report the losses; the counterpart of
``examples/convergence_demo.py``.

With distinct per-phone spectra the model should drive the mel loss well
below its initial value and learn durations within a few hundred steps.

Usage: python examples_torch/convergence_demo.py [--steps 300]
           [--workdir DIR] [--fresh] [--device cpu]

``main(argv, attention_impl="flash")`` trains with the float32 flash
attention kernels in every FFT block (``chip_smoke.py`` phase 15).
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from examples_torch.convergence_deep import (  # noqa: E402
    extract_features,
    parse_args,
    read_metrics,
)


def build_corpus(workdir: str, n_utts: int = 120, sr: int = 22050):
    """2 speakers × {Happy, Sad}: raw wavs, labs, filelist, speaker list
    and a TextGrid per utterance; returns (raw_path, preprocessed_path)."""
    from expressive_fastspeech2_mandarin_tpu_torch.preprocess import (
        Interval,
        TextGrid,
        Tier,
        write_textgrid,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(0)
    freq = {"b": 250, "a": 700, "n": 420, "h": 1500, "ao": 550, "z": 2200,
            "o": 480, "ng": 330}
    texts = [("ban hao", [["b", "a", "n"], ["h", "ao"]]),
             ("zong", [["z", "o", "ng"]]),
             ("hao ban", [["h", "ao"], ["b", "a", "n"]]),
             ("zong hao", [["z", "o", "ng"], ["h", "ao"]])]
    raw = os.path.join(workdir, "raw_data")
    pre = os.path.join(workdir, "preprocessed")
    filelist = []
    for spk_i, spk in enumerate(["0001", "0002"]):
        os.makedirs(os.path.join(raw, spk), exist_ok=True)
        os.makedirs(os.path.join(pre, "TextGrid", spk), exist_ok=True)
        for k in range(n_utts // 2):
            text, words = texts[k % len(texts)]
            phones = [p for w in words for p in w]
            durs = rng.uniform(0.07, 0.18, len(phones))
            parts = [np.zeros(int(sr * 0.08))]
            for p, d in zip(phones, durs):
                t = np.arange(int(sr * d)) / sr
                f = freq[p] * (1.0 + 0.1 * spk_i)
                sig = (0.4 * np.sin(2 * np.pi * f * t)
                       + 0.2 * np.sin(2 * np.pi * 2.1 * f * t))
                env = np.minimum(1, np.minimum(np.arange(len(t)) / 400,
                                               (len(t) - np.arange(len(t))) / 400))
                parts.append(sig * env)
            parts.append(np.zeros(int(sr * 0.08)))
            wav = np.concatenate(parts).astype(np.float32)
            wav += 0.01 * rng.standard_normal(len(wav)).astype(np.float32)
            base = f"{spk}_{k:06d}"
            save_wav(os.path.join(raw, spk, f"{base}.wav"), wav, sr)
            with open(os.path.join(raw, spk, f"{base}.lab"), "w") as f_:
                f_.write(text + "\n")
            dur_total = len(wav) / sr
            t0 = 0.08
            ivs = [Interval(0, t0, "sil")]
            for p, d in zip(phones, durs):
                ivs.append(Interval(t0, t0 + d, p))
                t0 += d
            ivs.append(Interval(t0, dur_total, "sp"))
            write_textgrid(TextGrid(0, dur_total, [Tier("phones", ivs)]),
                           os.path.join(pre, "TextGrid", spk,
                                        f"{base}.TextGrid"))
            emo = ["Happy", "Sad"][k % 2]
            av = {"Happy": ("0.8", "0.8"), "Sad": ("0.3", "0.2")}[emo]
            filelist.append(
                f"{base}|{text}|{spk}|demo|default|{emo}|{av[0]}|{av[1]}")
    with open(os.path.join(raw, "filelist.txt"), "w") as f_:
        f_.write("\n".join(filelist) + "\n")
    with open(os.path.join(raw, "speaker_info.txt"), "w") as f_:
        f_.write("0001|zh|f\n0002|zh|m\n")
    return raw, pre


def build_config(raw: str, pre: str, workdir: str, steps: int,
                 attention_impl: str = "auto"):
    """``examples/convergence_demo.py``'s configuration: the full-width
    FastSpeech2, batch 8, warm-up 100, one step a call, one (16, 128)
    bucket, validation every 100 steps; outputs under ``workdir``."""
    from expressive_fastspeech2_mandarin_tpu_torch.config import (
        BucketConfig,
        Config,
        ModelConfig,
        OptimizerConfig,
        PathConfig,
        PreprocessConfig,
        StepConfig,
        TrainConfig,
        TransformerConfig,
    )

    return Config(
        preprocess=PreprocessConfig(
            path=PathConfig(raw_path=raw, preprocessed_path=pre),
            val_size=8),
        model=ModelConfig(
            transformer=TransformerConfig(attention_impl=attention_impl),
            n_speakers=2, n_emotions=2, n_arousals=2, n_valences=2,
            max_seq_len=256),
        train=TrainConfig(
            path=PathConfig(ckpt_path=os.path.join(workdir, "ckpt"),
                            log_path=os.path.join(workdir, "log"),
                            result_path=os.path.join(workdir, "result")),
            optimizer=OptimizerConfig(batch_size=8, warm_up_step=100),
            step=StepConfig(total_step=steps, log_step=20,
                            synth_step=10 ** 9, val_step=100,
                            save_step=steps),
            buckets=BucketConfig(src_buckets=(16,), mel_buckets=(128,)),
        ),
    )


def main(argv: list[str] | None = None,
         attention_impl: str = "auto") -> dict:
    """The whole run; returns its train and val records."""
    args = parse_args(argv, 300, "convergence_demo", None)
    from expressive_fastspeech2_mandarin_tpu_torch.device import (
        resolve_device,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import train

    device = resolve_device(args.device)
    if args.fresh and os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    raw, pre = build_corpus(args.workdir)
    cfg = build_config(raw, pre, args.workdir, args.steps, attention_impl)
    extract_features(cfg, device)
    train(cfg, total_steps=args.steps, device=device)

    log = cfg.train.path.log_path
    records = read_metrics(os.path.join(log, "train", "metrics.jsonl"))
    first, last = records[0], records[-1]
    print(f"\ntrain loss: step {first['step']}: total={first['total_loss']:.3f} "
          f"mel={first['mel_loss']:.3f} dur={first['duration_loss']:.3f}")
    print(f"            step {last['step']}: total={last['total_loss']:.3f} "
          f"mel={last['mel_loss']:.3f} dur={last['duration_loss']:.3f}")
    vals = read_metrics(os.path.join(log, "val", "metrics.jsonl"))
    for v in vals:
        print(f"val step {v['step']}: total={v['total_loss']:.3f} "
              f"mel={v['mel_loss']:.3f} dur={v['duration_loss']:.3f}")
    return {"records": records, "vals": vals}


if __name__ == "__main__":
    main()
