"""Deep convergence run of the PyTorch port, with audible artifacts; the
counterpart of ``examples/convergence_deep.py``.

Builds the same structured multi-speaker / multi-emotion corpus (speaker
sets the formant register, emotion scales pitch and speaking rate), runs
the port's whole pipeline on the card (feature extraction → 5,000
optimizer steps of the full-width FastSpeech2 at batch 16, ten steps a
CUDA-graph replay → checkpoint), then:

* plots train/val loss curves (where matplotlib imports; else the skip is
  logged),
* saves GT-vs-predicted mel figures (likewise) and vocoded wavs
  (Griffin-Lim: no HiFi-GAN weights are configured),
* checks conditioning: speaker and emotion changes move the output mel,
  Sad is rendered slower than Happy, and duration control scales the
  predicted length monotonically,
* records the audio-health check of ``efs2-torch-validate synth`` (its
  verdict is reported, not required: a 5,000-step run on a synthetic
  corpus learns spectral structure before output gain),
* writes ``reports/convergence_torch/CONVERGENCE.md``.

Usage: python examples_torch/convergence_deep.py [--steps 5000]
           [--workdir DIR] [--report-dir DIR] [--fresh] [--device cpu]

``main(argv, attention_impl="flash")`` runs the same with the float32
flash attention kernels in every FFT block (``chip_smoke.py`` phase 15d);
the default, "auto", takes the math path at these lengths.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SR = 22050
SPEAKERS = ["0001", "0002", "0003", "0004"]
EMOTIONS = {  # name -> (arousal, valence, f0 scale, rate scale)
    "Happy": ("0.8", "0.8", 1.15, 1.1),
    "Sad": ("0.3", "0.2", 0.85, 0.8),
    "Angry": ("0.9", "0.1", 1.25, 1.25),
}
FREQ = {"b": 250, "a": 700, "n": 420, "h": 1500, "ao": 550, "z": 2200,
        "o": 480, "ng": 330, "m": 360, "i": 2400, "sh": 1800, "u": 380}
TEXTS = [
    ("ban hao", [["b", "a", "n"], ["h", "ao"]]),
    ("zong", [["z", "o", "ng"]]),
    ("hao ban", [["h", "ao"], ["b", "a", "n"]]),
    ("zong hao", [["z", "o", "ng"], ["h", "ao"]]),
    ("mi shu", [["m", "i"], ["sh", "u"]]),
    ("shu mi ban", [["sh", "u"], ["m", "i"], ["b", "a", "n"]]),
]
# Records averaged for a run's final losses.
FINAL_RECORDS = 5


def build_corpus(workdir: str, n_utts: int = 480):
    """Raw wavs, labs, filelist and speaker list, and a TextGrid per
    utterance; returns (raw_path, preprocessed_path)."""
    from expressive_fastspeech2_mandarin_tpu_torch.preprocess import (
        Interval,
        TextGrid,
        Tier,
        write_textgrid,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(0)
    raw = os.path.join(workdir, "raw_data")
    pre = os.path.join(workdir, "preprocessed")
    filelist = []
    emo_names = list(EMOTIONS)
    per_spk = n_utts // len(SPEAKERS)
    for spk_i, spk in enumerate(SPEAKERS):
        os.makedirs(os.path.join(raw, spk), exist_ok=True)
        os.makedirs(os.path.join(pre, "TextGrid", spk), exist_ok=True)
        for k in range(per_spk):
            text, words = TEXTS[k % len(TEXTS)]
            emo = emo_names[k % len(emo_names)]
            aro, val, f0_scale, rate = EMOTIONS[emo]
            phones = [p for w in words for p in w]
            durs = rng.uniform(0.07, 0.18, len(phones)) / rate
            spk_scale = 1.0 + 0.08 * spk_i  # per-speaker register
            parts = [np.zeros(int(SR * 0.08))]
            for p, d in zip(phones, durs):
                t = np.arange(int(SR * d)) / SR
                f = FREQ[p] * spk_scale * f0_scale
                sig = (0.4 * np.sin(2 * np.pi * f * t)
                       + 0.2 * np.sin(2 * np.pi * 2.1 * f * t))
                env = np.minimum(1, np.minimum(
                    np.arange(len(t)) / 400,
                    (len(t) - np.arange(len(t))) / 400))
                parts.append(sig * env)
            parts.append(np.zeros(int(SR * 0.08)))
            wav = np.concatenate(parts).astype(np.float32)
            wav += 0.01 * rng.standard_normal(len(wav)).astype(np.float32)
            base = f"{spk}_{k:06d}"
            save_wav(os.path.join(raw, spk, f"{base}.wav"), wav, SR)
            with open(os.path.join(raw, spk, f"{base}.lab"), "w") as f_:
                f_.write(text + "\n")
            dur_total = len(wav) / SR
            t0 = 0.08
            ivs = [Interval(0, t0, "sil")]
            for p, d in zip(phones, durs):
                ivs.append(Interval(t0, t0 + d, p))
                t0 += d
            ivs.append(Interval(t0, dur_total, "sp"))
            write_textgrid(TextGrid(0, dur_total, [Tier("phones", ivs)]),
                           os.path.join(pre, "TextGrid", spk,
                                        f"{base}.TextGrid"))
            filelist.append(
                f"{base}|{text}|{spk}|demo|default|{emo}|{aro}|{val}")
    with open(os.path.join(raw, "filelist.txt"), "w") as f_:
        f_.write("\n".join(filelist) + "\n")
    with open(os.path.join(raw, "speaker_info.txt"), "w") as f_:
        f_.write("\n".join(f"{s}|zh|f" for s in SPEAKERS) + "\n")
    return raw, pre


def extract_features(cfg, device) -> None:
    """The port's feature extraction of ``cfg.preprocess``'s corpus (F0 in
    a pool of host processes, mel and energy on ``device``), unless its
    ``train.txt`` exists already."""
    from expressive_fastspeech2_mandarin_tpu_torch.preprocess import (
        Preprocessor,
    )

    pre = cfg.preprocess.path.preprocessed_path
    if os.path.exists(os.path.join(pre, "train.txt")):
        return
    Preprocessor(cfg.preprocess, device=device).build_from_path()


def build_config(raw: str, pre: str, workdir: str, steps: int,
                 attention_impl: str = "auto"):
    """``examples/convergence_deep.py``'s configuration: the full-width
    FastSpeech2 (about 35M parameters), batch 16, warm-up 400, ten steps
    a call, one (16, 128) bucket; outputs under ``workdir``."""
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
            val_size=32),
        model=ModelConfig(
            transformer=TransformerConfig(attention_impl=attention_impl),
            n_speakers=len(SPEAKERS), n_emotions=len(EMOTIONS),
            n_arousals=len(EMOTIONS), n_valences=len(EMOTIONS),
            max_seq_len=256),
        train=TrainConfig(
            path=PathConfig(ckpt_path=os.path.join(workdir, "ckpt"),
                            log_path=os.path.join(workdir, "log"),
                            result_path=os.path.join(workdir, "result")),
            optimizer=OptimizerConfig(batch_size=16, warm_up_step=400),
            step=StepConfig(total_step=steps, log_step=50,
                            synth_step=steps // 4, val_step=steps // 10,
                            save_step=steps),
            buckets=BucketConfig(src_buckets=(16,), mel_buckets=(128,)),
            steps_per_call=10,
        ),
    )


def read_metrics(path: str) -> list[dict]:
    """The records of a ``metrics.jsonl``; none where it does not exist."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def final_losses(records: list[dict], n: int = FINAL_RECORDS) -> dict:
    """Each loss's mean over the last ``n`` records."""
    keys = [k for k in records[-1] if k.endswith("_loss")]
    return {k: float(np.mean([r[k] for r in records[-n:]])) for k in keys}


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    "CPU"."""
    import torch

    if device.type != "cuda":
        return "CPU"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def plot_losses(path: str, records: list[dict], vals: list[dict]) -> bool:
    """Train and validation loss curves to ``path``; False, nothing
    written, without matplotlib."""
    from expressive_fastspeech2_mandarin_tpu_torch.utils.plotting import (
        pyplot,
        save_figure,
    )

    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for ax, recs, title in ((axes[0], records, "train"),
                            (axes[1], vals, "validation")):
        if not recs:
            continue
        for key in ("total_loss", "mel_loss", "duration_loss"):
            ax.plot([r["step"] for r in recs], [r[key] for r in recs],
                    label=key)
        ax.set_yscale("log")
        ax.set_xlabel("step")
        ax.legend()
        ax.set_title(title)
    fig.tight_layout()
    save_figure(path, fig)
    return True


def conditioning_checks(synth) -> tuple[dict, dict]:
    """Speaker and emotion move the mel, Sad is slower than Happy, and
    duration control scales the length monotonically
    (``examples/convergence_deep.py:238-255``). Returns the checks and the
    Happy and Sad waveforms."""

    def mel_for(speaker, emotion, d_control=1.0):
        return synth.synthesize(["{b a n h ao}"], speakers=[speaker],
                                emotions=[emotion],
                                duration_control=d_control)[0]

    checks = {}
    base = mel_for("0001", "Happy")
    other_spk = mel_for("0004", "Happy")
    other_emo = mel_for("0001", "Sad")
    t = min(base.mel.shape[0], other_spk.mel.shape[0])
    checks["speaker_mel_l1"] = float(
        np.abs(base.mel[:t] - other_spk.mel[:t]).mean())
    t = min(base.mel.shape[0], other_emo.mel.shape[0])
    checks["emotion_mel_l1"] = float(
        np.abs(base.mel[:t] - other_emo.mel[:t]).mean())
    # Sad was rendered slower than Happy -> predicted durations longer.
    checks["happy_frames"] = int(base.mel.shape[0])
    checks["sad_frames"] = int(other_emo.mel.shape[0])
    lens = [mel_for("0001", "Happy", c).mel.shape[0]
            for c in (0.5, 1.0, 1.5, 2.0)]
    checks["duration_control_lens"] = lens
    checks["duration_monotonic"] = bool(
        all(a < b for a, b in zip(lens, lens[1:])))
    return checks, {"synth_happy": base.wav, "synth_sad": other_emo.wav}


def parse_args(argv, steps: int, workdir: str, report_dir: str | None):
    """The JAX script's flags (``--report-dir`` where ``report_dir`` is
    given) and ``--device``."""
    from expressive_fastspeech2_mandarin_tpu_torch.cli.common import (
        add_device_arg,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), workdir))
    if report_dir is not None:
        ap.add_argument("--report-dir", default=report_dir)
    ap.add_argument("--fresh", action="store_true")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None,
         attention_impl: str = "auto") -> dict:
    """The whole run; returns its logs, checks, health verdict and train
    wall time."""
    args = parse_args(argv, 5000, "convergence_deep", os.path.join(
        ROOT, "reports", "convergence_torch"))
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.cli.validate import (
        validate_synth,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.device import (
        resolve_device,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        SampleVocoder,
        train,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_synth_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.plotting import (
        save_mel_plot,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    device = resolve_device(args.device)
    if args.fresh and os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.report_dir, exist_ok=True)

    raw, pre = build_corpus(args.workdir)
    cfg = build_config(raw, pre, args.workdir, args.steps, attention_impl)
    t0 = time.perf_counter()
    extract_features(cfg, device)
    features_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = train(cfg, total_steps=args.steps, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    # ---- loss curves ------------------------------------------------------
    log = cfg.train.path.log_path
    recs = read_metrics(os.path.join(log, "train", "metrics.jsonl"))
    vals = read_metrics(os.path.join(log, "val", "metrics.jsonl"))
    plot_losses(os.path.join(args.report_dir, "loss_curves.png"), recs, vals)

    # ---- synthesis artifacts + conditioning checks ------------------------
    synth = Synthesizer.from_checkpoint(cfg, cfg.train.path.ckpt_path,
                                        preprocessed_path=pre, device=device)
    checks, wavs = conditioning_checks(synth)

    # GT-vs-pred artifact on a val utterance + vocoded audio.
    corpus = PreprocessedCorpus(pre)
    val_ds = BucketedDataset(corpus, "val.txt", 4, cfg.train.buckets,
                             cfg.model.max_seq_len)
    batch = next(val_ds.epoch(0, shuffle=False))
    mel_pred, mel_lens, _ = make_synth_step(state)(
        stage_batch(batch, device), batch["mels"].shape[1])
    mel_pred = mel_pred.float().cpu().numpy()
    i = 0
    t_pred, t_gt = int(mel_lens[i]), int(batch["mel_lens"][i])
    save_mel_plot(
        os.path.join(args.report_dir, "gt_vs_pred_mel.png"),
        [(mel_pred[i, :t_pred].T, None, None),
         (batch["mels"][i, :t_gt].T, None, None)],
        None, ["Predicted", "Ground truth"])

    sampler = SampleVocoder(cfg, device)
    save_wav(os.path.join(args.report_dir, "pred.wav"),
             sampler.vocode(mel_pred[i], t_pred), SR)
    save_wav(os.path.join(args.report_dir, "gt_reconstruction.wav"),
             sampler.vocode(batch["mels"][i], t_gt), SR)
    for name, wav in wavs.items():
        save_wav(os.path.join(args.report_dir, f"{name}.wav"), wav, SR)

    health = validate_synth(args.report_dir, expected_sr=SR)
    with open(os.path.join(args.report_dir, "synth_health.json"), "w") as f:
        json.dump(health, f, indent=2)

    card = device_line(device)
    first, last = recs[0], recs[-1]
    fin = final_losses(recs)
    lines = [
        "# Deep convergence run of the PyTorch port",
        "",
        f"Corpus: {len(SPEAKERS)} speakers x {len(EMOTIONS)} emotions "
        f"(structured synthetic; emotion scales pitch/rate, speaker sets "
        f"register), 480 utterances, full pipeline "
        f"(feature extraction -> train -> synthesize), "
        f"`examples_torch/convergence_deep.py`.",
        f"Model: reference-scale FastSpeech2 "
        f"({sum(p.numel() for p in state.model.parameters()) / 1e6:.1f}M "
        f"parameters), attention_impl {attention_impl!r}; {args.steps} "
        f"steps, batch 16, steps_per_call 10.",
        f"Device: {card}.",
        "",
        "| step | total | mel | duration |",
        "|---|---|---|---|",
        f"| {first['step']} | {first['total_loss']:.3f} | "
        f"{first['mel_loss']:.3f} | {first['duration_loss']:.3f} |",
        f"| {last['step']} | {last['total_loss']:.3f} | "
        f"{last['mel_loss']:.3f} | {last['duration_loss']:.3f} |",
        f"| mean of the last {FINAL_RECORDS} | {fin['total_loss']:.3f} | "
        f"{fin['mel_loss']:.3f} | {fin['duration_loss']:.3f} |",
        "",
        "The JAX package's run of `examples/convergence_deep.py` reached "
        "total 1.404, mel 0.608, duration 0.069 at step 5000 "
        "(`reports/convergence/CONVERGENCE.md`).",
        f"Throughput on {card}: {last.get('steps_per_sec', float('nan')):.1f}"
        f" steps/s over the last 100 steps; train() {train_s:.1f} s, "
        f"feature extraction {features_s:.1f} s.",
        "",
        "Conditioning checks:",
        "```json",
        json.dumps(checks, indent=2),
        "```",
        "",
        "Artifacts: loss_curves.png and gt_vs_pred_mel.png (where "
        "matplotlib imports), pred.wav,",
        "gt_reconstruction.wav, synth_happy.wav, synth_sad.wav "
        f"(vocoder: {sampler.kind}; no HiFi-GAN weights are configured).",
        "",
        "Audio health (`efs2-torch-validate synth`), recorded, not "
        f"required: ok = {str(health.get('ok')).lower()}, "
        f"{health.get('warnings', 0)} warnings (`synth_health.json`).",
        "",
    ]
    report = os.path.join(args.report_dir, "CONVERGENCE.md")
    with open(report, "w") as f:
        f.write("\n".join(lines))
    print(json.dumps(checks, indent=2))
    print(f"final: total={last['total_loss']:.3f} "
          f"mel={last['mel_loss']:.3f}")
    print(f"report: {report}")
    return {"records": recs, "vals": vals, "checks": checks,
            "health": health, "train_s": train_s, "features_s": features_s,
            "report": report}


if __name__ == "__main__":
    main()
