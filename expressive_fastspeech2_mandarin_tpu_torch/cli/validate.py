"""Validation and diagnostics CLI, the consolidated equivalent of the
reference's scripts (validate_textgrid.py, check_*.py,
diagnose_synthesis.py, validate_model.py).

Subcommands:
  textgrids  — alignment QA: coverage, phone inventory, words tier
               (writes textgrid_quality_report.json)
  data       — preprocessed-corpus consistency: phones vs durations vs mel
               lengths, vocabulary coverage (``--fix`` drops bad rows)
  checkpoint — a checkpoint of the port's trainer: strict load, parameter
               statistics, non-finite scan
  vocoder    — copy-synthesis quality of a trained HiFi-GAN on ``--device``:
               round-trip mel L1, MCD, F0-RMSE, V/UV error
  synth      — audio health of synthesized wavs
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from .common import (
    add_config_args,
    add_device_arg,
    config_from_args,
)


def validate_textgrids(tg_root: str, report_path: str | None) -> dict:
    from ..preprocess import read_textgrid

    report = {"files": 0, "errors": [], "phone_types": set(),
              "coverage_sum": 0.0, "span_coverage_sum": 0.0,
              "total_intervals": 0, "word_types": set(),
              "files_with_words_tier": 0, "total_word_intervals": 0}
    for speaker in sorted(os.listdir(tg_root)):
        spk = os.path.join(tg_root, speaker)
        if not os.path.isdir(spk):
            continue
        for name in sorted(os.listdir(spk)):
            if not name.endswith(".TextGrid"):
                continue
            path = os.path.join(spk, name)
            try:
                tg = read_textgrid(path)
                tier = tg.get_tier_by_name("phones")
            except Exception as e:
                report["errors"].append(f"{path}: {e}")
                continue
            covered = sum(iv.end - iv.start for iv in tier.intervals
                          if iv.text.strip())
            span = tg.xmax - tg.xmin
            report["coverage_sum"] += covered / span if span > 0 else 0.0
            # Reference definition (validate_textgrid.py:150): the span from
            # the first to the last interval — INCLUDING silences — over the
            # file duration.  ~1.0 by construction for any full-span
            # TextGrid; the reference's 0.99999995 QA bar is this metric
            # (float rounding of xmax), not the labeled-time fraction above.
            if tier.intervals and span > 0:
                report["span_coverage_sum"] += (
                    tier.intervals[-1].end - tier.intervals[0].start) / span
            report["total_intervals"] += len(tier.intervals)
            for iv in tier.intervals:
                if iv.text.strip():
                    report["phone_types"].add(iv.text)
            # Words tier (MFA exports words+phones pairs,
            # MFA/montreal_forced_aligner/textgrid.py:344-361; the native
            # aligner writes both).
            try:
                words = tg.get_tier_by_name("words")
            except Exception:
                words = None
            if words is not None:
                report["files_with_words_tier"] += 1
                labeled = [iv for iv in words.intervals if iv.text.strip()]
                report["total_word_intervals"] += len(labeled)
                report["word_types"].update(iv.text for iv in labeled)
            report["files"] += 1
    out = {
        "files_validated": report["files"],
        "avg_coverage": (report["coverage_sum"] / report["files"]
                         if report["files"] else 0.0),
        "avg_span_coverage": (report["span_coverage_sum"] / report["files"]
                              if report["files"] else 0.0),
        "phone_type_count": len(report["phone_types"]),
        "phone_types": sorted(report["phone_types"]),
        "total_intervals": report["total_intervals"],
        "files_with_words_tier": report["files_with_words_tier"],
        "word_type_count": len(report["word_types"]),
        "total_word_intervals": report["total_word_intervals"],
        "errors": report["errors"],
    }
    if report_path:
        with open(report_path, "w") as f:
            json.dump(out, f, indent=2, ensure_ascii=False)
    return out


def validate_data(preprocessed_path: str, fix: bool = False,
                  symbol_table: str = "pinyin") -> dict:
    """Consistency scan; ``fix=True`` rewrites train/val metadata without the
    inconsistent utterances (the consolidated equivalent of the reference's
    fix_duration_mismatch.py / fix_phoneme_encoding.py / fix_filelist.py
    repair scripts — drop-bad-rows is what they ultimately did).

    ``symbol_table`` is an inventory name ("pinyin", "ipa", a registered
    custom name) or a path to a harvest JSON; pre-encoded integer metadata
    (all-digit phones, reference dataset.py:60-70) is detected per-utterance
    and compared by encoded ID count, never treated as unknown symbols."""
    from ..data import PreprocessedCorpus
    from ..text import symbols

    if symbol_table.endswith(".json") or os.path.sep in symbol_table:
        symbol_table = symbols.load_symbol_table(symbol_table)
    table = symbols.get_symbol_table(symbol_table)

    corpus = PreprocessedCorpus(preprocessed_path)
    problems = []
    n_checked = 0
    dropped = {}
    unknown_phones: set[str] = set()
    for split in ("train.txt", "val.txt"):
        try:
            utts = corpus.metadata(split)
        except FileNotFoundError:
            continue
        bad: set[str] = set()
        for utt in utts:
            phones = utt.phone_text.strip("{}").split()
            # Pre-encoded integer variant (same heuristic as
            # Utterance.phone_ids): the field holds IDs, not symbols.
            pre_encoded = bool(phones) and all(p.isdigit() for p in phones)
            if not pre_encoded:
                for p in phones:
                    if p not in table:
                        unknown_phones.add(p)
            try:
                d = corpus.duration(utt)
                mel = corpus.mel(utt)
                pitch = corpus.pitch(utt)
                energy = corpus.energy(utt)
            except FileNotFoundError as e:
                problems.append(f"{utt.basename}: missing npy ({e})")
                bad.add(utt.basename)
                continue
            if pre_encoded:
                known = phones
            else:
                known = [p for p in phones if p in table]
            if len(d) != len(known):
                problems.append(
                    f"{utt.basename}: {len(known)} known phones vs "
                    f"{len(d)} durations")
                bad.add(utt.basename)
            if int(d.sum()) != mel.shape[0]:
                problems.append(
                    f"{utt.basename}: sum(durations)={int(d.sum())} vs "
                    f"mel frames={mel.shape[0]}")
                bad.add(utt.basename)
            if len(pitch) != len(d) or len(energy) != len(d):
                problems.append(f"{utt.basename}: pitch/energy length "
                                f"mismatch vs durations")
                bad.add(utt.basename)
            if not np.isfinite(mel).all():
                problems.append(f"{utt.basename}: non-finite mel values")
                bad.add(utt.basename)
            n_checked += 1
        if fix and bad:
            path = os.path.join(preprocessed_path, split)
            with open(path, encoding="utf-8") as f:
                lines = [ln for ln in f if ln.strip()]
            kept = [ln for ln in lines if ln.split("|", 1)[0] not in bad]
            os.replace(path, path + ".bak")
            with open(path, "w", encoding="utf-8") as f:
                f.writelines(kept)
            dropped[split] = len(lines) - len(kept)
    out = {
        "utterances_checked": n_checked,
        "problems": problems[:100],
        "problem_count": len(problems),
        "unknown_phones": sorted(unknown_phones),
    }
    if fix:
        out["dropped"] = dropped
    return out


def validate_checkpoint(ckpt_dir: str, cfg, step: int | None = None) -> dict:
    """Checkpoint health: the latest (or ``step``) checkpoint of the port's
    trainer loads strictly into ``FastSpeech2``; parameter count, non-finite
    parameters and the largest magnitude."""
    from ..models import FastSpeech2
    from ..train import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    if mgr.latest_step() is None:
        return {"ok": False, "error": f"no checkpoints in {ckpt_dir}"}
    ckpt = mgr.load(step)
    model = FastSpeech2(cfg.model, cfg.preprocess)
    model.load_state_dict(ckpt["model"], strict=True)
    params = [p.detach() for p in model.parameters()]
    n_nan = sum(int((~torch.isfinite(p)).sum()) for p in params)
    return {
        "ok": n_nan == 0,
        "step": int(ckpt["step"]),
        "param_count": sum(p.numel() for p in params),
        "non_finite_params": n_nan,
        "max_abs_param": float(max(p.abs().max() for p in params)),
    }


# Frame RMS below this (−54 dBFS) counts as silence for the silence-fraction
# and spectral-flatness gates; audible speech sits well above it.
_SILENCE_RMS = 2e-3


def _audio_profile(audio, sr: int, frame_s: float = 0.05) -> dict:
    """Per-file health statistics beyond peak/RMS: the share of silent
    frames and the median spectral flatness of the others. Flatness (the
    geometric over the arithmetic mean of the power spectrum) tells speech
    (harmonic, ≲0.2) from white noise (≈1), which the reference's
    diagnose_synthesis.py:12-60 cannot."""
    n = max(int(sr * frame_s), 256)
    n_frames = audio.size // n
    if n_frames == 0:
        return {"silence_fraction": 1.0, "spectral_flatness": None}
    frames = audio[: n_frames * n].reshape(n_frames, n)
    frame_rms = np.sqrt(np.mean(np.square(frames), axis=1))
    silent = frame_rms < _SILENCE_RMS
    voiced = frames[~silent]
    flatness = None
    if voiced.size:
        power = np.abs(np.fft.rfft(voiced, axis=1)[:, 1:]) ** 2
        eps = 1e-12
        flat = np.exp(np.mean(np.log(power + eps), axis=1)) / (
            np.mean(power, axis=1) + eps)
        flatness = float(np.median(flat))
    return {"silence_fraction": float(silent.mean()),
            "spectral_flatness": flatness}


def _is_reference_wav(name: str) -> bool:
    """GT/reconstruction wavs act as the in-directory reference group for
    the relative-RMS check (the train loop and reports write GT
    reconstructions next to predictions, e.g. gt_reconstruction.wav)."""
    stem = os.path.splitext(name)[0].lower()
    parts = set(stem.replace("-", "_").split("_"))
    return bool(parts & {"gt", "groundtruth", "reference", "reconstruction",
                         "recon"}) or "reconstruction" in stem


def validate_synth(result_dir: str, expected_sr: int = 22050,
                   min_amplitude: float = 0.01,
                   min_duration_s: float = 0.5,
                   max_silence_fraction: float = 0.7,
                   max_flatness: float = 0.45,
                   rms_ratio_range: tuple = (0.2, 5.0)) -> dict:
    """Audio-health check over synthesized wavs (reference:
    diagnose_synthesis.py:12-60, monitor_generation.py): sampling rate,
    duration, peak amplitude, RMS, clipping, non-finite samples, and the
    relative checks: silence fraction, spectral flatness (a white-noise
    detector), and the prediction-vs-GT RMS ratio when the directory holds
    GT/reconstruction wavs (``_is_reference_wav``)."""
    from ..utils.wav import load_wav

    out = {"files": [], "warnings": 0, "ok": True}
    if not os.path.isdir(result_dir):
        return {"ok": False, "error": f"no result dir {result_dir}"}
    wavs = sorted(f for f in os.listdir(result_dir)
                  if f.lower().endswith(".wav"))
    if not wavs:
        return {"ok": False, "error": f"no wavs in {result_dir}"}

    loaded = {name: load_wav(os.path.join(result_dir, name), sr=None)
              for name in wavs}
    ref_rms = [float(np.sqrt(np.mean(np.square(a))))
               for name, (a, _) in loaded.items()
               if _is_reference_wav(name) and a.size]
    ref_rms_median = float(np.median(ref_rms)) if ref_rms else None
    out["reference_files"] = sorted(n for n in wavs if _is_reference_wav(n))
    out["reference_rms"] = (round(ref_rms_median, 4)
                            if ref_rms_median is not None else None)

    for name in wavs:
        audio, sr = loaded[name]
        peak = float(np.max(np.abs(audio))) if audio.size else 0.0
        rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
        profile = _audio_profile(audio, sr) if sr else {
            "silence_fraction": 1.0, "spectral_flatness": None}
        entry = {
            "file": name,
            "sampling_rate": sr,
            "duration_s": round(audio.size / sr, 3) if sr else 0.0,
            "peak": round(peak, 4),
            "rms": round(rms, 4),
            "silence_fraction": round(profile["silence_fraction"], 3),
            "spectral_flatness": (round(profile["spectral_flatness"], 3)
                                  if profile["spectral_flatness"] is not None
                                  else None),
            "warnings": [],
        }
        if not np.isfinite(audio).all():
            entry["warnings"].append("non-finite samples")
        if peak < min_amplitude:
            entry["warnings"].append(f"peak {peak:.4f} < {min_amplitude} "
                                     "(likely inaudible)")
        if peak >= 0.999:
            entry["warnings"].append("clipping (peak at full scale)")
        if sr != expected_sr:
            entry["warnings"].append(f"sampling rate {sr} != {expected_sr}")
        if audio.size < sr * min_duration_s:
            entry["warnings"].append(
                f"duration {audio.size / sr:.2f}s < {min_duration_s}s")
        if profile["silence_fraction"] > max_silence_fraction:
            entry["warnings"].append(
                f"silence fraction {profile['silence_fraction']:.2f} > "
                f"{max_silence_fraction} (mostly silent)")
        if (profile["spectral_flatness"] is not None
                and profile["spectral_flatness"] > max_flatness):
            entry["warnings"].append(
                f"spectral flatness {profile['spectral_flatness']:.2f} > "
                f"{max_flatness} (noise-like, not harmonic)")
        if ref_rms_median and not _is_reference_wav(name) and rms > 0:
            ratio = rms / ref_rms_median
            entry["rms_ratio_vs_reference"] = round(ratio, 4)
            lo, hi = rms_ratio_range
            if not lo <= ratio <= hi:
                entry["warnings"].append(
                    f"RMS ratio vs GT reference {ratio:.3f} outside "
                    f"[{lo}, {hi}] (level mismatch with ground truth)")
        out["files"].append(entry)
        out["warnings"] += len(entry["warnings"])
    out["ok"] = out["warnings"] == 0
    out["n_files"] = len(wavs)
    return out


def validate_vocoder(cfg, vocoder_ckpt: str, wav_dir: str, n: int = 8,
                     out_dir: str | None = None, baseline: bool = False,
                     seed: int = 0, mel_dir: str | None = None,
                     metadata: str = "val.txt",
                     device: str | torch.device = "cuda") -> dict:
    """Copy-synthesis quality gate of a trained vocoder: vocode the log-mels
    of ``n`` real utterances (drawn by ``seed``) through the HiFi-GAN
    ``Generator`` on ``device`` in ``model.vocoder.compute_dtype``, and
    score it with the round-trip log-mel L1 (the mel of the vocoded wav
    against the input mel) and, against the real waveform, MCD, F0-RMSE and
    the V/UV error (``dsp.quality``); ``baseline=True`` adds Griffin-Lim's
    30-iteration round trip on the same mels. The analysis runs on the CPU.

    ``mel_dir`` switches to predicted mels (a GTA export,
    efs2-torch-train-vocoder --gta) of the utterances in ``metadata``,
    whose frames align with the real trimmed waveform."""
    from ..dsp.quality import wav_quality
    from ..dsp.stft import MelSTFT
    from ..graphs import Graphs, module_tensors
    from ..interop.torch_ckpt import load_vocoder_state
    from ..models import Generator
    from ..train.vocoder import load_corpus_wavs, load_paired_corpus
    from ..utils.wav import save_wav

    device = resolve_device(device)
    dtype = getattr(torch, cfg.model.vocoder.compute_dtype)
    gen = Generator(cfg.model.vocoder, cfg.preprocess.mel.n_mel_channels)
    gen.load_state_dict(load_vocoder_state(vocoder_ckpt), strict=True)
    gen = gen.to(device, dtype).eval()
    # JAX's jitted generator: on the card a CUDA graph per mel shape.
    vocode = Graphs(state=lambda: module_tensors(gen)).jit(
        lambda mel: gen(mel).float())
    sr = cfg.preprocess.audio.sampling_rate
    hop = cfg.preprocess.stft.hop_length
    stft_cpu = MelSTFT(cfg.preprocess.stft, cfg.preprocess.mel, sr, "cpu")

    if mel_dir:
        pairs = load_paired_corpus(cfg, mel_dir=mel_dir,
                                   filenames=(metadata,))
        wavs = [w for _m, w in pairs]
        pred_mels = [m for m, _w in pairs]
    else:
        wavs = load_corpus_wavs(wav_dir, sr)
        pred_mels = None
    idx = np.random.default_rng(seed).permutation(len(wavs))[:n]

    def log_mels(w: np.ndarray) -> np.ndarray:
        """(B, T) waveforms → (B, frames, n_mels) log-mels, on the CPU."""
        m, _ = stft_cpu.mel_energy(torch.as_tensor(w, dtype=torch.float32))
        return m.numpy()

    def log_mel(w: np.ndarray) -> np.ndarray:
        return log_mels(np.asarray(w)[None])[0]

    def roundtrip_l1(mel_in: np.ndarray, wav_out: np.ndarray,
                     frames: int) -> float:
        mel_back = log_mels(wav_out)
        f = min(frames, mel_back.shape[1])
        return float(np.mean(np.abs(mel_back[:, :f] - mel_in[:, :f])))

    def pad_frames(mel: np.ndarray, mult: int = 256) -> np.ndarray:
        """The frame axis padded to a multiple of ``mult`` with the log-mel
        floor, as the JAX package pads it for one compiled program."""
        pad = (-mel.shape[1]) % mult
        return np.pad(mel, ((0, 0), (0, pad), (0, 0)),
                      constant_values=np.log(1e-5)) if pad else mel

    out: dict = {"files": [], "vocoder_ckpt": vocoder_ckpt,
                 "mode": "predicted-mel" if mel_dir else "copy-synthesis"}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for k, i in enumerate(idx):
        wav = np.pad(wavs[i], (0, (-len(wavs[i])) % hop))
        if pred_mels is not None:
            mel_in = np.asarray(pred_mels[int(i)], np.float32)[None]
        else:
            mel_in = log_mels(wav[None])
        frames = int(mel_in.shape[1])
        mel = pad_frames(mel_in)
        with torch.inference_mode():
            wav_hat = vocode(torch.from_numpy(mel).to(device, dtype)
                             ).cpu().numpy()
        t = min(frames * hop, len(wav))
        ref_t, hat_t = wav[:t], wav_hat[0][:t]
        rec = {"index": int(i), "frames": frames,
               "mel_l1_hifigan": roundtrip_l1(mel, wav_hat, frames)}
        q = wav_quality(ref_t, hat_t, sr, log_mel, hop)
        rec["mcd_hifigan"] = round(q["mcd_db"], 3)
        rec["f0_rmse_hifigan"] = round(q["f0_rmse_hz"], 2)
        rec["vuv_error_hifigan"] = round(q["vuv_error"], 4)
        if baseline:
            gl = stft_cpu.mel_to_audio(torch.from_numpy(mel),
                                       n_iters=30).numpy()
            rec["mel_l1_griffin_lim"] = roundtrip_l1(mel, gl, frames)
            qg = wav_quality(ref_t, gl[0][:t], sr, log_mel, hop)
            rec["mcd_griffin_lim"] = round(qg["mcd_db"], 3)
            rec["f0_rmse_griffin_lim"] = round(qg["f0_rmse_hz"], 2)
            rec["vuv_error_griffin_lim"] = round(qg["vuv_error"], 4)
        out["files"].append(rec)
        if out_dir and k < 4:
            save_wav(os.path.join(out_dir, f"copysynth_{i:04d}.wav"),
                     wav_hat[0][: frames * hop], sr)
            save_wav(os.path.join(out_dir, f"copysynth_{i:04d}_gt.wav"),
                     wav, sr)

    def summarize(key):
        xs = [f[key] for f in out["files"]
              if key in f and np.isfinite(f[key])]
        return float(np.mean(xs)) if xs else None

    out["mel_l1_hifigan_mean"] = summarize("mel_l1_hifigan")
    out["mel_l1_hifigan_median"] = float(np.median(
        [f["mel_l1_hifigan"] for f in out["files"]]))
    for key in ("mcd_hifigan", "f0_rmse_hifigan", "vuv_error_hifigan"):
        out[f"{key}_mean"] = summarize(key)
    if baseline:
        for key in ("mel_l1_griffin_lim", "mcd_griffin_lim",
                    "f0_rmse_griffin_lim", "vuv_error_griffin_lim"):
            out[f"{key}_mean"] = summarize(key)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-validate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tg = sub.add_parser("textgrids")
    tg.add_argument("--textgrid-dir", required=True)
    tg.add_argument("--report", default="textgrid_quality_report.json")

    data = sub.add_parser("data")
    data.add_argument("--preprocessed-path", required=True)
    data.add_argument("--fix", action="store_true",
                      help="rewrite train/val metadata without inconsistent "
                           "utterances (.bak kept)")
    data.add_argument("--symbol-table", default="pinyin",
                      help="inventory name (pinyin/ipa/registered custom) or "
                           "path to a harvest JSON; pre-encoded integer "
                           "metadata is auto-detected")

    ck = sub.add_parser("checkpoint")
    add_config_args(ck)
    ck.add_argument("--ckpt-dir", default=None)

    vo = sub.add_parser("vocoder",
                        help="copy-synthesis quality gate for a trained "
                             "vocoder (GT-mel round-trip L1)")
    add_config_args(vo)
    vo.add_argument("--vocoder-ckpt", required=True,
                    help="generator.npz (efs2-train-vocoder) or torch ckpt")
    vo.add_argument("--wav-dir", required=True)
    vo.add_argument("--n", type=int, default=8)
    vo.add_argument("--out-dir", default=None,
                    help="write a few copy-synthesis wav pairs here")
    vo.add_argument("--baseline", action="store_true",
                    help="also compute the Griffin-Lim round-trip L1")
    vo.add_argument("--mel-dir", default=None,
                    help="predicted-mel mode: vocode teacher-forced mels "
                         "from this dir (efs2-train-vocoder --gta export) "
                         "and score against the aligned real waveforms")
    vo.add_argument("--metadata", default="val.txt",
                    help="metadata file for --mel-dir mode (val.txt keeps "
                         "the comparison out-of-sample)")
    add_device_arg(vo)

    sy = sub.add_parser("synth", help="audio-health check of output wavs")
    sy.add_argument("--result-dir", required=True)
    sy.add_argument("--sampling-rate", type=int, default=22050)
    sy.add_argument("--min-amplitude", type=float, default=0.01)
    sy.add_argument("--min-duration", type=float, default=0.5)
    sy.add_argument("--max-silence-fraction", type=float, default=0.7)
    sy.add_argument("--max-flatness", type=float, default=0.45)
    sy.add_argument("--rms-ratio-min", type=float, default=0.2)
    sy.add_argument("--rms-ratio-max", type=float, default=5.0)

    args = ap.parse_args(argv)
    if args.cmd == "textgrids":
        out = validate_textgrids(args.textgrid_dir, args.report)
        print(json.dumps({k: v for k, v in out.items() if k != "phone_types"},
                         indent=2, ensure_ascii=False))
    elif args.cmd == "data":
        print(json.dumps(validate_data(args.preprocessed_path, fix=args.fix,
                                       symbol_table=args.symbol_table),
                         indent=2, ensure_ascii=False))
    elif args.cmd == "checkpoint":
        cfg = config_from_args(args)
        ckpt = args.ckpt_dir or cfg.train.path.ckpt_path
        print(json.dumps(validate_checkpoint(ckpt, cfg), indent=2))
    elif args.cmd == "vocoder":
        device = resolve_device(args.device)
        cfg = config_from_args(args)
        out = validate_vocoder(cfg, args.vocoder_ckpt, args.wav_dir,
                               n=args.n, out_dir=args.out_dir,
                               baseline=args.baseline,
                               mel_dir=args.mel_dir, metadata=args.metadata,
                               device=device)
        print(json.dumps(out, indent=2))
    elif args.cmd == "synth":
        out = validate_synth(args.result_dir, args.sampling_rate,
                             args.min_amplitude, args.min_duration,
                             args.max_silence_fraction, args.max_flatness,
                             (args.rms_ratio_min, args.rms_ratio_max))
        print(json.dumps(out, indent=2, ensure_ascii=False))


if __name__ == "__main__":
    main()
