#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  1. environment: the card's name and power limit; build every CUDA source
     of the port with nvcc (sm_90a) and print ptxas's register, shared
     memory and spill lines;
  2. the MRF resblock kernel against its plain PyTorch version on the card,
     at the generator's four stage shapes (B=4 × 1000 mel frames) for
     k = 3, 7, 11 and at the ragged T=700, in float32 and bfloat16;
  3. the main path: ``Synthesizer.synthesize`` at ``Config()`` width on four
     utterances with a bfloat16 HiFi-GAN, with random weights from fixed
     seeds; the kernel's launch count over that run; the duration_control=2
     probe; one utterance's float32 waveform from the card against the same
     run on the CPU;
  4. times: steady-state batch synthesis, and per stage shape the kernel,
     its plain version, its bound and a cuDNN conv chain (library_ms).

Float32 comparisons run with TF32 off (cuDNN and matmul). Every failed
check is reported and the script exits 1 without its result lines; with
no CUDA device, or without the port's package beside it, it exits 1 at
once. Its last two lines are the ``kernels`` JSON line and the result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "expressive_fastspeech2_mandarin_tpu_torch"

# Stage shapes of the generator at B=4 × 1000 mel frames: (C, T).
STAGE_SHAPES = ((256, 8000), (128, 64000), (64, 128000), (32, 256000))
RAGGED_SHAPE = (128, 700)
KERNEL_SIZES = (3, 7, 11)
DILATIONS = (1, 3, 5)
BATCH = 4
F32_BOUND = 1e-4
# bfloat16: kernel and plain version do the same float32 arithmetic on the
# same bf16 values and differ only in summation order, which can flip the
# bf16 rounding of a conv output by one unit in the last place (2^-8
# relative) and carry through the later convs of the chain; allow four
# such units at the output's peak magnitude.
BF16_REL_BOUND = 2.0 ** -6

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TEXTS = ["今天天气真好", "我们明天见", "{n i h ao sh i j ie}",
         "{b a n h ao sh i j ie}"]
EMOTIONS = ["Neutral", "Happy", "Sad", "Angry"]
EMOTION_MAPS = {
    "emotion": {"Angry": 0, "Happy": 1, "Neutral": 2, "Sad": 3,
                "Surprise": 4},
    "arousal": {"0.3": 0, "0.5": 1, "0.8": 2, "0.9": 3},
    "valence": {"0.1": 0, "0.2": 1, "0.5": 2, "0.6": 3, "0.8": 4},
}


class Smoke:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)
        return ok

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:  # reported, and the run exits 1
            traceback.print_exc()
            self.failures.append(f"{name}: {traceback.format_exc(limit=1)}")
            return None


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment(smoke: Smoke):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    print(f"  nvidia-smi: {nvidia_smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    libs = build.build_all()
    print(f"  built {sorted(libs)} in {time.time() - t0:.1f} s")
    for name in libs:
        for line in build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smoke.check(bool(libs), "CUDA sources built")


def random_resblock(c: int, k: int, gen, device, dtype):
    import torch

    bound = 1.0 / math.sqrt(c * k)
    weights = []
    for _ in range(2 * len(DILATIONS)):
        w = (torch.rand(c, c, k, generator=gen) * 2 - 1) * bound
        b = (torch.rand(c, generator=gen) * 2 - 1) * bound
        weights.append((w.to(device, dtype), b.to(device, dtype)))
    return weights


def phase_kernel_vs_plain(smoke: Smoke, device, shapes, batch):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for c, t in shapes:
            x32 = torch.randn(batch, t, c, generator=gen)
            for k in KERNEL_SIZES:
                weights = random_resblock(c, k, gen, device, dtype)
                x = x32.to(device, dtype)
                out = mrf.mrf_resblock(x, weights, k, DILATIONS)
                ref = mrf.mrf_resblock_plain(x, weights, k, DILATIONS)
                diff = (out.float() - ref.float()).abs().max().item()  # syncs
                if dtype == torch.float32:
                    bound = F32_BOUND
                else:
                    bound = BF16_REL_BOUND * ref.float().abs().max().item()
                worst = max(worst, diff)
                smoke.check(
                    out.shape == ref.shape and math.isfinite(diff)
                    and diff <= bound,
                    f"{str(dtype)[6:]:8s} C={c:3d} T={t:6d} k={k:2d} "
                    f"max|diff|={diff:.3e} bound={bound:.3e}")
                if dtype == torch.float32:
                    # The same resblock in float64: the kernel's own error,
                    # which a summation order other than cuDNN's makes
                    # non-zero.
                    w64 = [(w.double(), b.double()) for w, b in weights]
                    ref64 = mrf.mrf_resblock_plain(x.double(), w64, k,
                                                   DILATIONS)
                    diff64 = (out.double() - ref64).abs().max().item()
                    smoke.check(diff64 <= F32_BOUND,
                                f"float32 kernel vs float64 plain: "
                                f"max|diff|={diff64:.3e}")
                    del ref64, w64
                del out, ref, x
    return worst


def seeded_states(cfg):
    """Random FastSpeech2 and HiFi-GAN state dicts from fixed seeds, the
    duration head's bias raised by 2 so that frames are not all zero."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.models import (
        FastSpeech2,
        Generator,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
        torch.manual_seed(1)
        voc = Generator(cfg.model.vocoder).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    return fs2, voc


def phase_main_path(smoke: Smoke, device, texts, emotions):
    import dataclasses

    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    cfg = Config()
    fs2, voc = seeded_states(cfg)
    synth = Synthesizer(cfg, fs2, voc, emotion_maps=EMOTION_MAPS,
                        device=device)
    speakers = list(range(len(texts)))
    n_resblocks = len(synth.vocoder.resblocks)
    per_call = 2 * len(DILATIONS) * n_resblocks

    mrf.launch_count = 0
    results = synth.synthesize(texts, speakers, emotions, vocoder="hifigan")
    launches = mrf.launch_count
    for r in results:
        ok = (r.mel.ndim == 2 and r.mel.shape[0] > 0 and r.wav.size > 0
              and bool(np.isfinite(r.mel).all())
              and bool(np.isfinite(r.wav).all()))
        smoke.check(ok, f"{r.basename}: mel {r.mel.shape}, wav "
                        f"{r.wav.shape}, finite and non-empty")
    smoke.check(launches == per_call,
                f"kernel launches in one generator call: {launches} "
                f"(expected {per_call})")

    # Probe: duration_control=2.0 doubles every duration and mel_len (with
    # room enough that no length is clamped).
    probe = [synth.synthesize(texts, speakers, emotions, duration_control=dc,
                              vocoder="none", max_mel_len=2000)
             for dc in (1.0, 2.0)]
    lens, lens2 = ([r.mel.shape[0] for r in p] for p in probe)
    doubled = all(np.array_equal(2 * a.durations, b.durations)
                  for a, b in zip(*probe))
    smoke.check(doubled and lens2 == [2 * n for n in lens]
                and max(lens2) < 2000,
                f"duration_control=2.0 doubles durations and mel_len: "
                f"{lens} -> {lens2}")

    # One utterance in float32 on the card against the same run on the CPU.
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocoder=dataclasses.replace(cfg.model.vocoder,
                                               compute_dtype="float32")))
    runs = []
    for dev in (device, torch.device("cpu")):
        s = Synthesizer(cfg32, fs2, voc, emotion_maps=EMOTION_MAPS,
                        device=dev)
        runs.append(s.synthesize(texts[:1], [0], emotions[:1],
                                 vocoder="hifigan")[0])
    card, cpu = runs
    same_dur = np.array_equal(card.durations, cpu.durations)
    mel_diff = float(np.abs(card.mel - cpu.mel).max()) if same_dur else math.inf
    wav_diff = float(np.abs(card.wav - cpu.wav).max()) if same_dur else math.inf
    smoke.check(same_dur, "float32 durations equal on the card and the CPU")
    smoke.check(mel_diff <= F32_BOUND * max(1.0, float(np.abs(cpu.mel).max())),
                f"float32 mel, card vs CPU: max|diff|={mel_diff:.3e}")
    smoke.check(wav_diff <= F32_BOUND,
                f"float32 wav, card vs CPU: max|diff|={wav_diff:.3e} "
                f"bound={F32_BOUND:.0e}")
    return synth, launches


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_resblock(x, weights, k):
    """The resblock as a chain of cuDNN convs in x's dtype (the yardstick;
    the port never calls this)."""
    import torch.nn.functional as F

    h = x.transpose(1, 2)
    for i, d in enumerate(DILATIONS):
        (w1, b1), (w2, b2) = weights[2 * i], weights[2 * i + 1]
        xt = F.conv1d(F.leaky_relu(h, 0.1), w1, b1,
                      padding=(k - 1) // 2 * d, dilation=d)
        xt = F.conv1d(F.leaky_relu(xt, 0.1), w2, b2, padding=(k - 1) // 2)
        h = xt + h
    return h.transpose(1, 2)


def resblock_bound_ms(b: int, t: int, c: int, k: int) -> tuple[float, str]:
    """Least time for one bf16 resblock: 6 convs of 2·k·C² flops per output
    element, against reading x and the weights once and writing the output
    once."""
    flops = 12 * k * c * c * t * b
    n_bytes = 2 * (2 * b * t * c + 6 * (c * c * k + c))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(synth, texts, emotions):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    speakers = list(range(len(texts)))
    for _ in range(2):
        synth.synthesize(texts, speakers, emotions, vocoder="hifigan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = synth.synthesize(texts, speakers, emotions, vocoder="hifigan")
        torch.cuda.synchronize()
        reps.append(1e3 * (time.perf_counter() - t0))
    audio_s = sum(r.wav.size for r in res) / res[0].sampling_rate
    reps.sort()
    print(f"  synthesis, batch of {len(texts)} ({audio_s:.3f} s of audio): "
          f"median {reps[2]:.3f} ms, min {reps[0]:.3f} ms, max "
          f"{reps[-1]:.3f} ms over 5 runs; "
          f"{1e3 * audio_s / reps[2]:.1f} audio-s/s at the median; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB")

    # Where the batch's time goes: text → mel alone (host clock, synced),
    # the generator alone on the batch's padded mel (CUDA events), and the
    # generator's resblock kernels at the same shapes (CUDA events).
    mel_only = []
    for _ in range(5):
        t0 = time.perf_counter()
        synth.synthesize(texts, speakers, emotions, vocoder="none")
        torch.cuda.synchronize()
        mel_only.append(1e3 * (time.perf_counter() - t0))
    mel_only.sort()
    frames = max(r.mel.shape[0] for r in res)
    mel = torch.randn(len(texts), frames, 80, device="cuda",
                      dtype=torch.bfloat16)
    with torch.inference_mode():
        gen_ms = cuda_time_ms(lambda: synth.vocoder(mel), 5)
        x = synth.vocoder.conv_pre(mel.transpose(1, 2)).transpose(1, 2)
        rb_ms = 0.0
        for i, up in enumerate(synth.vocoder.ups):
            x = up(x.transpose(1, 2)).transpose(1, 2).contiguous()
            for rb in synth.vocoder.resblocks[3 * i: 3 * i + 3]:
                rb_ms += cuda_time_ms(lambda: rb(x), 5)
    print(f"  text → mel (vocoder='none'): median {mel_only[2]:.3f} ms; "
          f"generator on a ({len(texts)}, {frames}, 80) mel: {gen_ms:.3f} ms,"
          f" of which the 12 resblocks' kernels {rb_ms:.3f} ms")

    gen = torch.Generator().manual_seed(1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bound_by_operations_ms": 0.0}
    rows = []
    for c, t in STAGE_SHAPES:
        x = torch.randn(BATCH, t, c, generator=gen).to("cuda", torch.bfloat16)
        for k in KERNEL_SIZES:
            w = random_resblock(c, k, gen, torch.device("cuda"),
                                torch.bfloat16)
            iters = 5
            ms = cuda_time_ms(lambda: mrf.mrf_resblock(x, w, k, DILATIONS),
                              iters)
            plain = cuda_time_ms(
                lambda: mrf.mrf_resblock_plain(x, w, k, DILATIONS), iters)
            lib = cuda_time_ms(lambda: library_resblock(x, w, k), iters)
            bound, by = resblock_bound_ms(BATCH, t, c, k)
            rows.append({"C": c, "T": t, "k": k, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": by})
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound)):
                totals[key] += v
            if by == "operations":
                totals["bound_by_operations_ms"] += bound
            print(f"  mrf_resblock bf16 B={BATCH} C={c:3d} T={t:6d} k={k:2d}:"
                  f" kernel {ms:.4f} ms, plain {plain:.4f} ms, cuDNN chain "
                  f"{lib:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
        del x
    print("  resblock times: " + json.dumps(rows))
    return totals


def main() -> int:
    if not (ROOT / PKG / "__init__.py").exists():
        print(f"chip_smoke: the package {PKG} is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smoke = Smoke()
    t_start = time.time()

    smoke.phase("1. environment and build", phase_environment, smoke)
    worst = smoke.phase("2. mrf_resblock kernel vs plain on the card",
                        phase_kernel_vs_plain, smoke, device,
                        STAGE_SHAPES + (RAGGED_SHAPE,), BATCH)
    main_run = smoke.phase("3. main path: Synthesizer.synthesize",
                           phase_main_path, smoke, device, TEXTS, EMOTIONS)
    totals = None
    if main_run is not None:
        totals = smoke.phase("4. times", phase_times, main_run[0], TEXTS,
                             EMOTIONS)
    print(f"== done in {time.time() - t_start:.1f} s")
    if smoke.failures or worst is None or totals is None:
        print("chip_smoke: FAILED:\n  " + "\n  ".join(smoke.failures),
              file=sys.stderr)
        return 1

    _, launches = main_run
    kernels = [{
        "name": "mrf_resblock",
        "route": "cuda",
        "source": f"{PKG}/csrc/mrf_resblock.cu",
        "replaces": "expressive_fastspeech2_mandarin_tpu/ops/pallas/"
                    "mrf_resblock.py:185",
        "launches": launches,
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if 2 * totals["bound_by_operations_ms"]
                     >= totals["bound_ms"] else "bytes"),
        "library_ms": totals["library_ms"],
    }]
    print(f"card: {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
