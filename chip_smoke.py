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
  2b. the flash attention kernel against its plain version on the card,
     float32, at (B, H, D) = (4, 2, 128) for T = 300, 2300, 4096 and
     (1, 2, 128) for T = 8192, ragged key lengths with a row of length 0
     (exactly 0 out), against float32 and float64 plain;
  2c. the MRF kernel against its plain version at the long-form path's
     shapes: B=4 × 4096 mel frames, and one streaming window, B=1 × 130
     frames, in float32 and bfloat16;
  3b. the long-form path: ``Synthesizer.synthesize`` with
     ``max_mel_len=4096`` on four phone strings, the longest in
     (2048, 4096) frames and the shortest under 1000: 6 flash launches
     (one per decoder layer) and 72 MRF launches; the longest utterance's
     float32 mel on the card (flash) against the CPU (math path);
     ``synthesize_streaming`` in chunks of 100 frames against the
     monolithic waveform of the same mel, with 6 flash launches per call
     and 72 MRF launches per window;
  4. times: steady-state batch synthesis, and per stage shape the kernel,
     its plain version, its bound and a cuDNN conv chain (library_ms);
     long-form batch synthesis, its text → mel and generator spans,
     streaming first and last chunk, and the flash kernel against its
     plain version, its bound and SDPA;
  2d. the flash attention backward kernels (dQ with Δ, then dK/dV) against
     the plain backward on the card, float32, at (4, 2, T, 128) for
     T = 300, 1000, 2300, 4096 and (1, 2, 8192, 128), ragged key lengths
     with a row of length 0 and random dO at every row: dq, dk, dv within
     1e-4 · max|ref| (the distance to float64 plain printed); the forward's stored
     log-sum-exp against torch.logsumexp (+inf for the length-0 row); the
     length-0 row's gradients exactly 0; a second backward bit-identical;
  5. training: ``train()`` at ``Config()`` width with the reference recipe
     (batch 4, Adam (0.9, 0.98, 1e-9), clip 1.0, warm-up 4000) and
     ``attention_impl="flash"`` on a synthetic corpus written from a seed
     (32 train and 8 val utterances, 20-120 phones, 200-1000 frames), 20
     steps in float32: finite losses, 10 forward and 10 + 10 backward flash
     launches per step (4 encoder and 6 decoder blocks; evaluation and
     sample synthesis add forward launches only), checkpoints, and a resume
     that continues the step and the learning rate; then one step from one
     state, batch and dropout seed under "flash" and under "xla": loss
     within 1e-5 relative, every gradient within 1e-3 · max|g| of the xla
     step's or of the xla step's with the inputs moved by float32
     round-off (a ReLU input within round-off of 0 has two float32
     answers);
  6. times: the train step at B = 4, bucket (S, T) = (128, 1000) under
     "flash" and "auto" (median of 10 after 3 warm-ups, synchronized) with
     peak memory; the backward kernels at (4, 2, T, 128), T = 1000 and
     4096, against their bounds, the plain backward and the backward of
     scaled_dot_product_attention.

Float32 comparisons run with TF32 off (cuDNN and matmul). Every failed
check is reported and the script exits 1 without its result lines; with
no CUDA device, or without the port's package beside it, it exits 1 at
once. Its last two lines are the ``kernels`` JSON line and the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "expressive_fastspeech2_mandarin_tpu_torch"



def stage_shapes(frames: int) -> tuple[tuple[int, int], ...]:
    """The generator's four resblock stages on ``frames`` mel frames:
    (C, T) after each upsample (×8, ×8, ×2, ×2)."""
    return tuple((256 >> i, frames * up)
                 for i, up in enumerate((8, 64, 128, 256)))


# Stage shapes of the generator at B=4 × 1000 mel frames: (C, T).
STAGE_SHAPES = stage_shapes(1000)
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

# Published H100 SXM peaks (dense bf16 and TF32 tensor-core rates, the
# float32 CUDA-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Flash attention: (B, T, key lengths) at H = 2, D = 128. Every batch of
# four has a length below 64, a full row and a row of length 0.
FLASH_CASES = ((4, 300, (300, 37, 0, 211)), (4, 2300, (2300, 63, 0, 2049)),
               (4, 4096, (4096, 1, 0, 3001)), (1, 8192, (8100,)))
FLASH_TIMED = (2300, 4096)  # B = 4, the long-form path's shapes
# Kernel and plain version sum the same float32 products in another order
# (the kernel online, tile by tile, with rescaling), and expf differs from
# torch.exp by an ulp or two: a few float32 ulps of the output's magnitude.
FLASH_REL_BOUND = 1e-5

# Flash backward: the forward's cases and the training path's T = 1000.
FLASH_BWD_CASES = ((4, 300, (300, 37, 0, 211)), (4, 1000, (1000, 63, 0, 777)),
                   (4, 2300, (2300, 63, 0, 2049)),
                   (4, 4096, (4096, 1, 0, 3001)), (1, 8192, (8100,)))
# The kernels recompute P from the stored log-sum-exp (expf of s - lse
# against the plain version's normalized exp) and sum dq, dk and dv in
# another order than cuBLAS, over up to 8192 terms.
FLASH_BWD_REL_BOUND = 1e-4
FLASH_BWD_TIMED = (1000, 4096)  # B = 4: the training bucket, long-form
# Log-sum-exp: expf and logf against torch.logsumexp, a few float32 ulps.
LSE_REL_BOUND = 1e-5

# Training (phase 5): the reference recipe at Config() width on a corpus
# written from a seed.
TRAIN_STEPS = 20
TRAIN_CADENCE = dict(log_step=5, synth_step=10, val_step=10, save_step=10)
N_TRAIN_UTTS, N_VAL_UTTS = 32, 8
GRAD_REL_BOUND = 1e-3   # flash against xla: float32, another sum order
# Relative perturbation of the phoneme embedding, about float32 round-off:
# a ReLU input that close to 0 changes sides, and the gradient with it.
PERTURB = 1e-7
LOSS_REL_BOUND = 1e-5
TRAIN_TIMED = (4, 128, 1000)  # B, S bucket, T bucket

# Long-form path: four phone strings of 240, 180, 90 and 24 phones; at
# duration_control 0.8 the seeded model gives 3338, 2693, 670 and 82 frames.
_SYLLABLES = ("n i h ao sh i j ie b a n h ao w o m e n q i zh e n t a d e "
              "g e l ai x ie z ai j ia").split()
LONG_TEXTS = ["{" + " ".join((_SYLLABLES * 20)[:n]) + "}"
              for n in (240, 180, 90, 24)]
LONG_DURATION_CONTROL = 0.8
LONG_MAX_MEL = 4096
STREAM_CHUNK = 100
STREAM_F32_BOUND = 1e-5

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


def phase_kernel_vs_plain(smoke: Smoke, device, shapes, batch,
                          float64: bool = True):
    """The MRF kernel against its plain version at (batch, T, C) for each
    (C, T) of ``shapes``; with ``float64``, float32 also against float64."""
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
                    f"{str(dtype)[6:]:8s} B={batch} C={c:3d} T={t:7d} "
                    f"k={k:2d} max|diff|={diff:.3e} bound={bound:.3e}")
                if dtype == torch.float32 and float64:
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


def phase_long_kernel_vs_plain(smoke: Smoke, device):
    """Phase 2 at the long-form path's shapes: the batch padded to
    max_mel_len, and one streaming window (a chunk and its halo on both
    sides). Float64 only at B=1: its cuDNN convs at 4 × 4096 frames would
    take longer than the rest of the run."""
    from expressive_fastspeech2_mandarin_tpu_torch.config import VocoderConfig
    from expressive_fastspeech2_mandarin_tpu_torch.synth.streaming import (
        generator_receptive_radius_frames,
    )

    window = STREAM_CHUNK + 2 * generator_receptive_radius_frames(
        VocoderConfig())
    worst = 0.0
    for batch, frames in ((BATCH, LONG_MAX_MEL), (1, window)):
        worst = max(worst, phase_kernel_vs_plain(
            smoke, device, stage_shapes(frames), batch, float64=batch == 1))
    return worst


def flash_inputs(b: int, t: int, lens, gen):
    """(B, 2, T, 128) float32 q, k, v and the (B, T) key mask on the card."""
    import torch

    q, k, v = (torch.randn(b, 2, t, 128, generator=gen).to("cuda")
               for _ in range(3))
    mask = torch.arange(t)[None, :] >= torch.tensor(lens)[:, None]
    return q, k, v, mask.to("cuda")


def phase_flash_vs_plain(smoke: Smoke):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    gen = torch.Generator().manual_seed(2)
    scale = 128 ** -0.5
    worst = 0.0
    for b, t, lens in FLASH_CASES:
        q, k, v, mask = flash_inputs(b, t, lens, gen)
        out = fa.flash_mha(q, k, v, mask, scale)
        ref = fa.flash_mha_plain(q, k, v, mask, scale)
        diff = (out - ref).abs().max().item()  # syncs
        bound = FLASH_REL_BOUND * ref.abs().max().item()
        worst = max(worst, diff)
        smoke.check(out.shape == ref.shape and math.isfinite(diff)
                    and diff <= bound,
                    f"float32 B={b} T={t:5d} lens={lens}: "
                    f"max|diff|={diff:.3e} bound={bound:.3e}")
        ref64 = fa.flash_mha_plain(q.double(), k.double(), v.double(), mask,
                                   scale)
        diff64 = (out.double() - ref64).abs().max().item()
        smoke.check(diff64 <= bound, f"float32 kernel vs float64 plain: "
                                     f"max|diff|={diff64:.3e}")
        for i, n in enumerate(lens):
            if n == 0:
                nonzero = torch.count_nonzero(out[i]).item()
                smoke.check(nonzero == 0, f"row {i} of length 0: "
                                          f"{nonzero} non-zero outputs")
        del q, k, v, mask, out, ref, ref64
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


def float32_vocoder(cfg):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocoder=dataclasses.replace(cfg.model.vocoder,
                                               compute_dtype="float32")))


def phase_main_path(smoke: Smoke, device, texts, emotions):
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
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
    fa.launch_count = 0
    results = synth.synthesize(texts, speakers, emotions, vocoder="hifigan")
    launches = mrf.launch_count
    smoke.check(fa.launch_count == 0,
                f"flash launches on this path: {fa.launch_count} (every "
                f"sequence is under 2048 frames: the math path)")
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
    cfg32 = float32_vocoder(cfg)
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


def phase_long_form(smoke: Smoke, device, synth):
    """The long-form path on the bf16 synthesizer of phase 3; returns the
    flash launches of its batch synthesis."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    speakers = list(range(len(LONG_TEXTS)))
    n_dec = synth.cfg.model.transformer.decoder_layer
    per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
    kwargs = dict(duration_control=LONG_DURATION_CONTROL,
                  max_mel_len=LONG_MAX_MEL)

    fa.launch_count = 0
    mrf.launch_count = 0
    results = synth.synthesize(LONG_TEXTS, speakers, EMOTIONS,
                               vocoder="hifigan", **kwargs)
    flash_launches, mrf_launches = fa.launch_count, mrf.launch_count
    lens = [r.mel.shape[0] for r in results]
    for r in results:
        ok = (r.mel.shape[0] > 0 and r.wav.size == r.mel.shape[0] * 256
              and bool(np.isfinite(r.mel).all())
              and bool(np.isfinite(r.wav).all()))
        smoke.check(ok, f"{r.basename}: mel {r.mel.shape}, wav "
                        f"{r.wav.shape}, finite and non-empty")
    smoke.check(2048 < max(lens) < LONG_MAX_MEL and min(lens) < 1000,
                f"mel lengths {lens}: the longest in (2048, {LONG_MAX_MEL}),"
                f" the shortest under 1000")
    smoke.check(flash_launches == n_dec,
                f"flash launches in one synthesize call: {flash_launches} "
                f"(expected {n_dec}, one per decoder layer)")
    smoke.check(mrf_launches == per_call,
                f"mrf launches in one generator call: {mrf_launches} "
                f"(expected {per_call})")

    # The longest utterance in float32: the card (flash) against the CPU
    # (math path), mel only.
    i = int(np.argmax(lens))
    one = ([LONG_TEXTS[i]], [speakers[i]], [EMOTIONS[i]])
    fs2, voc = seeded_states(synth.cfg)
    cfg32 = float32_vocoder(synth.cfg)
    card_synth = Synthesizer(cfg32, fs2, voc, emotion_maps=EMOTION_MAPS,
                             device=device)
    cpu_synth = Synthesizer(cfg32, fs2, emotion_maps=EMOTION_MAPS,
                            device="cpu")
    card, cpu = (s.synthesize(*one, vocoder="none", **kwargs)[0]
                 for s in (card_synth, cpu_synth))
    same_dur = np.array_equal(card.durations, cpu.durations)
    mel_diff = float(np.abs(card.mel - cpu.mel).max()) if same_dur else math.inf
    bound = F32_BOUND * max(1.0, float(np.abs(cpu.mel).max()))
    smoke.check(same_dur, f"float32 durations equal on the card and the CPU "
                          f"({card.mel.shape[0]} frames)")
    smoke.check(mel_diff <= bound, f"float32 mel, card (flash) vs CPU (math "
                                   f"path): max|diff|={mel_diff:.3e} "
                                   f"bound={bound:.3e}")

    # Streaming against the monolithic waveform of the same mel, with the
    # launches of one synthesize_streaming call: the decoder's through
    # flash, and every resblock of every window through the MRF kernel.
    windows = math.ceil(card.mel.shape[0] / STREAM_CHUNK)
    for s, name in ((card_synth, "float32"), (synth, "bfloat16")):
        fa.launch_count = 0
        mrf.launch_count = 0
        chunks = list(s.synthesize_streaming(
            *(x[0] for x in one), chunk_frames=STREAM_CHUNK, **kwargs))
        smoke.check(len(chunks) == windows
                    and fa.launch_count == n_dec
                    and mrf.launch_count == per_call * windows,
                    f"{name} synthesize_streaming: {len(chunks)} chunks "
                    f"(expected {windows}), {fa.launch_count} flash launches"
                    f" (expected {n_dec}), {mrf.launch_count} mrf launches "
                    f"(expected {per_call} × {windows} windows)")
        stream = np.concatenate(chunks)
        dtype = next(s.vocoder.parameters()).dtype
        with torch.inference_mode():
            full = s.vocoder(torch.from_numpy(card.mel)[None].to(
                device, dtype))[0].float().cpu().numpy()
        diff = (float(np.abs(stream - full).max())
                if stream.shape == full.shape else math.inf)
        line = (f"{name} streaming ({len(chunks)} chunks of "
                f"{STREAM_CHUNK} frames) vs monolithic: {stream.shape} "
                f"samples, max|diff|={diff:.3e}")
        if name == "float32":
            smoke.check(diff <= STREAM_F32_BOUND,
                        f"{line} bound={STREAM_F32_BOUND:.0e}")
        else:
            print(f"  {line}")
    return flash_launches


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


def generator_split_ms(vocoder, batch: int, frames: int):
    """CUDA-event ms of the bf16 generator on a random (batch, frames, 80)
    mel, and of its 12 resblocks' kernels at the same shapes."""
    import torch

    mel = torch.randn(batch, frames, 80, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        gen_ms = cuda_time_ms(lambda: vocoder(mel), 5)
        x = vocoder.conv_pre(mel.transpose(1, 2)).transpose(1, 2)
        rb_ms = 0.0
        for i, up in enumerate(vocoder.ups):
            x = up(x.transpose(1, 2)).transpose(1, 2).contiguous()
            for rb in vocoder.resblocks[3 * i: 3 * i + 3]:
                rb_ms += cuda_time_ms(lambda: rb(x), 5)
    return gen_ms, rb_ms


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
    gen_ms, rb_ms = generator_split_ms(synth.vocoder, len(texts), frames)
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


def flash_bound_ms(b: int, t: int) -> tuple[float, str, float]:
    """Least time for float32 attention at H = 2, D = 128: 4·B·H·T²·D flops
    at the TF32 tensor-core rate (the fastest at which the card multiplies
    float32 inputs) against q, k, v read once, out written once and the
    mask's bytes. Also the time of those flops at the float32 CUDA-core
    rate."""
    flops = 4 * b * 2 * t * t * 128
    n_bytes = 16 * b * 2 * t * 128 + b * t
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * flops / PEAK_F32_FLOPS)


def phase_long_times(synth):
    """Long-form batch synthesis, streaming latency, and the flash kernel
    at the long-form shapes; returns the kernel's row at T = 4096."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.synth.streaming import (
        generator_receptive_radius_frames,
    )

    print(f"  card: {nvidia_smi_line()}")
    speakers = list(range(len(LONG_TEXTS)))
    kwargs = dict(duration_control=LONG_DURATION_CONTROL,
                  max_mel_len=LONG_MAX_MEL)
    for _ in range(2):
        synth.synthesize(LONG_TEXTS, speakers, EMOTIONS, vocoder="hifigan",
                         **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = synth.synthesize(LONG_TEXTS, speakers, EMOTIONS,
                               vocoder="hifigan", **kwargs)
        torch.cuda.synchronize()
        reps.append(1e3 * (time.perf_counter() - t0))
    audio_s = sum(r.wav.size for r in res) / res[0].sampling_rate
    reps.sort()
    print(f"  long-form synthesis, batch of {len(LONG_TEXTS)} "
          f"({audio_s:.3f} s of audio, max_mel_len={LONG_MAX_MEL}): median "
          f"{reps[2]:.3f} ms, min {reps[0]:.3f} ms, max {reps[-1]:.3f} ms "
          f"over 5 runs; {1e3 * audio_s / reps[2]:.1f} audio-s/s at the "
          f"median; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # Where that time goes: text → mel alone at max_mel_len (host clock,
    # synced), the generator alone on a (4, max_mel_len) mel and its
    # resblocks' kernels at the same shapes (CUDA events).
    mel_only = []
    for _ in range(5):
        t0 = time.perf_counter()
        synth.synthesize(LONG_TEXTS, speakers, EMOTIONS, vocoder="none",
                         **kwargs)
        torch.cuda.synchronize()
        mel_only.append(1e3 * (time.perf_counter() - t0))
    mel_only.sort()
    gen_ms, rb_ms = generator_split_ms(synth.vocoder, len(LONG_TEXTS),
                                       LONG_MAX_MEL)
    print(f"  long-form text → mel (vocoder='none'): median "
          f"{mel_only[2]:.3f} ms (min {mel_only[0]:.3f}, max "
          f"{mel_only[-1]:.3f}); generator on a ({len(LONG_TEXTS)}, "
          f"{LONG_MAX_MEL}, 80) mel: {gen_ms:.3f} ms, of which the 12 "
          f"resblocks' kernels {rb_ms:.3f} ms")

    # Streaming the longest utterance: time to the first and the last chunk
    # (each chunk reaches the host as numpy, so both clocks wait for the
    # card). One warm-up, then the median of 3.
    i = int(np.argmax([r.mel.shape[0] for r in res]))
    firsts, lasts = [], []
    for rep in range(4):
        t0 = time.perf_counter()
        chunks = synth.synthesize_streaming(
            LONG_TEXTS[i], speakers[i], EMOTIONS[i],
            chunk_frames=STREAM_CHUNK, **kwargs)
        next(chunks)
        t1 = time.perf_counter()
        n = 1 + sum(1 for _ in chunks)
        t2 = time.perf_counter()
        if rep:
            firsts.append(1e3 * (t1 - t0))
            lasts.append(1e3 * (t2 - t0))
    print(f"  streaming {res[i].mel.shape[0]} frames in {n} chunks of "
          f"{STREAM_CHUNK}: first chunk {sorted(firsts)[1]:.3f} ms, last "
          f"chunk {sorted(lasts)[1]:.3f} ms (median of 3; first "
          f"{firsts}, last {lasts})")
    # One streaming window (a chunk and its halo on both sides).
    window = STREAM_CHUNK + 2 * generator_receptive_radius_frames(
        synth.vocoder.cfg)
    gen_ms, rb_ms = generator_split_ms(synth.vocoder, 1, window)
    print(f"  generator on one streaming window, a (1, {window}, 80) mel: "
          f"{gen_ms:.3f} ms, of which the 12 resblocks' kernels "
          f"{rb_ms:.3f} ms")

    gen = torch.Generator().manual_seed(3)
    scale = 128 ** -0.5
    rows = {}
    for b, t, lens in FLASH_CASES:
        if t not in FLASH_TIMED:
            continue
        q, k, v, mask = flash_inputs(b, t, lens, gen)
        keep = ~mask[:, None, None, :]  # SDPA's boolean mask: True = attend
        iters = 10
        ms = cuda_time_ms(lambda: fa.flash_mha(q, k, v, mask, scale), iters)
        plain = cuda_time_ms(
            lambda: fa.flash_mha_plain(q, k, v, mask, scale), iters)
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=scale), iters)
        bound, by, f32_ms = flash_bound_ms(b, t)
        rows[t] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bound, "bound_by": by}
        print(f"  flash_mha float32 (B, H, T, D) = ({b}, 2, {t}, 128): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms,"
              f" bound {bound:.4f} ms ({by}; TF32 rate), {f32_ms:.4f} ms at "
              f"the float32 CUDA-core rate; kernel "
              f"{4 * b * 2 * t * t * 128 / ms / 1e9:.1f} TF/s", flush=True)
        del q, k, v, mask, keep
    return rows[max(FLASH_TIMED)]


def phase_flash_bwd_vs_plain(smoke: Smoke):
    """The backward kernels against the plain backward; returns the worst
    max|diff| of dq (the dQ kernel) and of dk, dv (the dK/dV kernel)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    gen = torch.Generator().manual_seed(4)
    scale = 128 ** -0.5
    worst_dq = worst_dkv = 0.0
    for b, t, lens in FLASH_BWD_CASES:
        q, k, v, mask = flash_inputs(b, t, lens, gen)
        dout = torch.randn(q.shape, generator=gen).to("cuda")
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        grads = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
        ref = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
        q64, k64, v64, dout64 = (x.double() for x in (q, k, v, dout))
        out64 = fa.flash_mha_plain(q64, k64, v64, mask, scale)
        ref64 = fa.flash_mha_bwd_plain(q64, k64, v64, mask, out64, dout64,
                                       scale)
        for name, g, r, r64 in zip(("dq", "dk", "dv"), grads, ref, ref64):
            diff = (g - r).abs().max().item()  # syncs
            diff64 = (g.double() - r64).abs().max().item()
            bound = FLASH_BWD_REL_BOUND * r.abs().max().item()
            if name == "dq":
                worst_dq = max(worst_dq, diff)
            else:
                worst_dkv = max(worst_dkv, diff)
            # Against float64 the float32 cancellation in dP - Δ shows
            # (on a row with one valid key dk is 0 in exact arithmetic, so
            # both float32 versions hold round-off there): printed only.
            smoke.check(math.isfinite(diff) and diff <= bound,
                        f"{name} B={b} T={t:5d} lens={lens}: "
                        f"max|diff|={diff:.3e} bound={bound:.3e} (float64 "
                        f"plain: max|diff|={diff64:.3e})")
        lse_ref = fa.flash_mha_lse_plain(q, k, mask, scale)
        finite = torch.isfinite(lse_ref)
        lse_diff = (lse - lse_ref)[finite].abs().max().item()
        lse_bound = LSE_REL_BOUND * lse_ref[finite].abs().max().item()
        smoke.check(lse_diff <= lse_bound
                    and torch.equal(torch.isposinf(lse), ~finite),
                    f"lse B={b} T={t:5d}: max|diff|={lse_diff:.3e} "
                    f"bound={lse_bound:.3e}, +inf exactly at the rows with "
                    f"no valid key")
        for i, n in enumerate(lens):
            if n == 0:
                nonzero = sum(torch.count_nonzero(g[i]).item()
                              for g in grads)
                smoke.check(nonzero == 0, f"row {i} of length 0: {nonzero} "
                                          f"non-zero gradients")
        again = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
        smoke.check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                    f"B={b} T={t:5d}: a second backward is bit-identical")
        del q, k, v, mask, dout, out, lse, grads, ref, ref64, again
    return worst_dq, worst_dkv


def write_training_corpus(root: str, seed: int) -> str:
    """A reference-format preprocessed corpus of random utterances: 20-120
    pinyin phones, 200-1000 frames split over them, random log-mels, pitch
    and energy; 4 speakers and 5 emotions."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.text import symbols

    rng = np.random.default_rng(seed)
    emotions = ["Angry", "Happy", "Neutral", "Sad", "Surprise"]
    levels = ["0.1", "0.3", "0.5", "0.8", "0.9"]
    maps = {"speakers.json": {f"spk{i}": i for i in range(4)},
            "emotions.json": {
                "emotion_dict": {e: i for i, e in enumerate(emotions)},
                "arousal_dict": {a: i for i, a in enumerate(levels)},
                "valence_dict": {a: i for i, a in enumerate(levels)}},
            "stats.json": {"pitch": [-3.0, 6.0, 0.0, 1.0],
                           "energy": [-2.0, 8.0, 0.0, 1.0]}}
    for sub in ("mel", "pitch", "energy", "duration"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for name, obj in maps.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)
    lines = []
    for i in range(N_TRAIN_UTTS + N_VAL_UTTS):
        spk, base = f"spk{i % 4}", f"utt{i:04d}"
        s = int(rng.integers(20, 121))
        t = int(rng.integers(200, 1001))
        durations = rng.multinomial(t - s, np.full(s, 1.0 / s)) + 1
        arrays = {"duration": durations.astype(np.int64),
                  "mel": rng.normal(-4.0, 2.0, (t, 80)).astype(np.float32),
                  "pitch": rng.normal(size=s).astype(np.float32),
                  "energy": rng.normal(size=s).astype(np.float32)}
        for kind, a in arrays.items():
            np.save(os.path.join(root, kind, f"{spk}-{kind}-{base}.npy"), a)
        phones = " ".join(rng.choice(symbols.PINYIN_PHONEMES, s))
        lines.append(f"{base}|{spk}|{{{phones}}}|raw|{spk}|x|"
                     f"{emotions[i % 5]}|{levels[i % 5]}|{levels[-1 - i % 5]}")
    for name, part in (("train.txt", lines[N_VAL_UTTS:]),
                       ("val.txt", lines[:N_VAL_UTTS])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part) + "\n")
    return root


def training_config(corpus: str, out: str, impl: str):
    """Config() width, the reference recipe's optimizer (the defaults,
    configs/ESD-Chinese-Singing-MFA/train.yaml), phase 5's cadence."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    return C.Config(
        preprocess=C.PreprocessConfig(
            path=C.PathConfig(preprocessed_path=corpus)),
        model=C.ModelConfig(
            transformer=C.TransformerConfig(attention_impl=impl)),
        train=C.TrainConfig(
            path=C.PathConfig(ckpt_path=os.path.join(out, "ckpt"),
                              log_path=os.path.join(out, "log"),
                              result_path=os.path.join(out, "result")),
            step=C.StepConfig(total_step=TRAIN_STEPS, **TRAIN_CADENCE)))


def flash_counts() -> tuple[int, int, int]:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    return fa.launch_count, fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count


def reset_flash_counts() -> None:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    fa.launch_count = fa.bwd_dq_launch_count = fa.bwd_dkv_launch_count = 0


def _zero_in_exact_arithmetic(name: str) -> bool:
    """The key projection's bias (the softmax cancels it) and a postnet
    conv's bias (training-mode BatchNorm removes it): their gradients are
    float round-off."""
    return name.endswith("slf_attn.w_ks.bias") or (
        name.startswith("postnet.") and name.endswith(".conv.bias"))


def phase_training(smoke: Smoke, device):
    """The training path through ``train()``; returns the flash launches
    (forward, dQ, dK/dV) of its 20-step run."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        CheckpointManager,
        create_train_state,
        loss_and_grads,
        train,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )

    with tempfile.TemporaryDirectory() as tmp:
        corpus_dir = write_training_corpus(os.path.join(tmp, "corpus"), 0)
        cfg = training_config(corpus_dir, os.path.join(tmp, "out"), "flash")
        t = cfg.model.transformer
        n_blocks = t.encoder_layer + t.decoder_layer
        reset_flash_counts()
        t0 = time.perf_counter()
        state = train(cfg, total_steps=TRAIN_STEPS, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = flash_counts()
        n_params = sum(p.numel() for p in state.model.parameters())
        n_val_batches = math.ceil(N_VAL_UTTS / cfg.train.optimizer.batch_size)
        forwards = (TRAIN_STEPS + TRAIN_STEPS // TRAIN_CADENCE["val_step"]
                    * n_val_batches
                    + TRAIN_STEPS // TRAIN_CADENCE["synth_step"])
        expected = (n_blocks * forwards, n_blocks * TRAIN_STEPS,
                    n_blocks * TRAIN_STEPS)
        smoke.check(counts == expected,
                    f"train(): {TRAIN_STEPS} steps of a {n_params / 1e6:.1f}M"
                    f"-parameter model in {seconds:.1f} s; flash launches "
                    f"(forward, dQ, dK/dV) {counts}, expected {expected}: "
                    f"{n_blocks} of each per step, plus {n_blocks} forward "
                    f"per evaluation batch and sample synthesis")
        with open(os.path.join(tmp, "out/log/train/metrics.jsonl")) as f:
            log = [json.loads(line) for line in f]
        losses = [r["total_loss"] for r in log]
        smoke.check(state.step == TRAIN_STEPS
                    and [r["step"] for r in log] == list(range(
                        TRAIN_CADENCE["log_step"], TRAIN_STEPS + 1,
                        TRAIN_CADENCE["log_step"]))
                    and all(math.isfinite(x) for x in losses),
                    f"steps {state.step}, logged total losses {losses}")
        ckpt = CheckpointManager(cfg.train.path.ckpt_path)
        samples = os.listdir(os.path.join(tmp, "out/result/train_samples"))
        smoke.check(ckpt.steps() == [10, 20] and len(samples) == 4,
                    f"checkpoints at steps {ckpt.steps()}; sample files "
                    f"{sorted(samples)}")
        resumed = train(cfg, total_steps=TRAIN_STEPS + 2, device=device)
        lr = resumed.optimizer.schedule(TRAIN_STEPS + 2)
        smoke.check(resumed.step == TRAIN_STEPS + 2
                    and resumed.optimizer.count == TRAIN_STEPS + 2
                    and resumed.optimizer.lr == lr,
                    f"resumed from step {TRAIN_STEPS}: step {resumed.step}, "
                    f"updates {resumed.optimizer.count}, next lr "
                    f"{resumed.optimizer.lr:.6e}")
        del state, resumed

        # One step from one state, batch and dropout seed: flash and xla.
        corpus = PreprocessedCorpus(corpus_dir)
        ds = BucketedDataset(corpus, "train.txt", 4, cfg.train.buckets,
                             drop_last=True, seed=cfg.train.seed)
        raw = next(ds.epoch(0))
        batch = stage_batch(raw, device, cfg.train.transfer_dtype)
        runs = {}
        for name, impl, perturb in (("flash", "flash", 0.0),
                                    ("xla", "xla", 0.0),
                                    ("xla perturbed", "xla", PERTURB)):
            c = training_config(corpus_dir, tmp, impl)
            st = create_train_state(c, corpus.stats, device)
            if perturb:
                with torch.no_grad():
                    w = st.model.encoder.src_word_emb.weight
                    noise = torch.randn(w.shape, generator=torch.Generator(
                    ).manual_seed(0))
                    w.mul_(1.0 + perturb * noise.to(device))
            reset_flash_counts()
            report, grads = loss_and_grads(st.model, batch, c, st.generator)
            names = [n for n, _ in st.model.named_parameters()]
            runs[name] = (float(report.total), dict(zip(names, grads)),
                          flash_counts())
            del st
    (lf, gf, cf), (lx, gx, cx) = runs["flash"], runs["xla"]
    gp = runs["xla perturbed"][1]
    rel = abs(lf - lx) / abs(lx)
    smoke.check(rel <= LOSS_REL_BOUND and cf == (n_blocks,) * 3
                and cx == (0, 0, 0),
                f"one step, bucket {tuple(raw['mels'].shape[:2])} mel, "
                f"{tuple(raw['texts'].shape)} text: loss flash {lf:.7f}, xla "
                f"{lx:.7f}, rel diff {rel:.2e} (bound {LOSS_REL_BOUND:.0e}); "
                f"flash launches {cf}, xla {cx}")
    # Each gradient within 1e-3 · max|g| of its tensor, of the xla step or
    # of the xla step with the phoneme embedding moved by float32 round-off:
    # a ReLU input that close to 0 changes sides under any round-off, and
    # then both sides are float32 answers. (At Config() width and this
    # batch, a pitch-predictor ReLU input sits 3.5e-8 from 0; the flip moves
    # that conv's gradient by 3.9 % and, through the encoder, the gradients
    # upstream of it.)
    top = max(g.abs().max().item() for g in gx.values())
    worst, worst_name, noise, sides = 0.0, "", 0.0, []
    for name, g in gf.items():
        r = gx[name]
        if _zero_in_exact_arithmetic(name):
            noise = max(noise, g.abs().max().item(), r.abs().max().item())
            continue
        d_xla = (g - r).abs().max().item()
        d_pert = (g - gp[name]).abs().max().item()
        ratio = min(d_xla, d_pert) / r.abs().max().item()
        if d_pert < d_xla:
            sides.append(name)
        if ratio > worst:
            worst, worst_name = ratio, name
    pitch = "variance_adaptor.pitch_predictor.conv_layer.conv1d_1.conv.weight"
    jump = ((gp[pitch] - gx[pitch]).abs().max()
            / gx[pitch].abs().max()).item()
    smoke.check(worst <= GRAD_REL_BOUND,
                f"gradients, flash vs xla: worst max|diff| / max|g| "
                f"{worst:.2e} ({worst_name}), bound {GRAD_REL_BOUND:.0e}; "
                f"{len(sides)} of {len(gf)} tensors nearer the perturbed "
                f"xla step, whose pitch-predictor conv gradient moved by "
                f"{jump:.2e} of its max")
    smoke.check(noise <= 1e-5 * top,
                f"gradients zero in exact arithmetic (key biases, postnet "
                f"conv biases): at most {noise:.2e}, against the largest "
                f"gradient {top:.3e}")
    return counts


def synthetic_train_batch(b: int, s: int, t: int, seed: int):
    """A (B, S, T)-bucket training batch of numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src_lens = np.array([s, s - s // 8, s - s // 4, s // 2][:b], np.int32)
    mel_lens = np.array([t, t - t // 10, t - t // 4, t // 2][:b], np.int32)
    durations = np.zeros((b, s), np.int32)
    for i in range(b):
        durations[i, :src_lens[i]] = rng.multinomial(
            mel_lens[i] - src_lens[i], np.full(src_lens[i],
                                               1.0 / src_lens[i])) + 1
    texts = rng.integers(4, 100, (b, s)).astype(np.int32)
    texts[np.arange(s)[None] >= src_lens[:, None]] = 0
    return {
        "speakers": rng.integers(0, 4, b).astype(np.int32),
        "emotions": rng.integers(0, 5, b).astype(np.int32),
        "arousals": rng.integers(0, 5, b).astype(np.int32),
        "valences": rng.integers(0, 5, b).astype(np.int32),
        "texts": texts, "src_lens": src_lens,
        "mels": rng.normal(-4.0, 2.0, (b, t, 80)).astype(np.float32),
        "mel_lens": mel_lens,
        "pitches": rng.normal(size=(b, s)).astype(np.float32),
        "energies": rng.normal(size=(b, s)).astype(np.float32),
        "durations": durations,
    }


def flash_bwd_bound_ms(b: int, t: int, kernel: str
                       ) -> tuple[float, str]:
    """Least time for one backward kernel at H = 2, D = 128, float32 (TF32
    tensor-core rate, as the forward's bound): the dQ kernel recomputes S
    and dP and forms dq (6·B·H·T²·D flops) from q, k, v, out, dO, lse and
    the mask, writing dq and Δ; the dK/dV kernel recomputes S and dP and
    forms dk and dv (8·B·H·T²·D) from q, k, v, dO, lse, Δ and the mask,
    writing dk and dv. ``kernel="both"`` is the whole backward: 10·B·H·T²·D
    flops (S, dP, dq, dk, dv) against 8·B·H·T·D·4 bytes."""
    bhtd = b * 2 * t * 128
    flops = {"dq": 6, "dkv": 8, "both": 10}[kernel] * bhtd * t
    n_bytes = {"dq": 24 * bhtd + 8 * b * 2 * t + b * t,
               "dkv": 24 * bhtd + 8 * b * 2 * t + b * t,
               "both": 32 * bhtd}[kernel]
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_train_times(device):
    """Train-step times under "flash" and "auto" at the bucket (128, 1000),
    and the backward kernels at (4, 2, T, 128); returns the kernels' rows
    at the training bucket's T = 1000."""
    import torch
    import torch.nn.functional as F

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )

    card = nvidia_smi_line()
    b, s, t = TRAIN_TIMED
    batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
    runs = {}
    for impl in ("flash", "auto"):
        cfg = C.Config(model=C.ModelConfig(
            transformer=C.TransformerConfig(attention_impl=impl)))
        state = create_train_state(cfg, None, device)
        for _ in range(3):
            train_step(state, batch, cfg)
        runs[impl] = {"cfg": cfg, "state": state, "ms": [], "peak": 0.0}
    # Ten rounds, the two paths in turns; peak memory per path.
    for _ in range(10):
        for run in runs.values():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_flash_counts()
            t0 = time.perf_counter()
            report = train_step(run["state"], batch, run["cfg"])
            torch.cuda.synchronize()
            run["ms"].append(1e3 * (time.perf_counter() - t0))
            run["peak"] = max(run["peak"],
                              torch.cuda.max_memory_allocated() / 2**20)
            run["counts"], run["loss"] = flash_counts(), float(report.total)
    for impl, run in runs.items():
        reps, counts, loss = sorted(run["ms"]), run["counts"], run["loss"]
        print(f"  train step {impl!r}, B={b}, bucket (S, T) = ({s}, {t}): "
              f"median {(reps[4] + reps[5]) / 2:.3f} ms, min {reps[0]:.3f},"
              f" max {reps[-1]:.3f} over 10 steps after 3 warm-ups, in turns"
              f" with the other path; last loss {loss:.4f}; flash launches "
              f"per step (forward, dQ, dK/dV) {counts}; max_memory_allocated"
              f" {run['peak']:.1f} MiB [{card}]", flush=True)
    del runs

    gen = torch.Generator().manual_seed(6)
    scale = 128 ** -0.5
    rows = {}
    for t in FLASH_BWD_TIMED:
        lens = (t, 3 * t // 4, t // 2, t // 4)
        q, k, v, mask = flash_inputs(4, t, lens, gen)
        dout = torch.randn(q.shape, generator=gen).to("cuda")
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        _, delta = fa._flash_mha_bwd_dq_cuda(q, k, v, mask, out, dout, lse,
                                             scale)
        iters = 10
        dq_ms = cuda_time_ms(lambda: fa._flash_mha_bwd_dq_cuda(
            q, k, v, mask, out, dout, lse, scale), iters)
        dkv_ms = cuda_time_ms(lambda: fa._flash_mha_bwd_dkv_cuda(
            q, k, v, mask, dout, lse, delta, scale), iters)
        plain = cuda_time_ms(lambda: fa.flash_mha_bwd_plain(
            q, k, v, mask, out, dout, scale), iters)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=~mask[:, None, None, :], scale=scale)
        lib = cuda_time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dout, retain_graph=True), iters)
        both, both_by = flash_bwd_bound_ms(4, t, "both")
        for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            bound, by = flash_bwd_bound_ms(4, t, name)
            rows[(name, t)] = {"ms": ms, "plain_ms": plain,
                               "bound_ms": bound, "bound_by": by,
                               "library_ms": lib}
        flops = 14 * 4 * 2 * t * t * 128
        print(f"  flash_mha backward float32 (4, 2, {t}, 128), key lengths "
              f"{lens}: dQ kernel {dq_ms:.4f} ms (bound "
              f"{rows[('dq', t)]['bound_ms']:.4f}), dK/dV kernel "
              f"{dkv_ms:.4f} ms (bound {rows[('dkv', t)]['bound_ms']:.4f}),"
              f" together {dq_ms + dkv_ms:.4f} ms = "
              f"{flops / (dq_ms + dkv_ms) / 1e9:.1f} TF/s; whole-backward "
              f"bound {both:.4f} ms ({both_by}; TF32 rate); plain backward "
              f"{plain:.4f} ms; SDPA backward {lib:.4f} ms [{card}]",
              flush=True)
        del q, k, v, mask, dout, out, lse, delta, qs, ks, vs, o
    return {name: rows[(name, min(FLASH_BWD_TIMED))] for name in ("dq", "dkv")}


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
    worst_flash = smoke.phase("2b. flash_mha kernel vs plain on the card",
                              phase_flash_vs_plain, smoke)
    worst_long = smoke.phase("2c. mrf_resblock kernel vs plain at the "
                             "long-form and streaming shapes",
                             phase_long_kernel_vs_plain, smoke, device)
    worst_bwd = smoke.phase("2d. flash_mha backward kernels vs plain on "
                            "the card", phase_flash_bwd_vs_plain, smoke)
    main_run = smoke.phase("3. main path: Synthesizer.synthesize",
                           phase_main_path, smoke, device, TEXTS, EMOTIONS)
    flash_launches = totals = flash_row = None
    if main_run is not None:
        flash_launches = smoke.phase(
            "3b. long-form path: synthesize(max_mel_len=4096) and "
            "synthesize_streaming", phase_long_form, smoke, device,
            main_run[0])
        totals = smoke.phase("4. times", phase_times, main_run[0], TEXTS,
                             EMOTIONS)
        flash_row = smoke.phase("4b. times: long-form path and flash kernel",
                                phase_long_times, main_run[0])
    train_launches = smoke.phase("5. training: train() under "
                                 "attention_impl='flash'", phase_training,
                                 smoke, device)
    bwd_rows = smoke.phase("6. times: train step and flash backward "
                           "kernels", phase_train_times, device)
    print(f"== done in {time.time() - t_start:.1f} s")
    if (smoke.failures or None in (worst, worst_flash, worst_long,
                                   flash_launches, totals, flash_row,
                                   worst_bwd, train_launches, bwd_rows)):
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
        "max_abs_err": max(worst, worst_long),
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if 2 * totals["bound_by_operations_ms"]
                     >= totals["bound_ms"] else "bytes"),
        "library_ms": totals["library_ms"],
    }, {
        "name": "flash_mha",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha.cu",
        "replaces": "expressive_fastspeech2_mandarin_tpu/ops/pallas/"
                    "flash_mha.py:53",
        "launches": train_launches[0],
        "max_abs_err": worst_flash,
        **flash_row,
    }, {
        "name": "flash_mha_bwd_dq",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "launches": train_launches[1],
        "max_abs_err": worst_bwd[0],
        **bwd_rows["dq"],
    }, {
        "name": "flash_mha_bwd_dkv",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": train_launches[2],
        "max_abs_err": worst_bwd[1],
        **bwd_rows["dkv"],
    }]
    print(f"card: {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
