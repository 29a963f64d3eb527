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
     plain version, its bound and SDPA.

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
    print(f"== done in {time.time() - t_start:.1f} s")
    if (smoke.failures or None in (worst, worst_flash, worst_long,
                                   flash_launches, totals, flash_row)):
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
        "launches": flash_launches,
        "max_abs_err": worst_flash,
        **flash_row,
    }]
    print(f"card: {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
