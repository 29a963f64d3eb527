#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 1,2e,11b [--root DIR]

With no arguments every phase runs and the last two lines are the result
lines. ``--phases`` runs the phases named (comma-separated) and prints no
result line; ``--root`` takes the port's package from another checkout
(the parent's, unpacked with ``git archive``), so that phase 11b times its
kernels in the same call.

Phases:
  1. environment: the card's name and power limit; build every CUDA source
     of the port with nvcc (sm_90a) and print ptxas's register, shared
     memory and spill lines and the flash kernels' dynamic shared memory
     and tile widths; for the bf16 forward and backward kernels also the
     registers of each warpgroup role (setmaxnreg), the ring stages and
     the waves of blocks at the timed shapes;
     the tensor-core kernels (MRF, flash forward, flash backward dQ and
     dK/dV) must not spill, and no wgmma may be serialized; the bf16
     kernels must be given at launch the registers their setmaxnreg split
     asks for;
  2. the MRF resblock kernels against their plain PyTorch version on the
     card, at the generator's four stage shapes (B=4 × 1000 mel frames) for
     k = 3, 7, 11 and 13 (past the templated sizes: the kernels' run-time
     tap count) and at the ragged T=700, in float32 (the CUDA-core
     kernel) and bfloat16 (the tensor-core kernel), with each resblock's
     six launches counted on the kernel of its dtype; a width the kernels
     are not built for (C = 16, k = 5, zero-padded by the wrapper); the
     wrapper raises when a gradient is wanted;
  3. the main path: ``Synthesizer.synthesize`` at ``Config()`` width on four
     utterances with a bfloat16 HiFi-GAN, with random weights from fixed
     seeds; the MRF launches over that run, every one on the tensor-core
     kernel (72 per generator call); the duration_control=2
     probe; one utterance's float32 waveform from the card against the same
     run on the CPU, its 72 MRF launches all on the CUDA-core kernel;
  2b. the flash attention kernel (TF32 tensor cores at float32 accuracy)
     against its plain version on the card, float32, at (B, H, D) =
     (4, 2, 128) for T = 20 (under one key tile), 128 (the encoder's
     training S), 300, 1000 (a mask that is not a prefix: wholly padded key
     tiles at the start and in the middle of rows), 2300, 4096 and
     (1, 2, 128) for T = 8192, ragged key lengths with a row of no valid
     key (exactly 0 out), against float32 and float64 plain;
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
  4. times: steady-state batch synthesis, and per stage shape the kernel
     (and its TF/s), its plain version, its bound, the six-launch design's
     bytes floor and a cuDNN conv chain (library_ms); the same for the
     float32 CUDA-core kernel with TF32 off (its bound at the TF32 rate,
     its operations also at the FP32 CUDA-core rate, the cuDNN chain in
     float32);
     long-form batch synthesis, its text → mel and generator spans,
     streaming first and last chunk, and the flash kernel against its
     plain version, its bounds at the TF32 rate (over the live key tiles,
     which is ``bound_ms``, and dense; and both at three TF32 products a
     product, the kernel's method) and SDPA (default, and under the
     efficient-attention and math backends, to name the one that ran);
  2d. the flash attention backward kernels (dQ with Δ, then dK/dV) against
     the plain backward on the card, float32, at (4, 2, T, 128) for
     T = 300, 1000 (prefixes; the mask that is not a prefix; wholly padded
     64-key blocks in the middle of rows), 2300, 4096 and (1, 2, 8192, 128),
     with a row of no valid key and random dO at every row: dq, dk, dv
     within 1e-4 · max|ref| of float32 plain (of float64 plain where float32
     plain is itself further than that from it), and within twice float32
     plain's distance to float64 plain (+ 1e-6 · max|ref|); the forward's
     stored log-sum-exp against torch.logsumexp (+inf for the empty row);
     the empty row's gradients exactly 0; a second backward bit-identical;
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
     4096, against their bounds (over the live 32-key tiles, and dense),
     the plain backward and the backward of scaled_dot_product_attention;
  7. DSP and the non-neural and MelGAN vocoders on the card:
     ``MelSTFT.mel_energy`` of four 2-8 s signals made from a seed against
     the CPU (log-mel 1e-4, energy 1e-5 relative), the iSTFT round trip
     (1e-3); ``Synthesizer.synthesize`` without HiFi-GAN weights at
     ``Config()`` width on the four phase-3 utterances: Griffin-Lim is the
     default, its waveforms against the CPU run from the same initial
     phase (1e-3 of the peak) and at most 0.95 peak, and for the
     utterances of the largest and the smallest distance the distance
     after each round (from each device's mel, from the same mel, and on
     the CPU alone from the mel moved by one ulp); a random-weight MelGAN
     (seed 2), ``vocoder="melgan"``, against the CPU (1e-4); no MRF or
     flash launch; times of Griffin-Lim's 60 iterations and MelGAN;
  8. HiFi-GAN GAN training at ``Config()`` width (HiFi-GAN V1, MPD
     (2, 3, 5, 7, 11), MSD ×3), batch 16 × 8192 samples, float32, on 24
     WAVs written from a seed and read back by ``load_corpus_wavs``:
     ``train_vocoder`` for 20 steps (finite losses, the mean mel L1 of the
     last 5 steps below the first 5's, no MRF launch, the val record), its
     checkpoints and a resume that continues the step, the AdamW count and
     the learning rate; ``generator.npz`` in the Synthesizer in bf16 (72
     MRF tensor-core launches a call; the kernel path against the plain
     generator on the card); one GAN step at batch 2 on the card against
     the CPU from one state and batch (losses 1e-5 relative, each gradient
     1e-3 · max|g|); 8b: the GAN step's time at batch 16 in float32 and
     bf16 amp (median of 10 after 3 warm-ups) with its generator-forward,
     discriminator-update and generator-update spans (CUDA events) and
     peak memory;
  9. feature extraction and GTA fine-tuning at full width: an ESD-layout
     corpus written from a seed (2 speakers × 5 emotions × 10 utterances,
     16 kHz, 2-6 s) → ``prepare_esd`` → a TextGrid per utterance from its
     lab's pinyin phones → ``Preprocessor`` at ``Config()``'s STFT on the
     card against the same build on the CPU (metadata, maps, durations
     and pitch equal; log-mel 1e-4, energy 1e-5 relative), with the
     extraction rate, the F0 pool's start-up and steady rate and the mel
     STFT's share → ``train()`` at ``Config()`` width under "flash", 4
     steps → ``export_gta_mels`` under "flash" (10 flash launches a batch;
     rows equal to the ground truth's) against "xla" (phase 3b's bound),
     its time a batch and one batch's forward → ``train_vocoder(pairs=...)``
     at batch 16 × 8192, 10 steps (finite losses, the val record, no MRF
     launch) and the paired step's median time → the tuned
     ``generator.npz`` in the bf16 Synthesizer (72 MRF launches); every
     kernel counted from 0 over the phase, each launched (the flash
     counts read before the forward's timing runs).
  2e. the flash kernels in bf16 (forward with the float32 log-sum-exp, dQ
     with Δ, dK/dV) against their plain versions on the same bf16 inputs,
     which round where the TPU kernel rounds in bf16 (the forward against
     the blocked plain version on its own 64-key tiles), at
     (4, 2, T, 128) for T = 20, 300, 320 (an odd count of streamed tiles,
     a row of one live tile), 1000 (both masks that are not prefixes),
     2300, 4096, (1, 2, 8192, 128) and (32, 2, T, 128) for T = 1000, 500
     and 128 (the recipe's batch, the shapes phase 11b times): out within
     2^-7 · max|ref| (its margin printed), dq, dk, dv
     within 2^-6, the LSE within 1e-5, rows of length 0 exactly 0, one
     launch of each bf16 kernel and none of the float32 ones, a rerun
     bit-identical; and a layout witness whose every product is exact
     (two-hot P, small integers), which must come out exact;
  11. efs2-torch-train on the shipped train_tuned.yaml (batch 32, bf16
     amp, steps_per_call 10) with the ESD preprocess.yaml and model.yaml,
     ``attention_impl: "flash"``, phase 5's corpus, its paths and
     cadences moved inside the run: 20 steps in two chunks of 10, each
     train step 10 launches of each bf16 kernel and none of the float32
     kernels, the val and synth steps (float32, as the JAX package's) 10
     float32 forward launches each and nothing else; the chunk-mean loss
     falls;
  11b. times: the bf16 kernels against their bounds (bf16 rate), plain
     versions and SDPA in bf16 with the bool mask, its backend named
     (forward at B = 4, T = 2300 and 4096, and where the tuned recipe
     launches it, B = 32 at T = 1000 and 128, each also from a CUDA graph
     of 20 launches, without the host; backward at B = 4, T = 1000 and
     4096, and at the recipe's B = 32, T = 1000 and 500; the recipe's key
     lengths seeded over [T/2, T]); the train step under amp bf16
     "flash", amp bf16 "auto" and float32 "flash" at the bucket
     (128, 1000), B = 4 and 32, median of 10 after 3 warm-ups, in turns;
  12. the multilingual front end and corpora through the CLIs, at
     ``Config()`` width, every input written from a seed: (a) six Mandarin
     sentences with a date, a time, money, a percent, a phone number and a
     decimal through ``normalize_chinese`` (no ASCII digit left, no pad
     ID) and the bf16 Synthesizer (finite, non-silent; 72 MRF launches);
     (b) ``write_lexicon``'s syllable inventory, then
     ``efs2-torch-pipeline --lexicon <it> --skip-train`` on an ESD corpus
     (every utterance aligned); (c) an IEMOCAP release (2 sessions, 4
     emotions, 24 English utterances with numbers, "$" amounts and
     abbreviations) through ``efs2-torch-pipeline`` stages 1-4 with
     english_cleaners, a lexicon of the cleaned words' letters, 8 steps
     under "flash" (10 launches of each float32 flash kernel a step),
     matmul_precision "highest" and the profiler window of steps 3-5 (its
     trace's device busy share), the step-8 figure or its logged skip,
     then ``efs2-torch-synthesize --mode grid`` from the checkpoint (72
     MRF launches a speaker); (d) AIHub-MMV clips with pre-extracted WAVs
     and Korean scripts with numbers through ``create_dataset`` and
     ``prepare_aihub_mmv`` with korean_cleaners (17-field filelist, no
     digit left), ``extract_audio``'s refusal without ffmpeg; (e)
     ``train_vocoder`` at batch 16 × 8192 for 8 steps in chunks of 4
     against the same steps one by one (each chunk's losses its steps'
     mean within 1e-5 relative; JAX's log, val and save steps); (f)
     ``train()`` in float32 under matmul_precision "high": TF32 on for its
     steps and off after, its first loss within 1e-2 of "highest"'s, both
     step times.

Float32 comparisons run with TF32 off (cuDNN and matmul). Every failed
check is reported and the script exits 1 without its result lines; with
no CUDA device, or without the port's package beside it, it exits 1 at
once. Its last two lines are the ``kernels`` JSON line, whose every row
names the shape its times were taken at (``shape``), and the result line.
"""

from __future__ import annotations

import argparse
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
# Phase 2 also holds an odd K past the templated sizes, which the kernels
# read at run time.
PHASE2_KERNEL_SIZES = KERNEL_SIZES + (13,)
DILATIONS = (1, 3, 5)
BATCH = 4
F32_BOUND = 1e-4
# bfloat16: kernel and plain version do the same float32 arithmetic on the
# same bf16 values and differ only in summation order, which can flip the
# bf16 rounding of a conv output by one unit in the last place (2^-8
# relative) and carry through the later convs of the chain; allow four
# such units at the output's peak magnitude.
BF16_REL_BOUND = 2.0 ** -6

# Published H100 SXM peaks (dense bf16 and TF32 tensor-core rates, HBM3
# bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# Float32 outside the tensor cores (the CUDA-core MRF kernel's rate).
PEAK_FP32_FLOPS = 67e12

def prefixes(*lens):
    """Key-mask rows (the [start, stop) spans of each row's valid keys) for
    valid prefixes of these lengths."""
    return tuple(((0, n),) for n in lens)


# Flash attention: (B, T, rows) at H = 2, D = 128, a row the [start, stop)
# spans of its valid keys. Every batch of four has a length below 64, a
# full row and a row with no valid key. The case that is not a prefix
# leaves wholly padded 32-key tiles at the start of a row and in the middle
# of two, and one valid key at the end of a row.
FLASH_HOLES = (((0, 100), (300, 1000)), ((64, 128), (640, 700)),
               ((999, 1000),), ())
FLASH_CASES = ((4, 20, prefixes(20, 1, 0, 13)),
               (4, 128, prefixes(128, 1, 0, 77)),
               (4, 300, prefixes(300, 37, 0, 211)), (4, 1000, FLASH_HOLES),
               (4, 2300, prefixes(2300, 63, 0, 2049)),
               (4, 4096, prefixes(4096, 1, 0, 3001)),
               (1, 8192, prefixes(8100)))
FLASH_TIMED = (2300, 4096)  # B = 4, the long-form path's shapes
# Kernel and plain version sum the same products in another order (the
# kernel online, tile by tile, with rescaling), expf differs from torch.exp
# by an ulp or two, and the kernel's split TF32 products leave ~2^-21 of
# each product: a few float32 ulps of the output's magnitude.
FLASH_REL_BOUND = 1e-5

# Flash backward: the forward's cases and the training path's T = 1000,
# with the mask that is not a prefix, and one whose rows leave wholly
# padded 64-key blocks (the dK/dV kernel's unit) in the middle: [448, 512)
# in row 0, [64, 192) in row 2.
FLASH_BLOCK_HOLES = (((0, 448), (512, 1000)), ((0, 1000),),
                     ((0, 64), (192, 1000)), ((0, 5),))
FLASH_BWD_CASES = ((4, 300, prefixes(300, 37, 0, 211)),
                   (4, 1000, prefixes(1000, 63, 0, 777)),
                   (4, 1000, FLASH_HOLES), (4, 1000, FLASH_BLOCK_HOLES),
                   (4, 2300, prefixes(2300, 63, 0, 2049)),
                   (4, 4096, prefixes(4096, 1, 0, 3001)),
                   (1, 8192, prefixes(8100)))
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
        t0 = time.time()
        try:
            return fn(*args)
        except Exception:  # reported, and the run exits 1
            traceback.print_exc()
            self.failures.append(f"{name}: {traceback.format_exc(limit=1)}")
            return None
        finally:
            print(f"   ({time.time() - t0:.1f} s)", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# The bf16 flash kernels, warp-specialised with setmaxnreg: each kernel's
# library and the prefix of the exports that give its block's shape.
SETMAXNREG_KERNELS = {
    "flash_mha_fwd_bf16_kernel": ("flash_mha_bf16", "flash_mha_fwd_bf16"),
    "flash_mha_bwd_dq_bf16_kernel": ("flash_mha_bwd_bf16",
                                     "flash_mha_bwd_bf16"),
    "flash_mha_bwd_dkv_bf16_kernel": ("flash_mha_bwd_bf16",
                                      "flash_mha_bwd_bf16")}
# The tensor-core kernels, which must compile without spills.
TC_KERNELS = ("mrf_conv_tc_kernel", "flash_mha_fwd_kernel",
              "flash_mha_bwd_dq_kernel", "flash_mha_bwd_dkv_kernel",
              "flash_mha_fwd_bf16_kernel", "flash_mha_bwd_dq_bf16_kernel",
              "flash_mha_bwd_dkv_bf16_kernel")


def phase_environment(smoke: Smoke):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    print(f"  nvidia-smi: {nvidia_smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    libs = build.build_all()
    print(f"  built {sorted(libs)} in {time.time() - t0:.1f} s")
    entries = {k: 0 for k in TC_KERNELS}
    clean = {k: 0 for k in TC_KERNELS}
    launch_regs = {}  # registers a thread ptxas allocates at launch
    serialized, current = [], ""
    for name in libs:
        for line in build.ptxas_report(name).splitlines():
            if ("Used" in line or "spill" in line or "Compiling" in line
                    or "wgmma" in line):
                print(f"  ptxas {name}: {line.strip()}")
            if "wgmma" in line and "serialized" in line:
                serialized.append(line.strip())
            if "Compiling entry function" in line:
                current = line
                for k in TC_KERNELS:
                    entries[k] += k in line
            elif "spill stores" in line:
                for k in TC_KERNELS:
                    clean[k] += (k in current and "0 bytes spill stores, "
                                 "0 bytes spill loads" in line)
            elif "Used" in line and "registers" in line:
                for k in SETMAXNREG_KERNELS:
                    if k in current:
                        launch_regs[k] = int(line.split("Used")[1].split()[0])
    flash = build.load("flash_mha")
    print(f"  flash_mha_fwd_kernel: {flash.flash_mha_fwd_smem_bytes()} bytes "
          f"of dynamic shared memory a block, "
          f"{flash.flash_mha_fwd_key_tile()}-key tiles")
    bwd = build.load("flash_mha_bwd")
    print(f"  flash_mha_bwd_dq_kernel: {bwd.flash_mha_bwd_dq_smem_bytes()} "
          f"bytes a block, {bwd.flash_mha_bwd_block_rows()} query rows, "
          f"{bwd.flash_mha_bwd_stream_tile()}-key tiles; "
          f"flash_mha_bwd_dkv_kernel: {bwd.flash_mha_bwd_dkv_smem_bytes()} "
          f"bytes a block, {bwd.flash_mha_bwd_block_rows()} keys, "
          f"{bwd.flash_mha_bwd_stream_tile()}-query tiles")
    flash16 = build.load("flash_mha_bf16")
    bwd16 = build.load("flash_mha_bwd_bf16")
    # Each setmaxnreg kernel's threads and the registers its split asks for.
    split = {}
    for k, (lib, prefix) in SETMAXNREG_KERNELS.items():
        lib = build.load(lib)
        roles = [getattr(lib, f"{prefix}_{x}")() for x in (
            "threads", "producer_regs", "consumers", "consumer_regs")]
        split[k] = (roles[0], 128 * (roles[1] + roles[2] * roles[3]), roles)
    threads, asked, (_, producer, consumers, consumer) = split[
        "flash_mha_bwd_dq_bf16_kernel"]
    smem = {"fwd": flash16.flash_mha_fwd_bf16_smem_bytes(),
            "dq": bwd16.flash_mha_bwd_dq_bf16_smem_bytes(),
            "dkv": bwd16.flash_mha_bwd_dkv_bf16_smem_bytes()}
    f_threads, f_asked, (_, f_producer, f_consumers, f_consumer) = split[
        "flash_mha_fwd_bf16_kernel"]
    f_rows = flash16.flash_mha_fwd_bf16_block_rows()
    print(f"  flash_mha_fwd_bf16_kernel: {smem['fwd']} bytes a block, "
          f"{f_rows} query rows, {flash16.flash_mha_fwd_bf16_key_tile()}-key "
          f"tiles, {flash16.flash_mha_fwd_bf16_stages()} ring stages; "
          f"{f_threads} threads a block: a producer warpgroup at "
          f"{f_producer} registers a thread and {f_consumers} consumer "
          f"warpgroups at {f_consumer} (setmaxnreg: {f_asked} a block), each "
          f"consumer {f_rows // f_consumers} of the rows and every streamed "
          f"tile")
    print(f"  flash_mha_bwd_dq_bf16_kernel: {smem['dq']} bytes, "
          f"{bwd16.flash_mha_bwd_dq_bf16_stages()} ring stages; "
          f"flash_mha_bwd_dkv_bf16_kernel: {smem['dkv']} bytes, "
          f"{bwd16.flash_mha_bwd_dkv_bf16_stages()} ring stages; "
          f"{bwd16.flash_mha_bwd_bf16_block_rows()} resident rows, "
          f"{bwd16.flash_mha_bwd_bf16_stream_tile()}-row streamed tiles; "
          f"{threads} threads a block: a producer warpgroup at {producer} "
          f"registers a thread and {consumers} consumer warpgroups at "
          f"{consumer} (setmaxnreg: {asked} a block)")
    print(f"  ptxas allocates {launch_regs} registers a thread at launch")
    # One block an SM (shared memory and registers), so a launch's blocks
    # run in waves of one block per SM.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = {k: min(233472 // (v + 1024), 65536 // (threads * max(
        launch_regs.values(), default=1))) for k, v in smem.items()}
    for b, t, rows in fwd_timed_cases():
        blocks = b * 2 * math.ceil(t / f_rows)
        live = int((~flash_mask(t, rows)).any(-1).sum())  # rows with a key
        print(f"  bf16 forward at ({b}, 2, {t}, 128), {shown_rows(rows)}: "
              f"{blocks} blocks = {blocks / (sms * per_sm['fwd']):.2f} "
              f"waves, {live * 2 * math.ceil(t / f_rows)} of them with a "
              f"live key tile ({per_sm['fwd']} a SM, {sms} SMs)")
    for b, t, lens in bwd_timed_cases():
        dq_blocks = b * 2 * math.ceil(t / 64)
        live = 2 * sum(math.ceil(n / 64) for n in lens)
        print(f"  bf16 backward at ({b}, 2, {t}, 128), key lengths "
              f"{lens if b <= 4 else f'{min(lens)}..{max(lens)}'}: dQ "
              f"{dq_blocks} blocks = {dq_blocks / (sms * per_sm['dq']):.2f} "
              f"waves, dK/dV {live} live of {dq_blocks} blocks = "
              f"{live / (sms * per_sm['dkv']):.2f} waves ({per_sm} a SM, "
              f"{sms} SMs)")
    smoke.check(bool(libs), "CUDA sources built")
    for k, (n_threads, n_asked, _) in split.items():
        smoke.check(launch_regs.get(k, 0) * n_threads >= n_asked,
                    f"{k}: {launch_regs.get(k)} registers a thread at launch "
                    f"x {n_threads} threads hold the {n_asked} its setmaxnreg "
                    f"split asks for")
    for k in TC_KERNELS:
        smoke.check(entries[k] > 0 and clean[k] == entries[k],
                    f"{k}: {clean[k]} of {entries[k]} instantiations "
                    f"without spills")
    smoke.check(not serialized, f"no serialized wgmma ({len(serialized)} "
                                f"ptxas warnings)")
    return libs


def random_resblock(c: int, k: int, gen, device, dtype):
    import torch

    bound = 1.0 / math.sqrt(c * k)
    weights = []
    for _ in range(2 * len(DILATIONS)):
        w = (torch.rand(c, c, k, generator=gen) * 2 - 1) * bound
        b = (torch.rand(c, generator=gen) * 2 - 1) * bound
        weights.append((w.to(device, dtype), b.to(device, dtype)))
    return weights


def mrf_counts() -> tuple[int, int]:
    """Launches of the MRF tensor-core (bf16) and CUDA-core (f32) kernels."""
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    return mrf.tc_launch_count, mrf.fma_launch_count


def reset_mrf_counts() -> None:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    mrf.launch_count = mrf.tc_launch_count = mrf.fma_launch_count = 0


def phase_kernel_vs_plain(smoke: Smoke, device, shapes, batch,
                          float64: bool = True,
                          kernel_sizes=KERNEL_SIZES):
    """The MRF kernels against their plain version at (batch, T, C) for each
    (C, T) of ``shapes`` and K of ``kernel_sizes``; with ``float64``,
    float32 also against float64. Returns the worst max|diff| of the bf16
    (tensor-core) kernel and of the float32 (CUDA-core) kernel against
    their plain versions."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    gen = torch.Generator().manual_seed(0)
    worst = worst_f32 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for c, t in shapes:
            x32 = torch.randn(batch, t, c, generator=gen)
            for k in kernel_sizes:
                weights = random_resblock(c, k, gen, device, dtype)
                x = x32.to(device, dtype)
                tc0, fma0 = mrf_counts()
                out = mrf.mrf_resblock(x, weights, k, DILATIONS)
                tc, fma = (n - n0 for n, n0 in zip(mrf_counts(), (tc0, fma0)))
                ref = mrf.mrf_resblock_plain(x, weights, k, DILATIONS)
                diff = (out.float() - ref.float()).abs().max().item()  # syncs
                if bf16:
                    bound = BF16_REL_BOUND * ref.float().abs().max().item()
                    worst = max(worst, diff)
                else:
                    bound = F32_BOUND
                    worst_f32 = max(worst_f32, diff)
                smoke.check(
                    out.shape == ref.shape and math.isfinite(diff)
                    and diff <= bound
                    and (tc, fma) == ((6, 0) if bf16 else (0, 6)),
                    f"{str(dtype)[6:]:8s} B={batch} C={c:3d} T={t:7d} "
                    f"k={k:2d} max|diff|={diff:.3e} bound={bound:.3e}; "
                    f"launches tensor-core {tc}, CUDA-core {fma}")
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
    return worst, worst_f32


# A width the kernels are not built for (C % 32 != 0, K = 5, as the JAX
# package's vocoder tests and the port's streaming test use): the wrapper
# pads it to C = 32, K = 7.
PADDED_SHAPE = (16, 5, 2, 300)  # C, K, B, T


def phase_mrf_vs_plain(smoke: Smoke, device):
    """Phase 2: the stage shapes and the ragged shape, then one padded
    width in both dtypes, and the kernel's refusal of a gradient."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    worst, worst_f32 = phase_kernel_vs_plain(
        smoke, device, STAGE_SHAPES + (RAGGED_SHAPE,), BATCH,
        kernel_sizes=PHASE2_KERNEL_SIZES)
    c, k, b, t = PADDED_SHAPE
    gen = torch.Generator().manual_seed(7)
    x32 = torch.randn(b, t, c, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        weights = random_resblock(c, k, gen, device, dtype)
        x = x32.to(device, dtype)
        counts = mrf_counts()
        out = mrf.mrf_resblock(x, weights, k, DILATIONS)
        tc, fma = (n - n0 for n, n0 in zip(mrf_counts(), counts))
        ref = mrf.mrf_resblock_plain(x, weights, k, DILATIONS)
        diff = (out.float() - ref.float()).abs().max().item()
        bf16 = dtype == torch.bfloat16
        bound = (BF16_REL_BOUND * ref.float().abs().max().item() if bf16
                 else F32_BOUND)
        smoke.check(out.shape == ref.shape and diff <= bound
                    and (tc, fma) == ((6, 0) if bf16 else (0, 6)),
                    f"{str(dtype)[6:]:8s} B={b} C={c} T={t} k={k} (padded to "
                    f"C=32, k=7): max|diff|={diff:.3e} bound={bound:.3e}; "
                    f"launches tensor-core {tc}, CUDA-core {fma}")
    try:
        mrf.mrf_resblock(x.requires_grad_(), weights, k, DILATIONS)
        raised = False
    except RuntimeError:
        raised = True
    smoke.check(raised, "mrf_resblock raises on the card when a gradient is "
                        "wanted (the kernel has no backward)")
    return worst, worst_f32


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
    worst = (0.0, 0.0)
    for batch, frames in ((BATCH, LONG_MAX_MEL), (1, window)):
        worst = tuple(map(max, worst, phase_kernel_vs_plain(
            smoke, device, stage_shapes(frames), batch,
            float64=batch == 1)))
    return worst


def flash_mask(t: int, rows):
    """(B, T) bool key mask, True at padding; a row is the [start, stop)
    spans of its valid keys."""
    import torch

    mask = torch.ones(len(rows), t, dtype=torch.bool)
    for i, row in enumerate(rows):
        for start, stop in row:
            mask[i, start:stop] = False
    return mask


def flash_inputs(b: int, t: int, rows, gen):
    """(B, 2, T, 128) float32 q, k, v and the (B, T) key mask on the card."""
    import torch

    q, k, v = (torch.randn(b, 2, t, 128, generator=gen).to("cuda")
               for _ in range(3))
    return q, k, v, flash_mask(t, rows).to("cuda")


def phase_flash_vs_plain(smoke: Smoke):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    gen = torch.Generator().manual_seed(2)
    scale = 128 ** -0.5
    worst = 0.0
    for b, t, rows in FLASH_CASES:
        q, k, v, mask = flash_inputs(b, t, rows, gen)
        out = fa.flash_mha(q, k, v, mask, scale)
        ref = fa.flash_mha_plain(q, k, v, mask, scale)
        diff = (out - ref).abs().max().item()  # syncs
        bound = FLASH_REL_BOUND * ref.abs().max().item()
        worst = max(worst, diff)
        smoke.check(out.shape == ref.shape and math.isfinite(diff)
                    and diff <= bound,
                    f"float32 B={b} T={t:5d} rows={rows}: "
                    f"max|diff|={diff:.3e} bound={bound:.3e}")
        ref64 = fa.flash_mha_plain(q.double(), k.double(), v.double(), mask,
                                   scale)
        diff64 = (out.double() - ref64).abs().max().item()
        smoke.check(diff64 <= bound, f"float32 kernel vs float64 plain: "
                                     f"max|diff|={diff64:.3e}")
        for i in range(b):
            if bool(mask[i].all()):
                nonzero = torch.count_nonzero(out[i]).item()
                smoke.check(nonzero == 0, f"row {i}, no valid key: "
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
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    cfg = Config()
    fs2, voc = seeded_states(cfg)
    synth = Synthesizer(cfg, fs2, voc, emotion_maps=EMOTION_MAPS,
                        device=device)
    speakers = list(range(len(texts)))
    n_resblocks = len(synth.vocoder.resblocks)
    per_call = 2 * len(DILATIONS) * n_resblocks

    reset_mrf_counts()
    fa.launch_count = 0
    results = synth.synthesize(texts, speakers, emotions, vocoder="hifigan")
    launches, fma_launches = mrf_counts()
    smoke.check(fa.launch_count == 0,
                f"flash launches on this path: {fa.launch_count} (every "
                f"sequence is under 2048 frames: the math path)")
    for r in results:
        ok = (r.mel.ndim == 2 and r.mel.shape[0] > 0 and r.wav.size > 0
              and bool(np.isfinite(r.mel).all())
              and bool(np.isfinite(r.wav).all()))
        smoke.check(ok, f"{r.basename}: mel {r.mel.shape}, wav "
                        f"{r.wav.shape}, finite and non-empty")
    smoke.check(launches == per_call and fma_launches == 0,
                f"MRF launches in one bf16 generator call: tensor-core "
                f"kernel {launches} (expected {per_call}), CUDA-core kernel "
                f"{fma_launches} (expected 0)")

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
        reset_mrf_counts()
        runs.append(s.synthesize(texts[:1], [0], emotions[:1],
                                 vocoder="hifigan")[0])
        if dev == device:
            f32_counts = mrf_counts()
    smoke.check(f32_counts == (0, per_call),
                f"MRF launches in one float32 generator call: tensor-core "
                f"kernel {f32_counts[0]} (expected 0), CUDA-core kernel "
                f"{f32_counts[1]} (expected {per_call})")
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
    return synth, launches, f32_counts[1]


def phase_long_form(smoke: Smoke, device, synth):
    """The long-form path on the bf16 synthesizer of phase 3; returns the
    flash launches of its batch synthesis."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    speakers = list(range(len(LONG_TEXTS)))
    n_dec = synth.cfg.model.transformer.decoder_layer
    per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
    kwargs = dict(duration_control=LONG_DURATION_CONTROL,
                  max_mel_len=LONG_MAX_MEL)

    fa.launch_count = 0
    reset_mrf_counts()
    results = synth.synthesize(LONG_TEXTS, speakers, EMOTIONS,
                               vocoder="hifigan", **kwargs)
    flash_launches = fa.launch_count
    mrf_launches, fma_launches = mrf_counts()
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
    smoke.check(mrf_launches == per_call and fma_launches == 0,
                f"MRF launches in one bf16 generator call: tensor-core "
                f"kernel {mrf_launches} (expected {per_call}), CUDA-core "
                f"kernel {fma_launches} (expected 0)")

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
    # flash, and every resblock of every window through the MRF kernel of
    # the vocoder's dtype.
    windows = math.ceil(card.mel.shape[0] / STREAM_CHUNK)
    for s, name in ((card_synth, "float32"), (synth, "bfloat16")):
        fa.launch_count = 0
        reset_mrf_counts()
        chunks = list(s.synthesize_streaming(
            *(x[0] for x in one), chunk_frames=STREAM_CHUNK, **kwargs))
        tc, fma = mrf_counts()
        want = per_call * windows
        smoke.check(len(chunks) == windows
                    and fa.launch_count == n_dec
                    and (tc, fma) == ((0, want) if name == "float32"
                                      else (want, 0)),
                    f"{name} synthesize_streaming: {len(chunks)} chunks "
                    f"(expected {windows}), {fa.launch_count} flash launches"
                    f" (expected {n_dec}), MRF launches tensor-core {tc}, "
                    f"CUDA-core {fma} (expected {per_call} × {windows} "
                    f"windows on the {name} kernel)")
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


def resblock_bound_ms(b: int, t: int, c: int, k: int, elem_bytes: int = 2,
                      peak_flops: float = PEAK_BF16_FLOPS
                      ) -> tuple[float, str]:
    """Least time for one resblock: 6 convs of 2·k·C² flops per output
    element at ``peak_flops`` (bf16: the bf16 rate; float32: the TF32
    rate, the card's fastest float32 product), against reading x and the
    weights once and writing the output once, ``elem_bytes`` an element."""
    flops = 12 * k * c * c * t * b
    n_bytes = elem_bytes * (2 * b * t * c + 6 * (c * c * k + c))
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def six_launch_floor_ms(b: int, t: int, c: int, k: int) -> float:
    """Least time for one bf16 resblock run as six launches, as the port
    runs it: each conv pair moves the activation five times through device
    memory (x read, h written, h read, the residual read, out written), plus
    the weights once; the larger of that and the operations."""
    flops = 12 * k * c * c * t * b
    n_bytes = 2 * (15 * b * t * c + 6 * (c * c * k + c))
    return 1e3 * max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES)


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
              "bound_by_operations_ms": 0.0, "floor_ms": 0.0}
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
            floor = six_launch_floor_ms(BATCH, t, c, k)
            tflops = 12 * k * c * c * t * BATCH / ms / 1e9
            rows.append({"C": c, "T": t, "k": k, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": by, "floor_ms": floor, "tflops": tflops})
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound),
                           ("floor_ms", floor)):
                totals[key] += v
            if by == "operations":
                totals["bound_by_operations_ms"] += bound
            print(f"  mrf_resblock bf16 B={BATCH} C={c:3d} T={t:6d} k={k:2d}:"
                  f" kernel {ms:.4f} ms ({tflops:.1f} TF/s), plain "
                  f"{plain:.4f} ms, cuDNN chain {lib:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), six-launch floor {floor:.4f} ms",
                  flush=True)
        del x
    print("  resblock times: " + json.dumps(rows))
    flops = sum(12 * r["k"] * r["C"] ** 2 * r["T"] * BATCH for r in rows)
    print(f"  the 12 resblocks, bf16, B={BATCH} × 1000 frames: kernel "
          f"{totals['ms']:.3f} ms ({flops / totals['ms'] / 1e9:.1f} TF/s), "
          f"plain {totals['plain_ms']:.3f} ms, cuDNN chain "
          f"{totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms,"
          f" six-launch floor {totals['floor_ms']:.3f} ms "
          f"[{nvidia_smi_line()}]")
    totals["f32"] = f32_resblock_times(gen)
    return totals


def f32_resblock_times(gen) -> dict:
    """The float32 (CUDA-core) MRF kernel at the stage shapes, B = 4 × 1000
    frames, TF32 off: kernel, plain version, the cuDNN chain in float32
    (library_ms: the one library call of float32 accuracy), the bound (the
    operations at the TF32 rate against float32 bytes) and the operations
    at the float32 CUDA-core rate (the best this design can reach)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    assert not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bound_by_operations_ms": 0.0, "fp32_ops_ms": 0.0}
    rows = []
    for c, t in STAGE_SHAPES:
        x = torch.randn(BATCH, t, c, generator=gen).to("cuda")
        for k in KERNEL_SIZES:
            w = random_resblock(c, k, gen, torch.device("cuda"),
                                torch.float32)
            iters = 3
            ms = cuda_time_ms(lambda: mrf.mrf_resblock(x, w, k, DILATIONS),
                              iters)
            plain = cuda_time_ms(
                lambda: mrf.mrf_resblock_plain(x, w, k, DILATIONS), iters)
            lib = cuda_time_ms(lambda: library_resblock(x, w, k), iters)
            bound, by = resblock_bound_ms(BATCH, t, c, k, 4, PEAK_TF32_FLOPS)
            flops = 12 * k * c * c * t * BATCH
            fp32_ms = 1e3 * flops / PEAK_FP32_FLOPS
            rows.append({"C": c, "T": t, "k": k, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": by, "fp32_ops_ms": fp32_ms,
                         "tflops": flops / ms / 1e9})
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound),
                           ("fp32_ops_ms", fp32_ms)):
                totals[key] += v
            if by == "operations":
                totals["bound_by_operations_ms"] += bound
            print(f"  mrf_resblock f32 B={BATCH} C={c:3d} T={t:6d} k={k:2d}:"
                  f" kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TF/s), plain "
                  f"{plain:.4f} ms, cuDNN chain f32 {lib:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}, TF32 rate), at the FP32 CUDA-core "
                  f"rate {fp32_ms:.4f} ms", flush=True)
        del x
    print("  float32 resblock times: " + json.dumps(rows))
    flops = sum(12 * r["k"] * r["C"] ** 2 * r["T"] * BATCH for r in rows)
    print(f"  the 12 resblocks, float32, B={BATCH} × 1000 frames: kernel "
          f"{totals['ms']:.3f} ms ({flops / totals['ms'] / 1e9:.1f} TF/s), "
          f"plain {totals['plain_ms']:.3f} ms, cuDNN chain f32 "
          f"{totals['library_ms']:.3f} ms (kernel / cuDNN "
          f"{totals['ms'] / totals['library_ms']:.2f}×), bound "
          f"{totals['bound_ms']:.3f} ms (TF32 rate), {flops:.3e} flops at "
          f"the FP32 CUDA-core rate {totals['fp32_ops_ms']:.3f} ms "
          f"[{nvidia_smi_line()}]")
    return totals


def flash_bounds_ms(mask) -> dict:
    """Least times for float32 attention at H = 2, D = 128 on a (B, T) key
    mask, each the larger of operations at the TF32 tensor-core rate (the
    card's fastest for float32 inputs) and bytes at the memory rate:
    "tf32_dense", 4·B·H·T²·D flops against q, k, v read once and out
    written once; "tf32_live", the same over the key tiles with a valid key
    (the kernel skips the rest, neither reading nor multiplying them),
    which is this run's ``bound_ms``. For context, the kernel's own method
    takes three TF32 products per product at least (3xTF32; it takes four
    for S, three for P V): "x3_dense" and "x3_live". The tile width is the
    kernel's (``flash_mha_fwd_key_tile``)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    tile = build.load("flash_mha").flash_mha_fwd_key_tile()
    b, t = mask.shape
    n_tiles = math.ceil(t / tile)
    valid = torch.zeros(b, n_tiles * tile, dtype=torch.bool,
                        device=mask.device)
    valid[:, :t] = ~mask
    live = int(valid.view(b, n_tiles, tile).any(-1).sum())
    flops = 4 * b * 2 * t * t * 128
    flops_live = 4 * 2 * t * tile * live * 128
    n_bytes = 16 * b * 2 * t * 128 + b * t
    live_bytes = 4 * 2 * 128 * (2 * b * t + 2 * tile * live) + b * t

    def bound(ops, nb):
        return 1e3 * max(ops / PEAK_TF32_FLOPS, nb / PEAK_BYTES)

    return {"tf32_dense": bound(flops, n_bytes),
            "tf32_live": bound(flops_live, live_bytes),
            "x3_dense": bound(3 * flops, n_bytes),
            "x3_live": bound(3 * flops_live, live_bytes),
            "bound_by": ("operations" if flops_live / PEAK_TF32_FLOPS
                         >= live_bytes / PEAK_BYTES else "bytes"),
            "live_tiles": live, "tiles": b * n_tiles, "tile": tile,
            "flops_live": flops_live}


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

    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator().manual_seed(3)
    scale = 128 ** -0.5
    rows = {}
    for b, t, case_rows in FLASH_CASES:
        if t not in FLASH_TIMED:
            continue
        q, k, v, mask = flash_inputs(b, t, case_rows, gen)
        keep = ~mask[:, None, None, :]  # SDPA's boolean mask: True = attend

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                  scale=scale)

        iters = 10
        ms = cuda_time_ms(lambda: fa.flash_mha(q, k, v, mask, scale), iters)
        plain = cuda_time_ms(
            lambda: fa.flash_mha_plain(q, k, v, mask, scale), iters)
        lib = cuda_time_ms(sdpa, iters)
        # Which backend SDPA took: the one whose time, when forced, is the
        # default's (float32 with a boolean mask rules out flash and cuDNN).
        forced = {}
        for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                              ("math", SDPBackend.MATH)):
            with sdpa_kernel(backend):
                forced[name] = cuda_time_ms(sdpa, iters)
        ran = min(forced, key=lambda n: abs(forced[n] - lib))
        bd = flash_bounds_ms(mask)
        rows[t] = {"shape": f"({b}, 2, {t}, 128) float32, valid keys "
                            f"{case_rows}",
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bd["tf32_live"], "bound_by": bd["bound_by"]}
        print(f"  flash_mha float32 (B, H, T, D) = ({b}, 2, {t}, 128), valid "
              f"keys {case_rows}: kernel {ms:.4f} ms "
              f"({bd['flops_live'] / ms / 1e9:.1f} TF/s over the "
              f"{bd['live_tiles']} of {bd['tiles']} live {bd['tile']}-key "
              f"tiles); bounds (TF32 rate) {bd['tf32_live']:.4f} ms over the "
              f"live tiles, {bd['tf32_dense']:.4f} ms dense; at three TF32 "
              f"products a product (3xTF32) {bd['x3_live']:.4f} ms live, "
              f"{bd['x3_dense']:.4f} ms dense; plain {plain:.4f} ms; SDPA "
              f"{lib:.4f} ms "
              f"(forced: efficient {forced['efficient']:.4f} ms, math "
              f"{forced['math']:.4f} ms; the {ran} backend ran) "
              f"[{nvidia_smi_line()}]", flush=True)
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
    for b, t, rows in FLASH_BWD_CASES:
        q, k, v, mask = flash_inputs(b, t, rows, gen)
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
            plain64 = (r.double() - r64).abs().max().item()
            bound = FLASH_BWD_REL_BOUND * r.abs().max().item()
            # Against float64 the float32 cancellation in dP - Δ shows (on a
            # row with one valid key dk is 0 in exact arithmetic, so both
            # float32 versions hold round-off there): the kernel must be at
            # least as accurate as float32 plain, within twice its distance
            # to float64 and 1e-6 of the gradient's magnitude.
            bound64 = 2 * plain64 + 1e-6 * r64.abs().max().item()
            # Where float32 plain is itself further than the bound from
            # float64 (that round-off, summed over thousands of queries,
            # at T = 4096), no float32 kernel whose round-off is its own
            # can be within the bound of it: the kernel is then held to
            # the same bound against float64.
            ref_ok = plain64 <= bound
            near = diff <= bound if ref_ok else diff64 <= bound
            if name == "dq":
                worst_dq = max(worst_dq, diff)
            else:
                worst_dkv = max(worst_dkv, diff)
            note = "" if ref_ok else (" (float32 plain is off by more than "
                                      "the bound: held against float64)")
            smoke.check(math.isfinite(diff) and near and diff64 <= bound64,
                        f"{name} B={b} T={t:5d} rows={rows}: "
                        f"max|diff|={diff:.3e} bound={bound:.3e}{note}; "
                        f"float64 plain: max|diff|={diff64:.3e} "
                        f"bound={bound64:.3e} (float32 plain's {plain64:.3e})")
        lse_ref = fa.flash_mha_lse_plain(q, k, mask, scale)
        finite = torch.isfinite(lse_ref)
        lse_diff = (lse - lse_ref)[finite].abs().max().item()
        lse_bound = LSE_REL_BOUND * lse_ref[finite].abs().max().item()
        smoke.check(lse_diff <= lse_bound
                    and torch.equal(torch.isposinf(lse), ~finite),
                    f"lse B={b} T={t:5d}: max|diff|={lse_diff:.3e} "
                    f"bound={lse_bound:.3e}, +inf exactly at the rows with "
                    f"no valid key")
        for i in range(b):
            if bool(mask[i].all()):  # no valid key
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
        sample_dir = os.path.join(tmp, "out/result/train_samples")
        samples = os.listdir(sample_dir)
        # The first val utterance's predicted and ground-truth audio,
        # through the sample vocoder (Griffin-Lim on the card), where the
        # prediction is longer than 4 frames.
        wavs = sorted(
            f"step{n}_{kind}.wav" for n in (10, 20)
            for kind in ("predicted", "reconstructed")
            if np.load(os.path.join(sample_dir,
                                    f"step{n}_mel_lens.npy"))[0] > 4)
        smoke.check(ckpt.steps() == [10, 20]
                    and sorted(samples) == sorted(
                        wavs + [f"step{n}_{kind}.npy" for n in (10, 20)
                                for kind in ("mel", "mel_lens")]),
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
    """A (B, S, T)-bucket training batch of numpy arrays; the rows' lengths
    repeat in fours (the bucket's, 7/8, 3/4 and 1/2 of it)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src_lens = np.array([[s, s - s // 8, s - s // 4, s // 2][i % 4]
                         for i in range(b)], np.int32)
    mel_lens = np.array([[t, t - t // 10, t - t // 4, t // 2][i % 4]
                         for i in range(b)], np.int32)
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


def flash_bwd_bounds_ms(mask, kernel: str) -> dict:
    """Least times for a backward kernel at H = 2, D = 128 on a (B, T) key
    mask, float32, each the larger of operations at the TF32 tensor-core
    rate (as the forward's bound) and bytes at the memory rate: the dQ
    kernel recomputes S and dP and forms dq (6·H·D flops per query row and
    key) from q, out, dO, lse and the live keys' k, v, writing dq and Δ;
    the dK/dV kernel recomputes S and dP and forms dk and dv (8·H·D) from
    q, dO, lse, Δ and the live keys' k, v, writing dk and dv;
    ``kernel="both"`` is the whole backward, 10·H·D (S, dP, dq, dk, dv),
    reading q, out, dO and the live k, v, writing dq, dk, dv. "live" counts
    the 32-key tiles with a valid key (a padded key adds nothing), which is
    this run's ``bound_ms``; "dense" every key."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    tile = build.load("flash_mha_bwd").flash_mha_bwd_stream_tile()
    b, t = mask.shape
    n_tiles = math.ceil(t / tile)
    valid = torch.zeros(b, n_tiles * tile, dtype=torch.bool,
                        device=mask.device)
    valid[:, :t] = ~mask
    live = int(valid.view(b, n_tiles, tile).any(-1).sum())
    per = {"dq": 6, "dkv": 8, "both": 10}[kernel]
    # Full-size tensors read and written (q, out, dO; dq, dk, dv; float32
    # each) besides k and v over the keys counted; lse, Δ; the mask.
    full = {"dq": 4, "dkv": 4, "both": 6}[kernel]
    rows = {"dq": 2, "dkv": 3, "both": 2}[kernel]  # lse, Δ read or written

    def bound(keys):
        flops = per * 2 * t * keys * 128
        n_bytes = (4 * 2 * 128 * (full * b * t + 2 * keys)
                   + 4 * 2 * rows * b * t + b * t)
        t_ops, t_bytes = flops / PEAK_TF32_FLOPS, n_bytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    live_ms, by = bound(tile * live)
    return {"live": live_ms, "bound_by": by, "dense": bound(b * t)[0],
            "live_tiles": live, "tiles": b * n_tiles, "tile": tile}


def time_train_steps(configs: dict, batch, device) -> dict:
    """Each configuration's train step on ``batch``: 3 warm-ups, then 10
    rounds with the configurations in turns, each step synchronized. Per
    configuration: the step times in ms, the peak memory in MiB, and the
    last step's flash launches (bf16 forward, dQ, dK/dV; float32 forward,
    dQ, dK/dV) and loss."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        train_step,
    )

    runs = {}
    for key, cfg in configs.items():
        state = create_train_state(cfg, None, device)
        for _ in range(3):
            train_step(state, batch, cfg)
        runs[key] = {"cfg": cfg, "state": state, "ms": [], "peak": 0.0}
    for _ in range(10):
        for run in runs.values():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_flash_counts()
            reset_bf16_counts()
            t0 = time.perf_counter()
            report = train_step(run["state"], batch, run["cfg"])
            torch.cuda.synchronize()
            run["ms"].append(1e3 * (time.perf_counter() - t0))
            run["peak"] = max(run["peak"],
                              torch.cuda.max_memory_allocated() / 2**20)
            run["counts"] = bf16_counts() + flash_counts()
            run["loss"] = float(report.total)
    for run in runs.values():
        del run["state"]
    return runs


def phase_train_times(device):
    """Train-step times under "flash" and "auto" at the bucket (128, 1000),
    and the backward kernels at (4, 2, T, 128); returns the kernels' rows
    at the training bucket's T = 1000."""
    import torch
    import torch.nn.functional as F

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )

    card = nvidia_smi_line()
    b, s, t = TRAIN_TIMED
    batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
    runs = time_train_steps({impl: C.Config(model=C.ModelConfig(
        transformer=C.TransformerConfig(attention_impl=impl)))
        for impl in ("flash", "auto")}, batch, device)
    for impl, run in runs.items():
        reps, counts, loss = sorted(run["ms"]), run["counts"][3:], run["loss"]
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
        q, k, v, mask = flash_inputs(4, t, prefixes(*lens), gen)
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
        both = flash_bwd_bounds_ms(mask, "both")
        bd = {}
        for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            bd[name] = flash_bwd_bounds_ms(mask, name)
            rows[(name, t)] = {"shape": f"(4, 2, {t}, 128) float32, key "
                                        f"lengths {lens}",
                               "ms": ms, "plain_ms": plain,
                               "bound_ms": bd[name]["live"],
                               "bound_by": bd[name]["bound_by"],
                               "library_ms": lib}
        # The kernels' own work: S and dP in both, dq, dk, dv once (14·H·D
        # flops per query row and live key).
        flops = 14 * 2 * t * both["tile"] * both["live_tiles"] * 128
        print(f"  flash_mha backward float32 (4, 2, {t}, 128), key lengths "
              f"{lens} ({both['live_tiles']} of {both['tiles']} "
              f"{both['tile']}-key tiles live): dQ kernel {dq_ms:.4f} ms "
              f"(bound {bd['dq']['live']:.4f} live, {bd['dq']['dense']:.4f} "
              f"dense), dK/dV kernel {dkv_ms:.4f} ms (bound "
              f"{bd['dkv']['live']:.4f} live, {bd['dkv']['dense']:.4f} "
              f"dense), together {dq_ms + dkv_ms:.4f} ms = "
              f"{flops / (dq_ms + dkv_ms) / 1e9:.1f} TF/s over the live "
              f"tiles; whole-backward bound {both['live']:.4f} ms live, "
              f"{both['dense']:.4f} dense ({both['bound_by']}; TF32 rate); "
              f"plain backward {plain:.4f} ms; SDPA backward {lib:.4f} ms "
              f"[{card}]", flush=True)
        del q, k, v, mask, dout, out, lse, delta, qs, ks, vs, o
    return {name: rows[(name, min(FLASH_BWD_TIMED))] for name in ("dq", "dkv")}


# ---------------------------------------------------------------------------
# Phase 7: DSP, Griffin-Lim and MelGAN on the card.

SIGNAL_SECONDS = (2.0, 3.5, 5.0, 8.0)
SR = 22050
DSP_MEL_ATOL = 1e-4        # cuFFT against the CPU's FFT, log-mel
DSP_ENERGY_RTOL = 1e-5
ISTFT_ATOL = 1e-3          # tests/test_dsp.py's round-trip bound
# Griffin-Lim, card against CPU from the same initial phase: 60 rounds of
# rFFT → angle → iSTFT on FastSpeech2 mels that themselves differ by
# float32 round-off; bound on max|diff| / peak.
GRIFFIN_LIM_REL_BOUND = 1e-3
MELGAN_F32_BOUND = 1e-4


def harmonic_signal(seconds: float, rng, sr: int = SR):
    """Five harmonics of a 120-300 Hz fundamental with 5 Hz vibrato, plus
    noise, at ``sr`` (22050 Hz), peak at most 0.9."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(120.0, 300.0)
    phase = 2 * np.pi * np.cumsum(
        f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / sr
    sig = sum(rng.uniform(0.1, 0.4) / h * np.sin(h * phase + rng.uniform(
        0, 2 * np.pi)) for h in range(1, 6))
    sig = sig + 0.01 * rng.standard_normal(len(t))
    return (0.9 * sig / np.abs(sig).max()).astype(np.float32)


# Griffin-Lim's iterations at which phase 7 prints the card-vs-CPU distance.
GL_TRACE_AT = (0, 1, 2, 5, 10, 20, 30, 40, 50, 60)


def griffin_lim_trace(stfts, mels, lens, n_iters: int = 60):
    """Per round of Griffin-Lim (index 0: the first iSTFT), for each row j,
    max|a - b| / peak(b) over the row's first lens[j] samples, between two
    runs of ``MelSTFT.griffin_lim``'s loop: run i on ``stfts[i]``'s device
    from the (B, T', 80) log-mels ``mels[i]``, both from the same initial
    phase (CPU seed 0 over the batch, as ``mel_to_audio`` draws it)."""
    import torch

    signals, mags = [], []
    phase = None
    for stft, mel in zip(stfts, mels):
        dev = stft.window.device
        mag = torch.clamp(torch.exp(mel.float().to(dev)) @ stft.mel_pinv.T,
                          min=0.0)
        if phase is None:
            u = torch.rand(mag.shape,
                           generator=torch.Generator().manual_seed(0))
            phase = -math.pi + 2 * math.pi * u
        mags.append(mag)
        signals.append(stft.istft(mag, phase.to(dev)))
    trace = []
    for i in range(n_iters + 1):
        a, b = (x.cpu() for x in signals)
        trace.append([float((a[j, :n] - b[j, :n]).abs().max()
                            / b[j, :n].abs().max())
                      for j, n in enumerate(lens)])
        if i == n_iters:
            break
        for j, (stft, mag) in enumerate(zip(stfts, mags)):
            spec = torch.fft.rfft(stft.frame(signals[j]) * stft.window, dim=-1)
            signals[j] = stft.istft(mag, torch.angle(spec))
    return trace


def phase_dsp_vocoders(smoke: Smoke, device, texts, emotions):
    """Phase 7. Returns the times of Griffin-Lim and MelGAN."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.dsp import MelSTFT
    from expressive_fastspeech2_mandarin_tpu_torch.models import MelGAN
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    cfg = Config()
    pre = cfg.preprocess
    card = MelSTFT(pre.stft, pre.mel, SR, device)
    cpu = MelSTFT(pre.stft, pre.mel, SR)
    rng = np.random.default_rng(7)
    for seconds in SIGNAL_SECONDS:
        x = torch.from_numpy(harmonic_signal(seconds, rng))[None]
        mel_c, en_c = (a.cpu() for a in card.mel_energy(x.to(device)))
        mel_p, en_p = cpu.mel_energy(x)
        mel_diff = (mel_c - mel_p).abs().max().item()
        en_rel = ((en_c - en_p).abs() / en_p).max().item()
        smoke.check(mel_c.shape == mel_p.shape and mel_diff <= DSP_MEL_ATOL
                    and en_rel <= DSP_ENERGY_RTOL,
                    f"mel_energy of a {seconds} s signal, card vs CPU: "
                    f"{tuple(mel_c.shape)} log-mel max|diff|={mel_diff:.3e} "
                    f"(bound {DSP_MEL_ATOL:.0e}), energy max rel diff "
                    f"{en_rel:.3e} (bound {DSP_ENERGY_RTOL:.0e})")
        xc = x.to(device)
        spec = torch.fft.rfft(card.frame(xc) * card.window, dim=-1)
        back = card.istft(spec.abs(), torch.angle(spec))[0].cpu()
        n = back.shape[0]
        rt = (back[1024: n - 1024] - x[0, 1024: n - 1024]).abs().max().item()
        smoke.check(rt <= ISTFT_ATOL,
                    f"istft round trip on the card, {seconds} s: "
                    f"max|diff|={rt:.3e} (bound {ISTFT_ATOL:.0e})")

    # Griffin-Lim: the Synthesizer's default without HiFi-GAN weights, at
    # Config() width, card against CPU (the same initial phase: drawn on
    # the CPU from seed 0 in both).
    fs2, _ = seeded_states(cfg)
    torch.manual_seed(2)
    melgan = MelGAN().state_dict()
    speakers = list(range(len(texts)))
    synths, runs, gl_mels = {}, {}, {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        synths[name] = Synthesizer(cfg, fs2, emotion_maps=EMOTION_MAPS,
                                   device=dev, melgan_state=melgan)
        reset_mrf_counts()
        fa.launch_count = 0
        to_audio = synths[name].stft.mel_to_audio

        def keep_mel(mel, *args, name=name, to_audio=to_audio, **kwargs):
            gl_mels[name] = mel.cpu()  # the batch's padded log-mel
            return to_audio(mel, *args, **kwargs)

        synths[name].stft.mel_to_audio = keep_mel
        runs[name] = {v: synths[name].synthesize(
            texts, speakers, emotions, **({} if v == "default"
                                          else {"vocoder": v}))
            for v in ("default", "melgan")}
        synths[name].stft.mel_to_audio = to_audio
        if name == "card":
            smoke.check(mrf_counts() == (0, 0) and fa.launch_count == 0,
                        f"Griffin-Lim and MelGAN synthesis: MRF launches "
                        f"{mrf_counts()}, flash {fa.launch_count} (none "
                        f"expected)")
    worst_gl = 0.0
    for (c, p) in zip(runs["card"]["default"], runs["cpu"]["default"]):
        same = np.array_equal(c.durations, p.durations)
        peak = float(np.abs(p.wav).max())
        diff = (float(np.abs(c.wav - p.wav).max()) / peak
                if same and c.wav.shape == p.wav.shape else math.inf)
        worst_gl = max(worst_gl, diff)
        smoke.check(same and diff <= GRIFFIN_LIM_REL_BOUND
                    and float(np.abs(c.wav).max()) <= 0.95 + 1e-6
                    and np.isfinite(c.wav).all() and c.wav.size > 0,
                    f"{c.basename} Griffin-Lim (the default, 60 iterations) "
                    f"card vs CPU: {c.wav.shape} samples, peak "
                    f"{float(np.abs(c.wav).max()):.4f} (≤ 0.95), max|diff| / "
                    f"peak {diff:.3e} (bound {GRIFFIN_LIM_REL_BOUND:.0e})")
    # Where the card and the CPU part, round by round, over the batch the
    # Synthesizer vocoded (before its peak rescale): from each device's own
    # mels, from the same mels (the CPU's: FFT round-off alone), and on the
    # CPU alone from the mels moved by one float32 ulp (round-off without
    # the card); printed for the utterances of the largest and the
    # smallest distance.
    lens = [r.wav.shape[0] for r in runs["cpu"]["default"]]
    stfts = (synths["card"].stft, synths["cpu"].stft)
    mel_c, mel_p = gl_mels["card"], gl_mels["cpu"]
    traces = {
        "own mels": griffin_lim_trace(stfts, (mel_c, mel_p), lens),
        "same mels": griffin_lim_trace(stfts, (mel_p, mel_p), lens),
        "CPU, mels + 1 ulp": griffin_lim_trace(
            (stfts[1], stfts[1]), (torch.from_numpy(np.nextafter(
                mel_p.numpy(), np.float32(np.inf))), mel_p), lens)}
    gl = [(float(np.abs(c.wav - p.wav).max() / np.abs(p.wav).max()), i)
          for i, (c, p) in enumerate(zip(runs["card"]["default"],
                                         runs["cpu"]["default"]))]
    for dist, i in (max(gl), min(gl)):
        print(f"  {runs['cpu']['default'][i].basename} ({lens[i]} samples "
              f"of the {tuple(mel_p.shape)} batch; synthesize's distance "
              f"{dist:.3e}): Griffin-Lim max|diff| / peak after rounds "
              f"{list(GL_TRACE_AT)}: " + "; ".join(
                  f"{name} " + ", ".join(f"{tr[n][i]:.2e}"
                                         for n in GL_TRACE_AT)
                  for name, tr in traces.items())
              + f"; batch mels max|card - CPU| "
              f"{float((mel_c - mel_p).abs().max()):.2e}", flush=True)
    worst_mg = 0.0
    for (c, p) in zip(runs["card"]["melgan"], runs["cpu"]["melgan"]):
        diff = (float(np.abs(c.wav - p.wav).max())
                if c.wav.shape == p.wav.shape else math.inf)
        worst_mg = max(worst_mg, diff)
        smoke.check(diff <= MELGAN_F32_BOUND and c.wav.size > 0
                    and np.isfinite(c.wav).all(),
                    f"{c.basename} MelGAN (random weights, seed 2) float32 "
                    f"card vs CPU: {c.wav.shape} samples, max|diff|="
                    f"{diff:.3e} (bound {MELGAN_F32_BOUND:.0e})")

    # Times on the card: Griffin-Lim's 60 iterations and MelGAN on the
    # batch's padded mel (CUDA events), and the two synthesize calls (host
    # clock, synchronized).
    synth = synths["card"]
    card_line = nvidia_smi_line()
    mels = [r.mel for r in runs["card"]["default"]]
    mel = np.full((len(mels), max(m.shape[0] for m in mels), 80),
                  np.log(1e-5), np.float32)
    for i, m in enumerate(mels):
        mel[i, :m.shape[0]] = m
    mel = torch.from_numpy(mel).to(device)
    with torch.inference_mode():
        gl_ms = cuda_time_ms(lambda: synth.stft.mel_to_audio(mel, 60), 5)
        mg_ms = cuda_time_ms(lambda: synth.melgan(mel), 5)
    calls = {}
    for v in ("griffin_lim", "melgan"):
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            synth.synthesize(texts, speakers, emotions, vocoder=v)
            torch.cuda.synchronize()
            reps.append(1e3 * (time.perf_counter() - t0))
        calls[v] = sorted(reps)[2]
    print(f"  Griffin-Lim, 60 iterations on a {tuple(mel.shape)} mel: "
          f"{gl_ms:.3f} ms; MelGAN on it: {mg_ms:.3f} ms (CUDA events, 5 "
          f"runs); synthesize of {len(texts)} utterances, median of 5: "
          f"griffin_lim {calls['griffin_lim']:.3f} ms, melgan "
          f"{calls['melgan']:.3f} ms [{card_line}]", flush=True)
    return {"griffin_lim_ms": gl_ms, "melgan_ms": mg_ms,
            "worst_gl": worst_gl, "worst_melgan": worst_mg}


# ---------------------------------------------------------------------------
# Phase 8: HiFi-GAN GAN training at full width.

VOC_STEPS = 20
VOC_RESUME_TO = 22
N_VOC_WAVS = 24
VOC_CADENCE = dict(log_step=1, save_step=10, val_step=20)
VOC_STEP_BATCH = 2          # card against CPU, one step
VOC_TIMED_BATCH = 16
# One GAN step, float32 with TF32 off, card against CPU from one state and
# batch: the losses are sums of the same products in another order.
VOC_LOSS_REL_BOUND = 1e-5
# Each gradient, of its tensor's max|g|. Float32 holds this step's
# gradients only to ~1.5e-3 of their max: against the same step in float64
# on the card, the CPU's float32 step is 1.25e-3 off in its worst tensor,
# the card's 1.46e-3, the card's with cuDNN off 1.17e-3, each in another
# discriminator tensor (leaky-ReLU inputs within round-off of 0 change
# sides, as in phase 5; even the CPU's float64 step is 1.6e-4 from the
# card's). Phase 8 prints these distances beside the check, and holds the
# card's float32 step to within twice the CPU's distance from float64.
VOC_GRAD_REL_BOUND = 2e-3
# The exported generator in bf16: the MRF kernel path against the plain
# path (stock convs) on the same bf16 weights, and against float32 plain;
# max|diff| / peak.
VOC_BF16_REL_BOUND = 5e-2


def write_wav_corpus(root: str, seed: int) -> str:
    """``N_VOC_WAVS`` int16 WAVs of 1.5-4 s at 22050 Hz from a seed, in two
    speaker folders."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(seed)
    for i in range(N_VOC_WAVS):
        d = os.path.join(root, f"spk{i % 2}")
        os.makedirs(d, exist_ok=True)
        save_wav(os.path.join(d, f"utt{i:03d}.wav"),
                 harmonic_signal(rng.uniform(1.5, 4.0), rng), SR)
    return root


def vocoder_config(batch: int, amp: str = "float32"):
    import dataclasses

    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    return C.Config(vocoder_train=dataclasses.replace(
        C.VocoderTrainConfig(), batch_size=batch, amp_dtype=amp,
        **VOC_CADENCE))


def phase_vocoder_training(smoke: Smoke, device, texts, emotions):
    """Phase 8. Returns the MRF launches of the exported generator's
    synthesize call."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.interop import (
        load_vocoder_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.models import Generator
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    cfg = vocoder_config(VOC_TIMED_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        wavs = tv.load_corpus_wavs(write_wav_corpus(
            os.path.join(tmp, "wavs"), 3), SR)
        out = os.path.join(tmp, "voc")
        reset_mrf_counts()
        t0 = time.perf_counter()
        state = tv.train_vocoder(cfg, wavs, out, total_steps=VOC_STEPS,
                                 device=device, log=lambda *_: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = mrf.launch_count
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r for r in records if "mel_l1" in r]
        vals = [r for r in records if "val_mel_l1" in r]
        mel = [r["mel_l1"] for r in losses]
        n_params = sum(p.numel() for p in state.gen.parameters())
        d_params = sum(p.numel() for m in (state.mpd, state.msd)
                       for p in m.parameters())
        smoke.check(len(wavs) == N_VOC_WAVS and state.step == VOC_STEPS
                    and [r["step"] for r in losses] == list(range(
                        1, VOC_STEPS + 1))
                    and all(math.isfinite(r[k]) for r in losses
                            for k in ("gen_total", "disc", "mel_l1", "fm",
                                      "adv"))
                    and launches == 0,
                    f"train_vocoder: {VOC_STEPS} steps at batch "
                    f"{VOC_TIMED_BATCH}, segment "
                    f"{cfg.vocoder_train.segment_size}, generator "
                    f"{n_params / 1e6:.2f}M and discriminators "
                    f"{d_params / 1e6:.2f}M parameters, in {seconds:.1f} s; "
                    f"all losses finite; MRF launches {launches} (the plain "
                    f"generator)")
        first, last = float(np.mean(mel[:5])), float(np.mean(mel[-5:]))
        smoke.check(last < first,
                    f"mel L1, mean of the first 5 steps {first:.4f}, of the "
                    f"last 5 {last:.4f}; every step {[round(m, 4) for m in mel]}")
        smoke.check([r["step"] for r in vals] == [VOC_STEPS]
                    and math.isfinite(vals[0]["val_mel_l1"]),
                    f"val records {vals}")
        steps = sorted(int(n[:-3]) for n in os.listdir(
            os.path.join(out, "ckpt")) if n.endswith(".pt"))
        resumed = tv.train_vocoder(cfg, wavs, out, total_steps=VOC_RESUME_TO,
                                   device=device, log=lambda *_: None)
        p0 = next(resumed.gen.parameters())
        lr = resumed.opt_g.param_groups[0]["lr"]
        smoke.check(steps == [10, 20] and resumed.step == VOC_RESUME_TO
                    and int(resumed.opt_g.state[p0]["step"]) == VOC_RESUME_TO
                    and lr == tv.vocoder_lr(cfg, VOC_RESUME_TO - 1),
                    f"checkpoints at {steps}; resumed to step "
                    f"{resumed.step}, AdamW updates "
                    f"{int(resumed.opt_g.state[p0]['step'])}, last lr "
                    f"{lr:.6e}")
        del state, resumed
        npz = os.path.join(out, "generator.npz")

        # The exported generator, bf16, through the Synthesizer: every
        # resblock on the MRF tensor-core kernel.
        fs2, _ = seeded_states(cfg)
        synth = Synthesizer(cfg, fs2, load_vocoder_state(npz),
                            emotion_maps=EMOTION_MAPS, device=device)
        speakers = list(range(len(texts)))
        per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
        reset_mrf_counts()
        results = synth.synthesize(texts, speakers, emotions)
        tc, fma = mrf_counts()
        smoke.check((tc, fma) == (per_call, 0)
                    and all(np.isfinite(r.wav).all() and r.wav.size > 0
                            for r in results),
                    f"generator.npz in the Synthesizer (bf16): MRF launches "
                    f"tensor-core {tc}, CUDA-core {fma} (expected "
                    f"{per_call}, 0); waveforms finite")
        mel_b = torch.from_numpy(results[0].mel)[None].to(device)
        gen32 = Generator(cfg.model.vocoder)
        gen32.load_state_dict(load_vocoder_state(npz))
        gen32 = gen32.to(device).eval()
        with torch.inference_mode():
            kernel = synth.vocoder(mel_b.bfloat16()).float()
            plain16 = synth.vocoder(mel_b.bfloat16(), fast=False).float()
            plain32 = gen32(mel_b, fast=False)
        peak = plain32.abs().max().item()
        d16 = (kernel - plain16).abs().max().item() / peak
        d32 = (kernel - plain32).abs().max().item() / peak
        smoke.check(d16 <= VOC_BF16_REL_BOUND and d32 <= VOC_BF16_REL_BOUND,
                    f"trained generator, bf16 kernel path vs plain on the "
                    f"card: max|diff| / peak {d16:.3e} against bf16 plain, "
                    f"{d32:.3e} against float32 plain (bound "
                    f"{VOC_BF16_REL_BOUND:.0e}; peak {peak:.4f})")
        del synth, gen32

        # One GAN step from one state and batch, card against CPU.
        cfg2 = vocoder_config(VOC_STEP_BATCH)
        batch = torch.from_numpy(tv.SegmentSampler(cfg2, wavs, seed=11)
                                 .sample(VOC_STEP_BATCH))
        # The CPU's and the card's float32 step, and as yardsticks the
        # card's step in float64 and in float32 with cuDNN off.
        runs = (("cpu", "cpu", torch.float32, True),
                ("card", device, torch.float32, True),
                ("card float64", device, torch.float64, True),
                ("card cuDNN off", device, torch.float32, False))
        states, reports = {}, {}
        for name, dev, dtype, cudnn in runs:
            st = tv.init_vocoder_train_state(cfg2, torch.device(dev))
            if dtype == torch.float64:
                for m in (st.gen, st.mpd, st.msd):
                    m.double()
                st.opt_g, st.opt_d = tv.make_vocoder_optimizers(
                    cfg2, st.gen, st.mpd, st.msd)
            if name != "cpu":
                tv.load_vocoder_checkpoint(st, ckpt0)
            else:
                ckpt0 = tv.vocoder_checkpoint(st)
                ckpt0 = {k: ({n: (t.clone() if torch.is_tensor(t) else t)
                              for n, t in v.items()}
                             if k in ("gen", "mpd", "msd") else v)
                         for k, v in ckpt0.items()}
            torch.backends.cudnn.enabled = cudnn
            t0 = time.perf_counter()
            reports[name] = tv.make_vocoder_train_step(
                cfg2, torch.device(dev))(st, batch.to(dev, dtype)).as_dict()
            torch.backends.cudnn.enabled = True
            print(f"  one GAN step, batch {VOC_STEP_BATCH}, {name}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            states[name] = st
    worst_loss = max(abs(reports["card"][k] - reports["cpu"][k])
                     / abs(reports["cpu"][k]) for k in reports["cpu"])
    smoke.check(worst_loss <= VOC_LOSS_REL_BOUND,
                f"one GAN step card vs CPU, losses {reports['card']} vs "
                f"{reports['cpu']}: worst rel diff {worst_loss:.2e} (bound "
                f"{VOC_LOSS_REL_BOUND:.0e})")
    grads = {name: {f"{part}.{n}": p.grad.double().cpu()
                    for part in ("gen", "mpd", "msd")
                    for n, p in getattr(st, part).named_parameters()}
             for name, st in states.items()}

    def worst(a: str, b: str) -> tuple[float, str]:
        """The largest max|g_a - g_b| / max|g_b| over the tensors."""
        return max((((grads[a][k] - grads[b][k]).abs().max()
                     / grads[b][k].abs().max()).item(), k)
                   for k in grads[b])

    ratio, name = worst("card", "cpu")
    smoke.check(ratio <= VOC_GRAD_REL_BOUND,
                f"gradients card vs CPU: worst max|diff| / max|g| "
                f"{ratio:.2e} ({name}), bound {VOC_GRAD_REL_BOUND:.0e}")
    to64 = {a: worst(a, "card float64") for a in ("card", "card cuDNN off",
                                                  "cpu")}
    smoke.check(to64["card"][0] <= 2 * to64["cpu"][0],
                "against the card's float64 step, worst max|diff| / max|g|"
                " (the card's float32 within twice the CPU's): " + "; ".join(
                    f"{a} {r:.2e} ({k})" for a, (r, k) in to64.items()))
    return tc


def phase_vocoder_times(device):
    """Phase 8's times: the GAN step at batch 16, float32 (TF32 off) and
    bf16 amp, median of 10 after 3 warm-ups, with its three spans (CUDA
    events) and peak memory."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    card = nvidia_smi_line()
    rng = np.random.default_rng(4)
    wavs = [harmonic_signal(rng.uniform(1.5, 4.0), rng)
            for _ in range(N_VOC_WAVS)]
    rows = {}
    for amp in ("float32", "bfloat16"):
        cfg = vocoder_config(VOC_TIMED_BATCH, amp)
        state = tv.init_vocoder_train_state(cfg, device)
        sampler = tv.SegmentSampler(cfg, wavs, seed=5)
        events: list = []

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        step = tv.make_vocoder_train_step(cfg, device, mark=mark)
        batches = [torch.from_numpy(sampler.sample(VOC_TIMED_BATCH)).to(
            device) for _ in range(13)]
        for b in batches[:3]:
            step(state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, spans = [], {k: [] for k in tv.STEP_SPANS}
        for b in batches[3:]:
            events.clear()
            mark("start")
            t0 = time.perf_counter()
            report = step(state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            for (_, a), (name, e) in zip(events, events[1:]):
                spans[name].append(a.elapsed_time(e))
        ms.sort()
        med = {k: float(np.median(v)) for k, v in spans.items()}
        rows[amp] = {"ms": (ms[4] + ms[5]) / 2, **med}
        print(f"  GAN step {amp}, batch {VOC_TIMED_BATCH} × "
              f"{cfg.vocoder_train.segment_size} samples, Config() width: "
              f"median {rows[amp]['ms']:.3f} ms (host clock, synchronized), "
              f"min {ms[0]:.3f}, max {ms[-1]:.3f} over 10 steps after 3 "
              f"warm-ups; spans (CUDA events, medians): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in med.items())
              + f"; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; last "
              f"mel L1 {float(report.mel_l1):.4f} [{card}]", flush=True)
        rows[amp]["busy"] = profile_gan_steps(step, state, batches[3:5],
                                              amp)
        del state, batches
    return rows


def profile_gan_steps(step, state, batches, amp: str) -> float:
    """``torch.profiler`` over two GAN steps: the device's busy share of
    the window (the union of the kernels' device intervals over the wall
    time; the profiler's own cost on the host is in the wall time) and the
    ten kernels with the most device time. Returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def is_kernel(e) -> bool:
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if is_kernel(e)):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy = busy_us / 1e3 / wall_ms
    top = sorted((e for e in prof.key_averages() if is_kernel(e)),
                 key=lambda e: -e.self_device_time_total)[:10]
    print(f"  profile of {len(batches)} GAN steps ({amp}): {wall_ms:.1f} ms "
          f"wall, kernels busy {busy_us / 1e3:.1f} ms, busy share "
          f"{busy:.3f}; top kernels by device time: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
              f"×{e.count}" for e in top), flush=True)
    return busy


# ---------------------------------------------------------------------------
# Phase 9: feature extraction and GTA fine-tuning at full width.

ESD_SPEAKERS = ("0001", "0002")
ESD_EMOTIONS = ("Angry", "Happy", "Neutral", "Sad", "Surprise")
ESD_UTTS = 10           # per speaker and emotion
ESD_SR = 16000          # ESD's own rate; prepare_esd resamples to 22050
ESD_TEXTS = ("今天天气真好", "我们明天见", "你好世界", "他说这个很好看",
             "谢谢大家", "我爱你们", "我们都很好", "你说什么",
             "他们明天来", "这个是我的")
ESD_VAL = 10
ESD_LEAD, ESD_TAIL = 0.3, 0.25  # seconds of silence at the edges
PREP_TRAIN_STEPS = 4
GTA_VOC_STEPS = 10


def write_esd_corpus(root: str, seed: int,
                     seconds: tuple[float, float] = (2.0, 6.0),
                     utts: int = ESD_UTTS) -> str:
    """An ESD-layout tree: ``<spk>/<Emotion>/<spk>_<n>.wav`` (16 kHz int16,
    ``seconds`` long: ``harmonic_signal`` between silent edges of low
    noise), ``utts`` of them per speaker and emotion, and the
    tab-separated transcripts ``<spk>/<spk>.txt``."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(seed)

    def edge(seconds: float) -> np.ndarray:
        return 1e-3 * rng.standard_normal(int(seconds * ESD_SR))

    for speaker in ESD_SPEAKERS:
        lines = []
        for e, emotion in enumerate(ESD_EMOTIONS):
            os.makedirs(os.path.join(root, speaker, emotion))
            for k in range(utts):
                base = f"{speaker}_{e * utts + k:06d}"
                voiced = harmonic_signal(rng.uniform(*seconds) - ESD_LEAD
                                         - ESD_TAIL, rng, ESD_SR)
                save_wav(os.path.join(root, speaker, emotion, f"{base}.wav"),
                         np.concatenate([edge(ESD_LEAD), voiced,
                                         edge(ESD_TAIL)]), ESD_SR)
                lines.append(f"{base}\t{ESD_TEXTS[int(rng.integers(10))]}"
                             f"\t{emotion}")
        with open(os.path.join(root, speaker, f"{speaker}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


def write_esd_textgrids(raw: str, tg_root: str) -> int:
    """A TextGrid per prepared utterance from its lab's pinyin phones: a
    leading ``sil`` over the silent edge, the phones evenly over the
    voiced part, a trailing ``sp`` and a last gap with an empty mark (an
    interior gap would become ``sp``, which the pinyin table lacks).
    Returns how many."""
    from expressive_fastspeech2_mandarin_tpu_torch.preprocess.textgrid import (
        Interval,
        TextGrid,
        Tier,
        write_textgrid,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.text import (
        pinyin_sequence_to_phonemes,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import load_wav

    n = 0
    for speaker in ESD_SPEAKERS:
        os.makedirs(os.path.join(tg_root, speaker))
        for name in sorted(os.listdir(os.path.join(raw, speaker))):
            if not name.endswith(".lab"):
                continue
            base = name[:-4]
            with open(os.path.join(raw, speaker, name)) as f:
                phones = pinyin_sequence_to_phonemes(f.read().split())
            wav, sr = load_wav(os.path.join(raw, speaker, f"{base}.wav"),
                               None)
            end = len(wav) / sr
            step = (end - ESD_LEAD - ESD_TAIL) / len(phones)
            marks = [Interval(0.0, ESD_LEAD, "sil")]
            marks += [Interval(ESD_LEAD + i * step, ESD_LEAD + (i + 1) * step,
                               p) for i, p in enumerate(phones)]
            marks += [Interval(end - ESD_TAIL, end - 0.05, "sp"),
                      Interval(end - 0.05, end, "")]
            write_textgrid(TextGrid(0.0, end, [Tier("phones", marks)]),
                           os.path.join(tg_root, speaker,
                                        f"{base}.TextGrid"))
            n += 1
    return n


def phase_features_gta(smoke: Smoke, device, texts, emotions):
    """Phase 9: an ESD corpus → ``prepare_esd`` → TextGrids →
    ``Preprocessor`` on the card (against the CPU) → ``train()`` →
    ``export_gta_mels`` (flash, against xla) → ``train_vocoder(pairs=...)``
    → the tuned generator in the bf16 Synthesizer. Returns the flash
    forward launches and the times."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.dsp import pitch_backend
    from expressive_fastspeech2_mandarin_tpu_torch.interop import (
        load_vocoder_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.preprocess import (
        Preprocessor,
        prepare_esd,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
    from expressive_fastspeech2_mandarin_tpu_torch.train import train
    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    card_line = nvidia_smi_line()
    reset_flash_counts()
    reset_mrf_counts()
    with tempfile.TemporaryDirectory() as tmp:
        esd = write_esd_corpus(os.path.join(tmp, "esd"), 9)
        raw = os.path.join(tmp, "raw")
        prepare_esd(esd, raw, val_per_speaker_emotion=1,
                    test_per_speaker_emotion=1)
        tg_root = os.path.join(tmp, "TextGrid")
        n_tg = write_esd_textgrids(raw, tg_root)

        # Feature extraction on the card and on the CPU.
        dirs, runs = {}, {}
        for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
            dirs[name] = os.path.join(tmp, f"pre_{name}")
            shutil.copytree(tg_root, os.path.join(dirs[name], "TextGrid"))
            pcfg = C.PreprocessConfig(
                path=C.PathConfig(raw_path=raw,
                                  preprocessed_path=dirs[name]),
                val_size=ESD_VAL)
            prep = Preprocessor(pcfg, device=dev)
            t0 = time.perf_counter()
            lines = prep.build_from_path()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs[name] = dict(prep.timings, wall=time.perf_counter() - t0,
                              lines=lines, workers=prep.num_workers)
        card, cpu = runs["card"], runs["cpu"]
        for name, r in runs.items():
            steady = r["extract_s"] - r["first_s"]
            print(f"  Preprocessor ({name}): {len(r['lines'])} of {n_tg} "
                  f"utterances, {r['audio_s']:.1f} audio-seconds in "
                  f"{r['wall']:.2f} s wall = {r['audio_s'] / r['wall']:.1f} "
                  f"audio-seconds per second; F0 pool of {r['workers']} "
                  f"workers ({pitch_backend()} backend): start-up (until "
                  f"the first utterance arrived) {r['first_s']:.2f} s, then "
                  f"{steady:.2f} s = {r['audio_s'] / steady:.1f} "
                  f"audio-seconds per second; mel STFT on the {name} "
                  f"{r['mel_s']:.3f} s ({r['mel_s'] / r['wall']:.4f} of the "
                  f"wall) [{card_line}]", flush=True)
        same = {}
        for fname in ("train.txt", "val.txt", "speakers.json",
                      "emotions.json"):
            with open(os.path.join(dirs["card"], fname)) as a, \
                    open(os.path.join(dirs["cpu"], fname)) as b:
                same[fname] = a.read() == b.read()
        smoke.check(all(same.values()) and len(card["lines"]) == n_tg,
                    f"card and CPU builds: metadata and maps equal {same}; "
                    f"{len(card['lines'])} of {n_tg} utterances kept")
        stats = {}
        for name in dirs:
            with open(os.path.join(dirs[name], "stats.json")) as f:
                stats[name] = json.load(f)
        e_card, e_cpu = stats["card"]["energy"], stats["cpu"]["energy"]

        def energy(values, st):  # de-normalized by the run's own stats
            return np.asarray(values, np.float64) * st[3] + st[2]

        # min, max (de-normalized) and mean relative to themselves; the std
        # relative to the mean: an error of ε·e in every energy e moves the
        # std by up to ε·max e, however small the std is.
        st_rel = max([abs(a - b) / abs(b) for a, b in zip(
            list(energy(e_card[:2], e_card)) + e_card[2:3],
            list(energy(e_cpu[:2], e_cpu)) + e_cpu[2:3])]
            + [abs(e_card[3] - e_cpu[3]) / abs(e_cpu[2])])
        worst = {"mel": 0.0, "energy": 0.0}
        exact = True
        names = sorted(os.listdir(os.path.join(dirs["cpu"], "mel")))
        for name in names:
            arrays = {}
            for kind in ("duration", "pitch", "mel", "energy"):
                f = name.replace("-mel-", f"-{kind}-")
                arrays[kind] = [np.load(os.path.join(dirs[d], kind, f))
                                for d in ("card", "cpu")]
            for kind in ("duration", "pitch"):
                a, b = arrays[kind]
                exact &= a.dtype == b.dtype and np.array_equal(a, b)
            a, b = arrays["mel"]
            worst["mel"] = max(worst["mel"], float(np.abs(a - b).max())
                               if a.shape == b.shape else math.inf)
            a, b = (energy(v, st) for v, st in zip(arrays["energy"],
                                                   (e_card, e_cpu)))
            worst["energy"] = max(worst["energy"],
                                  float((np.abs(a - b) / np.abs(b)).max()))
        smoke.check(exact and stats["card"]["pitch"] == stats["cpu"]["pitch"]
                    and worst["mel"] <= DSP_MEL_ATOL
                    and worst["energy"] <= DSP_ENERGY_RTOL
                    and st_rel <= DSP_ENERGY_RTOL,
                    f"card vs CPU over {len(names)} utterances: durations "
                    f"and pitch equal {exact}, pitch stats equal; log-mel "
                    f"max|diff| {worst['mel']:.3e} (bound {DSP_MEL_ATOL:.0e}"
                    f"), energy max rel diff {worst['energy']:.3e} and its "
                    f"stats {st_rel:.3e} (bound {DSP_ENERGY_RTOL:.0e})")
        # FastSpeech2 on the card's corpus, then the GTA export.
        cfg = C.Config(
            preprocess=C.PreprocessConfig(path=C.PathConfig(
                raw_path=raw, preprocessed_path=dirs["card"])),
            model=C.ModelConfig(transformer=C.TransformerConfig(
                attention_impl="flash")),
            train=C.TrainConfig(
                path=C.PathConfig(ckpt_path=os.path.join(tmp, "ckpt"),
                                  log_path=os.path.join(tmp, "log"),
                                  result_path=os.path.join(tmp, "result")),
                step=C.StepConfig(total_step=PREP_TRAIN_STEPS, log_step=1,
                                  save_step=PREP_TRAIN_STEPS)))
        t0 = time.perf_counter()
        state = train(cfg, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "log/train/metrics.jsonl")) as f:
            losses = [json.loads(line)["total_loss"] for line in f]
        smoke.check(state.step == PREP_TRAIN_STEPS
                    and len(losses) == PREP_TRAIN_STEPS
                    and all(math.isfinite(x) for x in losses),
                    f"train() on the extracted corpus, Config() width, "
                    f"flash: {PREP_TRAIN_STEPS} steps in {seconds:.1f} s, "
                    f"losses {[round(x, 4) for x in losses]}")
        del state
        corpus = PreprocessedCorpus(dirs["card"])
        n_batches = sum(math.ceil(len(BucketedDataset(
            corpus, f, tv.GTA_BATCH, C.BucketConfig())) / tv.GTA_BATCH)
            for f in ("train.txt", "val.txt"))
        n_blocks = (cfg.model.transformer.encoder_layer
                    + cfg.model.transformer.decoder_layer)
        gta = {}
        for impl in ("flash", "xla"):
            icfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, transformer=dataclasses.replace(
                    cfg.model.transformer, attention_impl=impl)))
            gta[impl] = os.path.join(tmp, f"gta_{impl}")
            before = fa.launch_count
            t0 = time.perf_counter()
            n = tv.export_gta_mels(icfg, os.path.join(tmp, "ckpt"),
                                   gta[impl], device=device,
                                   log=lambda *_: None)
            ms = 1e3 * (time.perf_counter() - t0) / n_batches
            launches = fa.launch_count - before
            print(f"  export_gta_mels ({impl}): {n} mels in {n_batches} "
                  f"batches of {tv.GTA_BATCH}, {ms:.2f} ms a batch (host "
                  f"clock; each batch's mels copied to the host) "
                  f"[{card_line}]", flush=True)
            if impl == "flash":
                gta_ms, gta_launches = ms, launches
                smoke.check(n == len(card["lines"])
                            and launches == n_blocks * n_batches,
                            f"GTA export under flash: {n} mels, flash "
                            f"launches {launches} (expected {n_blocks} a "
                            f"batch × {n_batches})")
        # The main path's launches end here: the timing below is not one.
        counted = {"flash_mha": fa.launch_count,
                   "flash_mha_bwd_dq": fa.bwd_dq_launch_count,
                   "flash_mha_bwd_dkv": fa.bwd_dkv_launch_count}
        # One batch's forward alone (CUDA events, 5 runs), against the
        # export's time a batch.
        from expressive_fastspeech2_mandarin_tpu_torch.models import (
            FastSpeech2,
        )
        from expressive_fastspeech2_mandarin_tpu_torch.train import (
            CheckpointManager,
        )
        from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
            stage_batch,
        )

        model = FastSpeech2(cfg.model, cfg.preprocess, corpus.stats)
        model.load_state_dict(CheckpointManager(os.path.join(
            tmp, "ckpt")).load()["model"])
        model.to(device).eval()
        batch, _ = next(BucketedDataset(
            corpus, "train.txt", tv.GTA_BATCH,
            C.BucketConfig()).epoch_with_examples(shuffle=False))
        b = stage_batch(batch, device)
        with torch.inference_mode():
            fwd_ms = cuda_time_ms(lambda: model(
                b["speakers"], b["emotions"], b["arousals"], b["valences"],
                b["texts"], b["src_lens"], max_mel_len=batch["mels"].shape[1],
                mel_lens=b["mel_lens"], p_targets=b["pitches"],
                e_targets=b["energies"], d_targets=b["durations"]), 5)
        print(f"  teacher-forced forward of one batch, (S, T) bucket "
              f"{tuple(batch['texts'].shape[1:])} × "
              f"{batch['mels'].shape[1]}, flash: {fwd_ms:.2f} ms (CUDA "
              f"events, 5 runs) of the export's {gta_ms:.2f} ms a batch "
              f"[{card_line}]", flush=True)
        del model, b
        rows_ok, worst_gta = True, 0.0
        for name in sorted(os.listdir(gta["flash"])):
            a = np.load(os.path.join(gta["flash"], name))
            b = np.load(os.path.join(gta["xla"], name))
            gt = np.load(os.path.join(dirs["card"], "mel", name))
            rows_ok &= a.shape == b.shape == gt.shape
            if a.shape == b.shape:
                worst_gta = max(worst_gta, float(np.abs(a - b).max())
                                / max(1.0, float(np.abs(b).max())))
        smoke.check(rows_ok and worst_gta <= F32_BOUND,
                    f"GTA mels: rows equal the ground truth's {rows_ok}; "
                    f"flash vs xla max|diff| / max(1, peak) {worst_gta:.3e} "
                    f"(bound {F32_BOUND:.0e}, phase 3b's)")

        # Paired GAN fine-tuning on the GTA mels, HiFi-GAN V1 width.
        vcfg = dataclasses.replace(cfg, vocoder_train=dataclasses.replace(
            C.VocoderTrainConfig(), batch_size=VOC_TIMED_BATCH, log_step=1,
            save_step=GTA_VOC_STEPS, val_step=GTA_VOC_STEPS))
        pairs = tv.load_paired_corpus(vcfg, gta["flash"])
        out = os.path.join(tmp, "voc")
        mrf_before = mrf_counts()
        t0 = time.perf_counter()
        vstate = tv.train_vocoder(vcfg, None, out, total_steps=GTA_VOC_STEPS,
                                  pairs=pairs, device=device,
                                  log=lambda *_: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps = [r for r in records if "mel_l1" in r]
        vals = [r for r in records if "val_mel_l1" in r]
        smoke.check(vstate.step == GTA_VOC_STEPS
                    and [r["step"] for r in steps] == list(range(
                        1, GTA_VOC_STEPS + 1))
                    and all(math.isfinite(r[k]) for r in steps
                            for k in ("gen_total", "disc", "mel_l1", "fm",
                                      "adv"))
                    and [r["step"] for r in vals] == [GTA_VOC_STEPS]
                    and math.isfinite(vals[0]["val_mel_l1"])
                    and mrf_counts() == mrf_before,
                    f"train_vocoder(pairs=...) on {len(pairs)} GTA pairs: "
                    f"{GTA_VOC_STEPS} steps at batch {VOC_TIMED_BATCH} × "
                    f"{vcfg.vocoder_train.segment_size} in {seconds:.1f} s; "
                    f"mel L1 {[round(r['mel_l1'], 4) for r in steps]}; val "
                    f"{vals}; MRF launches {mrf_counts()[0] - mrf_before[0]}"
                    f" (the plain generator)")

        # The paired step's time, median of 10 after 3 warm-ups.
        step = tv.make_vocoder_train_step(vcfg, device)
        sampler = tv.PairedSegmentSampler(vcfg, pairs, seed=5)
        batches = [{k: torch.from_numpy(v).to(device) for k, v in
                    sampler.sample(VOC_TIMED_BATCH).items()}
                   for _ in range(13)]
        for b in batches[:3]:
            step(vstate, b)
        torch.cuda.synchronize()
        times = []
        for b in batches[3:]:
            t0 = time.perf_counter()
            step(vstate, b)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        paired_ms = (times[4] + times[5]) / 2
        print(f"  paired GAN step, batch {VOC_TIMED_BATCH} × "
              f"{vcfg.vocoder_train.segment_size}, float32: median "
              f"{paired_ms:.3f} ms, min {times[0]:.3f}, max {times[-1]:.3f}"
              f" (host clock, synchronized, 10 steps after 3 warm-ups) "
              f"[{card_line}]", flush=True)
        del vstate, batches, step

        # The tuned generator, bf16, through the Synthesizer.
        scfg = C.Config(preprocess=cfg.preprocess)
        fs2, _ = seeded_states(scfg)
        synth = Synthesizer(scfg, fs2, load_vocoder_state(
            os.path.join(out, "generator.npz")), emotion_maps=EMOTION_MAPS,
            device=device)
        per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
        tc0, fma0 = mrf_counts()
        results = synth.synthesize(texts, list(range(len(texts))), emotions)
        tc, fma = mrf_counts()
        smoke.check((tc - tc0, fma - fma0) == (per_call, 0)
                    and all(np.isfinite(r.wav).all() and r.wav.size > 0
                            for r in results),
                    f"GTA-tuned generator.npz in the Synthesizer (bf16): MRF "
                    f"launches tensor-core {tc - tc0}, CUDA-core "
                    f"{fma - fma0} (expected {per_call}, 0); waveforms "
                    f"finite")
    counted["mrf_resblock"] = mrf_counts()[0]
    smoke.check(all(n > 0 for n in counted.values()),
                f"kernel launches over phase 9: {counted}")
    return {"launches": counted, "gta_launches": gta_launches,
            "extract_rate": card["audio_s"] / card["wall"],
            "gta_ms": gta_ms, "gta_forward_ms": fwd_ms,
            "paired_ms": paired_ms}


# Phase 10: the Quick start through the port's command lines.
CONFIG_DIR = ROOT / "configs" / "ESD-Chinese-Singing-MFA"
E2E_SECONDS = (2.0, 5.0)  # every batch of 16 in the 500-frame mel bucket
E2E_TRAIN_STEPS = 20
E2E_VOC_STEPS = 10
B16_CADENCE = dict(log_step=5, save_step=15)  # inside chunks of 10
E2E_TEXT = "今天天气真好"


def _yaml_set(text: str, key: str, value) -> str:
    """A shipped YAML file's text with the first ``key:`` line's value
    replaced (a quoted string for a path)."""
    import re

    value = f'"{value}"' if isinstance(value, (str, Path)) else value
    out, n = re.subn(rf"^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text,
                     count=1, flags=re.M)
    if n != 1:
        raise KeyError(key)
    return out


def e2e_configs(root: Path, esd: str, name: str = "") -> dict[str, str]:
    """The shipped ESD triplet and train_b16.yaml with their paths moved
    under ``root``, ``attention_impl: "flash"``, a val split of ESD_VAL
    utterances, the vocoder's log/val/save cadences within 10 steps and
    B16_CADENCE; the recipes (widths, batches, optimizer, steps_per_call)
    are the shipped ones."""
    root.mkdir(parents=True, exist_ok=True)
    pre = (CONFIG_DIR / "preprocess.yaml").read_text()
    lexicon = ROOT / "lexicon" / "mandarin_pinyin.dict"
    for key, value in (("corpus_path", esd), ("raw_path", root / "raw"),
                       ("preprocessed_path", root / "pre"),
                       ("lexicon_path", lexicon), ("val_size", ESD_VAL)):
        pre = _yaml_set(pre, key, value)
    model = (CONFIG_DIR / "model.yaml").read_text().replace(
        "transformer:\n", 'transformer:\n  attention_impl: "flash"\n', 1)
    out = {}
    for fname, text in (("preprocess", pre), ("model", model)):
        out[fname] = str(root / f"{fname}{name}.yaml")
        Path(out[fname]).write_text(text)
    for fname, sub, extra in (
            ("train", "", "\nvocoder_train:\n  log_step: 1\n  save_step: "
             f"{E2E_VOC_STEPS}\n  val_step: {E2E_VOC_STEPS}\n"),
            ("train_b16", "b16", "")):
        text = (CONFIG_DIR / f"{fname}.yaml").read_text()
        for key in ("ckpt_path", "log_path", "result_path"):
            text = _yaml_set(text, key, root / sub / key.split("_")[0])
        if sub:
            for key, value in B16_CADENCE.items():
                text = _yaml_set(text, key, value)
        out[fname] = str(root / f"{fname}{name}.yaml")
        Path(out[fname]).write_text(text + extra)
    return out


def run_cli(module: str, argv: list) -> tuple[str, float]:
    """``<PKG>.cli.<module>.main(argv)`` in this process (so the launch
    counters count); returns its standard output, also echoed, and its
    wall seconds."""
    import contextlib
    import importlib
    import io

    import torch

    main = importlib.import_module(f"{PKG}.cli.{module}").main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main([str(a) for a in argv])
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    lines = text.strip().splitlines()
    shown = lines if len(lines) <= 6 else lines[:3] + ["..."] + lines[-2:]
    for line in shown:
        print(f"    | {line[:160]}")
    return text, seconds


def _json_of(text: str) -> dict:
    return json.loads(text[text.index("{"):])


def _metrics(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_entry_points(smoke: Smoke, device):
    """Phase 10: the README's Quick start through the port's CLIs, called
    in-process by ``main(argv)`` on the card, from an ESD-layout corpus
    written from a seed: preprocess esd → align (the aligner built from
    native/aligner) → validate textgrids → preprocess features → validate
    data → train (train.yaml, 20 steps) → train (train_b16.yaml:
    steps_per_call 10) → evaluate → train-vocoder (context, then --gta) →
    validate vocoder → synthesize (single, streamed, batch, grid) →
    validate synth and checkpoint → pipeline --skip-train on a fresh
    directory; and one ``python -m ...cli.synthesize`` from a cold start.
    Returns every kernel's launches over the phase and the times."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch import align
    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import chunks
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import load_wav

    card_line = nvidia_smi_line()
    dev = ["--device", str(device)]
    times: dict[str, float] = {}
    reset_flash_counts()
    reset_mrf_counts()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        esd = write_esd_corpus(str(tmp / "esd"), 10, E2E_SECONDS)
        y = e2e_configs(tmp, esd)
        cfg = ["-p", y["preprocess"], "-m", y["model"], "-t", y["train"]]
        b16 = ["-p", y["preprocess"], "-m", y["model"], "-t",
               y["train_b16"]]
        n_utts = len(ESD_SPEAKERS) * len(ESD_EMOTIONS) * ESD_UTTS

        def step(name, module, argv):
            text, times[name] = run_cli(module, argv)
            print(f"  [{name}] {times[name]:.2f} s wall [{card_line}]",
                  flush=True)
            return text

        step("preprocess esd", "preprocess", [
            "esd", "--esd-root", esd, "--raw-path", tmp / "raw"])
        t0 = time.perf_counter()
        binary = align.ensure_built()
        times["aligner build"] = time.perf_counter() - t0
        print(f"  aligner built from native/aligner with g++ in "
              f"{times['aligner build']:.2f} s -> "
              f"{os.path.relpath(binary, ROOT)}", flush=True)
        text = step("align", "align", ["--corpus", tmp / "raw", "--out",
                                       tmp / "pre" / "TextGrid"])
        smoke.check(f"aligned {n_utts} utterances (0 skipped)" in text,
                    f"align: {n_utts} utterances aligned in "
                    f"{times['align']:.2f} s (the build "
                    f"{times['aligner build']:.2f} s)")
        tg = _json_of(step("validate textgrids", "validate", [
            "textgrids", "--textgrid-dir", tmp / "pre" / "TextGrid",
            "--report", tmp / "tg_report.json"]))
        smoke.check(tg["files_validated"] == n_utts and not tg["errors"]
                    and tg["files_with_words_tier"] == n_utts,
                    f"validate textgrids: {tg['files_validated']} files, "
                    f"{tg['phone_type_count']} phone types, coverage "
                    f"{tg['avg_coverage']:.3f}")
        text = step("preprocess features", "preprocess",
                    ["features", *cfg, *dev])
        kept = int(text.split("wrote ")[1].split()[0])
        data = _json_of(step("validate data", "validate", [
            "data", "--preprocessed-path", tmp / "pre"]))
        # The one kind of problem both packages share (ROADMAP queue 3):
        # an interior pause the aligner marks "sp", which the pinyin
        # table lacks, leaves one duration more than known phones.
        with_sp = [line.split("|")[0] for f in ("train.txt", "val.txt")
                   for line in (tmp / "pre" / f).read_text().splitlines()
                   if " sp" in line.split("|")[2]]
        smoke.check(kept == n_utts and data["utterances_checked"] == n_utts
                    and data["problem_count"] == len(with_sp)
                    and all(p.split(":")[0] in with_sp
                            for p in data["problems"])
                    and set(data["unknown_phones"]) <= {"sp"},
                    f"features: {kept} of {n_utts} utterances; validate "
                    f"data: {data['utterances_checked']} checked, "
                    f"problems {data['problems']} (the utterances with an "
                    f"interior sp: {with_sp})")

        before = flash_counts()
        step("train", "train", [*cfg, "--total_steps", E2E_TRAIN_STEPS,
                                *dev])
        launches = [a - b for a, b in zip(flash_counts(), before)]
        n_blocks = 4 + 6
        smoke.check(sorted(os.listdir(tmp / "ckpt")) == [
            f"{E2E_TRAIN_STEPS}.pt"] and launches == [
            n_blocks * E2E_TRAIN_STEPS] * 3,
            f"train (train.yaml, flash): checkpoint {os.listdir(tmp / 'ckpt')}"
            f", flash launches forward/dQ/dK-dV {launches} (expected "
            f"{n_blocks * E2E_TRAIN_STEPS} each)")

        # train_b16.yaml: the expected chunks, from the same batches.
        tcfg = C.load_config(y["preprocess"], y["model"], y["train_b16"])
        ds = BucketedDataset(
            PreprocessedCorpus(str(tmp / "pre")), "train.txt",
            tcfg.train.optimizer.batch_size, tcfg.train.buckets,
            tcfg.model.max_seq_len, drop_last=True, seed=tcfg.train.seed)

        def stream():
            epoch = 0
            while True:
                yield from ds.epoch(epoch)
                epoch += 1

        ends, done, sizes = [], 0, []
        spc = tcfg.train.steps_per_call
        for group in chunks(stream(), spc):
            n = min(len(group), E2E_TRAIN_STEPS - done)
            done += n
            sizes.append(n)
            ends.append(done)
            if done >= E2E_TRAIN_STEPS:
                break

        def crossings(every):
            return [e for p, e in zip([0] + ends, ends)
                    if e // every > p // every]

        step("train b16", "train", [*b16, "--total_steps", E2E_TRAIN_STEPS,
                                    *dev])
        logged = [r["step"] for r in _metrics(tmp / "b16" / "log" / "train"
                                              / "metrics.jsonl")]
        saved = sorted(int(f[:-3]) for f in os.listdir(tmp / "b16" / "ckpt"))
        want_saved = sorted(set(crossings(B16_CADENCE["save_step"])
                                + [E2E_TRAIN_STEPS]))
        smoke.check(spc == 10 and max(sizes) == spc
                    and logged == crossings(B16_CADENCE["log_step"])
                    and saved == want_saved,
                    f"train (train_b16.yaml, steps_per_call {spc}): groups "
                    f"{sizes}; logged at {logged}, saved at {saved} "
                    f"(log_step {B16_CADENCE['log_step']} and save_step "
                    f"{B16_CADENCE['save_step']} read at chunk ends: "
                    f"{crossings(B16_CADENCE['log_step'])}, {want_saved})")

        text = step("evaluate", "evaluate", [*cfg, *dev])
        smoke.check(f"Validation at step {E2E_TRAIN_STEPS}:" in text
                    and "nan" not in text,
                    "evaluate: " + text.strip().splitlines()[-1])

        for name, extra in (
                ("train-vocoder", ["--out", tmp / "voc"]),
                ("train-vocoder --gta", [
                    "--out", tmp / "voc_gta", "--gta", tmp / "ckpt",
                    "--init_ckpt", tmp / "voc" / "generator.npz"])):
            out_dir = extra[1]
            step(name, "train_vocoder", [*cfg, *extra, "--total_steps",
                                         E2E_VOC_STEPS, *dev])
            records = _metrics(out_dir / "metrics.jsonl")
            steps = [r for r in records if "mel_l1" in r]
            smoke.check([r["step"] for r in steps] == list(
                range(1, E2E_VOC_STEPS + 1)) and all(
                math.isfinite(r["mel_l1"]) for r in steps)
                and (out_dir / "generator.npz").exists(),
                f"{name}: {len(steps)} steps, mel L1 "
                f"{[round(r['mel_l1'], 3) for r in steps]}")
        npz = tmp / "voc_gta" / "generator.npz"
        v = _json_of(step("validate vocoder", "validate", [
            "vocoder", *cfg, "--vocoder-ckpt", npz, "--wav-dir",
            tmp / "raw", *dev]))
        quality = {k: v[f"{k}_hifigan_mean"] for k in
                   ("mel_l1", "mcd", "f0_rmse", "vuv_error")}
        smoke.check(len(v["files"]) == 8 and all(
            x is not None and math.isfinite(x) for x in (
                quality["mel_l1"], quality["mcd"], quality["vuv_error"])),
            f"validate vocoder (copy synthesis, 8 utterances, bf16): "
            f"{quality} [{card_line}]")

        res = tmp / "result"
        vocoder = ["--vocoder_ckpt", npz]
        one = ["--mode", "single", "--text", E2E_TEXT, "--speaker_id",
               "0001", "--emotion", "Happy", *vocoder]
        step("synthesize single", "synthesize", [*cfg, *one, *dev])
        text = step("synthesize streamed", "synthesize", [
            *cfg, *one, "--stream_chunk_frames", 100, "--output_name",
            "streamed", *dev])
        step("synthesize batch", "synthesize", [
            *cfg, "--mode", "batch", "--source", tmp / "pre" / "val.txt",
            *vocoder, "--out_dir", tmp / "batch", *dev])
        step("synthesize grid", "synthesize", [
            *cfg, "--mode", "grid", "--text", E2E_TEXT, *vocoder,
            "--out_dir", tmp / "grid", *dev])
        single, sr = load_wav(str(res / "synthesis_0001_Happy.wav"), None)
        streamed, _ = load_wav(str(res / "streamed.wav"), None)
        n_batch = len(list((tmp / "batch").glob("*.wav")))
        n_grid = len(list((tmp / "grid").glob("grid_*.wav")))
        smoke.check(sr == 22050 and single.size > 0
                    and streamed.size == single.size
                    and n_batch == ESD_VAL
                    and n_grid == len(ESD_SPEAKERS) * len(ESD_EMOTIONS),
                    f"synthesize: single {single.size / sr:.2f} s, streamed "
                    f"in {text.count('chunk ')} chunks, batch {n_batch} "
                    f"wavs, grid {n_grid} wavs")
        health = _json_of(step("validate synth", "validate", [
            "synth", "--result-dir", res]))
        ck = _json_of(step("validate checkpoint", "validate",
                           ["checkpoint", *cfg]))
        smoke.check(health["n_files"] == 2 and ck["ok"]
                    and ck["step"] == E2E_TRAIN_STEPS,
                    f"validate synth: {health['n_files']} files, "
                    f"{health['warnings']} warnings; validate checkpoint: "
                    f"{ck}")
        counted = {"flash_mha": flash_counts()[0],
                   "flash_mha_bwd_dq": flash_counts()[1],
                   "flash_mha_bwd_dkv": flash_counts()[2],
                   "mrf_resblock": mrf_counts()[0]}

        y2 = e2e_configs(tmp / "fresh", esd, "_fresh")
        text = step("pipeline --skip-train", "pipeline", [
            "-p", y2["preprocess"], "-m", y2["model"], "-t", y2["train"],
            "--skip-train", *dev])
        pre2 = tmp / "fresh" / "pre"
        smoke.check("[4/4] training: skipped" in text
                    and (pre2 / "train.txt").exists()
                    and len(list(pre2.glob("TextGrid/*/*.TextGrid")))
                    == n_utts,
                    f"pipeline --skip-train on a fresh directory: corpus "
                    f"prep, alignment, features in "
                    f"{times['pipeline --skip-train']:.2f} s")

        # A cold start: a new process from its launch to the wav on disk.
        cold = tmp / "cold"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli.synthesize", *cfg, *one,
             "--out_dir", cold, *dev], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=600)
        times["cold synthesize"] = time.perf_counter() - t0
        wav = cold / "synthesis_0001_Happy.wav"
        smoke.check(proc.returncode == 0 and wav.exists(),
                    f"python -m {PKG}.cli.synthesize from a cold start: "
                    f"{times['cold synthesize']:.2f} s to the wav "
                    f"[{card_line}]" + (f"\n{proc.stderr[-2000:]}"
                                        if proc.returncode else ""))
        if proc.returncode == 0:
            a, _ = load_wav(str(wav), None)
            smoke.check(np.array_equal(a.shape, single.shape),
                        "cold-start wav as long as the in-process one")
    smoke.check(all(n > 0 for n in counted.values()),
                f"kernel launches over phase 10's CLIs: {counted}")
    print("  phase 10 wall times: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in times.items()) + f" [{card_line}]")
    return {"launches": counted, "times": times, "quality": quality}


# ---------------------------------------------------------------------------
# Phases 2e, 11 and 11b: the flash kernels in bf16 and bf16 amp training
# under "flash".

# The bf16 kernels against their plain versions (which round where the TPU
# kernel rounds in bf16): the float32 kernels' cases, the mask with wholly
# padded 64-key blocks in the middle of rows too.
# At T = 320 the streamed tiles are 5 (an odd count: the backward's two
# consumers take 3 and 2) and a row of 64 keys has one live tile; the
# recipe's batch of 32 at RECIPE_BWD_TIMED is added in the phase
# (recipe_lengths).
FLASH_BF16_CASES = ((4, 20, prefixes(20, 1, 0, 13)),
                    (4, 300, prefixes(300, 37, 0, 211)),
                    (4, 320, prefixes(320, 64, 0, 200)),
                    (4, 1000, FLASH_HOLES), (4, 1000, FLASH_BLOCK_HOLES),
                    (4, 2300, prefixes(2300, 63, 0, 2049)),
                    (4, 4096, prefixes(4096, 1, 0, 3001)),
                    (1, 8192, prefixes(8100)))
# Kernel and plain version round the same float32 values to bf16 at the
# same points (the forward's plain version: flash_mha_blocked_plain on the
# kernel's own key tiles), but sum in another order (online, tile by tile,
# against cuBLAS), which can flip a bf16 rounding of P or dS and of the
# stored output: out within 2^-7 · max|ref|, dq, dk, dv within
# 2^-6 · max|ref|.
FLASH_BF16_OUT_REL = 2.0 ** -7
FLASH_BF16_GRAD_REL = 2.0 ** -6
# Keys per tile in which the bounds count live keys: the float32 kernels'
# 32 (the bf16 kernels skip in 64-key tiles; a tile of 32 with no valid
# key is work no kernel needs).
BOUND_KEY_TILE = 32

# The bf16 backward's timed shapes (phase 11b): B = 4 at T = 1000 and 4096
# with key lengths (T, 3T/4, T/2, T/4); and the tuned recipe's batch of 32
# at the 1000-frame bucket and at 500, the T of the recipe's header, with
# seeded key lengths over [T/2, T].
RECIPE_BWD_TIMED = ((32, 1000), (32, 500))


def recipe_lengths(b: int, t: int) -> tuple[int, ...]:
    """``b`` key lengths drawn from a seed over [T/2, T]."""
    import numpy as np

    rng = np.random.default_rng(t)
    return tuple(int(n) for n in rng.integers(t // 2, t + 1, size=b))


def bwd_timed_cases():
    """(B, T, key lengths) of the bf16 backward's timed shapes."""
    return ([(4, t, (t, 3 * t // 4, t // 2, t // 4))
             for t in FLASH_BWD_TIMED]
            + [(b, t, recipe_lengths(b, t)) for b, t in RECIPE_BWD_TIMED])


# The bf16 forward's timed shapes (phase 11b): the long-form path's
# (4, 2, T, 128) with FLASH_CASES' masks (the `kernels` line's row is
# T = 4096), and where the tuned recipe launches it: its batch of 32 at the
# decoder's 1000-frame bucket and the encoder's 128-phone bucket, with
# seeded key lengths over [T/2, T].
RECIPE_FWD_TIMED = ((32, 1000), (32, 128))
# Phase 2e's recipe cases: every recipe shape phase 11b times.
RECIPE_CASES = tuple(sorted(set(RECIPE_BWD_TIMED + RECIPE_FWD_TIMED),
                            reverse=True))
# Launches a CUDA graph replays to time a kernel without the host.
GRAPH_LAUNCHES = 20


def fwd_timed_cases():
    """(B, T, rows) of the bf16 forward's timed shapes."""
    return ([(b, t, rows) for b, t, rows in FLASH_CASES if t in FLASH_TIMED]
            + [(b, t, prefixes(*recipe_lengths(b, t)))
               for b, t in RECIPE_FWD_TIMED])


def shown_rows(rows) -> str:
    """A mask's rows as the printouts name them: the spans of valid keys,
    or past a batch of 4 the range of the prefix lengths."""
    if len(rows) <= 4:
        return f"valid keys {rows}"
    lens = [r[0][1] for r in rows]
    return f"key lengths {len(rows)} seeded in [{min(lens)}, {max(lens)}]"


def graph_time_ms(fn, iters: int = GRAPH_LAUNCHES) -> tuple[float, str]:
    """Device time of one call of ``fn``, without the host's launch time:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events. If the capture fails, torch.profiler's device time of the
    kernels of ``iters`` calls instead. Returns (ms, how it was taken)."""
    import torch

    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters, "graph"
    except RuntimeError as err:  # the capture failed: say so, profile
        print(f"  CUDA graph capture failed ({str(err).splitlines()[0]}); "
              f"torch.profiler's kernel time instead", flush=True)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    return us / 1e3 / iters, "profiler"


# Phase 11: train_tuned.yaml (batch 32, bf16 amp, steps_per_call 10) under
# "flash" through efs2-torch-train, on phase 5's corpus, 20 steps in two
# chunks; its cadences brought inside the run.
TUNED_STEPS = 20
TUNED_CADENCE = dict(log_step=10, val_step=10, synth_step=10, save_step=20)
# Phase 11b: the train step at phase 6's bucket, at B = 4 and the recipe's
# B = 32, under three configurations in turns.
TUNED_TIMED = ((4, 128, 1000), (32, 128, 1000))
TUNED_RUNS = (("bfloat16", "flash"), ("bfloat16", "auto"),
              ("float32", "flash"))


def bf16_counts() -> tuple[int, int, int]:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    return (fa.bf16_launch_count, fa.bf16_bwd_dq_launch_count,
            fa.bf16_bwd_dkv_launch_count)


def reset_bf16_counts() -> None:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    fa.bf16_launch_count = fa.bf16_bwd_dq_launch_count = 0
    fa.bf16_bwd_dkv_launch_count = 0


def layout_witness(t: int = 192, lens=(192, 100), seed: int = 3):
    """bf16 inputs whose every product is exact (tests/
    test_torch_kernels_gpu.py holds the same witness): keys k_j = 64 e_j
    (j < 128) and -64 e_(j-128); query row i scores 1024 against exactly two
    valid keys (q_i = 16 (e_a + e_b)) and 0 or -1024 against the rest, so
    with sm_scale 1 its P is 1/2 at those two and exp(-1024) = 0 elsewhere;
    v and dO in {-1, 0, 1}. A wrong swizzle, descriptor or transpose bit
    moves a product by far more than round-off. Returns float64 q, k, v,
    dO and the mask, on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, h, d = len(lens), 2, 128
    k = np.zeros((b, h, t, d))
    for j in range(t):
        k[:, :, j, j % 128] = 64.0 if j < 128 else -64.0
    q = np.zeros((b, h, t, d))
    for i, n in enumerate(lens):
        for hh in range(h):
            for r in range(t):
                a, c = rng.choice(min(n, 128), size=2, replace=False)
                q[i, hh, r, a] = q[i, hh, r, c] = 16.0
    v, dout = (rng.choice([-1.0, 0.0, 1.0], size=(b, h, t, d),
                          p=[0.25, 0.5, 0.25]) for _ in range(2))
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return [torch.from_numpy(x) for x in (q, k, v, dout, mask)]


def phase_flash_bf16_vs_plain(smoke: Smoke):
    """The bf16 forward, dQ and dK/dV kernels against their plain versions
    on the same bf16 inputs, the layout witness exactly; returns the worst
    max|diff| of out, dq and (dk, dv)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    gen = torch.Generator().manual_seed(10)
    scale = 128 ** -0.5
    key_tile = build.load("flash_mha_bf16").flash_mha_fwd_bf16_key_tile()
    worst = [0.0, 0.0, 0.0]
    margin = 0.0  # the forward's worst max|diff| over its bound
    recipe = tuple((b, t, prefixes(*recipe_lengths(b, t)))
                   for b, t in RECIPE_CASES)
    for b, t, rows in FLASH_BF16_CASES + recipe:
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, rows, gen))
        dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
        reset_flash_counts()
        reset_bf16_counts()
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        grads = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
        launched = (bf16_counts(), flash_counts())
        ref = fa.flash_mha_blocked_plain(q, k, v, mask, scale, key_tile)
        refs = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
        line = []
        ok = launched == ((1, 1, 1), (0, 0, 0))
        for i, (name, x, r, rel) in enumerate(zip(
                ("out", "dq", "dk", "dv"), (out, *grads), (ref, *refs),
                (FLASH_BF16_OUT_REL,) + (FLASH_BF16_GRAD_REL,) * 3)):
            diff = (x.float() - r.float()).abs().max().item()  # syncs
            bound = rel * r.float().abs().max().item()
            ok &= (x.dtype == torch.bfloat16 and math.isfinite(diff)
                   and diff <= bound)
            worst[min(i, 2)] = max(worst[min(i, 2)], diff)
            if name == "out":
                margin = max(margin, diff / bound)
            line.append(f"{name} {diff:.3e} (bound {bound:.3e})")
        lse_ref = fa.flash_mha_lse_plain(q, k, mask, scale)
        finite = torch.isfinite(lse_ref)
        lse_diff = (lse - lse_ref)[finite].abs().max().item()
        ok &= (lse_diff <= LSE_REL_BOUND * lse_ref[finite].abs().max().item()
               and torch.equal(torch.isposinf(lse), ~finite))
        for i in range(b):
            if bool(mask[i].all()):  # no valid key: exactly 0
                ok &= all(torch.count_nonzero(x[i]).item() == 0
                          for x in (out, *grads))
        again = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        again_grads = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse,
                                             scale)
        same = (torch.equal(again[0], out) and torch.equal(again[1], lse)
                and all(torch.equal(a, g)
                        for a, g in zip(again_grads, grads)))
        smoke.check(ok and same,
                    f"bf16 B={b} T={t:5d} {shown_rows(rows)}: max|diff| "
                    f"{', '.join(line)}; lse {lse_diff:.3e}; launches "
                    f"(bf16, float32) {launched}; rows of length 0 exactly "
                    f"0; a rerun bit-identical: {same}")
        del q, k, v, mask, dout, out, lse, grads, ref, refs, again
    q, k, v, dout, mask = layout_witness()
    out64 = fa.flash_mha_plain(q, k, v, mask, 1.0)
    grads64 = fa.flash_mha_bwd_plain(q, k, v, mask, out64, dout, 1.0)
    exact_in_bf16 = all(torch.equal(x, x.bfloat16().double())
                        for x in (out64, *grads64))
    args = [x.to("cuda", torch.bfloat16) for x in (q, k, v, dout)]
    out, lse = fa._flash_mha_cuda(*args[:3], mask.to("cuda"), 1.0, True)
    grads = fa._flash_mha_bwd_cuda(*args[:3], mask.to("cuda"), out, args[3],
                                   lse, 1.0)
    wrong = [int((x.double().cpu() != r).sum()) for x, r in
             zip((out, *grads), (out64, *grads64))]
    nonzero = [int(torch.count_nonzero(x)) for x in (out64, *grads64)]
    smoke.check(exact_in_bf16 and wrong == [0, 0, 0, 0],
                f"layout witness (2, 2, 192, 128), two-hot P: out, dq, dk, "
                f"dv exact (elements off: {wrong}; nonzero in the "
                f"reference: {nonzero})")
    print(f"  bf16 forward against flash_mha_blocked_plain on its "
          f"{key_tile}-key tiles: worst max|diff| {margin:.3f} of its "
          f"2^-7 · max|ref| bound")
    return worst


def flash_bf16_bounds_ms(mask, kernel: str) -> dict:
    """Least times for a bf16 flash kernel at H = 2, D = 128 on a (B, T)
    key mask, each the larger of operations at the bf16 tensor-core rate
    (989 TF/s) and bytes at the memory rate, counting the keys of the
    BOUND_KEY_TILE-key tiles with a valid key: "fwd", 4·H·D flops per
    query row and key, q, k, v read and out written in bf16; "dq", 6·H·D
    (S, dP, dq), q, k, v, out, dO read and dq written, lse read and Δ
    written in float32; "dkv", 8·H·D (S, dP, dk, dv), q, k, v, dO read and
    dk, dv written, lse and Δ read; "both" (the whole backward) 10·H·D,
    q, k, v, out, dO read and dq, dk, dv written, lse read."""
    import torch

    b, t = mask.shape
    tile = BOUND_KEY_TILE
    n_tiles = math.ceil(t / tile)
    valid = torch.zeros(b, n_tiles * tile, dtype=torch.bool,
                        device=mask.device)
    valid[:, :t] = ~mask
    live = int(valid.view(b, n_tiles, tile).any(-1).sum())
    per = {"fwd": 4, "dq": 6, "dkv": 8, "both": 10}[kernel]
    tensors = {"fwd": 4, "dq": 6, "dkv": 7, "both": 8}[kernel]
    stats = {"fwd": 1, "dq": 2, "dkv": 2, "both": 1}[kernel]

    def bound(keys):
        flops = per * 2 * t * keys * 128
        n_bytes = 2 * 2 * 128 * tensors * b * t + 4 * 2 * stats * b * t \
            + b * t
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", flops)

    live_ms, by, flops = bound(tile * live)
    return {"live": live_ms, "bound_by": by, "dense": bound(b * t)[0],
            "live_tiles": live, "tiles": b * n_tiles, "tile": tile,
            "flops_live": flops}


def tuned_configs(root: Path, corpus: str) -> dict[str, str]:
    """The shipped ESD preprocess.yaml and model.yaml and train_tuned.yaml
    with the corpus at ``corpus``, ``attention_impl: "flash"``, the train
    paths under ``root`` and TUNED_CADENCE; the recipe (batch 32, bf16 amp,
    the optimizer, steps_per_call 10) is the shipped one."""
    root.mkdir(parents=True, exist_ok=True)
    pre = _yaml_set((CONFIG_DIR / "preprocess.yaml").read_text(),
                    "preprocessed_path", corpus)
    model = (CONFIG_DIR / "model.yaml").read_text().replace(
        "transformer:\n", 'transformer:\n  attention_impl: "flash"\n', 1)
    train = (CONFIG_DIR / "train_tuned.yaml").read_text()
    for key in ("ckpt_path", "log_path", "result_path"):
        train = _yaml_set(train, key, root / key.split("_")[0])
    for key, value in TUNED_CADENCE.items():
        train = _yaml_set(train, key, value)
    out = {}
    for name, text in (("preprocess", pre), ("model", model),
                       ("train", train)):
        out[name] = str(root / f"{name}.yaml")
        Path(out[name]).write_text(text)
    return out


def phase_tuned_training(smoke: Smoke, device):
    """Phase 11: efs2-torch-train on train_tuned.yaml under "flash", 20
    steps in two chunks of 10 on phase 5's corpus. Every train step must
    launch each bf16 kernel once per FFT block (10) and no float32 kernel;
    the val and synth steps run the float32 model, so the float32 forward
    only (10 a forward) and no bf16 kernel. Returns the launches over the
    run."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop

    card = nvidia_smi_line()
    calls: dict[str, list] = {"train_step": [], "eval_step": [],
                              "synth_step": []}
    losses: list[float] = []  # each train step's total loss
    originals = {name: getattr(loop, name) for name in calls}

    def counted(name):
        fn = originals[name]

        def wrapper(*args, **kwargs):
            before = bf16_counts() + flash_counts()
            out = fn(*args, **kwargs)
            calls[name].append(tuple(
                a - b for a, b in zip(bf16_counts() + flash_counts(),
                                      before)))
            if name == "train_step":
                losses.append(float(out.total))
            return out

        return wrapper

    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        corpus = write_training_corpus(str(tmp / "corpus"), 0)
        y = tuned_configs(tmp, corpus)
        cfg = C.load_config(y["preprocess"], y["model"], y["train"])
        t = cfg.model.transformer
        n_blocks = t.encoder_layer + t.decoder_layer
        reset_flash_counts()
        reset_bf16_counts()
        for name in calls:
            setattr(loop, name, counted(name))
        try:
            _, seconds = run_cli("train", [
                "-p", y["preprocess"], "-m", y["model"], "-t", y["train"],
                "--total_steps", TUNED_STEPS, "--device", str(device)])
        finally:
            for name, fn in originals.items():
                setattr(loop, name, fn)
        launches = bf16_counts() + flash_counts()
        log = _metrics(tmp / "log" / "train" / "metrics.jsonl")
        means = [r["total_loss"] for r in log]
        first, last = (sum(losses[:5]) / 5, sum(losses[-5:]) / 5)
        inference = calls["eval_step"] + calls["synth_step"]
        train_ok = all(c == (n_blocks,) * 3 + (0, 0, 0)
                       for c in calls["train_step"])
        eval_ok = all(c == (0, 0, 0, n_blocks, 0, 0) for c in inference)
        smoke.check(
            cfg.train.amp_dtype == "bfloat16" and t.attention_impl == "flash"
            and cfg.train.steps_per_call == 10
            and cfg.train.optimizer.batch_size == 32
            and len(calls["train_step"]) == TUNED_STEPS and train_ok
            and calls["eval_step"] and calls["synth_step"] and eval_ok,
            f"efs2-torch-train, train_tuned.yaml (batch "
            f"{cfg.train.optimizer.batch_size}, amp {cfg.train.amp_dtype}, "
            f"steps_per_call {cfg.train.steps_per_call}) under "
            f"{t.attention_impl!r}: {len(calls['train_step'])} train steps "
            f"in {seconds:.2f} s, each launching (bf16 forward, dQ, dK/dV; "
            f"float32 forward, dQ, dK/dV) {sorted(set(calls['train_step']))}"
            f" (expected {(n_blocks,) * 3 + (0, 0, 0)}); "
            f"{len(calls['eval_step'])} val and {len(calls['synth_step'])} "
            f"synth steps, each {sorted(set(inference))}"
            f" (expected {(0, 0, 0, n_blocks, 0, 0)}); over the run "
            f"{launches} [{card}]")
        smoke.check([r["step"] for r in log] == [10, 20]
                    and all(math.isfinite(x) for x in losses + means)
                    and last < first
                    and sorted(os.listdir(tmp / "ckpt")) == ["20.pt"],
                    f"total loss, mean of the first and the last 5 steps: "
                    f"{first:.4f} -> {last:.4f} (falling); logged chunk "
                    f"means at steps {[r['step'] for r in log]}: {means}; "
                    f"checkpoints {sorted(os.listdir(tmp / 'ckpt'))}")
    return {"bf16": launches[:3], "float32": launches[3:],
            "seconds": seconds}


def phase_bf16_times(device):
    """Phase 11b: the bf16 kernels against their bounds, their plain
    versions and SDPA in bf16 with the bool mask, its backend named
    (forward at fwd_timed_cases(): the long-form shapes and the recipe's
    B = 32 at T = 1000 and 128, also from a CUDA graph; backward at
    bwd_timed_cases(): the
    training bucket's T = 1000 and 4096 at B = 4, the recipe's B = 32 at
    T = 1000 and 500), and the train step under amp bf16 "flash", amp bf16
    "auto" and float32 "flash" at the bucket (128, 1000), B = 4 and 32, in
    turns. Returns the kernels' rows: the forward at T = 4096, the
    backward at (4, 2, 1000, 128)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )

    card = nvidia_smi_line()
    gen = torch.Generator().manual_seed(11)
    scale = 128 ** -0.5
    iters = 20
    key_tile = build.load("flash_mha_bf16").flash_mha_fwd_bf16_key_tile()
    # The forward kernel's plain version, blocked on its key tiles (an
    # older checkout, driven through --root, may have only the unblocked
    # one).
    forward_plain = getattr(fa, "flash_mha_blocked_plain",
                            lambda q, k, v, mask, scale, _: fa.flash_mha_plain(
                                q, k, v, mask, scale))
    rows = {}

    def sdpa_backend(fn):
        """The SDPA backend whose forced time is the default's."""
        default = cuda_time_ms(fn, iters)
        forced = {}
        for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                              ("cudnn", SDPBackend.CUDNN_ATTENTION),
                              ("math", SDPBackend.MATH)):
            try:
                with sdpa_kernel(backend):
                    forced[name] = cuda_time_ms(fn, iters)
            except RuntimeError:  # the backend refuses these inputs
                continue
        ran = min(forced, key=lambda n: abs(forced[n] - default))
        return default, ran, forced

    for b, t, case_rows in fwd_timed_cases():
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, case_rows, gen))
        keep = ~mask[:, None, None, :]

        def kernel():
            return fa.flash_mha(q, k, v, mask, scale)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                  scale=scale)

        ms = cuda_time_ms(kernel, iters)
        plain = cuda_time_ms(lambda: forward_plain(
            q, k, v, mask, scale, key_tile), iters)
        lib, ran, forced = sdpa_backend(sdpa)
        # The same launches replayed from a CUDA graph: the device's time
        # where the event loop above times the host (PERF.md §7).
        graph_ms, how = graph_time_ms(kernel)
        lib_graph, _ = graph_time_ms(sdpa)
        bd = flash_bf16_bounds_ms(mask, "fwd")
        rows[("fwd", b, t)] = {"shape": f"({b}, 2, {t}, 128) bf16, "
                                        f"{shown_rows(case_rows)}",
                               "ms": ms, "plain_ms": plain,
                               "library_ms": lib, "bound_ms": bd["live"],
                               "bound_by": bd["bound_by"]}
        print(f"  flash_mha bf16 ({b}, 2, {t}, 128), {shown_rows(case_rows)}"
              f": kernel {ms:.4f} ms ({bd['flops_live'] / ms / 1e9:.1f} TF/s"
              f" over the {bd['live_tiles']} of {bd['tiles']} live "
              f"{bd['tile']}-key tiles; {bd['live'] / ms:.3f} of the bound),"
              f" {graph_ms:.4f} ms from a {how} of {GRAPH_LAUNCHES} launches "
              f"({bd['flops_live'] / graph_ms / 1e9:.1f} TF/s, "
              f"{bd['live'] / graph_ms:.3f} of the bound); bound (bf16 rate) "
              f"{bd['live']:.4f} ms live, {bd['dense']:.4f} dense "
              f"({bd['bound_by']}); plain {plain:.4f} ms; SDPA bf16 "
              f"{lib:.4f} ms, {lib_graph:.4f} from a {how} (the {ran} "
              f"backend; forced "
              f"{', '.join(f'{n} {x:.4f}' for n, x in forced.items())}); "
              f"kernel / SDPA {ms / lib:.3f}, from graphs "
              f"{graph_ms / lib_graph:.3f} [{card}]", flush=True)
        del q, k, v, mask, keep

    for b, t, lens in bwd_timed_cases():
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, prefixes(*lens), gen))
        dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        _, delta = fa._flash_mha_bwd_dq_cuda(q, k, v, mask, out, dout, lse,
                                             scale)
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
        # The backend SDPA's dispatch picks for these inputs, whose
        # backward the autograd graph holds.
        ran = SDPBackend(torch._fused_sdp_choice(
            qs, ks, vs, ~mask[:, None, None, :], 0.0, False,
            scale=scale)).name.lower()
        bd = {name: flash_bf16_bounds_ms(mask, name)
              for name in ("dq", "dkv", "both")}
        for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            rows[(name, b, t)] = {"shape": f"({b}, 2, {t}, 128) bf16, key "
                                           f"lengths {lens}",
                                  "ms": ms, "plain_ms": plain,
                                  "bound_ms": bd[name]["live"],
                                  "bound_by": bd[name]["bound_by"],
                                  "library_ms": lib}
        flops = 14 * 2 * t * BOUND_KEY_TILE * bd["both"]["live_tiles"] * 128
        shown = lens if b <= 4 else f"{b} seeded in [{t // 2}, {t}]"
        print(f"  flash_mha backward bf16 ({b}, 2, {t}, 128), key lengths "
              f"{shown}: dQ kernel {dq_ms:.4f} ms (bound "
              f"{bd['dq']['live']:.4f} live, {bd['dq']['dense']:.4f} dense),"
              f" dK/dV kernel {dkv_ms:.4f} ms (bound {bd['dkv']['live']:.4f}"
              f" live, {bd['dkv']['dense']:.4f} dense), together "
              f"{dq_ms + dkv_ms:.4f} ms = {flops / (dq_ms + dkv_ms) / 1e9:.1f}"
              f" TF/s over the live tiles; whole-backward bound "
              f"{bd['both']['live']:.4f} ms; plain backward {plain:.4f} ms; "
              f"SDPA bf16 backward {lib:.4f} ms (the {ran} backend); "
              f"pair / SDPA {(dq_ms + dkv_ms) / lib:.3f} [{card}]",
              flush=True)
        del q, k, v, mask, dout, out, lse, delta, qs, ks, vs, o

    steps = {}
    for b, s, t in TUNED_TIMED:
        batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
        runs = time_train_steps({(amp, impl): C.Config(
            model=C.ModelConfig(
                transformer=C.TransformerConfig(attention_impl=impl)),
            train=C.TrainConfig(amp_dtype=amp)) for amp, impl in TUNED_RUNS},
            batch, device)
        for (amp, impl), run in runs.items():
            reps = sorted(run["ms"])
            steps[(b, amp, impl)] = (reps[4] + reps[5]) / 2
            print(f"  train step amp {amp} {impl!r}, B={b}, bucket (S, T) = "
                  f"({s}, {t}): median {steps[(b, amp, impl)]:.3f} ms, min "
                  f"{reps[0]:.3f}, max {reps[-1]:.3f} over 10 steps after 3 "
                  f"warm-ups, in turns with the other two; last loss "
                  f"{run['loss']:.4f}; launches per step (bf16 forward, dQ,"
                  f" dK/dV; float32 forward, dQ, dK/dV) {run['counts']}; "
                  f"max_memory_allocated {run['peak']:.1f} MiB [{card}]",
                  flush=True)
        del runs, batch
    for b, _, _ in TUNED_TIMED:
        bf16_flash = steps[(b, "bfloat16", "flash")]
        print(f"  B={b}: amp bf16 'flash' / float32 'flash' = "
              f"{bf16_flash / steps[(b, 'float32', 'flash')]:.3f}, amp bf16 "
              f"'flash' / amp bf16 'auto' = "
              f"{bf16_flash / steps[(b, 'bfloat16', 'auto')]:.3f}")
    return {"fwd": rows[("fwd", 4, max(FLASH_TIMED))],
            "dq": rows[("dq", 4, min(FLASH_BWD_TIMED))],
            "dkv": rows[("dkv", 4, min(FLASH_BWD_TIMED))]}


# Every phase, in the order a whole run takes them.
# ---------------------------------------------------------------------------
# Phase 12: the multilingual front end and corpora through the CLIs.

# Mandarin raw text with a date, a time, money, a percent, a phone number
# and a decimal, for normalize_chinese.
ZH_RAW_TEXTS = ("今天是2024年3月5日", "我们明天下午3:45见", "这个东西卖¥36.5",
                "他说好了80%", "请打电话13812345678", "今天的天气是3.14度")
LEX_ESD_UTTS = 2        # per speaker and emotion: 20 utterances to align
IEMOCAP_SR = 16000      # the release's rate; prepare_iemocap resamples
IEMOCAP_SESSIONS = ("Session1", "Session2")
# (emotion, valence, arousal), EmoEvaluation's order of the two values.
IEMOCAP_EMOTIONS = (("neu", "2.5", "2.5"), ("ang", "2.0", "3.5"),
                    ("hap", "4.0", "3.0"), ("sad", "2.0", "1.5"))
# English transcripts with numbers, "$" amounts and abbreviations, so that
# english_cleaners spells them out; each session says all twelve.
IEMOCAP_TEXTS = (
    "Dr. Smith paid $3.50 for 2 apples.", "Mr. Jones has 12 cats.",
    "We met at 10 on the 21st of May.", "It costs $1,200 to fly there.",
    "Mrs. Brown read 45 pages today.", "The 3rd train leaves at 7.",
    "Capt. Hook sailed 1,000 miles.", "I owe you $20, not $2.",
    "St. Louis is 250 miles away.", "Gen. Lee had 3 horses.",
    "She turned 30 on the 2nd.", "Lt. Dan ran 5 miles at dawn.")
IEMOCAP_VAL = 4
IEMOCAP_TRAIN_STEPS = 8
IEMOCAP_CADENCE = dict(log_step=1, val_step=8, synth_step=8, save_step=8)
PROFILE_STEPS = (3, 5)  # profile_start_step, profile_stop_step
# Korean scripts with numbers, for korean_cleaners: (clip, start frame,
# end frame, speaker, script).
AIHUB_TURNS = (("clip_0001", 30, 90, "1", "오늘은 3월 15일입니다"),
               ("clip_0001", 120, 200, "2", "사과 12개를 샀어요"),
               ("clip_0001", 230, 290, "1", "버스는 7시에 와요"),
               ("clip_0002", 20, 100, "2", "값이 12000원이에요 – 네"),
               ("clip_0002", 130, 190, "1", "2번 출구로…\t나가세요"),
               ("clip_0002", 210, 280, "2", "우리는 25살이에요"))
AIHUB_FRAMES, AIHUB_FPS = 300, 30.0
CHUNK_SPC = 4
CHUNK_VOC_STEPS = 8
CHUNK_VOC_CADENCE = dict(log_step=1, val_step=8, save_step=4)
# TF32 rounds each float32 operand to 10 mantissa bits (2^-11 relative);
# through the model's chains of matmuls and convs the first step's loss
# moves by far less than 1e-2 of itself.
TF32_LOSS_REL_BOUND = 1e-2
TF32_STEPS = 2


def write_iemocap_corpus(root: str, seed: int) -> list[tuple[str, str]]:
    """IEMOCAP's release layout under ``root``: per session
    ``sentences/wav/<dialog>/<base>.wav`` (16 kHz, ``harmonic_signal``, its
    length from the transcript's letters) and ``dialog/{transcriptions,
    EmoEvaluation}/<dialog>.txt``, the emotions in turn. Returns (base,
    transcript) of every utterance."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.text import clean_text
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(seed)
    utts = []
    for s, session in enumerate(IEMOCAP_SESSIONS):
        dialog = f"Ses0{s + 1}{'FM'[s]}_impro01"
        wav_dir = os.path.join(root, session, "sentences", "wav", dialog)
        dlg_dir = os.path.join(root, session, "dialog")
        os.makedirs(wav_dir)
        for sub in ("transcriptions", "EmoEvaluation"):
            os.makedirs(os.path.join(dlg_dir, sub))
        trans, emo = [], ["% [START_TIME - END_TIME] TURN_NAME EMOTION "
                          "[V, A, D]"]
        for i, text in enumerate(IEMOCAP_TEXTS):
            base = f"{dialog}_{'FM'[i % 2]}{i:03d}"
            emotion, valence, arousal = IEMOCAP_EMOTIONS[(i + s) % 4]
            # 0.1 s a letter of the cleaned transcript: a letter is a
            # phone of the phase's lexicon.
            letters = sum(c.isalpha()
                          for c in clean_text(text, ["english_cleaners"]))
            seconds = 0.8 + 0.1 * letters
            save_wav(os.path.join(wav_dir, base + ".wav"),
                     harmonic_signal(seconds, rng, IEMOCAP_SR), IEMOCAP_SR)
            t0 = 10.0 * i
            trans.append(f"{base} [{t0:.4f}-{t0 + seconds:.4f}]: {text}")
            emo.append(f"[{t0:.4f} - {t0 + seconds:.4f}]\t{base}\t{emotion}"
                       f"\t[{valence}, {arousal}, 2.5]")
            utts.append((base, text))
        for sub, lines in (("transcriptions", trans), ("EmoEvaluation", emo)):
            with open(os.path.join(dlg_dir, sub, dialog + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return utts


def write_letter_lexicon(texts, path: str) -> int:
    """An MFA-format lexicon for every whitespace token of ``texts``: a
    token's phones are its letters, which the pinyin table holds, so the
    aligner, the feature extractor and the dataset agree on every phone.
    Returns the entries."""
    words = sorted({w for t in texts for w in t.split()})
    with open(path, "w") as f:
        for w in words:
            f.write(f"{w}\t{' '.join(c for c in w if 'a' <= c <= 'z')}\n")
    return len(words)


def iemocap_configs(root: Path, corpus: str, lexicon: str,
                    npz: str) -> dict[str, str]:
    """The shipped ESD triplet turned to IEMOCAP: dataset IEMOCAP,
    english_cleaners, sub_dir_name "sessions", the letter lexicon, paths
    under ``root``; ``attention_impl: "flash"``, the seeded generator.npz
    as the sample vocoder; IEMOCAP_CADENCE, matmul_precision "highest"
    and the profiler window PROFILE_STEPS."""
    root.mkdir(parents=True, exist_ok=True)
    pre = (CONFIG_DIR / "preprocess.yaml").read_text()
    for key, value in (("dataset", "IEMOCAP"), ("corpus_path", corpus),
                       ("sub_dir_name", "sessions"),
                       ("lexicon_path", lexicon),
                       ("raw_path", root / "raw"),
                       ("preprocessed_path", root / "pre"),
                       ("val_size", IEMOCAP_VAL), ("language", "en")):
        pre = _yaml_set(pre, key, value)
    cleaners = 'text_cleaners: ["basic_cleaners"]'
    assert cleaners in pre
    pre = pre.replace(cleaners, 'text_cleaners: ["english_cleaners"]')
    model = (CONFIG_DIR / "model.yaml").read_text().replace(
        "transformer:\n", 'transformer:\n  attention_impl: "flash"\n', 1)
    speaker = '  speaker: "universal"\n'
    assert speaker in model
    model = model.replace(speaker, f'{speaker}  ckpt_path: "{npz}"\n')
    train = (CONFIG_DIR / "train.yaml").read_text()
    for key in ("ckpt_path", "log_path", "result_path"):
        train = _yaml_set(train, key, root / key.split("_")[0])
    for key, value in IEMOCAP_CADENCE.items():
        train = _yaml_set(train, key, value)
    train += ('\nmatmul_precision: "highest"\n'
              f"profile_start_step: {PROFILE_STEPS[0]}\n"
              f"profile_stop_step: {PROFILE_STEPS[1]}\n")
    out = {}
    for name, text in (("preprocess", pre), ("model", model),
                       ("train", train)):
        out[name] = str(root / f"{name}.yaml")
        Path(out[name]).write_text(text)
    return out


def trace_busy_share(path: str) -> tuple[float, float, int]:
    """From a ``torch.profiler`` Chrome trace: the union of the device's
    kernel, copy and set intervals over the window (the first event's
    start to the last event's end), the window in ms, and the kernels."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, last = 0.0, -math.inf
    for a, b in device:
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    return busy / (end - start), (end - start) / 1e3, n_kernels


def write_aihub_corpus(root: str, audio_root: str, seed: int) -> int:
    """AIHub-MMV's layout: per clip an annotation JSON (``nr_frame``,
    ``actor``, ``data[frame][sub]``) under ``root/part1`` and its audio,
    pre-extracted (no video, no ffmpeg), under ``audio_root/part1``.
    Returns the scripts."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    rng = np.random.default_rng(seed)
    for d in (root, audio_root):
        os.makedirs(os.path.join(d, "part1"))
    for clip in sorted({t[0] for t in AIHUB_TURNS}):
        save_wav(os.path.join(audio_root, "part1", clip + ".wav"),
                 harmonic_signal(AIHUB_FRAMES / AIHUB_FPS, rng, IEMOCAP_SR),
                 IEMOCAP_SR)
        data = {}
        for _, start, end, who, script in (t for t in AIHUB_TURNS
                                           if t[0] == clip):
            triple = {"emotion": "neutral", "arousal": "0.4",
                      "valence": "0.5"}
            data[str(start)] = {"sub1": {
                "text": {"script": script, "script_start": str(start),
                         "script_end": str(end), "intent": "inform",
                         "strategy": "none"},
                "emotion": {"text": triple, "sound": {}, "image": triple,
                            "multimodal": triple},
                "person_id": who}}
        with open(os.path.join(root, "part1", clip + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump({"nr_frame": AIHUB_FRAMES,
                       "actor": {"1": {"gender": "female", "age": "20대"},
                                 "2": {"gender": "male", "age": "30대"}},
                       "data": data}, f, ensure_ascii=False)
    return len(AIHUB_TURNS)


def phase12_mandarin_text(smoke: Smoke, device) -> int:
    """12a: raw Mandarin text → normalize_chinese → the bf16 Synthesizer
    at Config() width; returns the MRF launches."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
    from expressive_fastspeech2_mandarin_tpu_torch.text import (
        chinese_text_to_ids,
        symbols,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.text.hanzi import (
        hanzi_to_pinyin,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.text.normalizer_zh import (
        normalize_chinese,
    )

    normalized = [normalize_chinese(t) for t in ZH_RAW_TEXTS]
    ids = [chinese_text_to_ids(t) for t in normalized]
    unread = sorted({c for t in normalized for c in t
                     if "一" <= c <= "鿿"
                     and not "".join(hanzi_to_pinyin(c)).strip()})
    smoke.check(not any(c in "0123456789" for t in normalized for c in t)
                and all(x and symbols.PAD_ID not in x for x in ids),
                f"normalize_chinese: {list(zip(ZH_RAW_TEXTS, normalized))}; "
                f"no ASCII digit left, {[len(x) for x in ids]} phone IDs, "
                f"none pad (hanzi the built-in table cannot read, dropped "
                f"as in the JAX package: {unread})")
    cfg = Config()
    fs2, voc = seeded_states(cfg)
    synth = Synthesizer(cfg, fs2, voc, emotion_maps=EMOTION_MAPS,
                        device=device)
    n = len(normalized)
    tc0, fma0 = mrf_counts()
    results = synth.synthesize(normalized, [i % 4 for i in range(n)],
                               [EMOTIONS[i % 4] for i in range(n)],
                               vocoder="hifigan")
    tc, fma = (a - b for a, b in zip(mrf_counts(), (tc0, fma0)))
    per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
    peaks = [float(np.abs(r.wav).max()) for r in results]
    smoke.check(len(results) == n and all(
        r.wav.size > 0 and np.isfinite(r.wav).all() for r in results)
        and min(peaks) > 1e-4 and (tc, fma) == (per_call, 0),
        f"synthesize (bf16 HiFi-GAN): {n} waveforms, "
        f"{[round(r.wav.size / r.sampling_rate, 2) for r in results]} s, "
        f"peaks {[round(p, 4) for p in peaks]} (finite, non-silent); MRF "
        f"launches tensor-core {tc} (expected {per_call}), CUDA-core {fma}")
    del synth
    return tc


def phase12_lexicon(smoke: Smoke, device, tmp: Path) -> None:
    """12b: write_lexicon's inventory, then efs2-torch-pipeline
    --lexicon <it> --skip-train on phase 10's ESD corpus (fewer
    utterances)."""
    from expressive_fastspeech2_mandarin_tpu_torch.text.lexicon import (
        build_lexicon,
        write_lexicon,
    )

    lexicon = str(tmp / "pinyin.dict")
    n_entries = write_lexicon(lexicon)
    esd = write_esd_corpus(str(tmp / "esd"), 12, E2E_SECONDS, LEX_ESD_UTTS)
    y = e2e_configs(tmp / "lex", esd)
    text, seconds = run_cli("pipeline", [
        "-p", y["preprocess"], "-m", y["model"], "-t", y["train"],
        "--lexicon", lexicon, "--skip-train", "--device", str(device)])
    n_utts = len(ESD_SPEAKERS) * len(ESD_EMOTIONS) * LEX_ESD_UTTS
    grids = list((tmp / "lex" / "pre").glob("TextGrid/*/*.TextGrid"))
    smoke.check(n_entries == len(build_lexicon()) and len(grids) == n_utts
                and "[4/4] training: skipped" in text
                and (tmp / "lex" / "pre" / "train.txt").exists(),
                f"write_lexicon: {n_entries} syllables; efs2-torch-pipeline "
                f"--lexicon <it> --skip-train: {len(grids)} of {n_utts} "
                f"utterances aligned, features written, in {seconds:.2f} s")


def phase12_iemocap(smoke: Smoke, device, tmp: Path) -> dict:
    """12c: an IEMOCAP release → efs2-torch-pipeline stages 1-4 (8 steps
    under "flash", the profiler window, matmul_precision "highest") →
    efs2-torch-synthesize --mode grid from its checkpoint. Returns the
    flash and MRF launches."""
    import logging

    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import (
        save_generator_npz,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.text import clean_text
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop
    from expressive_fastspeech2_mandarin_tpu_torch.utils import plotting
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import load_wav

    card = nvidia_smi_line()
    utts = write_iemocap_corpus(str(tmp / "IEMOCAP_full_release"), 13)
    cleaned = [clean_text(" ".join(t.split()), ["english_cleaners"])
               for _, t in utts]
    lexicon = str(tmp / "english_letters.dict")
    n_words = write_letter_lexicon(cleaned, lexicon)
    npz = str(tmp / "generator.npz")
    save_generator_npz(npz, seeded_states(C.Config())[1])
    y = iemocap_configs(tmp / "iemocap", str(tmp / "IEMOCAP_full_release"),
                        lexicon, npz)
    argv = ["-p", y["preprocess"], "-m", y["model"], "-t", y["train"]]

    calls: dict[str, list] = {"train_step": [], "eval_step": [],
                              "synth_step": []}
    originals = {name: getattr(loop, name) for name in calls}

    def counted(name):
        fn = originals[name]

        def wrapper(*args, **kwargs):
            before = bf16_counts() + flash_counts()
            out = fn(*args, **kwargs)
            calls[name].append(tuple(
                a - b for a, b in zip(bf16_counts() + flash_counts(),
                                      before)))
            return out

        return wrapper

    skips: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: skips.append(record.getMessage())
    logging.getLogger(plotting.__name__).addHandler(handler)
    flash0, mrf0 = flash_counts(), mrf_counts()
    for name in calls:
        setattr(loop, name, counted(name))
    try:
        text, seconds = run_cli("pipeline", [
            *argv, "--total_steps", IEMOCAP_TRAIN_STEPS, "--device",
            str(device)])
    finally:
        for name, fn in originals.items():
            setattr(loop, name, fn)
        logging.getLogger(plotting.__name__).removeHandler(handler)
    train_flash = [a - b for a, b in zip(flash_counts(), flash0)]
    train_mrf = sum(mrf_counts()) - sum(mrf0)
    pre = tmp / "iemocap" / "pre"
    cfg = C.load_config(y["preprocess"], y["model"], y["train"])
    n_blocks = (cfg.model.transformer.encoder_layer
                + cfg.model.transformer.decoder_layer)
    emotions = json.loads((pre / "emotions.json").read_text())
    meta = [line for f in ("train.txt", "val.txt")
            for line in (pre / f).read_text().splitlines() if line.strip()]
    phones = {p for line in meta
              for p in line.split("|")[2].strip("{}").split()}
    grids = list(pre.glob("TextGrid/*/*.TextGrid"))
    smoke.check(len(grids) == len(utts) and len(meta) == len(utts)
                and set(emotions["emotion_dict"]) == {
                    e[0] for e in IEMOCAP_EMOTIONS}
                and phones <= set("abcdefghijklmnopqrstuvwxyz") | {"sp"},
                f"efs2-torch-pipeline stages 1-3 (IEMOCAP, english_cleaners, "
                f"{n_words} words in the letter lexicon): {len(grids)} of "
                f"{len(utts)} aligned, {len(meta)} utterances featurized, "
                f"emotions.json {sorted(emotions['emotion_dict'])}, "
                f"{len(phones)} phones, all letters of the pinyin table")
    log = _metrics(tmp / "iemocap" / "log" / "train" / "metrics.jsonl")
    smoke.check(
        cfg.train.matmul_precision == "highest"
        and len(calls["train_step"]) == IEMOCAP_TRAIN_STEPS
        and all(c == (0, 0, 0) + (n_blocks,) * 3
                for c in calls["train_step"])
        and [r["step"] for r in log] == list(
            range(1, IEMOCAP_TRAIN_STEPS + 1))
        and all(math.isfinite(r["total_loss"]) for r in log)
        and (tmp / "iemocap" / "ckpt" / f"{IEMOCAP_TRAIN_STEPS}.pt").exists(),
        f"stage 4, train under 'flash': {len(calls['train_step'])} steps in "
        f"{seconds:.2f} s (the whole pipeline), each launching (bf16 "
        f"forward, dQ, dK/dV; float32 forward, dQ, dK/dV) "
        f"{sorted(set(calls['train_step']))} (expected "
        f"{(0, 0, 0) + (n_blocks,) * 3}); val {calls['eval_step']}, synth "
        f"{calls['synth_step']}; flash over the run {train_flash}; losses "
        f"{[round(r['total_loss'], 3) for r in log]} [{card}]")
    traces = sorted((tmp / "iemocap" / "log" / "profile").glob("*.json"))
    want = f"trace_steps{PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}.json"
    ok = [t.name for t in traces] == [want]
    busy, window_ms, n_kernels = (trace_busy_share(str(traces[0])) if ok
                                  else (math.nan, math.nan, 0))
    smoke.check(ok and n_kernels > 0 and 0.0 < busy <= 1.0
                and "profiler trace written to" in text,
                f"profiler window steps {PROFILE_STEPS}: "
                f"{[os.path.relpath(t, tmp) for t in traces]}, "
                f"{os.path.getsize(traces[0]) / 2**20 if ok else 0:.1f} MiB, "
                f"{n_kernels} kernels over a {window_ms:.1f} ms window, "
                f"device busy share {busy:.3f} (the profiler's host cost in "
                f"the window) [{card}]")
    samples = tmp / "iemocap" / "result" / "train_samples"
    png = samples / f"step{IEMOCAP_TRAIN_STEPS}.png"
    no_plt = plotting.pyplot() is None
    smoke.check((samples / f"step{IEMOCAP_TRAIN_STEPS}_mel.npy").exists()
                and (png.exists() != no_plt)
                and (not no_plt or plotting._skip_logged),
                f"synth_step {IEMOCAP_TRAIN_STEPS}: "
                + ("no matplotlib here, the figure's skip logged "
                   f"({skips or 'in an earlier phase'})" if no_plt
                   else f"{png.name} written")
                + f"; sample vocoder MRF launches over the run {train_mrf}")

    mrf1 = mrf_counts()
    grid_dir = tmp / "iemocap_grid"
    phone_text = "{" + " ".join(c for c in cleaned[0] if "a" <= c <= "z") + "}"
    _, synth_s = run_cli("synthesize", [
        *argv, "--mode", "grid", "--text", phone_text, "--vocoder_ckpt",
        npz, "--out_dir", grid_dir, "--device", str(device)])
    grid_mrf = [a - b for a, b in zip(mrf_counts(), mrf1)]
    wavs = sorted(grid_dir.glob("grid_*.wav"))
    audio = [load_wav(str(w), None)[0] for w in wavs]
    per_call = 2 * len(DILATIONS) * 3 * len(cfg.model.vocoder.upsample_rates)
    speakers = json.loads((pre / "speakers.json").read_text())
    smoke.check(len(wavs) == len(speakers) * len(IEMOCAP_EMOTIONS)
                and all(a.size > 0 and np.isfinite(a).all() for a in audio)
                and grid_mrf == [per_call * len(speakers), 0],
                f"efs2-torch-synthesize --mode grid from the step-"
                f"{IEMOCAP_TRAIN_STEPS} checkpoint: {len(wavs)} wavs "
                f"({sorted(speakers)} × {len(IEMOCAP_EMOTIONS)} emotions) in "
                f"{synth_s:.2f} s; MRF launches (tensor-core, CUDA-core) "
                f"{grid_mrf} (expected {[per_call * len(speakers), 0]})")
    return {"flash": train_flash, "mrf": train_mrf + sum(grid_mrf)}


def phase12_aihub(smoke: Smoke, tmp: Path) -> None:
    """12d: AIHub-MMV clips with pre-extracted WAVs → create_dataset →
    prepare_aihub_mmv with korean_cleaners; extract_audio without
    ffmpeg."""
    import shutil

    from expressive_fastspeech2_mandarin_tpu_torch import preprocess

    n = write_aihub_corpus(str(tmp / "mmv"), str(tmp / "mmv_audio"), 14)
    n_ds = preprocess.create_aihub_dataset(
        str(tmp / "mmv"), str(tmp / "mmv_audio"), str(tmp / "mmv_ds"),
        sampling_rate=IEMOCAP_SR)
    n_raw = preprocess.prepare_aihub_mmv(
        str(tmp / "mmv_ds"), str(tmp / "mmv_raw"), sampling_rate=SR,
        sub_dir_name="clips", cleaners=("korean_cleaners",))
    lines = (tmp / "mmv_raw" / "filelist.txt").read_text(
        encoding="utf-8").splitlines()
    labs = sorted((tmp / "mmv_raw" / "clips").glob("*/*.lab"))
    texts = [p.read_text(encoding="utf-8") for p in labs]
    smoke.check(n_ds == n_raw == n == len(lines) == len(labs)
                and all(len(line.split("|")) == 17 for line in lines)
                and all(t and not any(c.isdigit() for c in t)
                        for t in texts),
                f"AIHub-MMV: {n_ds} utterances cut from "
                f"{len({t[0] for t in AIHUB_TURNS})} clips, 17-field "
                f"filelist, korean_cleaners labs without digits: {texts}")
    if shutil.which("ffmpeg") is None:
        try:
            preprocess.extract_aihub_audio(str(tmp / "mmv"),
                                           str(tmp / "mmv_x"))
            message = ""
        except RuntimeError as e:
            message = str(e)
        smoke.check(message.startswith("ffmpeg not found"),
                    f"extract_audio without ffmpeg raises: {message!r}")
    else:
        print("  ffmpeg is installed here: extract_audio's refusal not "
              "exercised")


def phase12_chunked_gan(smoke: Smoke, device, tmp: Path) -> None:
    """12e: train_vocoder at hifigan/config.json width (batch 16 × 8192),
    8 steps in chunks of 4, then the same 8 steps one by one from the
    same state: each chunk's logged losses against its steps' mean, and
    the log, val and save steps the JAX package's loop picks."""
    import dataclasses

    import torch

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.train.vocoder import (
        load_corpus_wavs,
        train_vocoder,
    )

    card = nvidia_smi_line()
    wavs = load_corpus_wavs(write_wav_corpus(str(tmp / "wavs"), 8), SR)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for spc, cadence in ((CHUNK_SPC, CHUNK_VOC_CADENCE),
                             (1, dict(log_step=1, val_step=100,
                                      save_step=100))):
            cfg = C.Config(vocoder_train=dataclasses.replace(
                C.VocoderTrainConfig(), steps_per_call=spc, **cadence))
            out = tmp / f"voc_spc{spc}"
            t0 = time.perf_counter()
            train_vocoder(cfg, wavs, str(out), total_steps=CHUNK_VOC_STEPS,
                          device=device, log=lambda *_: None)
            torch.cuda.synchronize()
            runs[spc] = (_metrics(out / "metrics.jsonl"),
                         sorted(int(p.name[:-3])
                                for p in (out / "ckpt").glob("*.pt")),
                         time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    records, saved, chunk_s = runs[CHUNK_SPC]
    one = {r["step"]: r for r in runs[1][0] if "mel_l1" in r}
    logged = [r for r in records if "mel_l1" in r]
    worst = 0.0
    for r in logged:
        for key in ("gen_total", "disc", "mel_l1", "fm", "adv"):
            mean = sum(one[s][key] for s in range(
                r["step"] - CHUNK_SPC + 1, r["step"] + 1)) / CHUNK_SPC
            worst = max(worst, abs(r[key] - mean) / abs(mean))
    ends = range(CHUNK_SPC, CHUNK_VOC_STEPS + 1, CHUNK_SPC)

    def jax_steps(every):  # the JAX loop's test at each chunk's end
        return [e for e in ends if e % max(every, CHUNK_SPC) < CHUNK_SPC]

    want = {"log": jax_steps(CHUNK_VOC_CADENCE["log_step"]),
            "val": jax_steps(CHUNK_VOC_CADENCE["val_step"]),
            "save": sorted(set(jax_steps(CHUNK_VOC_CADENCE["save_step"])
                               + [CHUNK_VOC_STEPS]))}
    got = {"log": [r["step"] for r in logged],
           "val": [r["step"] for r in records if "val_mel_l1" in r],
           "save": saved}
    smoke.check(got == want and worst <= VOC_LOSS_REL_BOUND,
                f"train_vocoder, {CHUNK_VOC_STEPS} steps in chunks of "
                f"{CHUNK_SPC} against one by one (batch "
                f"{C.VocoderTrainConfig().batch_size} × "
                f"{C.VocoderTrainConfig().segment_size}): worst rel diff "
                f"of a chunk's mean losses {worst:.2e} (bound "
                f"{VOC_LOSS_REL_BOUND:.0e}); logged, validated, saved at "
                f"{got} (the JAX loop's {want}); {chunk_s:.2f} s chunked, "
                f"{runs[1][2]:.2f} s one by one [{card}]")


def phase12_tf32(smoke: Smoke, device, tmp: Path) -> None:
    """12f: train() in float32 under matmul_precision "high" (TF32 on for
    its steps, off after it) against "highest"; the first step's loss;
    step times of both at phase 6's batch, in turns."""
    import dataclasses

    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        loop,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        matmul_precision,
        stage_batch,
    )

    card = nvidia_smi_line()
    corpus = write_training_corpus(str(tmp / "corpus"), 0)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    seen: dict[str, list] = {}
    real = loop.train_step
    for name in ("high", "highest"):
        base = training_config(corpus, str(tmp / name), "auto")
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, matmul_precision=name))
        seen[name] = []

        def step(state, batch, cfg, rows=seen[name]):
            rows.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            report = real(state, batch, cfg)
            rows[-1] += (float(report.total),)
            return report

        loop.train_step = step
        try:
            loop.train(cfg, total_steps=TF32_STEPS, device=device)
        finally:
            loop.train_step = real
    after = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    high, highest = seen["high"][0][2], seen["highest"][0][2]
    rel = abs(high - highest) / abs(highest)
    smoke.check([r[:2] for r in seen["high"]] == [(True, True)] * TF32_STEPS
                and [r[:2] for r in seen["highest"]]
                == [(False, False)] * TF32_STEPS
                and after == before and rel <= TF32_LOSS_REL_BOUND,
                f"train(), float32: TF32 (matmul, cuDNN) inside its steps "
                f"{sorted({r[:2] for r in seen['high']})} under 'high', "
                f"{sorted({r[:2] for r in seen['highest']})} under "
                f"'highest', {after} after ({before} before); first-step "
                f"loss {high:.6f} "
                f"against {highest:.6f}, rel diff {rel:.2e} (bound "
                f"{TF32_LOSS_REL_BOUND:.0e})")

    b, s, t = TRAIN_TIMED
    batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
    cfg = training_config(corpus, str(tmp / "timed"), "auto")
    states = {name: create_train_state(cfg, None, device)
              for name in ("highest", "high")}
    ms: dict[str, list] = {name: [] for name in states}
    for i in range(13):
        for name, state in states.items():
            with matmul_precision(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.train_step(state, batch, cfg)
                torch.cuda.synchronize()
            if i >= 3:
                ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {name: sorted(v)[len(v) // 2] for name, v in ms.items()}
    print(f"  float32 train step, B={b}, bucket ({s}, {t}), 'auto': "
          f"matmul_precision 'highest' {med['highest']:.3f} ms, 'high' "
          f"(TF32) {med['high']:.3f} ms, medians of 10 after 3 warm-ups, "
          f"in turns [{card}]", flush=True)


def phase_front_ends(smoke: Smoke, device):
    """Phase 12: (a) Mandarin raw text through normalize_chinese and the
    bf16 Synthesizer; (b) write_lexicon and the pipeline aligning from it;
    (c) an IEMOCAP release through efs2-torch-pipeline stages 1-4 and
    efs2-torch-synthesize; (d) AIHub-MMV prep; (e) chunked GAN steps; (f)
    TF32 under matmul_precision "high". Every kernel's counts are set to 0
    at the start and read at the end. Returns the launches."""
    reset_flash_counts()
    reset_bf16_counts()
    reset_mrf_counts()
    times = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        for key, fn, fn_args in (
                ("a", phase12_mandarin_text, (smoke, device)),
                ("b", phase12_lexicon, (smoke, device, tmp / "b")),
                ("c", phase12_iemocap, (smoke, device, tmp / "c")),
                ("d", phase12_aihub, (smoke, tmp / "d")),
                ("e", phase12_chunked_gan, (smoke, device, tmp / "e")),
                ("f", phase12_tf32, (smoke, device, tmp / "f"))):
            (tmp / key).mkdir()
            t0 = time.perf_counter()
            fn(*fn_args)
            times[key] = time.perf_counter() - t0
            print(f"   12{key}: {times[key]:.1f} s", flush=True)
    flash = flash_counts()
    launches = {"mrf_resblock": mrf_counts()[0],
                "mrf_resblock_f32": mrf_counts()[1],
                "flash_mha": flash[0], "flash_mha_bwd_dq": flash[1],
                "flash_mha_bwd_dkv": flash[2]}
    smoke.check(all(launches[k] > 0 for k in (
        "mrf_resblock", "flash_mha", "flash_mha_bwd_dq",
        "flash_mha_bwd_dkv")),
        f"kernel launches over phase 12: {launches}")
    return {"launches": launches, "times": times}


PHASES = ("1", "2", "2b", "2c", "2d", "2e", "3", "3b", "4", "4b", "5", "6",
          "7", "8", "8b", "9", "10", "11", "11b", "12")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA GPU and check it.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all, "
                             "and the result lines); 3b, 4 and 4b need 3")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose package to drive (default: "
                             "this script's)")
    args = parser.parse_args(argv)
    chosen = args.phases.split(",")
    whole = tuple(chosen) == PHASES
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown or ({"3b", "4", "4b"} & set(chosen) and "3" not in chosen):
        parser.error(f"phases {unknown or chosen}: not a phase, or 3b, 4, "
                     f"4b without 3")
    root = args.root.resolve()
    if not (root / PKG / "__init__.py").exists():
        print(f"chip_smoke: the package {PKG} is not in {root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smoke = Smoke()
    t_start = time.time()
    results = {}

    def run(key, name, fn, *fn_args):
        if key in chosen:
            results[key] = smoke.phase(f"{key}. {name}", fn, *fn_args)
        return results.get(key)

    run("1", "environment and build", phase_environment, smoke)
    worst = run("2", "mrf_resblock kernel vs plain on the card",
                phase_mrf_vs_plain, smoke, device)
    worst_flash = run("2b", "flash_mha kernel vs plain on the card",
                      phase_flash_vs_plain, smoke)
    worst_long = run("2c", "mrf_resblock kernel vs plain at the long-form "
                     "and streaming shapes", phase_long_kernel_vs_plain,
                     smoke, device)
    worst_bwd = run("2d", "flash_mha backward kernels vs plain on the card",
                    phase_flash_bwd_vs_plain, smoke)
    worst_bf16 = run("2e", "flash_mha bf16 kernels vs plain on the card",
                     phase_flash_bf16_vs_plain, smoke)
    main_run = run("3", "main path: Synthesizer.synthesize", phase_main_path,
                   smoke, device, TEXTS, EMOTIONS)
    flash_launches = totals = flash_row = None
    if main_run is not None:
        flash_launches = run(
            "3b", "long-form path: synthesize(max_mel_len=4096) and "
            "synthesize_streaming", phase_long_form, smoke, device,
            main_run[0])
        totals = run("4", "times", phase_times, main_run[0], TEXTS, EMOTIONS)
        flash_row = run("4b", "times: long-form path and flash kernel",
                        phase_long_times, main_run[0])
    train_launches = run("5", "training: train() under "
                         "attention_impl='flash'", phase_training, smoke,
                         device)
    bwd_rows = run("6", "times: train step and flash backward kernels",
                   phase_train_times, device)
    dsp = run("7", "DSP, Griffin-Lim and MelGAN on the card",
              phase_dsp_vocoders, smoke, device, TEXTS, EMOTIONS)
    voc_launches = run("8", "HiFi-GAN GAN training at full width",
                       phase_vocoder_training, smoke, device, TEXTS,
                       EMOTIONS)
    voc_times = run("8b", "times: GAN step", phase_vocoder_times, device)
    features = run("9", "feature extraction and GTA fine-tuning at full "
                   "width", phase_features_gta, smoke, device, TEXTS,
                   EMOTIONS)
    entry = run("10", "entry points: the Quick start through the CLIs",
                phase_entry_points, smoke, device)
    tuned = run("11", "efs2-torch-train on train_tuned.yaml (bf16 amp) "
                "under attention_impl='flash'", phase_tuned_training, smoke,
                device)
    bf16_rows = run("11b", "times: bf16 flash kernels and the amp bf16 "
                    "train step", phase_bf16_times, device)
    fronts = run("12", "the multilingual front end and corpora through the "
                 "CLIs", phase_front_ends, smoke, device)
    print(f"== done in {time.time() - t_start:.1f} s")
    if smoke.failures or any(results.get(key) is None for key in chosen):
        print("chip_smoke: FAILED:\n  " + "\n  ".join(smoke.failures),
              file=sys.stderr)
        return 1
    if not whole:
        print(f"chip_smoke: phases {','.join(chosen)} of {root} ok (not "
              f"the whole run: no result lines)")
        return 0

    _, launches, f32_launches = main_run
    f32 = totals["f32"]
    kernels = [{
        "name": "mrf_resblock",
        "route": "cuda",
        "source": f"{PKG}/csrc/mrf_resblock.cu",
        "replaces": "expressive_fastspeech2_mandarin_tpu/ops/pallas/"
                    "mrf_resblock.py:185",
        "launches": (launches + entry["launches"]["mrf_resblock"]
                     + fronts["launches"]["mrf_resblock"]),
        "max_abs_err": max(worst[0], worst_long[0]),
        "shape": f"{len(STAGE_SHAPES) * len(KERNEL_SIZES)} resblocks bf16, "
                 f"B = {BATCH}, (C, T) in {list(STAGE_SHAPES)}, k in "
                 f"{list(KERNEL_SIZES)}",
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if 2 * totals["bound_by_operations_ms"]
                     >= totals["bound_ms"] else "bytes"),
        "library_ms": totals["library_ms"],
    }, {
        "name": "mrf_resblock_f32",
        "route": "cuda",
        "source": f"{PKG}/csrc/mrf_resblock.cu",
        "replaces": "expressive_fastspeech2_mandarin_tpu/ops/pallas/"
                    "mrf_resblock.py:186",
        "launches": f32_launches + fronts["launches"]["mrf_resblock_f32"],
        "max_abs_err": max(worst[1], worst_long[1]),
        "shape": f"{len(STAGE_SHAPES) * len(KERNEL_SIZES)} resblocks float32 "
                 f"(TF32 off), B = {BATCH}, (C, T) in {list(STAGE_SHAPES)}, "
                 f"k in {list(KERNEL_SIZES)}",
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": ("operations" if 2 * f32["bound_by_operations_ms"]
                     >= f32["bound_ms"] else "bytes"),
        "library_ms": f32["library_ms"],
    }, {
        "name": "flash_mha",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha.cu",
        "replaces": "expressive_fastspeech2_mandarin_tpu/ops/pallas/"
                    "flash_mha.py:53",
        "launches": (train_launches[0] + features["launches"]["flash_mha"]
                     + entry["launches"]["flash_mha"] + tuned["float32"][0]
                     + fronts["launches"]["flash_mha"]),
        "max_abs_err": worst_flash,
        **flash_row,
    }, {
        "name": "flash_mha_bwd_dq",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "launches": (train_launches[1] + entry["launches"]["flash_mha_bwd_dq"]
                     + fronts["launches"]["flash_mha_bwd_dq"]),
        "max_abs_err": worst_bwd[0],
        **bwd_rows["dq"],
    }, {
        "name": "flash_mha_bwd_dkv",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": (train_launches[2]
                     + entry["launches"]["flash_mha_bwd_dkv"]
                     + fronts["launches"]["flash_mha_bwd_dkv"]),
        "max_abs_err": worst_bwd[1],
        **bwd_rows["dkv"],
    }, {
        "name": "flash_mha_bf16",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bf16.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:589",
        "launches": tuned["bf16"][0],
        "max_abs_err": worst_bf16[0],
        **bf16_rows["fwd"],
    }, {
        "name": "flash_mha_bwd_dq_bf16",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd_bf16.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "launches": tuned["bf16"][1],
        "max_abs_err": worst_bf16[1],
        **bf16_rows["dq"],
    }, {
        "name": "flash_mha_bwd_dkv_bf16",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd_bf16.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": tuned["bf16"][2],
        "max_abs_err": worst_bf16[2],
        **bf16_rows["dkv"],
    }]
    print(f"card: {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
