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
     the waves of blocks at the timed shapes; for the float32 backward at
     D = 256 its registers, shared memory and cluster shape;
     the tensor-core kernels (MRF, flash forward, flash backward dQ and
     dK/dV) must not spill, and no wgmma may be serialized; the bf16
     kernels must be given at launch the registers their setmaxnreg split
     asks for;
  2. the MRF resblock kernels against their plain PyTorch version on the
     card, at the generator's four stage shapes (B=4 × 1000 mel frames) for
     k = 3, 7, 11 and 13 (past the templated sizes: the kernels' run-time
     tap count) and, in both dtypes, 17 (a three-stage weight ring in
     float32) and 45 (16 input channels a chunk in float32 at C = 256) and
     at the ragged T=700, in float32 (the float32 kernel, 3xTF32 wgmma)
     and bfloat16 (the bf16 kernel), with each resblock's six launches
     counted on the kernel of its dtype; a width the kernels
     are not built for (C = 16, k = 5, zero-padded by the wrapper); the
     wrapper raises when a gradient is wanted;
  3. the main path: ``Synthesizer.synthesize`` at ``Config()`` width on four
     utterances with a bfloat16 HiFi-GAN, with random weights from fixed
     seeds; the MRF launches over that run, every one on the bf16
     kernel (72 per generator call); the duration_control=2
     probe; one utterance's float32 waveform from the card against the same
     run on the CPU, its 72 MRF launches all on the float32 kernel;
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
     float32 kernel with TF32 off (its TF/s, its bound at the TF32 rate,
     its 3xTF32 floor at three TF32 products a product, the cuDNN chain
     in float32); with --root, another checkout's kernels at the same
     shapes, for a comparison in turns;
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
     1e-3 · max|g|); 8b: the eager GAN step's time (a step timed with
     ``mark`` runs eagerly) at batch 16 in float32 and
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
     chunk one replay of the compiled multi step (a shorter group the
     compiled single step), each train step 10 launches of each bf16
     kernel and none of the float32 kernels, the val and synth steps
     (float32, as the JAX package's) 10 float32 forward launches each and
     nothing else; the chunk-mean loss falls;
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
     step times;
  13. data-parallel training (``parallel/``), each rank a process on the
     one card (``python3 chip_smoke.py --dp-worker``, killed after
     DP_TIMEOUT): at ``Config()`` width under "flash", float32, a global
     batch of 8 at the bucket (128, 1000) from phase 5's corpus, 6 steps
     on 1 rank and on 2 gloo ranks (4 rows each) over the same global
     batches: steps 1-3 within 2e-4 relative, all 6 within 5e-2, the
     parameters' sum within 5e-3, evaluation at the initial parameters
     within 2e-4 (tests/test_distributed.py's bounds), the 2 ranks
     bit-equal, their rows disjoint and tiling the 1-rank run's, each
     rank's flash forward, dQ and dK/dV launches as expected; the step
     times, 1 rank and 2 ranks time-sharing the card; ``efs2-torch-train
     --coordinator --num-processes 2 --process-id i --backend gloo`` for
     4 steps on the Quick-start corpus (one checkpoint directory, both
     ranks at the last step with the same parameter sum). Over NCCL, each
     process a world of one (the machine has one card): (a) an
     all-reduce with a pre-multiplied sum by 2 captured into a CUDA graph
     and replayed 3 times reads 8× its start (a replayed NCCL collective
     runs); (b) the data-parallel train step graphed against eager from
     one state over 6 global batches, with the recipe's Noam warm-up as
     phase 14 (whose bounds hold it) takes it (losses, the parameters'
     change, 10
     launches of each float32 flash kernel a step, graphs held after the
     first call), a steps_per_call = 2 chunk as one replay against the
     steps one by one, the eval step graphed against eager, and the step's
     ms eager and graphed, busy share and peak memory at (128, 1000),
     B = 8 and at the deep run's (16, 128), B = 16; (c) ``train()`` graphed
     (chunks of 2, evaluations and rank-0 samples inside the run: the
     train graphs kept across each sample), its checkpoint and its flash
     launches. The ranks' flash launches join the ``kernels`` line's.
     Gradient accumulation: 1 rank at B = 4 with grad_acc_step 2 over the
     2-rank run's row halves, its parameters bit-equal through each
     update's first micro-step, 6 updates, 2 flash launches a block an
     update, and moved; its change against the 1-rank run's printed;
  14. the compiled steps, CUDA graphs against the eager bodies from the
     same weights and state, at ``Config()`` width: ``synthesize`` short
     (4 utterances, mel bucket 250) and long-form (``max_mel_len=4096``)
     with the bf16 and the float32 vocoder (durations equal, mel and wav
     within GRAPH_MEL_REL and GRAPH_WAV_*, the flash and MRF launches of a
     call those of an eager call whether it captured or replayed), the
     median of 5 calls after 2 eager and graphed, text -> mel alone, the
     first graphed call, the device busy share over 5 calls of each from
     torch.profiler; ``synthesize_streaming`` with its full windows from
     one graph against eager; the float32 "flash" train step at B = 4,
     bucket (128, 1000): 20 steps graphed one a replay and ten a replay
     against 20 eager steps from one state (each loss within
     GRAPH_LOSS_RTOL, the parameters' change within GRAPH_DELTA_RTOL, 10
     launches of each flash kernel a step), the eager run's step-10
     checkpoint loaded into the graphed state and 10 more graphed steps
     against the eager run's, step ms, busy share and peak memory; the
     amp bf16 recipe's step at B = 32, eager and graphed in turns;
  14c. the vocoder trainer's compiled steps at ``Config()`` width, batch
     16 × 8192, float32 (TF32 off) and bf16 amp: 13 GAN steps from one
     state eager, eager again (cuDNN's backward sums with atomics),
     graphed one a replay and four a replay (each loss within
     GAN_LOSS_RTOL, the parameters' change within GAN_DELTA_RTOL of
     eager's, the AdamW counts on the card), and in float32 the mutant,
     its capture restoring the modules alone (the warm-up's moments and
     counts left in place, as a lazily made optimizer state leaves them:
     more than 10× the bound); the median of 10 after 3, the first call,
     the busy share over 2 steps and peak memory of each, and a chunk's
     time a step; ``train_vocoder`` with steps_per_call 4 (one replay a
     chunk, the val batches one graph, JAX's log, val and save steps) and
     its resume; ``evaluate`` over phase 5's val set and the sample
     synthesis step under "flash", ``export_gta_mels``, the vocoder's val
     step and ``SampleVocoder`` on a float32 generator.npz, graphed
     against eager (bit-equal; 10 flash forwards a batch, 72 float32 MRF
     launches a call, counted once a call);
  15. the example drivers of ``examples_torch/``: (a) the float32
     flash forward, dQ and dK/dV at the convergence scripts' buckets,
     (16, 2, 16, 128) and (16, 2, 128, 128), with the key lengths of the
     first train batch of 16 of ``convergence_demo``'s corpus (features
     extracted on the card), against their plain versions (phases 2b
     and 2d's bounds); (b) ``convergence_demo`` for 300 steps under
     "flash" and under "auto" from the same seed and features: the last
     logged mel and duration losses at most 0.6 × the first logged, the
     two last total losses within 15 % relative, 10 launches of each
     float32 flash kernel a "flash" train step (the forward 10 an eval
     step) and none under "auto"; (c) ``train_demo``'s loss falls over 30
     steps at ``Config()`` width (its ms a step printed); (d)
     ``synthesize_demo`` on the default text, with --duration-control 2.0
     (mel_len doubles) and on two probes ("今天魑魅魍魉": every hanzi has a
     reading; "今天龘靐": a warning for each of its two hanzi without
     one, the prefix synthesized), each generator call 72 launches of
     the bf16 MRF kernel;
  15d. (only when named: ``--phases 15d``) ``convergence_deep``'s 5,000
     steps at batch 16, ten steps a replay, under "auto" and under
     "flash" from the same seed and features: the mean of the last 5
     logged records' total at most 1.68, mel 0.73, duration 0.10; the
     two final totals within 10 %; duration control monotonic, Sad
     slower than Happy, the speaker and emotion mel distances at least
     2.0e-3 and 9.1e-3; the flash launches as in 15(b); the reports in
     ``output/convergence_torch/{auto,flash}/`` (ignored by git);
  15s. (only when named) 15d again with the mel targets staged in
     float32 instead of int16 (up to 2e-4 apart): a second trajectory of
     each path, against 15d's bounds;
  15t. (only when named) where the deep run's step goes: ``train()`` for
     300 steps with a profiler window over steps 200-250 (device busy
     share, device work and kernels a step, the top kernels), the loop's
     host work for a chunk (collation, staging, stacking), and a chunk
     of ten steps replayed alone on the same batches under "auto" and
     "flash".
  16. flash attention at head dims other than 128, on "h1d256" (Config()
     with one encoder and one decoder head: D = 256 at the parameters'
     shapes of Config()): (a) the float32 forward at D = 256
     (csrc/flash_mha_d256.cu) and the dQ and dK/dV kernels
     (csrc/flash_mha_bwd_d256.cu), all on 3xTF32 wgmma in clusters of two
     blocks, against their plain versions at phases 2b's and 2d's cases
     with H = 1 and their bounds (also against float64), each call on the
     D = 256 kernels and no other; the forward on exact witnesses (the
     layout witness's two-hot P over all 256 columns: out equal to
     float64; small-integer v with one valid key a row: out equal to that
     key's v) and a rerun bit-identical; the backward pair on an exact
     layout witness (two-hot P from a given lse, small integers: dq, dk,
     dv equal to float64) and a row of one valid key (dq and dk exactly
     0); at D = 64,
     the six D = 128 kernels on zero-padded inputs at (4, 2, 1000, 64)
     against the plain versions at D = 64 (float32: phases 2b and 2d's
     bounds; bf16: phase 2e's); (b) h1d256 long-form synthesis
     (``max_mel_len=4096``) under "auto": 6 launches of the D = 256
     forward a call and no other flash kernel, graphed against eager
     (phase 14's bounds), the mel against the math path on the card
     (phase 3b's bound), text -> mel times under "auto" and "xla"; (c)
     ``train()`` of h1d256 under "flash" for 20 steps on phase 5's corpus
     and recipe (graphed on the card), 10 launches of each D = 256 kernel
     a train step and none of the D = 128 kernels, against the same run
     under "auto": the logged losses within phase 5's 1e-5 relative; the
     graphed train step of each at B = 4, bucket (128, 1000), in turns;
     (d) times, each kernel call from a CUDA graph: the D = 256 forward at
     (4, 1, T, 256) for T = 1000 (the train step's key lengths), 2300 and
     4096 and the backward pair at T = 1000 and 4096 against their bounds
     (TF32 rate over the live key tiles; the forward also at three TF32
     products a product; TF/s and the share of the bound), plain versions
     and SDPA in float32 with the
     same bool mask, and the backward pair beside the D = 128 pair at the
     same H·D (4, 2, T, 128); D = 64 at (4, 2, 4096, 64)
     through the padding against the D = 128 kernel on inputs padded
     beforehand and SDPA.
  17. the bf16 flash kernels at D = 256 (csrc/flash_mha_bf16_d256.cu, the
     output's head dim split in halves of 128): (a) phase 2e at H = 1,
     D = 256 (its cases and bounds, each call on the three bf16 D = 256
     kernels and no other flash kernel, reruns bit-identical) and a
     (2, 2, 320, 256) layout witness, exact; (b) efs2-torch-train on
     train_tuned.yaml (batch 32, amp bf16, steps_per_call 10) with one
     encoder and one decoder head (h1d256), phase 5's corpus, 20 steps
     under "flash" and under "auto" from one seed: under "flash" 10
     launches of each bf16 D = 256 kernel a train step and no other flash
     kernel, 10 float32 D = 256 forwards a val or synth step; under
     "auto" none; losses finite and falling, the first logged loss
     within 5 % and the last within 8 % of "auto"'s; the graphed train
     step of each at B = 32, bucket (128, 1000), in turns; (c) the three
     kernels from CUDA graphs at (32, 1, 1000, 256) with the recipe's
     key lengths and at (4, 1, 4096, 256) with phase 11b's masks against
     their bounds (bf16 rate over the live key tiles, the function's
     flops), plain versions and SDPA bf16 with the bool mask, its backend
     named (its backward timed with CUDA events).

Float32 comparisons run with TF32 off (cuDNN and matmul). Every failed
check is reported and the script exits 1 without its result lines; with
no CUDA device, or without the port's package beside it, it exits 1 at
once. Its last two lines are the ``kernels`` JSON line, whose every row
names the shape its times were taken at (``shape``), and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
# Phase 2 also holds odd K past the templated sizes, which the kernels read
# at run time: at d = 5 the float32 kernel takes K = 17 with a three-stage
# weight ring and K = 45 with 16 input channels a chunk where C % 128 == 0.
PHASE2_KERNEL_SIZES = KERNEL_SIZES + (13, 17, 45)
# (C, K) at d = 5 where the float32 kernel's halo reaches the shared memory
# a block may use, at BN = 128, 64 and 32 (its longest chains of taps):
# phase 2 holds it against float64 there too.
F32_LIMIT_SHAPES = ((256, 131), (64, 143), (32, 149))
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
                                      "flash_mha_bwd_bf16"),
    **{f"flash_mha_{k}_bf16_d256_kernel": ("flash_mha_bf16_d256",
                                           "flash_mha_bf16_d256")
       for k in ("fwd", "bwd_dq", "bwd_dkv")}}
# The tensor-core kernels and the float32 flash forward at D = 256 (CUDA
# cores), which must compile without spills.
TC_KERNELS = ("mrf_conv_tc_kernel", "mrf_conv_f32_tc_kernel",
              "flash_mha_fwd_kernel",
              "flash_mha_bwd_dq_kernel", "flash_mha_bwd_dkv_kernel",
              "flash_mha_fwd_bf16_kernel", "flash_mha_bwd_dq_bf16_kernel",
              "flash_mha_bwd_dkv_bf16_kernel", "flash_mha_fwd_d256_kernel",
              "flash_mha_bwd_dq_d256_kernel", "flash_mha_bwd_dkv_d256_kernel",
              "flash_mha_fwd_bf16_d256_kernel",
              "flash_mha_bwd_dq_bf16_d256_kernel",
              "flash_mha_bwd_dkv_bf16_d256_kernel")


def phase_environment(smoke: Smoke):
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    print(f"  nvidia-smi: {nvidia_smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    smoke.check(hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
                "torch.cuda.CUDAGraph.register_generator_state exists (the "
                "graphed train step draws its dropout from the state's "
                "generator)")
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
    regs256 = {}
    for lib in ("flash_mha_d256", "flash_mha_bwd_d256"):
        for line in build.ptxas_report(lib).splitlines():
            if "Compiling entry function" in line:
                current = line
            elif "Used" in line and "registers" in line:
                for k in ("flash_mha_fwd_d256_kernel",
                          "flash_mha_bwd_dq_d256_kernel",
                          "flash_mha_bwd_dkv_d256_kernel"):
                    if k in current:
                        regs256[k] = int(line.split("Used")[1].split()[0])
    d256 = build.load("flash_mha_d256")
    print(f"  flash_mha_fwd_d256_kernel (3xTF32 wgmma): "
          f"{d256.flash_mha_d256_smem_bytes()} bytes of dynamic shared "
          f"memory a block, 256 threads (a consumer warpgroup, a producer "
          f"warp, three converter warps), registers a thread "
          f"{regs256.get('flash_mha_fwd_d256_kernel')}; clusters of "
          f"{d256.flash_mha_d256_cluster()} blocks (one a 128-column chunk "
          f"of the head dim, partial S swapped through distributed shared "
          f"memory), {d256.flash_mha_d256_key_tile()}-key tiles, 64 query "
          f"rows")
    bwd256 = build.load("flash_mha_bwd_d256")
    regs256.pop("flash_mha_fwd_d256_kernel", None)
    smem256 = [bwd256.flash_mha_bwd_d256_smem_bytes(i) for i in range(2)]
    print(f"  flash_mha_bwd_dq_d256_kernel, flash_mha_bwd_dkv_d256_kernel "
          f"(3xTF32 wgmma): {smem256} bytes of dynamic shared memory a "
          f"block, 256 threads (two "
          f"consumer warpgroups), registers a thread {regs256}; clusters of "
          f"{bwd256.flash_mha_bwd_d256_cluster()} blocks (one a 128-column "
          f"chunk of the head dim, partial S and dP swapped through "
          f"distributed shared memory), "
          f"{bwd256.flash_mha_bwd_d256_block_rows()} resident rows, "
          f"{bwd256.flash_mha_bwd_d256_key_tile()}-row streamed tiles")
    wide16 = build.load("flash_mha_bf16_d256")
    print(f"  flash_mha_fwd_bf16_d256_kernel, flash_mha_bwd_dq_bf16_d256_"
          f"kernel, flash_mha_bwd_dkv_bf16_d256_kernel: "
          f"{[wide16.flash_mha_bf16_d256_smem_bytes(i) for i in range(3)]} "
          f"bytes of dynamic shared memory a block, "
          f"{[wide16.flash_mha_bf16_d256_stages(i) for i in range(3)]} ring "
          f"stages, {wide16.flash_mha_bf16_d256_key_tile()}-row streamed "
          f"tiles; the forward {wide16.flash_mha_bf16_d256_block_rows()} "
          f"query rows a block and half of the head dim, the backward 64 "
          f"resident rows a block, each consumer warpgroup half of the head "
          f"dim")
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
    """Launches of the MRF bf16 and float32 kernels."""
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    return mrf.tc_launch_count, mrf.f32_launch_count


def reset_mrf_counts() -> None:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    mrf.launch_count = mrf.tc_launch_count = mrf.f32_launch_count = 0


def phase_kernel_vs_plain(smoke: Smoke, device, shapes, batch,
                          float64: bool = True,
                          kernel_sizes=KERNEL_SIZES):
    """The MRF kernels against their plain version at (batch, T, C) for each
    (C, T) of ``shapes`` and K of ``kernel_sizes``; with ``float64``,
    float32 also against float64. Returns the worst max|diff| of the bf16
    kernel and of the float32 kernel against their plain versions."""
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
                tc0, f320 = mrf_counts()
                out = mrf.mrf_resblock(x, weights, k, DILATIONS)
                tc, f32 = (n - n0 for n, n0 in zip(mrf_counts(), (tc0, f320)))
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
                    and (tc, f32) == ((6, 0) if bf16 else (0, 6)),
                    f"{str(dtype)[6:]:8s} B={batch} C={c:3d} T={t:7d} "
                    f"k={k:2d} max|diff|={diff:.3e} bound={bound:.3e}; "
                    f"launches bf16 kernel {tc}, float32 kernel {f32}")
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
    width in both dtypes, the kernel's refusal of a gradient, and the
    float32 kernel at its longest K against float64."""
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
        tc, f32 = (n - n0 for n, n0 in zip(mrf_counts(), counts))
        ref = mrf.mrf_resblock_plain(x, weights, k, DILATIONS)
        diff = (out.float() - ref.float()).abs().max().item()
        bf16 = dtype == torch.bfloat16
        bound = (BF16_REL_BOUND * ref.float().abs().max().item() if bf16
                 else F32_BOUND)
        smoke.check(out.shape == ref.shape and diff <= bound
                    and (tc, f32) == ((6, 0) if bf16 else (0, 6)),
                    f"{str(dtype)[6:]:8s} B={b} C={c} T={t} k={k} (padded to "
                    f"C=32, k=7): max|diff|={diff:.3e} bound={bound:.3e}; "
                    f"launches bf16 kernel {tc}, float32 kernel {f32}")
    try:
        mrf.mrf_resblock(x.requires_grad_(), weights, k, DILATIONS)
        raised = False
    except RuntimeError:
        raised = True
    smoke.check(raised, "mrf_resblock raises on the card when a gradient is "
                        "wanted (the kernel has no backward)")
    b, t = 2, RAGGED_SHAPE[1]
    for c, k in F32_LIMIT_SHAPES:
        weights = random_resblock(c, k, gen, device, torch.float32)
        x = torch.randn(b, t, c, generator=gen).to(device)
        counts = mrf_counts()
        out = mrf.mrf_resblock(x, weights, k, DILATIONS)
        tc, f32 = (n - n0 for n, n0 in zip(mrf_counts(), counts))
        ref64 = mrf.mrf_resblock_plain(
            x.double(), [(w.double(), bb.double()) for w, bb in weights], k,
            DILATIONS)
        diff64 = (out.double() - ref64).abs().max().item()
        smoke.check(out.shape == ref64.shape and diff64 <= F32_BOUND
                    and (tc, f32) == (0, 6),
                    f"float32 B={b} C={c} T={t} k={k} (the kernel's limit at "
                    f"d = 5) vs float64 plain: max|diff|={diff64:.3e} "
                    f"bound={F32_BOUND:.0e}; launches bf16 kernel {tc}, "
                    f"float32 kernel {f32}")
        del out, ref64, x
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


def flash_inputs(b: int, t: int, rows, gen, h: int = 2, d: int = 128):
    """(B, H, T, D) float32 q, k, v and the (B, T) key mask on the card."""
    import torch

    q, k, v = (torch.randn(b, h, t, d, generator=gen).to("cuda")
               for _ in range(3))
    return q, k, v, flash_mask(t, rows).to("cuda")


def phase_flash_vs_plain(smoke: Smoke, cases=FLASH_CASES, h: int = 2,
                         d: int = 128):
    """The float32 forward kernel of head dim ``d`` against its plain
    version at (B, h, T, d) for ``cases``; returns the worst max|diff|."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    gen = torch.Generator().manual_seed(2)
    scale = d ** -0.5
    worst = 0.0
    for b, t, rows in cases:
        q, k, v, mask = flash_inputs(b, t, rows, gen, h, d)
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
    launches, f32_launches = mrf_counts()
    smoke.check(fa.launch_count == 0,
                f"flash launches on this path: {fa.launch_count} (every "
                f"sequence is under 2048 frames: the math path)")
    for r in results:
        ok = (r.mel.ndim == 2 and r.mel.shape[0] > 0 and r.wav.size > 0
              and bool(np.isfinite(r.mel).all())
              and bool(np.isfinite(r.wav).all()))
        smoke.check(ok, f"{r.basename}: mel {r.mel.shape}, wav "
                        f"{r.wav.shape}, finite and non-empty")
    smoke.check(launches == per_call and f32_launches == 0,
                f"MRF launches in one bf16 generator call: bf16 kernel "
                f"{launches} (expected {per_call}), float32 kernel "
                f"{f32_launches} (expected 0)")

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
                f"MRF launches in one float32 generator call: bf16 kernel "
                f"{f32_counts[0]} (expected 0), float32 kernel "
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
    mrf_launches, f32_launches = mrf_counts()
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
    smoke.check(mrf_launches == per_call and f32_launches == 0,
                f"MRF launches in one bf16 generator call: bf16 kernel "
                f"{mrf_launches} (expected {per_call}), float32 kernel "
                f"{f32_launches} (expected 0)")

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
        tc, f32 = mrf_counts()
        want = per_call * windows
        smoke.check(len(chunks) == windows
                    and fa.launch_count == n_dec
                    and (tc, f32) == ((0, want) if name == "float32"
                                      else (want, 0)),
                    f"{name} synthesize_streaming: {len(chunks)} chunks "
                    f"(expected {windows}), {fa.launch_count} flash launches"
                    f" (expected {n_dec}), MRF launches bf16 kernel {tc}, "
                    f"float32 kernel {f32} (expected {per_call} × {windows} "
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
    """CUDA-event ms of the generator on a random (batch, frames, 80) mel in
    its dtype, and of its 12 resblocks' kernels at the same shapes."""
    import torch

    mel = torch.randn(batch, frames, 80, device="cuda",
                      dtype=next(vocoder.parameters()).dtype)
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
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

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
    # The float32 generator (TF32 off) at the stage shapes timed below.
    fs2, voc = seeded_states(synth.cfg)
    gen32 = Synthesizer(float32_vocoder(synth.cfg), fs2, voc,
                        emotion_maps=EMOTION_MAPS, device="cuda").vocoder
    gen_ms, rb_ms = generator_split_ms(gen32, BATCH, 1000)
    print(f"  float32 generator on a ({BATCH}, 1000, 80) mel: {gen_ms:.3f} ms,"
          f" of which the 12 resblocks' kernels {rb_ms:.3f} ms")
    del gen32

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
    """The float32 MRF kernel at the stage shapes, B = 4 × 1000 frames,
    TF32 off: kernel (and its TF/s), plain version, the cuDNN chain in
    float32 (library_ms: the one library call of float32 accuracy), the
    bound (the operations at the TF32 rate against float32 bytes) and the
    3xTF32 floor (three TF32 products a product, the kernel's method). The
    package is the one ``--root`` names, so two checkouts' kernels can be
    timed in turns in one call."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import mrf_resblock as mrf

    assert not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "bound_by_operations_ms": 0.0, "x3_floor_ms": 0.0}
    rows = []
    print(f"  float32 MRF kernel of {Path(mrf.__file__).parents[2]}")
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
            floor, _ = resblock_bound_ms(BATCH, t, c, k, 4,
                                         PEAK_TF32_FLOPS / 3)
            flops = 12 * k * c * c * t * BATCH
            rows.append({"C": c, "T": t, "k": k, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": by, "x3_floor_ms": floor,
                         "tflops": flops / ms / 1e9})
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound),
                           ("x3_floor_ms", floor)):
                totals[key] += v
            if by == "operations":
                totals["bound_by_operations_ms"] += bound
            print(f"  mrf_resblock f32 B={BATCH} C={c:3d} T={t:6d} k={k:2d}:"
                  f" kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TF/s), plain "
                  f"{plain:.4f} ms, cuDNN chain f32 {lib:.4f} ms (kernel / "
                  f"cuDNN {ms / lib:.2f}×), bound {bound:.4f} ms ({by}, "
                  f"TF32 rate), 3xTF32 floor {floor:.4f} ms", flush=True)
        del x
    print("  float32 resblock times: " + json.dumps(rows))
    flops = sum(12 * r["k"] * r["C"] ** 2 * r["T"] * BATCH for r in rows)
    slower = [(r["C"], r["k"]) for r in rows if r["ms"] > r["library_ms"]]
    print(f"  the 12 resblocks, float32, B={BATCH} × 1000 frames: kernel "
          f"{totals['ms']:.3f} ms ({flops / totals['ms'] / 1e9:.1f} TF/s), "
          f"plain {totals['plain_ms']:.3f} ms, cuDNN chain f32 "
          f"{totals['library_ms']:.3f} ms (kernel / cuDNN "
          f"{totals['ms'] / totals['library_ms']:.2f}×; slower than cuDNN "
          f"at (C, k) {slower}), bound {totals['bound_ms']:.3f} ms (TF32 "
          f"rate), 3xTF32 floor {totals['x3_floor_ms']:.3f} ms, "
          f"{flops:.3e} flops [{nvidia_smi_line()}]")
    return totals


def flash_bounds_ms(mask, h: int = 2, d: int = 128,
                    lib: str = "flash_mha") -> dict:
    """Least times for float32 attention at H = h, D = d on a (B, T) key
    mask, each the larger of operations at the TF32 tensor-core rate (the
    card's fastest for float32 inputs) and bytes at the memory rate:
    "tf32_dense", 4·B·H·T²·D flops against q, k, v read once and out
    written once; "tf32_live", the same over the key tiles with a valid key
    (the kernel skips the rest, neither reading nor multiplying them),
    which is this run's ``bound_ms``. For context, the kernel's own method
    takes three TF32 products per product at least (3xTF32; it takes four
    for S, three for P V): "x3_dense" and "x3_live". The tile width is the
    kernel's (``flash_mha_fwd_key_tile``, or ``flash_mha_d256_key_tile``
    for ``lib="flash_mha_d256"``)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    tile = getattr(build.load(lib), "flash_mha_fwd_key_tile" if lib
                   == "flash_mha" else f"{lib}_key_tile")()
    b, t = mask.shape
    n_tiles = math.ceil(t / tile)
    valid = torch.zeros(b, n_tiles * tile, dtype=torch.bool,
                        device=mask.device)
    valid[:, :t] = ~mask
    live = int(valid.view(b, n_tiles, tile).any(-1).sum())
    flops = 4 * b * h * t * t * d
    flops_live = 4 * h * t * tile * live * d
    n_bytes = 16 * b * h * t * d + b * t
    live_bytes = 4 * h * d * (2 * b * t + 2 * tile * live) + b * t

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


def phase_flash_bwd_vs_plain(smoke: Smoke, cases=FLASH_BWD_CASES,
                             h: int = 2, d: int = 128):
    """The float32 backward kernels of head dim ``d`` against the plain
    backward at (B, h, T, d) for ``cases``; returns the worst max|diff| of
    dq (the dQ kernel) and of dk, dv (the dK/dV kernel)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    gen = torch.Generator().manual_seed(4)
    scale = d ** -0.5
    worst_dq = worst_dkv = 0.0
    for b, t, rows in cases:
        q, k, v, mask = flash_inputs(b, t, rows, gen, h, d)
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
        lr = float(resumed.optimizer.schedule(
            torch.tensor(TRAIN_STEPS + 2, device=device)))
        smoke.check(resumed.step == TRAIN_STEPS + 2
                    and int(resumed.optimizer.count) == TRAIN_STEPS + 2
                    and resumed.optimizer.lr == lr,
                    f"resumed from step {TRAIN_STEPS}: step {resumed.step}, "
                    f"updates {int(resumed.optimizer.count)}, next lr "
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


def flash_bwd_bounds_ms(mask, kernel: str, h: int = 2, d: int = 128,
                        lib: str = "flash_mha_bwd") -> dict:
    """Least times for a backward kernel at H = h, D = d on a (B, T) key
    mask, float32, each the larger of operations at the TF32 tensor-core
    rate (as the forward's bound) and bytes at the memory rate: the dQ
    kernel recomputes S and dP and forms dq (6·H·D flops per query row and
    key) from q, out, dO, lse and the live keys' k, v, writing dq and Δ;
    the dK/dV kernel recomputes S and dP and forms dk and dv (8·H·D) from
    q, dO, lse, Δ and the live keys' k, v, writing dk and dv;
    ``kernel="both"`` is the whole backward, 10·H·D (S, dP, dq, dk, dv),
    reading q, out, dO and the live k, v, writing dq, dk, dv. "live" counts
    the 32-key tiles with a valid key (a padded key adds nothing), which is
    this run's ``bound_ms``; "dense" every key. The tile is the dQ
    kernel's key tile (``flash_mha_bwd_stream_tile``, or
    ``flash_mha_bwd_d256_key_tile`` for ``lib="flash_mha_bwd_d256"``)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    tile = getattr(build.load(lib), "flash_mha_bwd_stream_tile" if lib
                   == "flash_mha_bwd" else f"{lib}_key_tile")()
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
        flops = per * h * t * keys * d
        n_bytes = (4 * h * d * (full * b * t + 2 * keys)
                   + 4 * h * rows * b * t + b * t)
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
        counts = (int(resumed.opt_g.count), int(resumed.opt_d.count))
        lr = resumed.opt_g.lr
        smoke.check(steps == [10, 20] and resumed.step == VOC_RESUME_TO
                    and counts == (VOC_RESUME_TO,) * 2
                    and resumed.opt_g.count.device.type == "cuda"
                    and lr == float(tv.vocoder_lr(cfg, VOC_RESUME_TO)),
                    f"checkpoints at {steps}; resumed to step "
                    f"{resumed.step}, AdamW updates (generator, "
                    f"discriminators) {counts} on "
                    f"{resumed.opt_g.count.device}, next lr {lr:.6e}")
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
        tc, f32 = mrf_counts()
        smoke.check((tc, f32) == (per_call, 0)
                    and all(np.isfinite(r.wav).all() and r.wav.size > 0
                            for r in results),
                    f"generator.npz in the Synthesizer (bf16): MRF launches "
                    f"bf16 kernel {tc}, float32 kernel {f32} (expected "
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
    events) and peak memory: the eager step, as a step made with ``mark``
    is (phase 14c times the graphed one)."""
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
        print(f"  GAN step {amp}, eager (the step timed with mark runs "
              f"eagerly), batch {VOC_TIMED_BATCH} × "
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


def profile_gan_steps(step, state, batches, amp: str,
                      cpu: bool = True) -> float:
    """``torch.profiler`` over two GAN steps: the device's busy share of
    the window (the union of the kernels' device intervals over the wall
    time; the profiler's own cost on the host is in the wall time) and the
    ten kernels with the most device time, read from the profiler's raw
    events (building its event tree takes tens of seconds for a step's
    ~20,000 launches). Returns the busy share. With ``cpu`` False the
    profiler records the CUDA activity alone, which costs the host less
    (no operator records)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
    busy_ns, end = 0, -math.inf
    for a, b in sorted((e.start_ns(), e.end_ns()) for e in kernels):
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
    busy = busy_ns / 1e6 / wall_ms
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in kernels:
        by_name[e.name()][0] += e.duration_ns()
        by_name[e.name()][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"  profile of {len(batches)} GAN steps ({amp}"
          f"{'' if cpu else ', CUDA activity alone'}): {wall_ms:.1f} ms "
          f"wall, kernels busy {busy_ns / 1e6:.1f} ms, busy share "
          f"{busy:.3f}; top kernels by device time: " + "; ".join(
              f"{name[:60]} {ns / 1e6:.2f} ms ×{n}"
              for name, (ns, n) in top), flush=True)
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
              f"{vcfg.vocoder_train.segment_size}, float32, graphed: median "
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
        tc0, f320 = mrf_counts()
        results = synth.synthesize(texts, list(range(len(texts))), emotions)
        tc, f32 = mrf_counts()
        smoke.check((tc - tc0, f32 - f320) == (per_call, 0)
                    and all(np.isfinite(r.wav).all() and r.wav.size > 0
                            for r in results),
                    f"GTA-tuned generator.npz in the Synthesizer (bf16): MRF "
                    f"launches bf16 kernel {tc - tc0}, float32 kernel "
                    f"{f32 - f320} (expected {per_call}, 0); waveforms "
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
    import importlib

    main = importlib.import_module(f"{PKG}.cli.{module}").main
    _, text, seconds = echoed(main, [str(a) for a in argv])
    return text, seconds


def echoed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its standard output captured and its
    first and last lines echoed; returns (its result, the output, wall
    seconds to the device's synchronization)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    lines = text.strip().splitlines()
    shown = lines if len(lines) <= 6 else lines[:3] + ["..."] + lines[-2:]
    for line in shown:
        print(f"    | {line[:160]}")
    return out, text, seconds


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


@contextlib.contextmanager
def collector_off():
    """Python's cyclic garbage collector off, around a capture: a
    collection may free a dead Synthesizer's or train state's CUDA graph,
    which invalidates a capture under way (``graphs.capturing``; this
    script keeps its own, for a ``--root`` package without it)."""
    import gc

    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


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
        with collector_off(), torch.cuda.graph(graph):
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


def layout_witness(t: int = 192, lens=(192, 100), seed: int = 3,
                   d: int = 128):
    """bf16 inputs whose every product is exact (tests/
    test_torch_kernels_gpu.py holds the same witness): keys k_j = 64 e_j
    (j < D) and -64 e_(j-D); query row i scores 1024 against exactly two
    valid keys (q_i = 16 (e_a + e_b)) and 0 or -1024 against the rest, so
    with sm_scale 1 its P is 1/2 at those two and exp(-1024) = 0 elsewhere;
    v and dO in {-1, 0, 1}. A wrong swizzle, descriptor or transpose bit
    moves a product by far more than round-off. Returns float64 q, k, v,
    dO and the mask, on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, h = len(lens), 2
    k = np.zeros((b, h, t, d))
    for j in range(t):
        k[:, :, j, j % d] = 64.0 if j < d else -64.0
    q = np.zeros((b, h, t, d))
    for i, n in enumerate(lens):
        for hh in range(h):
            for r in range(t):
                a, c = rng.choice(min(n, d), size=2, replace=False)
                q[i, hh, r, a] = q[i, hh, r, c] = 16.0
    v, dout = (rng.choice([-1.0, 0.0, 1.0], size=(b, h, t, d),
                          p=[0.25, 0.5, 0.25]) for _ in range(2))
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    return [torch.from_numpy(x) for x in (q, k, v, dout, mask)]


def phase_flash_bf16_vs_plain(smoke: Smoke, h: int = 2, d: int = 128):
    """The bf16 forward, dQ and dK/dV kernels at head dim ``d`` (H = ``h``)
    against their plain versions on the same bf16 inputs, each call on the
    three bf16 kernels of that head dim and no other flash kernel, the
    layout witness exactly; returns the worst max|diff| of out, dq and
    (dk, dv)."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    gen = torch.Generator().manual_seed(10 + d)
    scale = d ** -0.5
    wide = d == D256
    key_tile = (build.load("flash_mha_bf16_d256").flash_mha_bf16_d256_key_tile
                if wide else
                build.load("flash_mha_bf16").flash_mha_fwd_bf16_key_tile)()
    want = (0,) * 3 + ((0,) * 6 + (1,) * 3 if wide else (1,) * 3 + (0,) * 6)
    worst = [0.0, 0.0, 0.0]
    margin = 0.0  # the forward's worst max|diff| over its bound
    recipe = tuple((b, t, prefixes(*recipe_lengths(b, t)))
                   for b, t in RECIPE_CASES)
    for b, t, rows in FLASH_BF16_CASES + recipe:
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, rows, gen, h, d))
        dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
        before = flash_all_counts()
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        grads = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
        launched = tuple(a - b for a, b in zip(flash_all_counts(), before))
        ref = fa.flash_mha_blocked_plain(q, k, v, mask, scale, key_tile)
        refs = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
        line = []
        ok = launched == want
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
                    f"bf16 D={d} B={b} H={h} T={t:5d} {shown_rows(rows)}: "
                    f"max|diff| {', '.join(line)}; lse {lse_diff:.3e}; "
                    f"launches (flash_all_counts) {launched}; rows of length"
                    f" 0 exactly 0; a rerun bit-identical: {same}")
        del q, k, v, mask, dout, out, lse, grads, ref, refs, again
    # At D = 256: five key tiles, the two-hot P over all four 64-column
    # chunks of q and k.
    q, k, v, dout, mask = (layout_witness(320, (320, 150), d=d) if wide
                           else layout_witness())
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
                f"layout witness {tuple(q.shape)}, two-hot P: out, dq, dk, "
                f"dv exact (elements off: {wrong}; nonzero in the "
                f"reference: {nonzero})")
    print(f"  bf16 forward against flash_mha_blocked_plain on its "
          f"{key_tile}-key tiles: worst max|diff| {margin:.3f} of its "
          f"2^-7 · max|ref| bound")
    return worst


def flash_bf16_bounds_ms(mask, kernel: str, h: int = 2,
                         d: int = 128) -> dict:
    """Least times for a bf16 flash kernel at H = h, D = d on a (B, T)
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
        flops = per * h * t * keys * d
        n_bytes = 2 * h * d * tensors * b * t + 4 * h * stats * b * t \
            + b * t
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes", flops)

    live_ms, by, flops = bound(tile * live)
    return {"live": live_ms, "bound_by": by, "dense": bound(b * t)[0],
            "live_tiles": live, "tiles": b * n_tiles, "tile": tile,
            "flops_live": flops}


def tuned_configs(root: Path, corpus: str, impl: str = "flash",
                  heads: int | None = None) -> dict[str, str]:
    """The shipped ESD preprocess.yaml and model.yaml and train_tuned.yaml
    with the corpus at ``corpus``, ``attention_impl: impl``, ``heads``
    encoder and decoder heads if given, the train paths under ``root`` and
    TUNED_CADENCE; the recipe (batch 32, bf16 amp, the optimizer,
    steps_per_call 10) is the shipped one."""
    root.mkdir(parents=True, exist_ok=True)
    pre = _yaml_set((CONFIG_DIR / "preprocess.yaml").read_text(),
                    "preprocessed_path", corpus)
    model = (CONFIG_DIR / "model.yaml").read_text().replace(
        "transformer:\n", f'transformer:\n  attention_impl: "{impl}"\n', 1)
    if heads is not None:
        for key in ("encoder_head", "decoder_head"):
            model = _yaml_set(model, key, heads)
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


@contextlib.contextmanager
def compiled_step_calls(on_call):
    """``train.loop``'s compiled-step makers patched so that every call of
    a step they make (the single step, or the multi step's chunk) goes
    through ``on_call(n_steps, step, batch)``, which returns the report:
    on the card ``train()`` takes its steps from them."""
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop

    originals = {name: getattr(loop, name)
                 for name in ("make_train_step", "make_train_multi_step")}

    def patched(name):
        def make(state, cfg, *n_steps):
            step = originals[name](state, cfg, *n_steps)
            steps = n_steps[0] if n_steps else 1
            return lambda batch: on_call(steps, step, batch)

        return make

    for name in originals:
        setattr(loop, name, patched(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(loop, name, fn)


@contextlib.contextmanager
def inference_step_calls(on_call):
    """``train.loop``'s makers of the compiled eval and synth steps
    patched so that every call of a step they make goes through
    ``on_call(name, step, *args)`` ("eval_step" or "synth_step"), which
    returns its output: on the card ``train()`` evaluates and synthesizes
    through them."""
    from expressive_fastspeech2_mandarin_tpu_torch.train import loop

    names = {"make_eval_step": "eval_step", "make_synth_step": "synth_step"}
    originals = {maker: getattr(loop, maker) for maker in names}

    def patched(maker):
        def make(*args):
            step = originals[maker](*args)
            return lambda *a: on_call(names[maker], step, *a)

        return make

    for maker in originals:
        setattr(loop, maker, patched(maker))
    try:
        yield
    finally:
        for maker, fn in originals.items():
            setattr(loop, maker, fn)


def phase_tuned_training(smoke: Smoke, device):
    """Phase 11: efs2-torch-train on train_tuned.yaml under "flash", 20
    steps on phase 5's corpus, replayed from CUDA graphs: a full chunk of
    10 same-bucket steps one replay of the multi step, a shorter group the
    single step. Every train step must launch each bf16 kernel once per
    FFT block (10) and no float32 kernel; the val and synth steps run the
    float32 model, so the float32 forward only (10 a forward) and no bf16
    kernel. Returns the launches over the run."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    card = nvidia_smi_line()
    # Per call of each compiled step or inference step: (steps, launches);
    # each compiled call's report (a chunk's mean for the multi step).
    calls: dict[str, list] = {"train_step": [], "eval_step": [],
                              "synth_step": []}
    losses: list[float] = []

    def counting(key, steps, fn, *args, **kwargs):
        before = bf16_counts() + flash_counts()
        out = fn(*args, **kwargs)
        calls[key].append((steps, tuple(
            a - b for a, b in zip(bf16_counts() + flash_counts(), before))))
        if key == "train_step":
            losses.append(float(out.total))
        return out

    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        corpus = write_training_corpus(str(tmp / "corpus"), 0)
        y = tuned_configs(tmp, corpus)
        cfg = C.load_config(y["preprocess"], y["model"], y["train"])
        t = cfg.model.transformer
        n_blocks = t.encoder_layer + t.decoder_layer
        reset_flash_counts()
        reset_bf16_counts()
        with compiled_step_calls(functools.partial(
                counting, "train_step")), inference_step_calls(
                lambda name, fn, *a: counting(name, 1, fn, *a)):
            _, seconds = run_cli("train", [
                "-p", y["preprocess"], "-m", y["model"], "-t",
                y["train"], "--total_steps", TUNED_STEPS, "--device",
                str(device)])
        launches = bf16_counts() + flash_counts()
        log = _metrics(tmp / "log" / "train" / "metrics.jsonl")
        means = [r["total_loss"] for r in log]
        per_step = (n_blocks,) * 3 + (0, 0, 0)
        train_calls = calls["train_step"]
        n_steps = sum(n for n, _ in train_calls)
        chunked = sum(1 for n, _ in train_calls if n > 1)
        inference = [c for _, c in calls["eval_step"] + calls["synth_step"]]
        train_ok = all(c == tuple(n * x for x in per_step)
                       for n, c in train_calls)
        eval_ok = all(c == (0, 0, 0, n_blocks, 0, 0) for c in inference)
        smoke.check(
            cfg.train.amp_dtype == "bfloat16" and t.attention_impl == "flash"
            and cfg.train.steps_per_call == 10
            and cfg.train.optimizer.batch_size == 32
            and n_steps == TUNED_STEPS and train_ok
            and calls["eval_step"] and calls["synth_step"] and eval_ok,
            f"efs2-torch-train, train_tuned.yaml (batch "
            f"{cfg.train.optimizer.batch_size}, amp {cfg.train.amp_dtype}, "
            f"steps_per_call {cfg.train.steps_per_call}) under "
            f"{t.attention_impl!r}: {n_steps} train steps in "
            f"{len(train_calls)} compiled calls ({chunked} of the multi "
            f"step) in {seconds:.2f} s, each step launching (bf16 forward,"
            f" dQ, dK/dV; float32 forward, dQ, dK/dV) "
            f"{sorted({tuple(x // n for x in c) for n, c in train_calls})}"
            f" (expected {per_step}; calls {train_calls}); "
            f"{len(calls['eval_step'])} val and {len(calls['synth_step'])} "
            f"synth steps, each {sorted(set(inference))}"
            f" (expected {(0, 0, 0, n_blocks, 0, 0)}); over the run "
            f"{launches} [{card}]")
        # Each step's loss, a chunk's steps its mean.
        series = [x for (n, _), x in zip(train_calls, losses)
                  for _ in range(n)]
        first, last = sum(series[:5]) / 5, sum(series[-5:]) / 5
        smoke.check([r["step"] for r in log] == [10, 20]
                    and all(math.isfinite(x) for x in losses + means)
                    and last < first
                    and sorted(os.listdir(tmp / "ckpt")) == ["20.pt"],
                    f"total loss, mean of the first and the last 5 steps "
                    f"(a chunk's steps at its mean): {first:.4f} -> "
                    f"{last:.4f} (falling); each compiled call's "
                    f"{[round(x, 4) for x in losses]}; logged chunk means "
                    f"at steps {[r['step'] for r in log]}: {means}; "
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
    tc0, f320 = mrf_counts()
    results = synth.synthesize(normalized, [i % 4 for i in range(n)],
                               [EMOTIONS[i % 4] for i in range(n)],
                               vocoder="hifigan")
    tc, f32 = (a - b for a, b in zip(mrf_counts(), (tc0, f320)))
    per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
    peaks = [float(np.abs(r.wav).max()) for r in results]
    smoke.check(len(results) == n and all(
        r.wav.size > 0 and np.isfinite(r.wav).all() for r in results)
        and min(peaks) > 1e-4 and (tc, f32) == (per_call, 0),
        f"synthesize (bf16 HiFi-GAN): {n} waveforms, "
        f"{[round(r.wav.size / r.sampling_rate, 2) for r in results]} s, "
        f"peaks {[round(p, 4) for p in peaks]} (finite, non-silent); MRF "
        f"launches bf16 kernel {tc} (expected {per_call}), float32 kernel "
        f"{f32}")
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

    def counting(name, steps, fn, *args, **kwargs):
        before = bf16_counts() + flash_counts()
        out = fn(*args, **kwargs)
        calls[name].append(tuple(
            (a - b) // steps for a, b in zip(bf16_counts() + flash_counts(),
                                             before)))
        calls[name].extend(calls[name][-1:] * (steps - 1))
        return out

    skips: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: skips.append(record.getMessage())
    logging.getLogger(plotting.__name__).addHandler(handler)
    flash0, mrf0 = flash_counts(), mrf_counts()
    try:
        with compiled_step_calls(functools.partial(
                counting, "train_step")), inference_step_calls(
                lambda name, fn, *a: counting(name, 1, fn, *a)):
            text, seconds = run_cli("pipeline", [
                *argv, "--total_steps", IEMOCAP_TRAIN_STEPS, "--device",
                str(device)])
    finally:
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
                f"{synth_s:.2f} s; MRF launches (bf16, float32 kernel) "
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
        train_step,
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
    for name in ("high", "highest"):
        base = training_config(corpus, str(tmp / name), "auto")
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, matmul_precision=name))
        seen[name] = []

        def call(n_steps, step, batch, rows=seen[name]):
            flags = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
            report = step(batch)
            rows.extend([(*flags, float(report.total))] * n_steps)
            return report

        with compiled_step_calls(call):
            loop.train(cfg, total_steps=TF32_STEPS, device=device)
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
                train_step(state, batch, cfg)
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


# ---------------------------------------------------------------------------
# Phase 13: data-parallel training over processes (parallel/).

DP_STEPS = 6
DP_BATCH = 8            # the global batch: 4 rows a rank on 2 ranks
DP_BUCKET = (128, 1000)  # (S, T): every batch padded to it
DP_NCCL_STEPS = 4       # train() over NCCL: 2 chunks of DP_NCCL_SPC
DP_NCCL_SPC = 2
DP_NCCL_EVERY = 2       # its val_step and synth_step: both inside the run
DP_WITNESS_REPLAYS = 3  # a PREMUL_SUM by 2 replayed: 2**3 × its start
DP_GRAPH_SPC = 2        # the graphed DP chunk
DP_GRAPH_TIMED = 10     # timed steps at the deep run's bucket, after 3
DP_GRAPH_WARM_UP = 4000  # the recipe's Noam warm-up (phase 14's)
DP_CLI_STEPS = 4
DP_TIMEOUT = 300        # seconds a group of ranks may take
DP_WARM_UP = 10         # Noam warm-up steps: the 6 steps move the weights
DP_REDUCE_REPEATS = 5   # untimed-step all-reduces of the gradients' size
# tests/test_distributed.py's bounds for 2 ranks against 1 over the same
# global batches: the first 3 losses, all 6 (reduction-order noise grows
# through Adam and BatchNorm), the parameters' sum, evaluation at the
# initial parameters.
DP_LOSS_RTOL_EARLY, DP_LOSS_RTOL = 2e-4, 5e-2
DP_PARAM_RTOL, DP_EVAL_RTOL = 5e-3, 2e-4
# The parameters' change over the 6 steps on 2 ranks against 1 rank,
# ||d2 - d1|| / ||d1||, and the least change a run must make, ||d1|| /
# ||p0||, set from the H100's readings (PERF.md section 6): 2.7e-3 to
# 5.4e-3 over five runs, and 4.6e-3 for 1 rank against itself (the noise:
# the length regulator's gather backward sums with atomics); 0.34 with
# BatchNorm's moments taken per rank and 0.75 with dropout masks drawn per
# rank (which the bounds above let through); the weights move by 0.25.
DP_DELTA_RTOL, DP_MIN_MOVE = 2e-2, 1e-3


def dp_config(corpus: str, out: str, total: int, grad_acc_step: int = 1,
              steps_per_call: int = 1, every: int = 1000,
              warm_up: int = DP_WARM_UP):
    """Config() width under "flash", float32, a global batch of DP_BATCH
    at the single bucket DP_BUCKET, a warm-up of ``warm_up`` steps, losses
    logged every step; ``grad_acc_step`` micro-steps an update,
    ``steps_per_call`` steps a chunk, an evaluation and a sample every
    ``every`` steps."""
    from expressive_fastspeech2_mandarin_tpu_torch import config as C

    return C.Config(
        preprocess=C.PreprocessConfig(
            path=C.PathConfig(preprocessed_path=corpus)),
        model=C.ModelConfig(
            transformer=C.TransformerConfig(attention_impl="flash")),
        train=C.TrainConfig(
            path=C.PathConfig(ckpt_path=os.path.join(out, "ckpt"),
                              log_path=os.path.join(out, "log"),
                              result_path=os.path.join(out, "result")),
            optimizer=C.OptimizerConfig(batch_size=DP_BATCH,
                                        warm_up_step=warm_up,
                                        grad_acc_step=grad_acc_step),
            buckets=C.BucketConfig(src_buckets=DP_BUCKET[:1],
                                   mel_buckets=DP_BUCKET[1:]),
            step=C.StepConfig(total_step=total, log_step=1, val_step=every,
                              synth_step=every, save_step=1000),
            steps_per_call=steps_per_call))


def dp_worker(spec_path: str) -> int:
    """One rank of phase 13, in its own process on cuda:0: ``steps`` runs
    DP_STEPS train steps by hand over the row-sharded batches (evaluation
    before and after, each step timed; with ``grad_acc_step`` k in the
    spec, one process takes each batch as k micro-steps over its row
    slices, the slices the ranks of a k-rank run take, and reads whether
    the parameters stayed bit-equal through each update's first k - 1
    micro-steps and the optimizer's count of updates), then, on more than
    one rank, times
    the gradients' all-reduce alone on tensors of their sizes; ``nccl``
    runs ``train()`` graphed in a world of one over NCCL (chunks, an
    evaluation and a sample inside the run, the train graphs read around
    each sample); ``graphed`` is ``dp_graphed``. Writes its result as
    JSON, and the flat parameters before and after the steps
    (``torch.save``, not named .pt: the phase counts the checkpoints by
    that suffix)."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, spec["root"])
    import torch
    import torch.distributed as dist

    from expressive_fastspeech2_mandarin_tpu_torch import parallel
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        loop,
        train,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        broadcast_state,
    )

    def flat_params(state):
        return torch.cat([p.detach().reshape(-1)
                          for p in state.model.parameters()]).cpu()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    n, rank = spec["num_processes"], spec["rank"]
    if spec["mode"] in ("nccl", "graphed"):
        dist.init_process_group("nccl", init_method=f"tcp://{spec['coord']}",
                                world_size=1, rank=0)
    else:
        parallel.initialize_distributed(spec["coord"], n, rank, "gloo")
    result = {"rank": rank,
              "backend": dist.get_backend() if dist.is_initialized()
              else None}
    reset_flash_counts()
    if spec["mode"] == "graphed":
        state = dp_graphed(spec, device, result)
    elif spec["mode"] == "nccl":
        cfg = dp_config(spec["corpus"], spec["out"], DP_NCCL_STEPS,
                        steps_per_call=DP_NCCL_SPC, every=DP_NCCL_EVERY)
        held, samples = {}, []
        create, sample = loop.create_train_state, loop.save_synth_sample

        def creating(*args, **kwargs):
            held["state"] = create(*args, **kwargs)
            return held["state"]

        def sampling(*args, **kwargs):
            # The train graphs as the sample finds and leaves them.
            owner = held["state"].graphs
            before = (owner.count(), owner.check())
            out = sample(*args, **kwargs)
            samples.append([*before, owner.count(), owner.check()])
            return out

        loop.create_train_state, loop.save_synth_sample = creating, sampling
        state = train(cfg, device=device)
        torch.cuda.synchronize()
        result.update(step=state.step, samples=samples,
                      capturable=state.layout.capturable,
                      checkpoints=sorted(os.listdir(
                          os.path.join(spec["out"], "ckpt"))))
    else:
        acc = spec.get("grad_acc_step", 1)
        cfg = dp_config(spec["corpus"], spec["out"], DP_STEPS, acc)
        tc = cfg.train
        layout = parallel.make_layout()
        corpus = PreprocessedCorpus(spec["corpus"])
        shards = dict(seed=tc.seed, num_shards=n,
                      shard_index=layout.data_index if layout else 0)
        ds_args = (DP_BATCH, tc.buckets, cfg.model.max_seq_len)
        train_ds = BucketedDataset(corpus, "train.txt", *ds_args,
                                   drop_last=True, **shards)
        val_ds = BucketedDataset(corpus, "val.txt", *ds_args, **shards)
        state = create_train_state(cfg, corpus.stats, device, layout)
        if layout is not None:
            broadcast_state(state)
        torch.save(flat_params(state), spec["result"] + ".p0")
        losses, ms, shapes, held = [], [], set(), []
        eval0 = loop.evaluate(loop.make_eval_step(state, cfg), val_ds,
                              device)
        epoch = 0
        while len(losses) < DP_STEPS:
            for raw in train_ds.epoch(epoch):
                rows = len(raw["mels"]) // acc
                parts = [loop.stage_batch(
                    {k: v[i * rows:(i + 1) * rows] for k, v in raw.items()},
                    device, tc.transfer_dtype) for i in range(acc)]
                shapes.add((raw["texts"].shape[1],
                            raw["mels"].shape[1], rows))
                before = ([p.detach().clone()
                           for p in state.model.parameters()]
                          if acc > 1 else [])
                totals, step_ms = [], 0.0
                for i, b in enumerate(parts):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    totals.append(train_step(state, b, cfg).total)
                    torch.cuda.synchronize()
                    step_ms += (time.perf_counter() - t0) * 1e3
                    if i < acc - 1:  # outside the timed micro-steps
                        held.append(all(torch.equal(p, q) for p, q in zip(
                            state.model.parameters(), before)))
                del before
                ms.append(step_ms)
                losses.append(sum(float(x) for x in totals) / acc)
                if len(losses) == DP_STEPS:
                    break
            epoch += 1
        evals = loop.evaluate(loop.make_eval_step(state, cfg), val_ds,
                              device)
        torch.save(flat_params(state), spec["result"] + ".p1")
        reduce_ms = []  # outside the timed steps
        if layout is not None:
            grads = [torch.ones_like(p) for p in state.model.parameters()]
            for _ in range(DP_REDUCE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                parallel.all_reduce_(grads)
                torch.cuda.synchronize()
                reduce_ms.append((time.perf_counter() - t0) * 1e3)
        result.update(losses=losses, ms=ms, reduce_ms=reduce_ms,
                      eval0=eval0, eval=evals, held=held,
                      updates=int(state.optimizer.count),
                      mini_step=int(state.optimizer.mini_step),
                      shapes=sorted(shapes),
                      host_rows=train_ds.host_rows(0))
    params = list(state.model.parameters())
    result["param_sum"] = sum(p.double().abs().sum() for p in params).item()
    result["grad_mb"] = sum(p.numel() for p in params) * 4 / 1e6
    result["flash"] = flash_counts()
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


def dp_graphed(spec: dict, device, result: dict):
    """``dp_worker``'s ``graphed`` mode, a world of one over NCCL: the
    PREMUL_SUM replay witness; the DP train step graphed against eager
    from one state over DP_STEPS global batches of phase 13's corpus, the
    steps one a replay and DP_GRAPH_SPC a replay, the eval step graphed
    against eager, each call's flash launches and ms; busy share and peak
    memory eager and graphed, at DP_BUCKET and at the deep run's bucket.
    Returns the graphed state."""
    import torch
    import torch.distributed as dist

    from expressive_fastspeech2_mandarin_tpu_torch import graphs, parallel
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        loop,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        broadcast_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        eval_step,
        make_eval_step,
        make_train_multi_step,
        make_train_step,
        stack_batches,
    )

    os.makedirs(spec["out"], exist_ok=True)
    # (a) A replayed NCCL collective runs: at one rank a plain sum moves
    # nothing, a pre-multiplied one scales.
    dist.all_reduce(torch.ones(1, device=device))  # the communicator
    x = torch.ones(1024, device=device)
    witness = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(witness):
        dist.all_reduce(x, op=dist._make_nccl_premul_sum(2.0))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    captured = sorted(set(x.tolist()))
    for _ in range(DP_WITNESS_REPLAYS):
        witness.replay()
    torch.cuda.synchronize()
    result["witness"] = [captured, sorted(set(x.tolist()))]

    # (b) The DP step graphed against eager, with the recipe's warm-up, as
    # phase 14 (whose bounds these are) takes it: past DP_WARM_UP's steps
    # the eager step's float noise grows by chaos (a repeated 1-rank run
    # showed it).
    cfg = dp_config(spec["corpus"], spec["out"], DP_STEPS,
                    warm_up=DP_GRAPH_WARM_UP)
    tc = cfg.train
    layout = parallel.make_layout()
    corpus = PreprocessedCorpus(spec["corpus"])
    ds_args = (DP_BATCH, tc.buckets, cfg.model.max_seq_len)
    train_ds = BucketedDataset(corpus, "train.txt", *ds_args,
                               drop_last=True, seed=tc.seed)
    val_ds = BucketedDataset(corpus, "val.txt", *ds_args, seed=tc.seed)
    raw = [b for epoch in range(2) for b in train_ds.epoch(epoch)]
    batches = [loop.stage_batch(b, device) for b in raw[:DP_STEPS]]
    val = [loop.stage_batch(b, device) for b in val_ds.epoch(0, False)]
    states = {k: create_train_state(cfg, corpus.stats, device, layout)
              for k in ("eager", "graphed", "chunked")}
    for state in states.values():
        broadcast_state(state)

    def flat(state):
        return torch.cat([p.detach().reshape(-1).double()
                          for p in state.model.parameters()])

    p0 = flat(states["eager"])
    replays = []
    replay = graphs.Compiled._replay

    def counted_replay(g, tensors):
        replays.append(1)
        return replay(g, tensors)

    graphs.Compiled._replay = staticmethod(counted_replay)

    def launched(fn):
        """fn()'s result and the flash launches (forward, dQ, dK/dV) it
        counted; the counters run on over the mode (``dp_worker`` reads
        their total)."""
        before = flash_counts()
        out = fn()
        return out, [a - b for a, b in zip(flash_counts(), before)]

    def timed(fn):
        """fn()'s result, ms, flash launches and graph replays."""
        n = len(replays)
        holder = {}
        ms = synced_ms(lambda: holder.update(out=launched(fn)))
        out, flash = holder["out"]
        return out, ms, flash, len(replays) - n

    runs = {"eager": [], "graphed": [], "chunked": []}
    step = make_train_step(states["graphed"], cfg)
    multi = make_train_multi_step(states["chunked"], cfg, DP_GRAPH_SPC)
    for batch in batches:
        runs["eager"].append(timed(
            lambda: train_step(states["eager"], batch, cfg)))
        runs["graphed"].append(timed(lambda: step(batch)))
        if len(runs["graphed"]) == 1:
            result["graphs_after_first"] = states["graphed"].graphs.count()
    for c in range(0, DP_STEPS, DP_GRAPH_SPC):
        stacked = stack_batches(batches[c:c + DP_GRAPH_SPC])
        runs["chunked"].append(timed(lambda: multi(stacked)))
    for name, rows in runs.items():
        result[name] = {"losses": [float(r[0].total) for r in rows],
                        "ms": [r[1] for r in rows],
                        "flash": [r[2] for r in rows],
                        "replays": [r[3] for r in rows]}
    d_eager = flat(states["eager"]) - p0
    result["delta_rel"] = {
        k: float((flat(states[k]) - p0 - d_eager).norm() / d_eager.norm())
        for k in ("graphed", "chunked")}
    result["move"] = float(d_eager.norm() / p0.norm())
    result["graphs"] = states["graphed"].graphs.count()
    # The eval step on the graphed state's weights: eager, then graphed
    # twice (the capture, a replay), each graphed call's flash launches.
    evaluate = make_eval_step(states["graphed"], cfg)
    model = states["graphed"].model
    result["eval"] = []
    for b in val:
        row = [[float(x) for x in eval_step(model, b, cfg, layout)]]
        for _ in range(2):
            losses, flash = launched(lambda: evaluate(b))
            row += [[float(x) for x in losses], flash]
        result["eval"].append(row)

    # Times, busy share and peak memory, eager and graphed, at DP_BUCKET
    # (B = DP_BATCH) and at the deep run's bucket (B = CONV_KERNEL_BATCH).
    s, t = CONV_BUCKET
    deep_batch = loop.stage_batch(
        synthetic_train_batch(CONV_KERNEL_BATCH, s, t, seed=7), device)
    deep = {k: create_train_state(cfg, corpus.stats, device, layout)
            for k in ("eager", "graphed")}
    shapes = {"dp": (batches[0], states["eager"], step),
              "deep": (deep_batch, deep["eager"],
                       make_train_step(deep["graphed"], cfg))}
    result["profiles"] = {}
    for name, (batch, eager, graphed_step) in shapes.items():
        fns = {"eager": lambda: train_step(eager, batch, cfg),
               "graphed": lambda: graphed_step(batch)}
        for _ in range(3):
            for fn in fns.values():
                fn()
        ms = {k: [] for k in fns}
        for _ in range(DP_GRAPH_TIMED):
            for k, fn in fns.items():
                ms[k].append(synced_ms(fn))
        out = {}
        for k, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            (busy, window, kernels), counted, traced = profiled_busy(
                fn, GRAPH_PROFILED,
                os.path.join(spec["out"], f"profile_{name}_{k}.json"))
            out[k] = {"ms": ms[k], "busy": busy, "window_ms": window,
                      "kernels": kernels, "counted": list(counted),
                      "traced": list(traced),
                      "peak_mib": (torch.cuda.max_memory_allocated()
                                   - base) / 2**20,
                      "base_mib": base / 2**20,
                      "reserved_mib": torch.cuda.memory_reserved() / 2**20}
        result["profiles"][name] = out
    graphs.Compiled._replay = staticmethod(replay)
    return states["graphed"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(commands: list[list[str]], logs: list[Path],
              root: Path) -> list[int]:
    """Start the commands together from ``root`` (output to ``logs``); on
    DP_TIMEOUT kill them all. Returns the exit codes (-9 for a killed
    process)."""
    procs = []
    for cmd, log in zip(commands, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(root))))
    deadline = time.monotonic() + DP_TIMEOUT
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0,
                                            deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            return [-9] * len(procs)
    return codes


def dp_runs(tmp: Path, mode: str, groups: dict[str, tuple[int, dict]],
            corpus: str, root: Path) -> dict[str, list[dict] | None]:
    """Groups of ranks of ``dp_worker`` (``python3 chip_smoke.py
    --dp-worker``), started together: per group name its number of ranks
    and what to add to their specs. Each group's results, or None (the
    logs' tails printed) when one of its ranks failed."""
    commands, logs, results = [], [], {}
    for name, (n, extra) in groups.items():
        coord = f"127.0.0.1:{free_port()}"
        results[name] = []
        for rank in range(n):
            spec = tmp / f"{name}_{rank}.json"
            results[name].append(tmp / f"{name}_{rank}.result.json")
            spec.write_text(json.dumps({
                "root": str(root), "mode": mode, "num_processes": n,
                "rank": rank, "coord": coord, "corpus": corpus,
                "out": str(tmp / name), "result": str(results[name][-1]),
                **extra}))
            commands.append([sys.executable, str(Path(__file__).resolve()),
                             "--dp-worker", str(spec)])
            logs.append((name, tmp / f"{name}_{rank}.log"))
    codes = run_ranks(commands, [log for _, log in logs], root)
    out = {}
    for name, paths in results.items():
        failed = [log for (group, log), code in zip(logs, codes)
                  if group == name and code]
        for log in failed:
            print(f"  {log.name}:\n" + log.read_text()[-3000:])
        out[name] = (None if failed
                     else [json.loads(r.read_text()) for r in paths])
    return out


def dp_run(tmp: Path, name: str, mode: str, n: int, corpus: str,
           root: Path) -> list[dict] | None:
    """``n`` ranks of ``dp_worker``; their results, or None."""
    return dp_runs(tmp, mode, {name: (n, {})}, corpus, root)[name]


def check_dp_graphed(smoke: Smoke, r: dict, card: str) -> None:
    """Phase 13's checks and times of ``dp_graphed``'s result."""
    import numpy as np

    smoke.check(r["witness"] == [[1.0], [2.0 ** DP_WITNESS_REPLAYS]],
                f"a PREMUL_SUM all-reduce by 2 over NCCL (world of 1) "
                f"captured and replayed {DP_WITNESS_REPLAYS} times: values "
                f"{r['witness'][0]} after the capture, {r['witness'][1]} "
                f"after the replays (expected "
                f"{[2.0 ** DP_WITNESS_REPLAYS]})")

    def loss_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    eager, graphed, chunked = r["eager"], r["graphed"], r["chunked"]
    per_step = [10, 10, 10]
    means = [float(np.mean(eager["losses"][c:c + DP_GRAPH_SPC]))
             for c in range(0, DP_STEPS, DP_GRAPH_SPC)]
    smoke.check(r["backend"] == "nccl" and r["graphs_after_first"] > 0
                and all(f == per_step for f in eager["flash"]
                        + graphed["flash"])
                and all(f == [DP_GRAPH_SPC * n for n in per_step]
                        for f in chunked["flash"])
                and eager["replays"] == [0] * DP_STEPS
                and graphed["replays"] == [1] * DP_STEPS
                and chunked["replays"] == [1] * len(means),
                f"the DP step over {r['backend']}: graphs after the first "
                f"call {r['graphs_after_first']}; flash launches (forward, "
                f"dQ, dK/dV) a call eager {eager['flash']}, graphed "
                f"{graphed['flash']}, chunks of {DP_GRAPH_SPC} "
                f"{chunked['flash']}; graph replays a call eager "
                f"{eager['replays']}, graphed {graphed['replays']}, chunks "
                f"{chunked['replays']}")
    smoke.check(loss_rel(graphed["losses"], eager["losses"])
                <= GRAPH_LOSS_RTOL
                and loss_rel(chunked["losses"], means) <= GRAPH_LOSS_RTOL
                and max(r["delta_rel"].values()) <= GRAPH_DELTA_RTOL,
                f"{DP_STEPS} DP steps, float32 'flash', B = {DP_BATCH}, "
                f"bucket {DP_BUCKET}: losses eager "
                f"{[f'{x:.6f}' for x in eager['losses']]}; graphed rel diff "
                f"{loss_rel(graphed['losses'], eager['losses']):.2e}, chunk "
                f"means {chunked['losses']} against {means} rel diff "
                f"{loss_rel(chunked['losses'], means):.2e} (bound "
                f"{GRAPH_LOSS_RTOL:.0e}); ||dp - dp_eager|| / ||dp_eager|| "
                f"{r['delta_rel']} (bound {GRAPH_DELTA_RTOL:.0e}); "
                f"||dp_eager|| / ||p0|| {r['move']:.3e}")
    smoke.check(all(loss_rel(row[i], row[0]) <= GRAPH_LOSS_RTOL
                    and row[i + 1] == [10, 0, 0]
                    for row in r["eval"] for i in (1, 3)),
                f"the eval step graphed (capture, replay) against eager on "
                f"{len(r['eval'])} val batch(es): "
                + "; ".join(f"eager {row[0][0]:.6f}, graphed {row[1][0]:.6f}"
                            f" and {row[3][0]:.6f}, flash {row[2]} and "
                            f"{row[4]}" for row in r["eval"]))
    print(f"  DP step ms, world of 1 over NCCL, B = {DP_BATCH}, bucket "
          f"{DP_BUCKET}: eager median "
          f"{float(np.median(eager['ms'][1:])):.3f} {eager['ms'][1:]}, "
          f"graphed {float(np.median(graphed['ms'][1:])):.3f} "
          f"{graphed['ms'][1:]}, {DP_GRAPH_SPC} a replay "
          f"{[m / DP_GRAPH_SPC for m in chunked['ms'][1:]]} a step; first "
          f"calls (warm-up, capture, replay) {graphed['ms'][0]:.1f} and "
          f"{chunked['ms'][0]:.1f} ms [{card}]", flush=True)
    for name, prof in r["profiles"].items():
        what = (f"B = {DP_BATCH}, bucket {DP_BUCKET}" if name == "dp"
                else f"B = {CONV_KERNEL_BATCH}, bucket {CONV_BUCKET}")
        print("  " + f"DP step {what}, {DP_GRAPH_TIMED} steps in turns "
              f"after 3, then {GRAPH_PROFILED} profiled (median ms; busy, "
              f"window ms, kernels; peak MiB above allocated, reserved): "
              + "; ".join(
                  f"{k} {float(np.median(v['ms'])):.3f} "
                  f"({min(v['ms']):.3f}-{max(v['ms']):.3f}); busy "
                  f"{v['busy']:.3f}, {v['window_ms']:.1f}, {v['kernels']};"
                  f" {v['peak_mib']:.1f} above {v['base_mib']:.1f}, "
                  f"reserved {v['reserved_mib']:.1f}"
                  for k, v in prof.items()) + f" [{card}]", flush=True)
        smoke.check(all(v["busy"] > 0 and all(
            t <= c for t, c in zip(v["traced"], v["counted"]))
            for v in prof.values()),
            f"DP step {what}: the profiler saw device time, and no more "
            f"port kernels than counted: " + "; ".join(
                f"{k} counted {v['counted']} traced {v['traced']}"
                for k, v in prof.items()))


def phase_data_parallel(smoke: Smoke, device, root: Path):
    """Phase 13: 1 rank against 2 gloo ranks sharing the card over the same
    global batches; ``efs2-torch-train --coordinator`` on 2 processes on the
    Quick-start corpus; over NCCL in worlds of one, the DP steps graphed
    against eager (``dp_graphed``) and ``train()`` graphed. Returns the
    flash launches (forward, dQ, dK/dV) the ranks counted."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch import align
    from expressive_fastspeech2_mandarin_tpu_torch.kernels import build

    card = nvidia_smi_line()
    build.build_all(["flash_mha", "flash_mha_bwd"])  # before the ranks
    torch.cuda.empty_cache()
    launches = [0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        corpus = write_training_corpus(str(tmp / "corpus"), 0)
        runs = {}
        # Gradient accumulation: 1 rank, B = 4 a micro-step (the 2-rank
        # run's row slices), two micro-steps an update.
        for groups in ({"one": (1, {})}, {"two": (2, {})},
                       {"acc2": (1, {"grad_acc_step": 2})}):
            t0 = time.perf_counter()
            runs.update(dp_runs(tmp, "steps", groups, corpus, root))
            for name, (n, _) in groups.items():
                smoke.check(runs[name] is not None,
                            f"{name}: {n} rank(s), {DP_STEPS} updates: the "
                            f"ranks ran in {time.perf_counter() - t0:.1f} s")
        if runs["one"] and runs["two"]:
            (one,), two = runs["one"], runs["two"]
            t = dp_config(corpus, str(tmp), DP_STEPS).model.transformer
            n_blocks = t.encoder_layer + t.decoder_layer
            forwards = DP_STEPS + 2 * math.ceil(N_VAL_UTTS / DP_BATCH)
            expected = [n_blocks * forwards, n_blocks * DP_STEPS,
                        n_blocks * DP_STEPS]
            for r in runs["one"] + two:
                launches = [a + b for a, b in zip(launches, r["flash"])]
            smoke.check(all(r["flash"] == expected for r in [one, *two])
                        and two[0]["backend"] == "gloo"
                        and one["shapes"] == [[*DP_BUCKET, DP_BATCH]]
                        and all(r["shapes"] == [[*DP_BUCKET, DP_BATCH // 2]]
                                for r in two),
                        f"flash launches (forward, dQ, dK/dV): 1 rank "
                        f"{one['flash']}, 2 ranks {[r['flash'] for r in two]}"
                        f" (expected {expected} each: {n_blocks} a step, "
                        f"{n_blocks} forward an evaluation batch); (S, T, "
                        f"rows) of the batches: 1 rank {one['shapes']}, "
                        f"each of 2 {[r['shapes'] for r in two]}; backend "
                        f"{two[0]['backend']}")
            smoke.check(two[0]["losses"] == two[1]["losses"]
                        and two[0]["param_sum"] == two[1]["param_sum"]
                        and two[0]["eval"] == two[1]["eval"],
                        f"the 2 ranks bit-equal: parameter sums "
                        f"{two[0]['param_sum']!r}, {two[1]['param_sum']!r}")
            a, b = np.array(one["losses"]), np.array(two[0]["losses"])
            rel = np.abs(a - b) / np.abs(a)
            p_rel = (abs(one["param_sum"] - two[0]["param_sum"])
                     / one["param_sum"])
            e_rel = max(abs(one["eval0"][k] - two[0]["eval0"][k])
                        / abs(one["eval0"][k]) for k in one["eval0"])
            smoke.check(rel[:3].max() <= DP_LOSS_RTOL_EARLY
                        and rel.max() <= DP_LOSS_RTOL
                        and p_rel <= DP_PARAM_RTOL and e_rel <= DP_EVAL_RTOL,
                        f"2 ranks against 1: losses 1 rank {one['losses']}, "
                        f"2 ranks {two[0]['losses']}, rel diff "
                        f"{[f'{x:.1e}' for x in rel]} (bounds "
                        f"{DP_LOSS_RTOL_EARLY:.0e} for steps 1-3, "
                        f"{DP_LOSS_RTOL:.0e}); parameter sum rel diff "
                        f"{p_rel:.2e} (bound {DP_PARAM_RTOL:.0e}); "
                        f"evaluation at the initial parameters rel diff "
                        f"{e_rel:.2e} (bound {DP_EVAL_RTOL:.0e})")
            names = ["one_0", "two_0"] + ["acc2_0"] * bool(runs["acc2"])
            flat = {(k, v): torch.load(
                tmp / f"{k}.result.json.{v}").double()
                for k in names for v in ("p0", "p1")}
            p0 = flat["one_0", "p0"]
            d1 = flat["one_0", "p1"] - p0
            move = float(d1.norm() / p0.norm())
            d_rel = float((flat["two_0", "p1"] - flat["one_0", "p1"]).norm()
                          / d1.norm())
            smoke.check(torch.equal(flat["two_0", "p0"], p0)
                        and move >= DP_MIN_MOVE and d_rel <= DP_DELTA_RTOL,
                        f"the parameters' change over {DP_STEPS} steps: "
                        f"||d1|| / ||p0|| = {move:.3e} (at least "
                        f"{DP_MIN_MOVE:.0e}); 2 ranks against 1 "
                        f"||d2 - d1|| / ||d1|| = {d_rel:.3e} (bound "
                        f"{DP_DELTA_RTOL:.0e}); the same initial parameters")
            if runs["acc2"]:
                (acc2,) = runs["acc2"]
                d_acc = flat["acc2_0", "p1"] - p0
                a_move = float(d_acc.norm() / p0.norm())
                a_rel = float((d_acc - d1).norm() / d1.norm())
                want = [n_blocks * (2 * DP_STEPS + forwards - DP_STEPS),
                        2 * n_blocks * DP_STEPS, 2 * n_blocks * DP_STEPS]
                smoke.check(torch.equal(flat["acc2_0", "p0"], p0)
                            and acc2["held"] == [True] * DP_STEPS
                            and acc2["updates"] == DP_STEPS
                            and acc2["mini_step"] == 0
                            and acc2["flash"] == want
                            and acc2["shapes"] == [[*DP_BUCKET,
                                                    DP_BATCH // 2]]
                            and all(map(math.isfinite, acc2["losses"]))
                            and a_move >= DP_MIN_MOVE,
                            f"grad_acc_step 2, 1 rank, B = "
                            f"{DP_BATCH // 2} a micro-step: parameters "
                            f"bit-equal through each update's first "
                            f"micro-step {acc2['held']}; "
                            f"{acc2['updates']} updates of {DP_STEPS} "
                            f"batches, mini_step {acc2['mini_step']}; flash "
                            f"launches {acc2['flash']} (expected {want}); "
                            f"||d|| / ||p0|| = {a_move:.3e} (at least "
                            f"{DP_MIN_MOVE:.0e}); losses {acc2['losses']}; "
                            f"||d - d1|| / ||d1|| = {a_rel:.3e}, printed "
                            f"only (BatchNorm's moments over 4 rows, masks "
                            f"drawn per micro-step, the loss a mean of the "
                            f"halves' means) [{card}]")
                del d_acc
            del flat, p0, d1
            r0, r1 = two[0]["host_rows"], two[1]["host_rows"]
            smoke.check(not set(r0) & set(r1)
                        and set(r0) | set(r1) == set(one["host_rows"]),
                        f"the ranks' rows ({len(r0)} and {len(r1)} in epoch "
                        f"0) are disjoint and tile the 1-rank run's "
                        f"{len(one['host_rows'])}")
            step_ms = {"train step, 1 rank, B = 8": one["ms"][1:],
                       "train step, 2 ranks on one card, B = 4 each":
                       two[0]["ms"][1:],
                       f"the gradients' all-reduce alone, outside the "
                       f"steps (gloo, {two[0]['grad_mb']:.1f} MB, 2 ranks)":
                       two[0]["reduce_ms"][1:]}
            for what, ms in step_ms.items():
                print(f"  ms, {what} (all but the first): "
                      f"median {float(np.median(ms)):.1f}, "
                      f"{[round(x, 1) for x in ms]} [{card}]")

        # The command line on 2 processes, on the Quick-start corpus.
        esd = write_esd_corpus(str(tmp / "esd"), 10, E2E_SECONDS)
        y = e2e_configs(tmp / "qs", esd)
        cfg = ["-p", y["preprocess"], "-m", y["model"], "-t", y["train"]]
        run_cli("preprocess", ["esd", "--esd-root", esd, "--raw-path",
                               tmp / "qs" / "raw"])
        align.ensure_built()
        run_cli("align", ["--corpus", tmp / "qs" / "raw", "--out",
                          tmp / "qs" / "pre" / "TextGrid"])
        run_cli("preprocess", ["features", *cfg, "--device", str(device)])
        coord = f"127.0.0.1:{free_port()}"
        logs = [tmp / f"cli_{i}.log" for i in range(2)]
        t0 = time.perf_counter()
        codes = run_ranks([[sys.executable, "-m", f"{PKG}.cli.train", *cfg,
                            "--total_steps", str(DP_CLI_STEPS),
                            "--coordinator", coord, "--num-processes", "2",
                            "--process-id", str(i), "--backend", "gloo",
                            "--device", str(device)] for i in range(2)],
                          logs, root)
        seconds = time.perf_counter() - t0
        finals = []
        for log in logs:
            lines = [s for s in log.read_text().splitlines()
                     if " of 2: step " in s]
            finals.append(lines[-1] if lines else "")
        sums = [s.split("parameter sum ")[-1] for s in finals]
        ckpt_dirs = sorted({str(p.parent.relative_to(tmp))
                            for p in tmp.rglob("*.pt")})
        if any(codes):
            for log in logs:
                print(f"  {log.name}:\n" + log.read_text()[-3000:])
        smoke.check(not any(codes)
                    and [s.split(":")[0] for s in finals] == [
                        "rank 0 of 2", "rank 1 of 2"]
                    and all(f" step {DP_CLI_STEPS}," in s for s in finals)
                    and sums[0] == sums[1]
                    and ckpt_dirs == ["qs/ckpt"]
                    and sorted(os.listdir(tmp / "qs" / "ckpt")) == [
                        f"{DP_CLI_STEPS}.pt"],
                    f"efs2-torch-train --coordinator {coord} "
                    f"--num-processes 2 --backend gloo, {DP_CLI_STEPS} "
                    f"steps in {seconds:.1f} s (exit codes {codes}): "
                    f"{finals}; checkpoint directories {ckpt_dirs} "
                    f"[{card}]")

        t0 = time.perf_counter()
        graphed = dp_run(tmp, "graphed", "graphed", 1, corpus, root)
        if smoke.check(graphed is not None,
                       f"the DP steps graphed over NCCL, world of 1 "
                       f"({time.perf_counter() - t0:.1f} s)"):
            r = graphed[0]
            launches = [a + b for a, b in zip(launches, r["flash"])]
            check_dp_graphed(smoke, r, card)
        t0 = time.perf_counter()
        nccl = dp_run(tmp, "nccl", "nccl", 1, corpus, root)
        if smoke.check(nccl is not None,
                       f"train() over NCCL, world of 1 "
                       f"({time.perf_counter() - t0:.1f} s)"):
            r = nccl[0]
            launches = [a + b for a, b in zip(launches, r["flash"])]
            t = dp_config(corpus, str(tmp), DP_NCCL_STEPS).model.transformer
            n_blocks = t.encoder_layer + t.decoder_layer
            crossings = DP_NCCL_STEPS // DP_NCCL_EVERY
            forwards = (DP_NCCL_STEPS + crossings * math.ceil(
                N_VAL_UTTS / DP_BATCH) + crossings)
            expected = [n_blocks * forwards] + [n_blocks * DP_NCCL_STEPS] * 2
            kept = all(count > 0 and not changed and after == count
                       and not changed_after
                       for count, changed, after, changed_after
                       in r["samples"])
            smoke.check(r["backend"] == "nccl" and r["capturable"]
                        and r["step"] == DP_NCCL_STEPS
                        and r["checkpoints"] == [f"{DP_NCCL_STEPS}.pt"]
                        and r["flash"] == expected
                        and len(r["samples"]) == crossings and kept,
                        f"train() in a world of 1 over {r['backend']}, "
                        f"graphed (capturable {r['capturable']}), chunks of "
                        f"{DP_NCCL_SPC}, an evaluation and a sample every "
                        f"{DP_NCCL_EVERY} steps: step {r['step']}, "
                        f"checkpoints {r['checkpoints']}, flash launches "
                        f"{r['flash']} (expected {expected}); the train "
                        f"graphs around each sample (held, changed) before "
                        f"and after: {r['samples']}")
    smoke.check(all(n > 0 for n in launches),
                f"flash launches (forward, dQ, dK/dV) the ranks counted over "
                f"phase 13: {launches}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 14: the compiled steps (CUDA graphs) against the eager path.

GRAPH_WARM, GRAPH_REPEATS = 2, 5   # untimed, then timed calls
GRAPH_PROFILED = 5                 # calls or steps a profiler window holds
GRAPH_STEPS, GRAPH_SPC, GRAPH_RESUME_AT = 20, 10, 10
GRAPH_TUNED_STEPS = 10             # timed B = 32 steps, after 3 untimed
# Graphed against eager from the same weights and state (PERF.md section
# 6, written before the first run): the mel within 1e-5 of max(1,
# max|mel|); the waveform within 1e-5 (float32 vocoder) or 5e-2 of its
# peak (bf16, phase 8's kernel-path bound); each train step's loss within
# 1e-5 relative (phase 5's); the parameters' change over 20 steps,
# ||dp_graph - dp_eager|| / ||dp_eager||, within 1e-2.
GRAPH_MEL_REL, GRAPH_WAV_F32, GRAPH_WAV_BF16 = 1e-5, 1e-5, 5e-2
GRAPH_LOSS_RTOL, GRAPH_DELTA_RTOL = 1e-5, 1e-2


def eager_synthesize(synth, *args, **kwargs):
    """``synth.synthesize`` (or another entry, ``entry=``) with the
    compiled functions' eager bodies: the same code, no graph."""
    entry = kwargs.pop("entry", "synthesize")
    compiled = synth._synth_fn, synth._vocoder_fn
    synth._synth_fn = lambda *key: synth._compile_synth(*key).fn
    synth._vocoder_fn = lambda kind: synth._compile_vocoder(kind).fn
    try:
        out = getattr(synth, entry)(*args, **kwargs)
        return list(out) if entry == "synthesize_streaming" else out
    finally:
        synth._synth_fn, synth._vocoder_fn = compiled


def synced_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def profiled_busy(fn, calls: int, path: str):
    """``trace_busy_share`` of a torch.profiler window over ``calls``
    calls of ``fn``, then the port's kernels over the window as the
    launch counters count them and as the trace shows them
    (``trace_kernel_counts``), in ``all_counts``' order."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    before = all_counts()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(all_counts(), before))
    prof.export_chrome_trace(path)
    return trace_busy_share(path), counted, trace_kernel_counts(path)


# The port's kernels by their names on the card, in all_counts()' order.
PORT_KERNELS = ("flash_mha_fwd_kernel", "flash_mha_bwd_dq_kernel",
                "flash_mha_bwd_dkv_kernel", "flash_mha_fwd_bf16_kernel",
                "flash_mha_bwd_dq_bf16_kernel",
                "flash_mha_bwd_dkv_bf16_kernel", "mrf_conv_tc_kernel",
                "mrf_conv_f32_tc_kernel")


def trace_kernel_counts(path: str) -> tuple[int, ...]:
    """Launches of each of ``PORT_KERNELS`` that a torch.profiler Chrome
    trace holds (a graph's kernels each appear as launched). A name is
    found in the event's, which may carry a namespace, the signature or
    the mangling; none of the names is a part of another."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return tuple(sum(k in name for name in names) for k in PORT_KERNELS)


def all_counts() -> tuple[int, ...]:
    """Flash (float32 forward, dQ, dK/dV; bf16 forward, dQ, dK/dV) and MRF
    (bf16, float32) launches."""
    return flash_counts() + bf16_counts() + mrf_counts()


def check_traced_launches(smoke: Smoke, what: str, kernels: dict) -> None:
    """Each profiled window's launches as the counters counted them (a
    replay adds what its capture counted) against the kernels its trace
    holds, kernel by kernel. A trace may lack a record (in a whole run,
    one flash forward of the 50 in each B = 4 train window, eager and
    graphed alike) but never holds more; ``check_graph_launches`` holds
    the graphs' counts exactly."""
    names = ", ".join(k.removesuffix("_kernel") for k in PORT_KERNELS)
    smoke.check(
        all(all(t <= c for t, c in zip(traced, counted))
            for counted, traced in kernels.values()),
        f"{what}: the port's kernels ({names}) over each profiled window, "
        f"counted / traced: " + "; ".join(
            f"{name} {c} / {t}" for name, (c, t) in kernels.items()))


# PORT_KERNELS' launch counters (module, name), as ``graphs.COUNTERS``
# names them.
KERNEL_COUNTERS = (
    ("flash_mha", "launch_count"), ("flash_mha", "bwd_dq_launch_count"),
    ("flash_mha", "bwd_dkv_launch_count"), ("flash_mha", "bf16_launch_count"),
    ("flash_mha", "bf16_bwd_dq_launch_count"),
    ("flash_mha", "bf16_bwd_dkv_launch_count"),
    ("mrf_resblock", "tc_launch_count"), ("mrf_resblock", "f32_launch_count"))


@contextlib.contextmanager
def dumpable_graphs():
    """``torch.cuda.CUDAGraph()`` made with ``keep_graph=True`` in debug
    mode while the block runs, so that ``CUDAGraph.debug_dump`` can write
    each graph captured in it (``check_graph_launches``)."""
    import torch

    cls = torch.cuda.CUDAGraph

    def make():
        graph = cls(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    torch.cuda.CUDAGraph = make
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = cls


def check_graph_launches(smoke: Smoke, what: str, owner, tmp: Path) -> None:
    """Each graph of ``owner`` (``graphs.Graphs``, captured under
    ``dumpable_graphs``): the launches its capture counted, which each
    replay adds to the counters, against the kernel nodes of the graph
    itself (``cudaGraphDebugDotPrint``: one ``{ID | ...}`` line a node,
    the kernel's mangled name in it), kernel by kernel."""
    import warnings

    from expressive_fastspeech2_mandarin_tpu_torch import graphs

    index = {(module.__name__.rsplit(".", 1)[-1], name): i
             for i, (module, name) in enumerate(graphs.COUNTERS)}
    rows = []
    for compiled in owner.compiled:
        for g in compiled.graphs.values():
            path = tmp / f"graph_{len(rows)}.dot"
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # debug_dump's notices
                g.graph.debug_dump(str(path))
            with open(path) as f:
                nodes = [line for line in f
                         if line.lstrip().startswith("| {ID |")]
            rows.append((tuple(g.launches[index[k]] for k in KERNEL_COUNTERS),
                         tuple(sum(k in n for n in nodes)
                               for k in PORT_KERNELS)))
    smoke.check(bool(rows) and all(a == b for a, b in rows),
                f"{what}: each graph's counted launches against its kernel "
                f"nodes (in the order of PORT_KERNELS): "
                + "; ".join(f"{a} / {b}" for a, b in rows))


def phase_graphs_synthesis(smoke: Smoke, device, tmp: Path) -> None:
    """Phase 14a: ``synthesize`` (short and long-form) and
    ``synthesize_streaming`` replayed from CUDA graphs against the same
    calls through the eager bodies, with the bf16 and the float32
    vocoder."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer
    from expressive_fastspeech2_mandarin_tpu_torch.text import text_to_ids

    card = nvidia_smi_line()
    base = Config()
    fs2, voc = seeded_states(base)
    n_dec = base.model.transformer.decoder_layer
    long_kw = dict(duration_control=LONG_DURATION_CONTROL,
                   max_mel_len=LONG_MAX_MEL)
    for dtype, cfg in (("bfloat16", base), ("float32",
                                            float32_vocoder(base))):
        synth = Synthesizer(cfg, fs2, voc, emotion_maps=EMOTION_MAPS,
                            device=device)
        per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)
        mrf_want = (per_call, 0) if dtype == "bfloat16" else (0, per_call)
        cases = {"short": ((TEXTS, list(range(len(TEXTS))), EMOTIONS), {}),
                 "long-form": ((LONG_TEXTS, list(range(len(LONG_TEXTS))),
                                EMOTIONS), long_kw)}
        for case, (args, kw) in cases.items():
            flash_want = (0, 0, 0) if case == "short" else (n_dec, 0, 0)
            want = flash_want + (0, 0, 0) + mrf_want
            counts = {}

            def counted(name, fn):
                reset_flash_counts()
                reset_bf16_counts()
                reset_mrf_counts()
                out = fn()
                counts[name] = all_counts()
                return out

            eager = counted("eager", lambda: eager_synthesize(
                synth, *args, vocoder="hifigan", **kw))
            synth.drop_graphs()
            t0 = time.perf_counter()
            first = counted("capture", lambda: synth.synthesize(
                *args, vocoder="hifigan", **kw))
            torch.cuda.synchronize()
            capture_ms = 1e3 * (time.perf_counter() - t0)
            graphed = counted("replay", lambda: synth.synthesize(
                *args, vocoder="hifigan", **kw))
            same_dur = all(np.array_equal(a.durations, b.durations)
                           for a, b in zip(eager, graphed))
            mel_diff = max(float(np.abs(a.mel - b.mel).max())
                           for a, b in zip(eager, graphed))
            wav_diff = max(float(np.abs(a.wav - b.wav).max())
                           for a, b in zip(eager, graphed))
            peak_mel = max(1.0, max(float(np.abs(a.mel).max())
                                    for a in eager))
            peak_wav = max(float(np.abs(a.wav).max()) for a in eager)
            wav_bound = (GRAPH_WAV_F32 if dtype == "float32"
                         else GRAPH_WAV_BF16 * peak_wav)
            replays_equal = all(np.array_equal(a.wav, b.wav)
                                for a, b in zip(first, graphed))
            smoke.check(
                same_dur and mel_diff <= GRAPH_MEL_REL * peak_mel
                and wav_diff <= wav_bound and replays_equal,
                f"{case}, {dtype} vocoder, graphed vs eager: durations "
                f"equal {same_dur}, mel max|diff| {mel_diff:.3e} (bound "
                f"{GRAPH_MEL_REL * peak_mel:.3e}), wav max|diff| "
                f"{wav_diff:.3e} (bound {wav_bound:.3e}); the capturing "
                f"call and a replay equal: {replays_equal}")
            smoke.check(all(c == want for c in counts.values()),
                        f"{case}, {dtype}: launches a call (flash f32 fwd, "
                        f"dQ, dK/dV; bf16 fwd, dQ, dK/dV; MRF bf16, f32) "
                        f"{counts} (expected {want} each)")
            paths = (
                ("eager", lambda: eager_synthesize(
                    synth, *args, vocoder="hifigan", **kw)),
                ("graphed", lambda: synth.synthesize(
                    *args, vocoder="hifigan", **kw)),
                ("eager text -> mel", lambda: eager_synthesize(
                    synth, *args, vocoder="none", **kw)),
                ("graphed text -> mel", lambda: synth.synthesize(
                    *args, vocoder="none", **kw)))
            if dtype != "bfloat16":
                paths = paths[:2]  # text -> mel is the same model
            ms = {}
            for name, fn in paths:
                for _ in range(GRAPH_WARM):
                    fn()
                ms[name] = [synced_ms(fn) for _ in range(GRAPH_REPEATS)]
            line = ", ".join(f"{k} {float(np.median(v)):.3f} ms "
                             f"({min(v):.3f}-{max(v):.3f})"
                             for k, v in ms.items())
            print(f"  {case}, {dtype} vocoder, median of {GRAPH_REPEATS} "
                  f"after {GRAPH_WARM}: {line}; the first graphed call "
                  f"(warm-up, capture, replay) {capture_ms:.1f} ms "
                  f"[{card}]", flush=True)
            if dtype != "bfloat16":
                continue
            # Host spans a graphed call still runs: the front end, and
            # the weights' fingerprint (each compiled call takes one).
            front = [synced_ms(lambda: [text_to_ids(
                x, cfg.preprocess.symbol_table) for x in args[0]])
                for _ in range(GRAPH_REPEATS)]
            check = [synced_ms(synth._graphs.check)
                     for _ in range(GRAPH_REPEATS)]
            print(f"  {case}: host spans, median of {GRAPH_REPEATS}: "
                  f"text_to_ids of the batch {float(np.median(front)):.3f}"
                  f" ms, the Synthesizer's weight fingerprint "
                  f"{float(np.median(check)):.3f} ms [{card}]", flush=True)
            busy, kernels = {}, {}
            for name, fn in paths:
                busy[name], *kernels[name] = profiled_busy(
                    fn, GRAPH_PROFILED,
                    str(tmp / f"synth_{case}_{len(busy)}.json"))
            print("  " + f"{case}, bf16 vocoder, device busy share over "
                  f"{GRAPH_PROFILED} calls (busy, window ms, kernels): "
                  + "; ".join(f"{k} {b:.3f}, {w:.1f}, {n}"
                              for k, (b, w, n) in busy.items())
                  + f" [{card}]", flush=True)
            smoke.check(all(b > 0 for b, _, _ in busy.values()),
                        f"{case}: the profiler saw device time in every "
                        f"window")
            check_traced_launches(smoke, f"{case} synthesis", kernels)
        # Streaming: the full windows from one graph, against the same
        # windows eagerly.
        i = 0
        one = (LONG_TEXTS[i], 0, EMOTIONS[i])
        reset_mrf_counts()
        stream = synth.synthesize_streaming(*one, chunk_frames=STREAM_CHUNK,
                                            **long_kw)
        chunks = list(stream)
        graphed_counts = mrf_counts()
        eager_chunks = eager_synthesize(synth, *one,
                                        entry="synthesize_streaming",
                                        chunk_frames=STREAM_CHUNK, **long_kw)
        a, b = np.concatenate(chunks), np.concatenate(eager_chunks)
        diff = float(np.abs(a - b).max()) if a.shape == b.shape else math.inf
        bound = (GRAPH_WAV_F32 if dtype == "float32"
                 else GRAPH_WAV_BF16 * float(np.abs(b).max()))
        windows = len(chunks)
        smoke.check(diff <= bound and sum(graphed_counts) == per_call
                    * windows,
                    f"{dtype} synthesize_streaming, {windows} windows, the "
                    f"full ones from one graph, vs eager: max|diff| "
                    f"{diff:.3e} (bound {bound:.3e}); MRF launches "
                    f"{graphed_counts} ({per_call} a window)")
        print(f"  {dtype}: graphs held by the Synthesizer "
              f"{synth._graphs.count()}")
        check_graph_launches(smoke, f"{dtype} Synthesizer", synth._graphs,
                             tmp)
        del synth


def phase_graphs_training(smoke: Smoke, device, tmp: Path) -> None:
    """Phase 14b: the float32 "flash" train step at B = 4, bucket
    (128, 1000): 20 steps graphed one a replay and ten a replay, against
    20 eager steps from one state; a checkpoint of the eager run at step
    10 loaded into the graphed state, which goes on graphed; the amp bf16
    recipe's step at B = 32 eager and graphed."""
    import gc

    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        train_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        load_checkpoint,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_train_multi_step,
        make_train_step,
        stack_batches,
    )

    card = nvidia_smi_line()
    b, s, t = TRAIN_TIMED
    cfg = training_config(str(tmp), str(tmp), "flash")
    n_blocks = (cfg.model.transformer.encoder_layer
                + cfg.model.transformer.decoder_layer)
    batches = [stage_batch(synthetic_train_batch(b, s, t, seed=100 + i),
                           device) for i in range(GRAPH_STEPS)]

    def flat(state):
        return torch.cat([p.detach().reshape(-1).double()
                          for p in state.model.parameters()])

    def step_counts(fn):
        reset_flash_counts()
        out = fn()
        return out, flash_counts()

    eager = create_train_state(cfg, None, device)
    p0 = flat(eager)
    e_losses, e_ms, e_counts, ckpt = [], [], set(), None
    for i, batch in enumerate(batches):
        if i == GRAPH_RESUME_AT:
            ckpt = {"model": {k: v.clone() for k, v in
                              eager.model.state_dict().items()},
                    "optimizer": eager.optimizer.state_dict(),
                    "step": eager.step,
                    "generator": eager.generator.get_state()}
        holder = {}
        e_ms.append(synced_ms(lambda: holder.update(
            r=step_counts(lambda: train_step(eager, batch, cfg)))))
        report, counts = holder["r"]
        e_counts.add(counts)
        e_losses.append(float(report.total))
    d_eager = flat(eager) - p0

    one = create_train_state(cfg, None, device)
    step = make_train_step(one, cfg)
    g_losses, g_ms, g_counts = [], [], set()
    for batch in batches:
        holder = {}
        g_ms.append(synced_ms(lambda: holder.update(
            r=step_counts(lambda: step(batch)))))
        report, counts = holder["r"]
        g_counts.add(counts)
        g_losses.append(float(report.total))
    d_one = flat(one) - p0

    ten = create_train_state(cfg, None, device)
    multi = make_train_multi_step(ten, cfg, GRAPH_SPC)
    m_losses, m_ms, m_counts = [], [], set()
    for c in range(0, GRAPH_STEPS, GRAPH_SPC):
        stacked = stack_batches(batches[c:c + GRAPH_SPC])
        holder = {}
        m_ms.append(synced_ms(lambda: holder.update(
            r=step_counts(lambda: multi(stacked)))))
        report, counts = holder["r"]
        m_counts.add(counts)
        m_losses.append(float(report.total))
    d_ten = flat(ten) - p0
    chunk_means = [float(np.mean(e_losses[c:c + GRAPH_SPC]))
                   for c in range(0, GRAPH_STEPS, GRAPH_SPC)]

    def rel(d):
        return float((d - d_eager).norm() / d_eager.norm())

    def loss_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    per_step = (n_blocks,) * 3
    smoke.check(e_counts == g_counts == {per_step}
                and m_counts == {tuple(GRAPH_SPC * n for n in per_step)},
                f"flash launches (forward, dQ, dK/dV): eager steps "
                f"{e_counts}, graphed steps {g_counts}, graphed chunks of "
                f"{GRAPH_SPC} {m_counts} (expected {per_step} a step)")
    smoke.check(loss_rel(g_losses, e_losses) <= GRAPH_LOSS_RTOL
                and loss_rel(m_losses, chunk_means) <= GRAPH_LOSS_RTOL
                and rel(d_one) <= GRAPH_DELTA_RTOL
                and rel(d_ten) <= GRAPH_DELTA_RTOL,
                f"{GRAPH_STEPS} steps, float32 'flash', B = {b}, bucket "
                f"({s}, {t}): losses eager {[f'{x:.6f}' for x in e_losses]};"
                f" graphed one a replay, rel diff "
                f"{loss_rel(g_losses, e_losses):.2e}; {GRAPH_SPC} a replay, "
                f"chunk means {m_losses} against {chunk_means}, rel diff "
                f"{loss_rel(m_losses, chunk_means):.2e} (bound "
                f"{GRAPH_LOSS_RTOL:.0e}); ||dp - dp_eager|| / ||dp_eager||"
                f" {rel(d_one):.3e} and {rel(d_ten):.3e} (bound "
                f"{GRAPH_DELTA_RTOL:.0e}), ||dp_eager|| / ||p0|| "
                f"{float(d_eager.norm() / p0.norm()):.3e}")
    print(f"  step ms, float32 'flash', B = {b} (all but the first): eager "
          f"median {float(np.median(e_ms[1:])):.3f} "
          f"({min(e_ms[1:]):.3f}-{max(e_ms[1:]):.3f}), graphed one a "
          f"replay {float(np.median(g_ms[1:])):.3f} "
          f"({min(g_ms[1:]):.3f}-{max(g_ms[1:]):.3f}), {GRAPH_SPC} a replay"
          f" {m_ms[1] / GRAPH_SPC:.3f} a step; first calls (warm-up, "
          f"capture, replay) {g_ms[0]:.1f} and {m_ms[0]:.1f} ms [{card}]",
          flush=True)

    # Resume: the eager run's step-10 checkpoint into the graphed state.
    load_checkpoint(one, ckpt)
    r_losses = [float(step(batch).total)
                for batch in batches[GRAPH_RESUME_AT:]]
    d_resumed = flat(one) - p0
    smoke.check(one.step == GRAPH_STEPS
                and int(one.optimizer.count) == GRAPH_STEPS
                and loss_rel(r_losses, e_losses[GRAPH_RESUME_AT:])
                <= GRAPH_LOSS_RTOL and rel(d_resumed) <= GRAPH_DELTA_RTOL,
                f"resumed at step {GRAPH_RESUME_AT} (load_checkpoint into "
                f"the graphed state), {GRAPH_STEPS - GRAPH_RESUME_AT} "
                f"graphed steps: step {one.step}, updates "
                f"{int(one.optimizer.count)}, losses rel diff "
                f"{loss_rel(r_losses, e_losses[GRAPH_RESUME_AT:]):.2e}, "
                f"||dp - dp_eager|| / ||dp_eager|| {rel(d_resumed):.3e}")
    for name, state in (("one a replay", one), ("ten a replay", ten)):
        check_graph_launches(smoke, f"train step B = {b}, {name}",
                             state.graphs, tmp)
    del d_eager, d_one, d_ten, d_resumed, p0, ten, multi

    busy, peak, kernels = {}, {}, {}
    for name, fn in (("eager", lambda: train_step(eager, batches[0], cfg)),
                     ("graphed", lambda: step(batches[0]))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        busy[name], *kernels[name] = profiled_busy(
            fn, GRAPH_PROFILED, str(tmp / f"train_{name}.json"))
        peak[name] = ((torch.cuda.max_memory_allocated() - base) / 2**20,
                      base / 2**20, torch.cuda.memory_reserved() / 2**20)
    print("  " + f"train step B = {b}, device busy share over "
          f"{GRAPH_PROFILED} steps (busy, window ms, kernels); "
          f"max_memory_allocated in the window above what was allocated "
          f"before it (a graph's activations sit in its pool, reserved at "
          f"capture), and memory_reserved after it: " + "; ".join(
              f"{k} {v[0]:.3f}, {v[1]:.1f}, {v[2]}; {peak[k][0]:.1f} MiB "
              f"above {peak[k][1]:.1f}, reserved {peak[k][2]:.1f}"
              for k, v in busy.items()) + f" [{card}]", flush=True)
    smoke.check(all(v[0] > 0 for v in busy.values()),
                "the profiler saw device time in both train windows")
    check_traced_launches(smoke, f"train step B = {b}", kernels)
    del eager, one, step, batches
    gc.collect()  # a state and its graphs hold each other
    torch.cuda.empty_cache()

    # The tuned recipe's step: amp bf16 "flash" at B = 32, in turns.
    tuned = C.Config(model=C.ModelConfig(
        transformer=C.TransformerConfig(attention_impl="flash")),
        train=C.TrainConfig(amp_dtype="bfloat16"))
    batch = stage_batch(synthetic_train_batch(32, s, t, seed=5), device)
    e_state = create_train_state(tuned, None, device)
    g_state = create_train_state(tuned, None, device)
    g_step = make_train_step(g_state, tuned)
    runs = {"eager": lambda: train_step(e_state, batch, tuned),
            "graphed": lambda: g_step(batch)}
    first = synced_ms(runs["graphed"])
    for _ in range(3):
        for fn in runs.values():
            fn()
    ms = {k: [] for k in runs}
    for _ in range(GRAPH_TUNED_STEPS):
        for k, fn in runs.items():
            ms[k].append(synced_ms(fn))
    reset_flash_counts()
    reset_bf16_counts()
    runs["graphed"]()
    tuned_counts = bf16_counts() + flash_counts()
    print("  " + f"amp bf16 'flash' step, B = 32, bucket ({s}, {t}), "
          f"{GRAPH_TUNED_STEPS} steps after 3, in turns: " + "; ".join(
              f"{k} median {float(np.median(v)):.3f} ms "
              f"({min(v):.3f}-{max(v):.3f})" for k, v in ms.items())
          + f"; the first graphed call {first:.1f} ms [{card}]", flush=True)
    smoke.check(tuned_counts == (n_blocks,) * 3 + (0, 0, 0),
                f"a graphed amp bf16 step's launches (bf16 forward, dQ, "
                f"dK/dV; float32 forward, dQ, dK/dV): {tuned_counts} "
                f"(expected {(n_blocks,) * 3 + (0, 0, 0)})")
    check_graph_launches(smoke, "amp bf16 step B = 32", g_state.graphs, tmp)


def phase_compiled_steps(smoke: Smoke, device):
    """Phase 14: synthesis and training from CUDA graphs against eager."""
    with tempfile.TemporaryDirectory() as tmp_dir, dumpable_graphs():
        tmp = Path(tmp_dir)
        phase_graphs_synthesis(smoke, device, tmp)
        phase_graphs_training(smoke, device, tmp)
    return True


# ---------------------------------------------------------------------------
# Phase 14c: the vocoder trainer's compiled steps, evaluation, samples and
# the GTA forward replayed from CUDA graphs against eager.

GAN_WARM, GAN_TIMED = 3, 10        # untimed, then timed steps
GAN_CHUNK = 4                      # steps a replay of the multi step
GAN_SHORT = 8                      # steps of the eager-again and mutant runs
GAN_LOOP_STEPS, GAN_LOOP_RESUME, GAN_LOOP_BATCH = 8, 12, 4
# Graphed against eager from one state and the same batches (PERF.md
# section 6, set from eager against itself before the run that holds
# them: float32 3.95e-3 and 3.60e-3, bf16 0 and 0): each step's
# losses within GAN_LOSS_RTOL relative, the parameters' change
# ||dp - dp_eager|| / ||dp_eager|| within GAN_DELTA_RTOL; the mutant
# more than 10x past it (it read 0.213-0.253). The inference forwards
# bit-equal.
GAN_LOSS_RTOL = GAN_DELTA_RTOL = 1e-2


class EagerGraphs:
    """``graphs.Graphs`` whose ``jit`` returns the function itself: a
    compiled path's eager body, for comparison."""

    def __init__(self, *args, **kwargs):
        pass

    def jit(self, fn, *args, **kwargs):
        return fn


def gan_params(state):
    import torch

    return torch.cat([p.detach().reshape(-1).double()
                      for m in (state.gen, state.mpd, state.msd)
                      for p in m.parameters()])


def gan_batches(cfg, device, n: int, seed: int):
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    rng = np.random.default_rng(seed)
    wavs = [harmonic_signal(rng.uniform(1.5, 4.0), rng)
            for _ in range(N_VOC_WAVS)]
    sampler = tv.SegmentSampler(cfg, wavs, seed=seed)
    return [torch.from_numpy(sampler.sample(cfg.vocoder_train.batch_size))
            .to(device) for _ in range(n)]


def gan_run(cfg, device, batches, kind: str, profile: bool = False):
    """``len(batches)`` GAN steps from ``init_vocoder_train_state``: eager
    (the ``mark`` path, no events), graphed one a replay, graphed
    ``GAN_CHUNK`` a replay, or the mutant (graphed, its capture saving and
    restoring the modules alone, so that the warm-up's moments and counts
    stay, as a lazily made optimizer state would). Returns each call's ms
    and report (a chunk's mean), the parameters' change after each whole
    chunk and at the end, peak memory and, with ``profile``, the busy
    share over 2 more steps."""
    import gc

    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.graphs import (
        Graphs,
        module_tensors,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    t_run = time.perf_counter()
    state = tv.init_vocoder_train_state(cfg, device)
    p0 = gan_params(state)
    ends = {*range(GAN_CHUNK, len(batches) + 1, GAN_CHUNK), len(batches)}
    if kind == "mutant":
        state.graphs = Graphs(state=lambda: module_tensors(
            state.gen, state.mpd, state.msd))
    if kind == "eager":
        step = tv.make_vocoder_train_step(cfg, device,
                                          mark=lambda _name: None)
    elif kind == "chunk":
        multi = tv.make_vocoder_multi_step(state, cfg, device, GAN_CHUNK)
        batches = [torch.stack(batches[i:i + GAN_CHUNK])
                   for i in range(0, len(batches) - GAN_CHUNK + 1,
                                  GAN_CHUNK)]
        step = lambda _state, b: multi(b)  # noqa: E731
    else:
        step = tv.make_vocoder_train_step(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, reports, deltas = [], [], {}
    for b in batches:
        holder = {}
        ms.append(synced_ms(lambda: holder.update(r=step(state, b))))
        reports.append(holder["r"].as_dict())
        if state.step in ends:
            deltas[state.step] = gan_params(state) - p0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    reserved = torch.cuda.memory_reserved() / 2**20
    busy = (profile_gan_steps(step, state, batches[-2:],
                              f"{cfg.vocoder_train.amp_dtype}, {kind}",
                              cpu=False)
            if profile else None)
    out = {"ms": ms, "reports": reports, "deltas": deltas, "peak": peak,
           "reserved": reserved, "busy": busy, "step": state.step,
           "counts": (int(state.opt_g.count), int(state.opt_d.count)),
           "graphs": state.graphs.count() if state.graphs else 0,
           "seconds": time.perf_counter() - t_run}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_graphs_gan(smoke: Smoke, device, tmp: Path) -> None:
    """14c, the GAN step at phase 8b's batch (16 × 8192, Config() width),
    float32 (TF32 off) and bf16 amp: eager, graphed one a replay, graphed
    four a replay and, in float32, eager again over the first 8 batches
    (the yardstick: cuDNN's float32 backward sums with atomics; bf16's
    read 0) and the mutant; times, busy shares, peak memory; losses and
    the parameters' change against eager."""
    import numpy as np

    card = nvidia_smi_line()
    n = GAN_WARM + GAN_TIMED
    for amp in ("float32", "bfloat16"):
        cfg = vocoder_config(VOC_TIMED_BATCH, amp)
        batches = gan_batches(cfg, device, n, seed=4)
        kinds = ["eager", "graphed", "chunk"]
        if amp == "float32":
            kinds += ["eager again", "mutant"]
        runs = {k: gan_run(cfg, device,
                           batches[:GAN_SHORT] if k in (
                               "eager again", "mutant") else batches,
                           "eager" if k == "eager again" else k,
                           profile=k in ("eager", "graphed"))
                for k in kinds}
        eager = runs["eager"]

        def loss_rel(run):
            if run is runs["chunk"]:
                want = [{k: float(np.mean([r[k] for r in eager["reports"][
                    i:i + GAN_CHUNK]])) for k in run["reports"][0]}
                    for i in range(0, n - GAN_CHUNK + 1, GAN_CHUNK)]
            else:
                want = eager["reports"][:len(run["reports"])]
            return max(abs(a[k] - b[k]) / abs(b[k])
                       for a, b in zip(run["reports"], want) for k in a)

        def dp_rel(run):
            # At the run's last step (a chunk run stops at a multiple of
            # GAN_CHUNK, the short runs at GAN_SHORT); eager's there too.
            at = max(run["deltas"])
            d = eager["deltas"][at]
            return float((run["deltas"][at] - d).norm() / d.norm())

        rel = {k: (loss_rel(r), dp_rel(r)) for k, r in runs.items()
               if k != "eager"}
        d_eager = eager["deltas"][n]
        short = f" over the first {GAN_SHORT} for eager again and the mutant"
        lines = "; ".join(f"{k}: losses rel {a:.2e}, dp rel {b:.3e}"
                          for k, (a, b) in rel.items())
        lines += "; each run's seconds " + ", ".join(
            f"{k} {r['seconds']:.1f}" for k, r in runs.items())
        print(f"  GAN step {amp}, {n} steps from one state"
              f"{short if amp == 'float32' else ''}, against eager "
              f"(||dp_eager|| {float(d_eager.norm()):.4e}): {lines}",
              flush=True)
        held = [k for k in rel if k in ("graphed", "chunk")]
        smoke.check(
            all(rel[k][0] <= GAN_LOSS_RTOL and rel[k][1] <= GAN_DELTA_RTOL
                for k in held)
            and all(runs[k]["counts"] == (runs[k]["step"],) * 2
                    for k in ("graphed", "chunk")),
            f"{amp}: graphed against eager within losses "
            f"{GAN_LOSS_RTOL:.0e} and dp {GAN_DELTA_RTOL:.0e}; AdamW "
            f"counts (generator, discriminators) on the device, after "
            f"the profiled steps: "
            f"{[runs[k]['counts'] for k in ('graphed', 'chunk')]}")
        if "mutant" in rel:
            smoke.check(rel["mutant"][1] > 10 * GAN_DELTA_RTOL,
                        f"{amp}: the mutant (warm-up moments and counts "
                        f"left in the captured state) dp rel "
                        f"{rel['mutant'][1]:.3e}, losses rel "
                        f"{rel['mutant'][0]:.2e}: outside the bound "
                        f"{GAN_DELTA_RTOL:.0e} by more than 10x")
        for k in ("eager", "graphed", "chunk"):
            r = runs[k]
            timed = r["ms"][1:] if k == "chunk" else r["ms"][GAN_WARM:]
            per = GAN_CHUNK if k == "chunk" else 1
            timed = [t / per for t in timed]
            print(f"  GAN step {amp}, batch {VOC_TIMED_BATCH} x "
                  f"{cfg.vocoder_train.segment_size}, {k}"
                  + (f" ({GAN_CHUNK} a replay, per step)" if per > 1 else "")
                  + f": median {float(np.median(timed)):.3f} ms (min "
                  f"{min(timed):.3f}, max {max(timed):.3f}, "
                  f"{len(timed)} calls after the first"
                  + ("" if per > 1 else f" {GAN_WARM}") + "); first call "
                  f"{r['ms'][0]:.1f} ms"
                  + (f"; busy share over 2 steps {r['busy']:.3f}"
                     if r["busy"] is not None else "")
                  + f"; max_memory_allocated {r['peak']:.1f} MiB above "
                  f"what was allocated before, reserved {r['reserved']:.1f}"
                  f" MiB; graphs {r['graphs']} [{card}]", flush=True)


def phase_graphs_gan_loop(smoke: Smoke, device, tmp: Path) -> None:
    """14c, ``train_vocoder`` at Config() width, batch 4, steps_per_call
    4: each chunk one replay of the multi step's graph, the val batches
    one graph, the JAX loop's log, val and save steps; then resumed from
    its checkpoint to step 12, the counts on the device."""
    import dataclasses

    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch import graphs
    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv

    card = nvidia_smi_line()
    rng = np.random.default_rng(6)
    wavs = [harmonic_signal(rng.uniform(1.5, 4.0), rng)
            for _ in range(N_VOC_WAVS)]
    cfg = C.Config(vocoder_train=dataclasses.replace(
        C.VocoderTrainConfig(), batch_size=GAN_LOOP_BATCH,
        steps_per_call=GAN_CHUNK, log_step=4, val_step=8, save_step=4))
    out = tmp / "voc_loop"
    calls = {"captures": 0, "replays": 0, "chunks": 0}
    capture, replay = graphs.Compiled._capture, graphs.Compiled._replay
    maker = tv.make_vocoder_multi_step

    def counted_capture(self, *args):
        calls["captures"] += 1
        return capture(self, *args)

    def counted_replay(g, tensors):
        calls["replays"] += 1
        return replay(g, tensors)

    def counted_maker(*args):
        multi = maker(*args)

        def call(batches):
            calls["chunks"] += 1
            return multi(batches)

        return call

    graphs.Compiled._capture = counted_capture
    graphs.Compiled._replay = staticmethod(counted_replay)
    tv.make_vocoder_multi_step = counted_maker
    runs = {}
    try:
        for total in (GAN_LOOP_STEPS, GAN_LOOP_RESUME):
            before = dict(calls)
            t0 = time.perf_counter()
            state = tv.train_vocoder(cfg, wavs, str(out), total_steps=total,
                                     device=device, log=lambda *_: None)
            runs[total] = (state.step, int(state.opt_g.count),
                           int(state.opt_d.count), state.opt_g.count.device,
                           {k: calls[k] - before[k] for k in calls},
                           time.perf_counter() - t0)
            del state
    finally:
        graphs.Compiled._capture = capture
        graphs.Compiled._replay = staticmethod(replay)
        tv.make_vocoder_multi_step = maker
    records = _metrics(out / "metrics.jsonl")
    got = {"log": [r["step"] for r in records if "mel_l1" in r],
           "val": [r["step"] for r in records if "val_mel_l1" in r],
           "save": sorted(int(p.name[:-3]) for p in (out / "ckpt").glob(
               "*.pt"))}
    want = {"log": [4, 8, 12], "val": [8], "save": [4, 8, 12]}
    first, resumed = runs[GAN_LOOP_STEPS], runs[GAN_LOOP_RESUME]
    # One replay a chunk, plus the four val batches' replays at step 8:
    # one capture of the chunk and one of the val step, then the resumed
    # run's chunk.
    smoke.check(
        first[:3] == (GAN_LOOP_STEPS,) * 3 and resumed[:3] == (
            GAN_LOOP_RESUME,) * 3 and first[3].type == "cuda"
        and first[4] == {"captures": 2, "replays": 2 + 4, "chunks": 2}
        and resumed[4] == {"captures": 1, "replays": 1, "chunks": 1}
        and got == want
        and all(math.isfinite(r["mel_l1"]) for r in records
                if "mel_l1" in r),
        f"train_vocoder, steps_per_call {GAN_CHUNK}, batch "
        f"{cfg.vocoder_train.batch_size}: (step, AdamW counts, count device,"
        f" calls) {first[:5]} in {first[5]:.2f} s; resumed {resumed[:5]} "
        f"in {resumed[5]:.2f} s; logged, validated, saved at {got} (the "
        f"JAX loop's {want}) [{card}]")


def phase_graphs_inference(smoke: Smoke, device, tmp: Path) -> dict:
    """14c, the inference forwards at Config() width, graphed against
    eager: ``evaluate`` over phase 5's val set under "flash" and the
    sample synthesis step (10 float32 flash forwards a batch), the
    vocoder's val step, ``SampleVocoder`` (a float32 generator.npz, 72
    float32 MRF launches a call) and ``export_gta_mels``. Returns the
    graphed paths' flash and MRF launches."""
    import dataclasses

    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import BucketConfig
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import (
        save_generator_npz,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        eval_step,
        synth_step,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import vocoder as tv
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        evaluate,
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.sampling import (
        SampleVocoder,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
        CheckpointManager,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_eval_step,
        make_synth_step,
    )

    card = nvidia_smi_line()
    corpus_dir = write_training_corpus(str(tmp / "corpus"), 0)
    cfg = training_config(corpus_dir, str(tmp / "fs2"), "flash")
    t = cfg.model.transformer
    n_blocks = t.encoder_layer + t.decoder_layer
    corpus = PreprocessedCorpus(corpus_dir)
    state = create_train_state(cfg, corpus.stats, device)
    val_ds = BucketedDataset(corpus, "val.txt", cfg.train.optimizer.batch_size,
                             cfg.train.buckets, cfg.model.max_seq_len,
                             symbol_table=cfg.preprocess.symbol_table)
    n_batches = sum(1 for _ in val_ds.epoch(0, shuffle=False))
    launches = {"flash_mha": 0, "mrf_resblock_f32": 0}
    rows = []

    def flash_of(fn):
        reset_flash_counts()
        out = fn()
        return out, flash_counts()[0]

    eval_step_fn = make_eval_step(state, cfg)
    ms = {"eager": [], "graphed": []}
    eager, graphed = [], []
    for _ in range(GRAPH_WARM + 1):  # graphed: the capturing call first
        holder = {}
        ms["eager"].append(synced_ms(lambda: holder.update(r=flash_of(
            lambda: evaluate(lambda b: eval_step(state.model, b, cfg),
                             val_ds, device)))))
        eager.append(holder["r"])
        ms["graphed"].append(synced_ms(lambda: holder.update(r=flash_of(
            lambda: evaluate(eval_step_fn, val_ds, device)))))
        graphed.append(holder["r"])
        launches["flash_mha"] += graphed[-1][1]
    diff = max(abs(o[k] - eager[0][0][k]) for o, _ in eager + graphed
               for k in o)
    rows.append(("evaluate", diff, eager[0][1], [f for _, f in graphed],
                 n_blocks * n_batches))
    print(f"  evaluate over {n_batches} val batch(es), Config() width, "
          f"'flash': eager {ms['eager']} ms, graphed {ms['graphed']} ms "
          f"(the first graphed call captures) [{card}]", flush=True)

    batch = next(val_ds.epoch(0, shuffle=False))
    staged = stage_batch(batch, device)
    t_mel = batch["mels"].shape[1]
    synth_fn = make_synth_step(state)
    (e_mel, e_len, _), f_eager = flash_of(
        lambda: synth_step(state.model, staged, t_mel))
    graphed = []
    for _ in range(2):
        (g_mel, g_len, _), f = flash_of(lambda: synth_fn(staged, t_mel))
        graphed.append(f)
        launches["flash_mha"] += f
    diff = (float((g_mel - e_mel).abs().max())
            if torch.equal(g_len, e_len) else math.inf)
    rows.append(("sample synthesis", diff, f_eager, graphed, n_blocks))
    check_graph_launches(smoke, "train state's eval and synth graphs",
                         state.graphs, tmp)

    # The GTA export, from a checkpoint of this state.
    CheckpointManager(str(tmp / "fs2" / "ckpt")).save(0, state)
    del state
    gta = {}
    for kind in ("eager", "graphed"):
        saved = tv.Graphs
        if kind == "eager":
            tv.Graphs = EagerGraphs
        try:
            reset_flash_counts()
            t0 = time.perf_counter()
            count = tv.export_gta_mels(cfg, str(tmp / "fs2" / "ckpt"),
                                       str(tmp / f"gta_{kind}"),
                                       filenames=("val.txt",), device=device,
                                       log=lambda *_: None)
            torch.cuda.synchronize()
            gta[kind] = (count, flash_counts()[0],
                         time.perf_counter() - t0)
        finally:
            tv.Graphs = saved
    launches["flash_mha"] += gta["graphed"][1]
    diff = 0.0
    for name in sorted(os.listdir(tmp / "gta_eager")):
        a = np.load(tmp / "gta_eager" / name)
        b = np.load(tmp / "gta_graphed" / name)
        diff = max(diff, float(np.abs(a - b).max())
                   if a.shape == b.shape else math.inf)
    gta_batches = sum(1 for _ in BucketedDataset(
        corpus, "val.txt", tv.GTA_BATCH, BucketConfig(),
        cfg.model.max_seq_len,
        symbol_table=cfg.preprocess.symbol_table).epoch(0, shuffle=False))
    rows.append(("GTA export", diff, gta["eager"][1], [gta["graphed"][1]],
                 n_blocks * gta_batches))
    print(f"  GTA export of {gta['graphed'][0]} val mels: eager "
          f"{gta['eager'][2]:.2f} s, graphed {gta['graphed'][2]:.2f} s "
          f"(captures included) [{card}]", flush=True)

    # The vocoder's val step on a fresh GAN state, four batches.
    vcfg = vocoder_config(VOC_TIMED_BATCH)
    vstate = tv.init_vocoder_train_state(vcfg, device)
    vbatches = gan_batches(vcfg, device, 4, seed=9)
    plain = tv.make_vocoder_val_step(vcfg, device)
    compiled = tv.make_vocoder_val_step(vcfg, device, vstate)
    e_val = [plain(vstate.gen, b) for b in vbatches]
    g_val = [compiled(vstate.gen, b) for b in vbatches]
    diff = max(float((a - b).abs()) for a, b in zip(e_val, g_val))
    rows.append(("vocoder val step", diff, 0, [vstate.graphs.count()], 1))
    del vstate

    # SampleVocoder on a float32 generator.npz.
    npz = str(tmp / "generator.npz")
    save_generator_npz(npz, seeded_states(cfg)[1])
    scfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocoder=dataclasses.replace(cfg.model.vocoder,
                                               ckpt_path=npz)))
    sampler = SampleVocoder(scfg, device)
    mel = np.random.default_rng(2).normal(-4, 2, (t_mel, 80)).astype(
        np.float32)
    compiled = sampler._generator
    reset_mrf_counts()
    sampler._generator = sampler.generator
    e_wav = sampler.vocode(mel, t_mel - 13)
    e_mrf = mrf_counts()[1]
    sampler._generator = compiled
    g_wav, g_mrf = [], []
    for _ in range(2):
        reset_mrf_counts()
        g_wav.append(sampler.vocode(mel, t_mel - 13))
        g_mrf.append(mrf_counts()[1])
        launches["mrf_resblock_f32"] += g_mrf[-1]
    diff = max(float(np.abs(w - e_wav).max()) for w in g_wav)
    per_call = 2 * len(DILATIONS) * len(sampler.generator.resblocks)
    rows.append(("SampleVocoder", diff, e_mrf, g_mrf, per_call))
    check_graph_launches(smoke, "SampleVocoder's graphs",
                         compiled.owner, tmp)

    smoke.check(
        all(d == 0.0 and e == want and all(f == want for f in g)
            for name, d, e, g, want in rows if name != "vocoder val step")
        and rows[3][1] == 0.0 and rows[3][3] == [1],
        "inference forwards graphed against eager (max|diff|, launches "
        "eager, graphed calls, expected; flash forwards, or float32 MRF "
        "for SampleVocoder, or graphs held for the val step): " + "; ".join(
            f"{name} {d:.3e}, {e}, {g}, {want}"
            for name, d, e, g, want in rows) + f" [{card}]")
    return launches


def phase_compiled_gan(smoke: Smoke, device):
    """Phase 14c: the vocoder trainer's steps, evaluation, samples and the
    GTA forward from CUDA graphs against eager."""
    with tempfile.TemporaryDirectory() as tmp_dir, dumpable_graphs():
        tmp = Path(tmp_dir)
        seconds = []
        for part in (phase_graphs_gan, phase_graphs_gan_loop,
                     phase_graphs_inference):
            t0 = time.perf_counter()
            out = part(smoke, device, tmp)
            seconds.append(f"{part.__name__} {time.perf_counter() - t0:.1f}")
        print(f"  14c's parts, seconds: {', '.join(seconds)}", flush=True)
        return out


# Phase 15: the example drivers of examples_torch/.
CONV_STEPS = 300                 # convergence_demo's default
CONV_BUCKET = (16, 128)          # the convergence scripts' one (S, T) bucket
CONV_KERNEL_BATCH = 16           # convergence_deep's batch
CONV_DROP = 0.6                  # last logged mel, duration loss ≤ 0.6 × first
CONV_IMPL_RTOL = 0.15            # "flash" against "auto": last total loss
TRAIN_DEMO_STEPS = 30
# The verify skill's probe (every hanzi has a reading in the builtin
# table) and two hanzi without one: a warning each, the prefix synthesized.
DEMO_PROBES = (("今天魑魅魍魉", 0), ("今天龘靐", 2))
# Phase 15d: the deep run, 5,000 steps under "auto" and under "flash".
# Bounds stated before its first run: 1.2 × the JAX run's final total and
# mel (1.404, 0.608), and a quarter of its conditioning distances.
DEEP_STEPS = 5000
DEEP_FINAL = {"total_loss": 1.68, "mel_loss": 0.73, "duration_loss": 0.10}
DEEP_IMPL_RTOL = 0.10
DEEP_MIN_L1 = {"speaker_mel_l1": 2.0e-3, "emotion_mel_l1": 9.1e-3}


def counted_training(fn, counts=None):
    """``fn()`` (a run of ``train()``) with the flash launches of each
    compiled train, eval and synth step call recorded (``counts()``, the
    float32 kernels at D = 128 by default): returns (its result, {step:
    [(steps, (forward, dQ, dK/dV))]}, the run's totals)."""
    counts = counts or flash_counts
    calls: dict[str, list] = {"train_step": [], "eval_step": [],
                              "synth_step": []}

    def counting(key, steps, step, *args):
        before = counts()
        out = step(*args)
        calls[key].append((steps, tuple(
            a - b for a, b in zip(counts(), before))))
        return out

    reset_flash_counts()
    start = counts()
    with compiled_step_calls(functools.partial(
            counting, "train_step")), inference_step_calls(
            lambda name, step, *a: counting(name, 1, step, *a)):
        out = fn()
    return out, calls, tuple(a - b for a, b in zip(counts(), start))


def check_flash_calls(smoke: Smoke, what: str, impl: str, calls: dict,
                      n_blocks: int, steps: int) -> None:
    """Under "flash" each train step launches each float32 kernel once an
    FFT block and each eval or synth step the forward once a block; under
    "auto" (the math path at these lengths) nothing."""
    per = n_blocks if impl == "flash" else 0
    train_calls = calls["train_step"]
    inference = calls["eval_step"] + calls["synth_step"]
    ok = (sum(n for n, _ in train_calls) == steps
          and all(c == (n * per,) * 3 for n, c in train_calls)
          and all(c == (per, 0, 0) for _, c in inference))
    smoke.check(ok, f"{what} under {impl!r}: {steps} steps in "
                    f"{len(train_calls)} compiled calls, each step "
                    f"(forward, dQ, dK/dV) "
                    f"{sorted({tuple(x // n for x in c) for n, c in train_calls})}"
                    f" (expected {(per,) * 3}); {len(inference)} eval and "
                    f"synth calls, each {sorted({c for _, c in inference})} "
                    f"(expected {(per, 0, 0)})")


def phase_examples(smoke: Smoke, device):
    """Phase 15: the kernels at the convergence scripts' shapes, then
    ``convergence_demo`` under "flash" and "auto", ``train_demo`` and
    ``synthesize_demo``'s probes; returns the launches and the kernels'
    worst differences."""
    import logging
    import shutil

    import numpy as np

    from examples_torch import convergence_demo as demo
    from examples_torch import synthesize_demo, train_demo
    from expressive_fastspeech2_mandarin_tpu_torch.config import BucketConfig
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )

    card = nvidia_smi_line()
    seconds = {}
    launches = {"flash_mha": 0, "flash_mha_bwd_dq": 0,
                "flash_mha_bwd_dkv": 0, "mrf_resblock": 0}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        work = {impl: tmp / impl for impl in ("flash", "auto")}
        t0 = time.perf_counter()
        raw, pre = demo.build_corpus(str(work["auto"]))
        demo.extract_features(demo.build_config(
            raw, pre, str(work["auto"]), CONV_STEPS), device)
        shutil.copytree(pre, work["flash"] / "preprocessed")
        seconds["corpus and features"] = time.perf_counter() - t0

        # (a) The float32 kernels at the encoder's and the decoder's
        # bucket, with the key lengths of the corpus's first train batch
        # of 16.
        t0 = time.perf_counter()
        ds = BucketedDataset(PreprocessedCorpus(pre), "train.txt",
                             CONV_KERNEL_BATCH,
                             BucketConfig(src_buckets=CONV_BUCKET[:1],
                                          mel_buckets=CONV_BUCKET[1:]), 256)
        batch = next(ds.epoch(0))  # the first batch a run trains on
        cases = tuple((CONV_KERNEL_BATCH, t, prefixes(*map(int, lens)))
                      for t, lens in zip(CONV_BUCKET, (batch["src_lens"],
                                                       batch["mel_lens"])))
        print(f"  key lengths: encoder {batch['src_lens'].tolist()}, "
              f"decoder {batch['mel_lens'].tolist()}")
        worst = (phase_flash_vs_plain(smoke, cases),
                 *phase_flash_bwd_vs_plain(smoke, cases))
        seconds["(a) kernels"] = time.perf_counter() - t0

        # (b) convergence_demo, "flash" and "auto" from the same seed and
        # features.
        finals = {}
        for impl, path in work.items():
            argv = ["--steps", CONV_STEPS, "--workdir", path, "--device",
                    device]
            (out, _, seconds[f"(b) {impl}"]), calls, counts = (
                counted_training(lambda: echoed(
                    demo.main, [str(a) for a in argv],
                    attention_impl=impl)))
            cfg = demo.build_config(raw, pre, str(path), CONV_STEPS, impl)
            t = cfg.model.transformer
            check_flash_calls(smoke, "convergence_demo", impl, calls,
                              t.encoder_layer + t.decoder_layer, CONV_STEPS)
            for key, n in zip(("flash_mha", "flash_mha_bwd_dq",
                               "flash_mha_bwd_dkv"), counts):
                launches[key] += n
            recs = out["records"]
            first, last = recs[0], recs[-1]
            finals[impl] = last["total_loss"]
            for key in ("mel_loss", "duration_loss"):
                smoke.check(
                    math.isfinite(last[key])
                    and last[key] <= CONV_DROP * first[key],
                    f"convergence_demo {impl!r}: {key} step "
                    f"{first['step']} {first[key]:.4f} -> step "
                    f"{last['step']} {last[key]:.4f} (bound "
                    f"{CONV_DROP} x first: {CONV_DROP * first[key]:.4f})")
            print(f"  convergence_demo {impl!r}: total "
                  f"{[round(r['total_loss'], 4) for r in recs]}; val "
                  f"{[round(v['total_loss'], 4) for v in out['vals']]}; "
                  f"steps/s at the end {last['steps_per_sec']} [{card}]")
        gap = abs(finals["flash"] - finals["auto"]) / finals["auto"]
        smoke.check(gap <= CONV_IMPL_RTOL,
                    f"convergence_demo last total loss, 'flash' "
                    f"{finals['flash']:.4f} against 'auto' "
                    f"{finals['auto']:.4f}: {gap:.3e} relative (bound "
                    f"{CONV_IMPL_RTOL})")

        # (c) train_demo: the loss drops over 30 steps at Config() width.
        reset_flash_counts()
        reset_mrf_counts()
        out, _, seconds["(c) train_demo"] = echoed(
            train_demo.main, ["--steps", str(TRAIN_DEMO_STEPS), "--device",
                              str(device)])
        smoke.check(
            out["steps"] == TRAIN_DEMO_STEPS
            and math.isfinite(out["final"]["total"])
            and out["final"]["total"] < out["first"]["total"]
            and flash_counts() == (0, 0, 0) and mrf_counts() == (0, 0),
            f"train_demo: total {out['first']['total']:.4f} -> "
            f"{out['final']['total']:.4f} over {out['steps']} steps "
            f"(falling), {out['ms_per_step']:.3f} ms a step at B = 4, "
            f"(64, 250); flash and MRF launches {flash_counts()}, "
            f"{mrf_counts()} (T = 250: the math path) [{card}]")

        # (d) synthesize_demo: the default text, duration control 2.0, the
        # probes; every generator call 72 launches of the bf16 MRF kernel.
        t0 = time.perf_counter()
        hanzi = logging.getLogger(f"{PKG}.text.hanzi")
        warned: list[str] = []

        class Collect(logging.Handler):
            def emit(self, record):
                warned.append(record.getMessage())

        handler = Collect(logging.WARNING)
        hanzi.addHandler(handler)
        runs = {}
        try:
            for key, argv in (("default", []),
                              ("x2", ["--duration-control", "2.0"]),
                              *((text, ["--text", text])
                                for text, _ in DEMO_PROBES)):
                reset_mrf_counts()
                del warned[:]
                out, _, _ = echoed(synthesize_demo.main, argv + [
                    "--out", str(tmp / "demo.wav"), "--device",
                    str(device)])
                runs[key] = (out, list(warned), mrf_counts())
        finally:
            hanzi.removeHandler(handler)
        seconds["(d) synthesize_demo"] = time.perf_counter() - t0
        per_call = 2 * len(DILATIONS) * 12
        for key, (out, msgs, counts) in runs.items():
            launches["mrf_resblock"] += counts[0]
            smoke.check(
                out["mrf_launches"] == [per_call] * 2
                and counts == (2 * per_call, 0)
                and out["mel_len"] > 0 and np.isfinite(out["wav"]).all(),
                f"synthesize_demo {key}: {len(out['ids'])} IDs, mel_len "
                f"{out['mel_len']}, bf16 MRF launches a generator call "
                f"{out['mrf_launches']} (expected {per_call}), float32 "
                f"{counts[1]}; steady {out['steady_ms']:.2f} ms for "
                f"{out['audio_s']:.2f} s of audio (RTF {out['rtf']:.4f}) "
                f"[{card}]")
        base, doubled = runs["default"][0], runs["x2"][0]
        smoke.check(doubled["mel_len"] == 2 * base["mel_len"],
                    f"--duration-control 2.0 doubles mel_len: "
                    f"{base['mel_len']} -> {doubled['mel_len']}")
        for text, missing in DEMO_PROBES:
            out, msgs, _ = runs[text]
            n_known = len(synthesize_demo.phoneme_ids(text[:2]))
            smoke.check(
                len(msgs) == missing
                and all("no pinyin reading" in m for m in msgs)
                and out["ids"][:n_known] == base["ids"][:n_known]
                and len(out["ids"]) >= n_known,
                f"--text {text}: {len(msgs)} warnings (expected "
                f"{missing}: {msgs}), {len(out['ids'])} IDs, the prefix's "
                f"{n_known} synthesized, mel_len {out['mel_len']}")
    print(f"  phase 15's parts, seconds: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return {"launches": launches, "worst": worst}


def phase_deep_convergence(smoke: Smoke, device, tag: str = ""):
    """Phase 15d: ``convergence_deep`` for 5,000 steps under "auto" and
    under "flash" from the same seed and features, against the bounds;
    the reports go to ``output/convergence_torch/<impl><tag>/``."""
    import shutil

    from examples_torch import convergence_deep as deep

    card = nvidia_smi_line()
    out_root = ROOT / "output" / "convergence_torch"
    finals = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        for impl in ("auto", "flash"):
            work = tmp / impl
            if impl == "flash":
                shutil.copytree(tmp / "auto" / "preprocessed",
                                work / "preprocessed")
            argv = ["--steps", DEEP_STEPS, "--workdir", work, "--report-dir",
                    out_root / f"{impl}{tag}", "--device", device]
            (out, _, seconds), calls, counts = counted_training(
                lambda: echoed(deep.main, [str(a) for a in argv],
                               attention_impl=impl))
            t = deep.build_config("", "", "", DEEP_STEPS).model.transformer
            check_flash_calls(smoke, "convergence_deep", impl, calls,
                              t.encoder_layer + t.decoder_layer, DEEP_STEPS)
            recs, checks = out["records"], out["checks"]
            fin = deep.final_losses(recs)
            finals[impl] = fin
            print(f"  convergence_deep {impl!r}: {seconds:.1f} s in all, "
                  f"features {out['features_s']:.1f} s, train() "
                  f"{out['train_s']:.1f} s, {DEEP_STEPS / out['train_s']:.2f}"
                  f" steps/s over train(), {recs[-1]['steps_per_sec']} "
                  f"steps/s over its last 100 steps; flash launches "
                  f"{counts} [{card}]")
            for r in recs[::10] + recs[-1:]:
                print(f"    step {r['step']}: total {r['total_loss']:.4f} "
                      f"mel {r['mel_loss']:.4f} duration "
                      f"{r['duration_loss']:.4f}")
            print(f"  final (the mean of the last 5 records): "
                  f"{', '.join(f'{k} {v:.4f}' for k, v in fin.items())}")
            for key, bound in DEEP_FINAL.items():
                smoke.check(fin[key] <= bound,
                            f"convergence_deep {impl!r}: final {key} (the "
                            f"mean of the last 5 records) {fin[key]:.4f} "
                            f"(bound {bound})")
            for key, bound in DEEP_MIN_L1.items():
                smoke.check(checks[key] >= bound,
                            f"convergence_deep {impl!r}: {key} "
                            f"{checks[key]:.4e} (bound >= {bound:.1e})")
            smoke.check(checks["duration_monotonic"]
                        and checks["sad_frames"] > checks["happy_frames"],
                        f"convergence_deep {impl!r}: duration control lens "
                        f"{checks['duration_control_lens']} (monotonic "
                        f"{checks['duration_monotonic']}), happy "
                        f"{checks['happy_frames']} < sad "
                        f"{checks['sad_frames']} frames; health ok "
                        f"{out['health'].get('ok')} (recorded, not "
                        f"required)")
    gap = (abs(finals["flash"]["total_loss"] - finals["auto"]["total_loss"])
           / finals["auto"]["total_loss"])
    smoke.check(gap <= DEEP_IMPL_RTOL,
                f"convergence_deep final total, 'flash' "
                f"{finals['flash']['total_loss']:.4f} against 'auto' "
                f"{finals['auto']['total_loss']:.4f}: {gap:.3e} relative "
                f"(bound {DEEP_IMPL_RTOL})")
    return finals


def phase_deep_spread(smoke: Smoke, device):
    """Phase 15s: phase 15d again with the mel targets staged in float32
    (``transfer_dtype``; the int16 encoding moves them by up to 2e-4),
    a second trajectory of each path from the same seed: whether the
    paths' final losses differ as the two samples of one path do."""
    import dataclasses

    from examples_torch import convergence_deep as deep

    build = deep.build_config

    def float32_targets(*args, **kwargs):
        cfg = build(*args, **kwargs)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, transfer_dtype="float32"))

    deep.build_config = float32_targets
    try:
        return phase_deep_convergence(smoke, device, "_float32_targets")
    finally:
        deep.build_config = build


DEEP_TIMED_STEPS = 300            # phase 15t's profiled train() run
DEEP_PROFILED = (200, 250)        # its profiler window, 5 chunks of 10
DEEP_REPLAYS = 10                 # timed chunk replays, after one untimed


def trace_top_kernels(path: str, n: int = 5) -> list[tuple[str, float]]:
    """The ``n`` kernels of most device time in a torch.profiler Chrome
    trace: (name, ms)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    total: dict[str, float] = {}
    for e in events:
        total[e["name"]] = total.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def phase_deep_times(smoke: Smoke, device):
    """Phase 15t: where the deep run's time goes, at its bucket (16, 128)
    and batch 16: ``train()`` for 300 steps with a profiler window over
    steps 200-250 (its busy share and kernels), a chunk of ten steps
    replayed alone on the same batches under "auto" and "flash", and the
    loop's host work for a chunk (collation, staging, stacking)."""
    import dataclasses
    import glob
    import itertools

    import torch

    from examples_torch import convergence_deep as deep
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        train,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_train_multi_step,
        stack_batches,
    )

    card = nvidia_smi_line()
    out = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        work = Path(tmp_dir)
        raw, pre = deep.build_corpus(str(work))
        cfg = deep.build_config(raw, pre, str(work), DEEP_TIMED_STEPS)
        deep.extract_features(cfg, device)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, profile_start_step=DEEP_PROFILED[0],
            profile_stop_step=DEEP_PROFILED[1]))
        _, _, seconds = echoed(train, cfg, total_steps=DEEP_TIMED_STEPS,
                               device=device)
        traces = glob.glob(str(work / "log" / "profile" / "*.json"))
        busy, window_ms, n_kernels = trace_busy_share(traces[0])
        steps = DEEP_PROFILED[1] - DEEP_PROFILED[0]
        out["train"] = {"s": seconds, "busy": busy,
                        "window_ms_a_step": window_ms / steps,
                        "kernel_ms_a_step": busy * window_ms / steps}
        print(f"  train(): {DEEP_TIMED_STEPS} steps in {seconds:.2f} s "
              f"({DEEP_TIMED_STEPS / seconds:.2f} steps/s with the "
              f"captures, evaluation, samples); profiled steps "
              f"{DEEP_PROFILED[0]}-{DEEP_PROFILED[1]}: "
              f"{window_ms / steps:.3f} ms a step, device busy "
              f"{busy:.3f}, {busy * window_ms / steps:.3f} ms of device "
              f"work a step, {n_kernels / steps:.0f} kernels a step "
              f"[{card}]")
        for name, ms in trace_top_kernels(traces[0]):
            print(f"    {ms / steps:9.3f} ms a step  {name[:110]}")
        smoke.check(len(traces) == 1 and 0 < busy <= 1,
                    f"one profiler trace of train(): {traces}")

        ds = BucketedDataset(PreprocessedCorpus(pre), "train.txt",
                             cfg.train.optimizer.batch_size,
                             cfg.train.buckets, cfg.model.max_seq_len,
                             drop_last=True, seed=cfg.train.seed)
        spc = cfg.train.steps_per_call
        t0 = time.perf_counter()
        batches = list(itertools.islice(itertools.chain.from_iterable(
            ds.epoch(e) for e in itertools.count(1)), spc))
        collate_ms = (time.perf_counter() - t0) * 1e3 / spc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = [stage_batch(b, device, cfg.train.transfer_dtype)
                  for b in batches]
        torch.cuda.synchronize()
        stage_ms = (time.perf_counter() - t0) * 1e3 / spc
        t0 = time.perf_counter()
        stacked = stack_batches(staged)
        torch.cuda.synchronize()
        stack_ms = (time.perf_counter() - t0) * 1e3
        out["host"] = {"collate_ms": collate_ms, "stage_ms": stage_ms,
                       "stack_ms_a_chunk": stack_ms}
        print(f"  host, a batch of {cfg.train.optimizer.batch_size}: "
              f"collation {collate_ms:.3f} ms, staging (int16 mels, "
              f"pinned, synchronized) {stage_ms:.3f} ms; stacking a chunk "
              f"of {spc} {stack_ms:.3f} ms [{card}]")
        for impl in ("auto", "flash"):
            c = deep.build_config(raw, pre, str(work), DEEP_TIMED_STEPS,
                                  impl)
            state = create_train_state(c, PreprocessedCorpus(pre).stats,
                                       device)
            multi = make_train_multi_step(state, c, spc)
            report = multi(stacked)  # captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DEEP_REPLAYS):
                report = multi(stacked)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (DEEP_REPLAYS * spc)
            out[impl] = ms
            smoke.check(math.isfinite(float(report.total)),
                        f"a chunk of {spc} steps replayed alone under "
                        f"{impl!r}: {ms:.3f} ms a step ({DEEP_REPLAYS} "
                        f"replays, the same stacked batches) [{card}]")
            del state, multi
    return out


# ---------------------------------------------------------------------------
# Phase 16: flash attention at head dims other than 128. "h1d256" is
# Config() with one encoder and one decoder head, so D = 256 in every FFT
# block at the parameters' shapes of Config(); its attention runs on the
# float32 kernels at D = 256 (the forward csrc/flash_mha_d256.cu and the
# backward csrc/flash_mha_bwd_d256.cu, on 3xTF32 wgmma in clusters of two
# blocks). A head dim under 128 runs on the D = 128 kernels of its dtype,
# zero-padded.

D256 = 256
D64_CASE = (4, 1000, FLASH_HOLES)      # (B, T, rows) at H = 2, D = 64
D64_TIMED = (4, 4096, prefixes(4096, 1, 0, 3001))
# The D = 256 forward's timed cases: the train step's bucket with phase
# 6's key lengths, then the long-form shapes of FLASH_CASES.
D256_FWD_TIMED = ((4, 1000, prefixes(1000, 750, 500, 250)),) + tuple(
    c for c in FLASH_CASES if c[1] in FLASH_TIMED and c[0] == 4)


def d256_counts() -> tuple[int, int, int]:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    return (fa.d256_launch_count, fa.d256_bwd_dq_launch_count,
            fa.d256_bwd_dkv_launch_count)


def bf16_d256_counts() -> tuple[int, int, int]:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    return (fa.bf16_d256_launch_count, fa.bf16_d256_bwd_dq_launch_count,
            fa.bf16_d256_bwd_dkv_launch_count)


def flash_all_counts() -> tuple[int, ...]:
    """Every flash counter: float32 D = 128, bf16 D = 128, float32 D = 256,
    bf16 D = 256 (forward, dQ, dK/dV each)."""
    return flash_counts() + bf16_counts() + d256_counts() + bf16_d256_counts()


def h1d256(cfg):
    """``cfg`` with one encoder and one decoder head (D = 256)."""
    import dataclasses

    t = dataclasses.replace(cfg.model.transformer, encoder_head=1,
                            decoder_head=1)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transformer=t))


def with_impl(cfg, impl: str):
    import dataclasses

    t = dataclasses.replace(cfg.model.transformer, attention_impl=impl)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, transformer=t))


def phase_d256_d64_vs_plain(smoke: Smoke):
    """16a: the float32 kernels at D = 256 against their plain versions at
    phase 2b's and 2d's cases with H = 1 (and their bounds, also against
    float64); the six D = 128 kernels at D = 64 through the padding, at one
    shape. Returns the worst max|diff| of the forward, dq, and dk/dv at
    D = 256."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    before = flash_all_counts()
    worst_fwd = phase_flash_vs_plain(smoke, FLASH_CASES, h=1, d=D256)
    worst_dq, worst_dkv = phase_flash_bwd_vs_plain(smoke, FLASH_BWD_CASES,
                                                   h=1, d=D256)
    counts = tuple(a - b for a, b in zip(flash_all_counts(), before))
    n_fwd, n_bwd = len(FLASH_CASES), len(FLASH_BWD_CASES)
    want = (0,) * 6 + (n_fwd + n_bwd, 2 * n_bwd, 2 * n_bwd) + (0,) * 3
    smoke.check(counts == want,
                f"D = 256: flash launches (float32 D = 128, bf16, float32 and "
                f"bf16 D = 256; forward, dQ, dK/dV) {counts}, expected {want}")

    # D = 64, both dtypes: the D = 128 kernels on zero-padded inputs.
    b, t, rows = D64_CASE
    gen = torch.Generator().manual_seed(64)
    scale = 64 ** -0.5
    for dtype, first in ((torch.float32, 0), (torch.bfloat16, 3)):
        q, k, v, mask = flash_inputs(b, t, rows, gen, 2, 64)
        q, k, v = (x.to(dtype) for x in (q, k, v))
        dout = torch.randn(q.shape, generator=gen).to("cuda", dtype)
        before = flash_all_counts()
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        grads = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
        counts = tuple(a - b for a, b in zip(flash_all_counts(), before))
        want = tuple(int(first <= i < first + 3) for i in range(12))
        if dtype == torch.float32:
            ref = fa.flash_mha_plain(q, k, v, mask, scale)
            bounds = (FLASH_REL_BOUND, FLASH_BWD_REL_BOUND)
        else:  # the bf16 kernel's 64-key tiles (phase 2e)
            ref = fa.flash_mha_blocked_plain(q, k, v, mask, scale, 64)
            bounds = (FLASH_BF16_OUT_REL, FLASH_BF16_GRAD_REL)
        refs = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
        rel = [((g.float() - r.float()).abs().max()
                / r.float().abs().max()).item()
               for g, r in zip((out, *grads), (ref, *refs))]
        lse_ref = fa.flash_mha_lse_plain(q, k, mask, scale)
        finite = torch.isfinite(lse_ref)
        lse_rel = ((lse - lse_ref)[finite].abs().max()
                   / lse_ref[finite].abs().max()).item()
        shapes = all(x.shape == q.shape and x.dtype == dtype
                     for x in (out, *grads))
        smoke.check(
            shapes and counts == want and rel[0] <= bounds[0]
            and max(rel[1:]) <= bounds[1] and lse_rel <= LSE_REL_BOUND
            and torch.equal(torch.isposinf(lse), ~finite),
            f"D = 64 {dtype} at ({b}, 2, {t}, 64), valid keys {rows}, "
            f"through the D = 128 kernels: out {rel[0]:.3e} of max|ref| "
            f"(bound {bounds[0]:.1e}), dq, dk, dv "
            f"{[f'{x:.3e}' for x in rel[1:]]} (bound {bounds[1]:.1e}), lse "
            f"{lse_rel:.3e}; launches "
            f"{counts} (expected {want})")
        del q, k, v, mask, dout, out, lse, grads, ref, refs
    phase_d256_fwd_exact(smoke)
    phase_d256_bwd_exact(smoke)
    return worst_fwd, worst_dq, worst_dkv


def phase_d256_fwd_exact(smoke: Smoke) -> None:
    """16a: the float32 forward at D = 256 where its result is exact. (1)
    The layout witness at T = 300, H = 1, sm_scale 1: each query scores
    1024 against two valid keys whose hot columns lie anywhere in the 256
    (so in either block of a cluster, or both), P is 1 at those two and 0
    elsewhere, v in {-1, 0, 1}: out must equal float64's bit for bit,
    which a block that mislaid its chunk of Q, K or V, or its partial of
    S, would not. (2) Small-integer v (its TF32 lo part 0) and one valid
    key a batch row, at the start, inside and at the end of T = 300: P is
    1 exactly, so every query's out must be that key's v bit for bit in
    all 256 columns. (3) A rerun at (4, 1, 4096, 256) equal bit for bit.
    Each call launches the forward once and no other flash kernel."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    q, k, v, _, mask = layout_witness(300, (300, 150), d=D256)
    q, k, v = (x[:, :1].contiguous() for x in (q, k, v))
    want = fa.flash_mha_plain(q, k, v, mask, 1.0)
    before = flash_all_counts()
    got = fa.flash_mha(*(x.to("cuda", torch.float32) for x in (q, k, v)),
                       mask.to("cuda"), 1.0)
    counts = tuple(a - b for a, b in zip(flash_all_counts(), before))
    exact = torch.equal(got.double().cpu(), want)
    smoke.check(exact and counts == (0,) * 6 + (1, 0, 0) + (0,) * 3
                and float(want.abs().max()) >= 1,
                f"D = 256 forward layout witness (2, 1, 300, 256), two-hot P "
                f"over all 256 columns: out equal to float64 {exact} "
                f"({int((got.double().cpu() != want).sum())} elements "
                f"differ); launches {counts}")

    gen = torch.Generator().manual_seed(23)
    t, keys = 300, (0, 137, 299)
    q, k = (torch.randn(len(keys), 1, t, D256, generator=gen)
            for _ in range(2))
    v = torch.randint(-8, 9, q.shape, generator=gen).float()
    mask = torch.ones(len(keys), t, dtype=torch.bool)
    for i, j in enumerate(keys):
        mask[i, j] = False
    out = fa.flash_mha(q.cuda(), k.cuda(), v.cuda(), mask.cuda(),
                       D256 ** -0.5).cpu()
    exact = [torch.equal(out[i, 0], v[i, 0, j].expand(t, D256))
             for i, j in enumerate(keys)]
    smoke.check(all(exact),
                f"D = 256 forward, small-integer v, one valid key a row (at "
                f"{keys}): every query's out equal to that key's v in all "
                f"256 columns {exact}")

    b, t, rows = FLASH_CASES[5]
    q, k, v, mask = flash_inputs(b, t, rows, gen, 1, D256)
    runs = [fa._flash_mha_cuda(q, k, v, mask, D256 ** -0.5, with_lse=True)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    smoke.check(same, f"D = 256 forward ({b}, 1, {t}, 256), valid keys "
                      f"{rows}: a rerun's out and lse bit-identical {same}")


def bwd_formulas(q, k, v, mask, out, dout, lse, scale):
    """(dq, dk, dv) of the backward's formulas from a given lse (not the
    forward's), in the inputs' dtype: P = exp(s - lse), 0 at padded keys;
    dS = P (dO vᵀ - Δ), Δ = rowsum(dO ∘ out)."""
    import torch

    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(mask[:, None, None, :],
                                                  0.0)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dout, v.transpose(-1, -2)) - delta)
    return (torch.matmul(ds, k) * scale,
            torch.matmul(ds.transpose(-1, -2), q) * scale,
            torch.matmul(p.transpose(-1, -2), dout))


def phase_d256_bwd_exact(smoke: Smoke) -> None:
    """16a: the float32 backward pair at D = 256 where its result is exact.
    (1) The layout witness at T = 300 (not a multiple of the 32-row tile or
    the 64-key block; row 1's 150 valid keys leave the blocks [192, 256)
    and [256, 300) wholly padded), H = 1, sm_scale 1, given lse = 1024 and
    an out in {-1, 0, 1}: P is 1 at each query's two keys and exp(-1024) =
    0 elsewhere, so every product and sum is an integer that TF32's hi part
    and float32 hold exactly, and dq, dk, dv must equal float64's formulas
    bit for bit, which a wrong chunk, cluster half, swizzle or transpose
    would not. (2) A row with one valid key: out is that key's v, dP - Δ is
    0 in exact arithmetic, and the pair (Δ formed as dP is) leaves dq and
    dk of that row exactly 0. Each call launches the D = 256 pair once."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    q, k, v, dout, mask = layout_witness(300, (300, 150), d=D256)
    q, k, v, dout = (x[:, :1].contiguous() for x in (q, k, v, dout))
    gen = torch.Generator().manual_seed(22)
    out = torch.randint(-1, 2, q.shape, generator=gen).double()
    lse = torch.full(q.shape[:-1], 1024.0, dtype=torch.float64)
    want = bwd_formulas(q, k, v, mask, out, dout, lse, 1.0)
    args = [x.to("cuda", torch.float32) for x in (q, k, v)] + [
        mask.to("cuda")] + [x.to("cuda", torch.float32)
                            for x in (out, dout, lse)]
    before = flash_all_counts()
    got = fa._flash_mha_bwd_cuda(*args, 1.0)
    counts = tuple(a - b for a, b in zip(flash_all_counts(), before))
    exact = [torch.equal(g.double().cpu(), w) for g, w in zip(got, want)]
    zero = all(torch.count_nonzero(g[1, :, 150:]).item() == 0
               for g in got[1:])
    smoke.check(all(exact) and zero and counts == (0,) * 7 + (1, 1)
                + (0,) * 3 and float(want[1].abs().max()) > 1,
                f"D = 256 backward layout witness (2, 1, 300, 256), two-hot "
                f"P, lse given: dq, dk, dv equal to float64 {exact}, the "
                f"wholly padded key blocks' dk, dv zero {zero}; launches "
                f"{counts}")

    q, k, v, mask = flash_inputs(2, 300, prefixes(1, 211), gen, 1, D256)
    dout = torch.randn(q.shape, generator=gen).to("cuda")
    scale = D256 ** -0.5
    out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
    dq, dk, _ = fa._flash_mha_bwd_cuda(q, k, v, mask, out, dout, lse, scale)
    nonzero = (torch.count_nonzero(dq[0]).item(),
               torch.count_nonzero(dk[0]).item())
    plain = fa.flash_mha_bwd_plain(q, k, v, mask, out, dout, scale)
    smoke.check(nonzero == (0, 0),
                f"D = 256 backward, a row of one valid key (2, 1, 300, 256): "
                f"non-zero dq, dk {nonzero} (Δ formed as dP is: exactly 0; "
                f"float32 plain's dk there "
                f"{torch.count_nonzero(plain[1][0]).item()} non-zero, max "
                f"{plain[1][0].abs().max().item():.2e})")


def phase_h1d256_synthesis(smoke: Smoke, device) -> int:
    """16b: h1d256 long-form synthesis (``max_mel_len=4096``) under
    "auto": the float32 forward kernel at D = 256 once a decoder layer a
    call (and no other flash kernel), graphed (the Synthesizer's compiled
    forward) against eager, and against the math path ("xla") on the card.
    Returns the forward launches of the graphed and eager calls."""
    import numpy as np

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.synth import Synthesizer

    card = nvidia_smi_line()
    cfg = h1d256(Config())
    fs2, voc = seeded_states(cfg)
    n_dec = cfg.model.transformer.decoder_layer
    args = (LONG_TEXTS, list(range(len(LONG_TEXTS))), EMOTIONS)
    kwargs = dict(duration_control=LONG_DURATION_CONTROL,
                  max_mel_len=LONG_MAX_MEL)
    synth = Synthesizer(cfg, fs2, voc, emotion_maps=EMOTION_MAPS,
                        device=device)
    per_call = 2 * len(DILATIONS) * len(synth.vocoder.resblocks)  # bf16 MRF
    want = (0,) * 6 + (n_dec, 0, 0) + (0,) * 3
    counts, launches = {}, 0

    def counted(name, fn):
        nonlocal launches
        before, mrf_before = flash_all_counts(), mrf_counts()
        out = fn()
        counts[name] = (tuple(a - b for a, b in zip(flash_all_counts(),
                                                    before)),
                        tuple(a - b for a, b in zip(mrf_counts(),
                                                    mrf_before)))
        launches += counts[name][0][6]
        return out

    eager = counted("eager", lambda: eager_synthesize(
        synth, *args, vocoder="hifigan", **kwargs))
    synth.drop_graphs()
    first = counted("capture", lambda: synth.synthesize(
        *args, vocoder="hifigan", **kwargs))
    graphed = counted("replay", lambda: synth.synthesize(
        *args, vocoder="hifigan", **kwargs))
    lens = [r.mel.shape[0] for r in graphed]
    smoke.check(2048 < max(lens) < LONG_MAX_MEL
                and all(np.isfinite(r.mel).all() and np.isfinite(r.wav).all()
                        and r.wav.size == r.mel.shape[0] * 256
                        for r in graphed),
                f"h1d256 long-form: mel lengths {lens}, the longest in "
                f"(2048, {LONG_MAX_MEL}); finite mel and wav")
    smoke.check(all(c == (want, (per_call, 0)) for c in counts.values()),
                f"h1d256 long-form under 'auto', launches a call (flash "
                f"float32 D = 128, bf16, float32 and bf16 D = 256; MRF bf16, "
                f"float32): {counts} (expected {want}, ({per_call}, 0)): "
                f"the D = 256 forward once a decoder layer")
    same_dur = all(np.array_equal(a.durations, b.durations)
                   for a, b in zip(eager, graphed))
    mel_diff = max(float(np.abs(a.mel - b.mel).max())
                   for a, b in zip(eager, graphed)) if same_dur else math.inf
    peak = max(1.0, max(float(np.abs(a.mel).max()) for a in eager))
    wav_diff = max(float(np.abs(a.wav - b.wav).max())
                   for a, b in zip(eager, graphed)) if same_dur else math.inf
    wav_bound = GRAPH_WAV_BF16 * max(float(np.abs(a.wav).max())
                                     for a in eager)
    replays = all(np.array_equal(a.wav, b.wav) for a, b in zip(first,
                                                                graphed))
    smoke.check(same_dur and mel_diff <= GRAPH_MEL_REL * peak
                and wav_diff <= wav_bound and replays,
                f"h1d256 long-form, graphed vs eager: durations equal "
                f"{same_dur}, mel max|diff| {mel_diff:.3e} (bound "
                f"{GRAPH_MEL_REL * peak:.3e}), wav max|diff| {wav_diff:.3e} "
                f"(bound {wav_bound:.3e}); the capturing call and a replay "
                f"equal: {replays}")

    # The math path on the card, the same weights: phase 3b's bound.
    math_synth = Synthesizer(with_impl(cfg, "xla"), fs2,
                             emotion_maps=EMOTION_MAPS, device=device)
    ref = math_synth.synthesize(*args, vocoder="none", **kwargs)
    same_dur = all(np.array_equal(a.durations, b.durations)
                   for a, b in zip(ref, graphed))
    mel_diff = max(float(np.abs(a.mel - b.mel).max())
                   for a, b in zip(ref, graphed)) if same_dur else math.inf
    bound = F32_BOUND * max(1.0, max(float(np.abs(a.mel).max())
                                     for a in ref))
    smoke.check(same_dur and mel_diff <= bound,
                f"h1d256 long-form mel, 'auto' (the D = 256 kernel) vs the "
                f"math path on the card: durations equal {same_dur}, "
                f"max|diff| {mel_diff:.3e} (bound {bound:.3e})")
    ms = {}
    for name, fn in (("auto, graphed", lambda: synth.synthesize(
            *args, vocoder="none", **kwargs)),
                     ("xla, graphed", lambda: math_synth.synthesize(
            *args, vocoder="none", **kwargs))):
        fn()
        ms[name] = sorted(synced_ms(fn) for _ in range(3))[1]
    print(f"  h1d256 long-form text -> mel (vocoder='none'), median of 3: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" [{card}]", flush=True)
    del synth, math_synth
    return launches


def phase_h1d256_training(smoke: Smoke, device) -> tuple[int, int, int]:
    """16c: train() of h1d256 under "flash" for 20 steps (float32, phase
    5's corpus and recipe, batch 4 in its buckets; on the card train()
    replays its steps from CUDA graphs): each compiled train step launches
    each D = 256 kernel once an FFT block and no other flash kernel, each
    eval and synth step the D = 256 forward once a block; the logged losses
    against the same run under "auto" (the math path at these lengths)
    within phase 5's bound; then the graphed train step of each at B = 4,
    bucket (128, 1000), in turns. Returns the run's D = 256 launches."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
        train,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_train_step,
    )

    card = nvidia_smi_line()
    losses, totals, cfgs = {}, None, {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = write_training_corpus(os.path.join(tmp, "corpus"), 0)
        for impl in ("flash", "auto"):
            out = os.path.join(tmp, impl)
            cfg = cfgs[impl] = h1d256(training_config(corpus, out, impl))
            t = cfg.model.transformer
            n_blocks = t.encoder_layer + t.decoder_layer
            bf16_before = bf16_counts() + bf16_d256_counts()
            t0 = time.perf_counter()
            state, calls, counts = counted_training(
                lambda: train(cfg, total_steps=TRAIN_STEPS,
                              device=device), counts=d256_counts)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # counted_training set the float32 D = 128 counts to 0 first.
            others = flash_counts() + tuple(
                a - b for a, b in zip(bf16_counts() + bf16_d256_counts(),
                                      bf16_before))
            check_flash_calls(smoke, "h1d256 train()", impl, calls,
                              n_blocks, TRAIN_STEPS)
            smoke.check(others == (0,) * 9 and state.step == TRAIN_STEPS,
                        f"h1d256 train() {impl!r}: {state.step} steps in "
                        f"{seconds:.1f} s; D = 256 launches {counts}, the "
                        f"other flash kernels' {others} (expected none) "
                        f"[{card}]")
            if impl == "flash":
                totals = counts
            with open(os.path.join(out, "log/train/metrics.jsonl")) as f:
                losses[impl] = [json.loads(line)["total_loss"] for line in f]
            del state
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["flash"],
                                               losses["auto"])]
    smoke.check(len(rel) == TRAIN_STEPS // TRAIN_CADENCE["log_step"]
                and max(rel) <= LOSS_REL_BOUND,
                f"h1d256 train() logged total losses, 'flash' "
                f"{losses['flash']} vs 'auto' {losses['auto']}: relative "
                f"differences {[f'{x:.2e}' for x in rel]} (bound "
                f"{LOSS_REL_BOUND:.0e})")

    # The graphed train step of each at phase 6's batch, in turns.
    b, s, t = TRAIN_TIMED
    batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
    steps, ms, counts = {}, {}, {}
    for impl, cfg in cfgs.items():
        state = create_train_state(cfg, None, device)
        steps[impl] = (state, make_train_step(state, cfg))
        ms[impl] = []
    for _ in range(3):
        for _, step in steps.values():
            step(batch)
    for _ in range(GRAPH_TUNED_STEPS):
        for impl, (_, step) in steps.items():
            ms[impl].append(synced_ms(lambda: step(batch)))
    for impl, (_, step) in steps.items():
        before = d256_counts()
        step(batch)
        counts[impl] = tuple(a - b for a, b in zip(d256_counts(), before))
    print("  " + f"h1d256 float32 train step graphed, B = {b}, bucket "
          f"({s}, {t}), {GRAPH_TUNED_STEPS} steps after 3, in turns: "
          + "; ".join(f"{k} median {float(np.median(v)):.3f} ms "
                      f"({min(v):.3f}-{max(v):.3f}), D = 256 launches "
                      f"{counts[k]}" for k, v in ms.items())
          + f"; 'flash' / 'auto' "
          f"{float(np.median(ms['flash'])) / float(np.median(ms['auto'])):.3f}"
          f" [{card}]", flush=True)
    del steps, batch
    return totals


def phase_d256_times(smoke: Smoke):
    """16d: the D = 256 kernels at (4, 1, T, 256), each call timed from a
    CUDA graph, against their bounds, plain versions and SDPA in float32
    with the same bool mask; D = 64 through the padding against the D = 128
    kernel on inputs padded beforehand and SDPA at D = 64. Returns the
    kernels' rows: the forward at T = 4096, the backward pair at T =
    1000."""
    import torch
    import torch.nn.functional as F

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    card = nvidia_smi_line()
    gen = torch.Generator().manual_seed(16)
    scale = D256 ** -0.5
    rows = {}

    def sdpa_fn(q, k, v, mask, s):
        keep = ~mask[:, None, None, :]  # SDPA's boolean mask: True = attend
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=keep, scale=s)

    for b, t, case_rows in D256_FWD_TIMED:
        q, k, v, mask = flash_inputs(b, t, case_rows, gen, 1, D256)
        ms, how = graph_time_ms(lambda: fa.flash_mha(q, k, v, mask, scale))
        plain = cuda_time_ms(lambda: fa.flash_mha_plain(q, k, v, mask,
                                                        scale), 10)
        lib, _ = graph_time_ms(sdpa_fn(q, k, v, mask, scale))
        bd = flash_bounds_ms(mask, 1, D256, "flash_mha_d256")
        rows["fwd"] = {"shape": f"({b}, 1, {t}, 256) float32, valid keys "
                                f"{case_rows}",
                       "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bd["tf32_live"],
                       "bound_by": bd["bound_by"]}
        print(f"  flash_mha float32 D = 256 ({b}, 1, {t}, 256), valid keys "
              f"{case_rows}: kernel {ms:.4f} ms ({how}; "
              f"{bd['flops_live'] / ms / 1e9:.1f} TF/s over the "
              f"{bd['live_tiles']} of {bd['tiles']} live {bd['tile']}-key "
              f"tiles, {bd['tf32_live'] / ms:.3f} of the bound); bound "
              f"{bd['tf32_live']:.4f} ms live, {bd['tf32_dense']:.4f} ms "
              f"dense (TF32 rate, {bd['bound_by']}); at three TF32 products "
              f"a product {bd['x3_live']:.4f} ms; plain {plain:.4f} ms; SDPA "
              f"{lib:.4f} ms (kernel / SDPA {ms / lib:.3f}) [{card}]",
              flush=True)
        del q, k, v, mask
    for t in FLASH_BWD_TIMED:
        lens = (t, 3 * t // 4, t // 2, t // 4)
        q, k, v, mask = flash_inputs(4, t, prefixes(*lens), gen, 1, D256)
        dout = torch.randn(q.shape, generator=gen).to("cuda")
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        _, delta = fa._flash_mha_bwd_dq_cuda(q, k, v, mask, out, dout, lse,
                                             scale)
        dq_ms, how = graph_time_ms(lambda: fa._flash_mha_bwd_dq_cuda(
            q, k, v, mask, out, dout, lse, scale))
        dkv_ms, _ = graph_time_ms(lambda: fa._flash_mha_bwd_dkv_cuda(
            q, k, v, mask, dout, lse, delta, scale))
        plain = cuda_time_ms(lambda: fa.flash_mha_bwd_plain(
            q, k, v, mask, out, dout, scale), 10)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        o = sdpa_fn(qs, ks, vs, mask, scale)()
        lib = cuda_time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dout, retain_graph=True), 10)
        line = []
        for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            bd = flash_bwd_bounds_ms(mask, name, 1, D256,
                                     "flash_mha_bwd_d256")
            flops = ({"dq": 6, "dkv": 8}[name] * t * bd["tile"]
                     * bd["live_tiles"] * D256)
            rows.setdefault(name, {
                "shape": f"(4, 1, {t}, 256) float32, key lengths {lens}",
                "ms": ms, "plain_ms": plain, "bound_ms": bd["live"],
                "bound_by": bd["bound_by"], "library_ms": lib})
            line.append(f"{name} kernel {ms:.4f} ms ({flops / ms / 1e9:.1f}"
                        f" TF/s over the live tiles, {bd['live'] / ms:.3f} "
                        f"of the bound; bound {bd['live']:.4f} live, "
                        f"{bd['dense']:.4f} dense)")
        # The D = 128 pair at the same H·D and mask: a block of it does the
        # work of a D = 256 block without the cluster's exchange.
        q2, k2, v2, dout2 = (torch.randn(4, 2, t, 128, generator=gen).to(
            "cuda") for _ in range(4))
        out2, lse2 = fa._flash_mha_cuda(q2, k2, v2, mask, 128 ** -0.5,
                                        with_lse=True)
        _, delta2 = fa._flash_mha_bwd_dq_cuda(q2, k2, v2, mask, out2, dout2,
                                              lse2, 128 ** -0.5)
        dq2_ms = graph_time_ms(lambda: fa._flash_mha_bwd_dq_cuda(
            q2, k2, v2, mask, out2, dout2, lse2, 128 ** -0.5))[0]
        dkv2_ms = graph_time_ms(lambda: fa._flash_mha_bwd_dkv_cuda(
            q2, k2, v2, mask, dout2, lse2, delta2, 128 ** -0.5))[0]
        print(f"  flash_mha backward float32 D = 256 (4, 1, {t}, 256), key "
              f"lengths {lens}, flash_mha_bwd_d256.cu: " + ", ".join(line)
              + f" ({how}); the pair {dq_ms + dkv_ms:.4f} ms; the D = 128 "
              f"pair at the same H·D, (4, 2, {t}, 128): dq {dq2_ms:.4f}, dkv"
              f" {dkv2_ms:.4f}, the pair {dq2_ms + dkv2_ms:.4f} ms; plain "
              f"backward {plain:.4f} ms; SDPA backward {lib:.4f} ms "
              f"[{card}]", flush=True)
        del q, k, v, mask, dout, out, lse, delta, qs, ks, vs, o
        del q2, k2, v2, dout2, out2, lse2, delta2
    # D = 64: the padding's cost, at (4, 2, 4096, 64).
    b, t, case_rows = D64_TIMED
    q, k, v, mask = flash_inputs(b, t, case_rows, gen, 2, 64)
    padded = [F.pad(x, (0, 64)) for x in (q, k, v)]
    dout = torch.randn(q.shape, generator=gen).to("cuda")
    out, lse = fa._flash_mha_cuda(q, k, v, mask, 64 ** -0.5, with_lse=True)
    fwd = {
        "through the padding": graph_time_ms(lambda: fa.flash_mha(
            q, k, v, mask, 64 ** -0.5))[0],
        "the D = 128 kernel on padded inputs": graph_time_ms(
            lambda: fa.flash_mha(*padded, mask, 64 ** -0.5))[0],
        "SDPA": graph_time_ms(sdpa_fn(q, k, v, mask, 64 ** -0.5))[0]}
    bwd = graph_time_ms(lambda: fa._flash_mha_bwd_cuda(
        q, k, v, mask, out, dout, lse, 64 ** -0.5))[0]
    print(f"  D = 64 float32 ({b}, 2, {t}, 64), valid keys {case_rows}, "
          f"forward: " + ", ".join(f"{k} {v:.4f} ms" for k, v in fwd.items())
          + f"; backward through the padding (dQ and dK/dV) {bwd:.4f} ms "
          f"[{card}]", flush=True)
    smoke.check(all(math.isfinite(r["ms"]) and r["ms"] > 0
                    for r in rows.values()),
                "D = 256 kernel times measured")
    return rows


def phase_head_dims(smoke: Smoke, device):
    """Phase 16: returns the D = 256 kernels' rows of the kernels line."""
    worst = phase_d256_d64_vs_plain(smoke)
    synth_launches = phase_h1d256_synthesis(smoke, device)
    train_launches = phase_h1d256_training(smoke, device)
    times = phase_d256_times(smoke)
    launches = (synth_launches + train_launches[0], train_launches[1],
                train_launches[2])
    return {name: {"launches": n, "max_abs_err": err, **times[name]}
            for name, n, err in zip(("fwd", "dq", "dkv"), launches, worst)}


# ---------------------------------------------------------------------------
# Phase 17: the bf16 flash kernels at D = 256 (csrc/flash_mha_bf16_d256.cu),
# through amp bf16 training of h1d256 on the tuned recipe.

# "flash" against "auto" from one seed: the first and the last logged loss
# (tests/test_torch_flash_bf16.py: test_amp_bf16_flash_tracks_amp_bf16_xla's
# bounds; bf16 rounds at other points on the two paths).
BF16_D256_FIRST_RTOL = 0.05
BF16_D256_LAST_RTOL = 0.08
# Phase 17c's shapes at H = 1, D = 256: the recipe's batch of 32 at the
# 1000-frame bucket with seeded key lengths (the `kernels` line's rows),
# and B = 4 at T = 4096 with phase 11b's masks.
BF16_D256_TIMED = (32, 1000)


def reset_all_flash_counts() -> None:
    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    for name in fa.COUNTERS:
        setattr(fa, name, 0)


def phase_bf16_d256_training(smoke: Smoke, device) -> dict:
    """17b: efs2-torch-train on train_tuned.yaml (batch 32, amp bf16,
    steps_per_call 10, graphed) with one encoder and one decoder head
    (D = 256) on phase 5's corpus, 20 steps under "flash" and under "auto"
    (the math path at these lengths) from one seed: under "flash" each train
    step launches each bf16 D = 256 kernel once an FFT block and no other
    flash kernel, each val and synth step (the float32 model) the float32
    D = 256 forward once a block and nothing else; under "auto" no flash
    kernel. Losses finite and falling, the first and the last logged loss
    within BF16_D256_FIRST_RTOL and BF16_D256_LAST_RTOL of "auto"'s; then
    the graphed train step of each at B = 32, bucket (128, 1000), in turns.
    Returns the "flash" run's bf16 D = 256 launches."""
    import numpy as np
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch import config as C
    from expressive_fastspeech2_mandarin_tpu_torch.train import (
        create_train_state,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.loop import (
        stage_batch,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.train.step import (
        make_train_step,
    )

    card = nvidia_smi_line()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        corpus = write_training_corpus(str(tmp / "corpus"), 0)
        for impl in ("flash", "auto"):
            calls: dict[str, list] = {"train_step": [], "eval_step": [],
                                      "synth_step": []}
            losses: list[float] = []

            def counting(key, steps, fn, *args):
                before = flash_all_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                calls[key].append((steps, tuple(
                    a - b for a, b in zip(flash_all_counts(), before)),
                    1e3 * (time.perf_counter() - t0)))
                if key == "train_step":
                    losses.append(float(out.total))
                return out

            y = tuned_configs(tmp / impl, corpus, impl=impl, heads=1)
            cfg = C.load_config(y["preprocess"], y["model"], y["train"])
            reset_all_flash_counts()
            with compiled_step_calls(functools.partial(
                    counting, "train_step")), inference_step_calls(
                    lambda name, fn, *a: counting(name, 1, fn, *a)):
                _, seconds = run_cli("train", [
                    "-p", y["preprocess"], "-m", y["model"], "-t",
                    y["train"], "--total_steps", TUNED_STEPS, "--device",
                    str(device)])
            runs[impl] = {"cfg": cfg, "calls": calls, "losses": losses,
                          "seconds": seconds, "launches": bf16_d256_counts(),
                          "log": _metrics(tmp / impl / "log" / "train"
                                          / "metrics.jsonl")}

    for impl, run in runs.items():
        cfg, calls = run["cfg"], run["calls"]
        t = cfg.model.transformer
        n = t.encoder_layer + t.decoder_layer
        flash = impl == "flash"
        per_step = (0,) * 9 + ((n,) * 3 if flash else (0,) * 3)
        per_eval = (0,) * 6 + (n if flash else 0,) + (0,) * 5
        train_calls = calls["train_step"]
        inference = [c for _, c, _ in calls["eval_step"]
                     + calls["synth_step"]]
        n_steps = sum(k for k, _, _ in train_calls)
        smoke.check(
            cfg.train.amp_dtype == "bfloat16"
            and t.attention_impl == impl and cfg.train.steps_per_call == 10
            and cfg.train.optimizer.batch_size == 32
            and t.encoder_head == t.decoder_head == 1
            and t.encoder_hidden // t.encoder_head == D256
            and n_steps == TUNED_STEPS
            and all(c == tuple(k * x for x in per_step)
                    for k, c, _ in train_calls)
            and calls["eval_step"] and calls["synth_step"]
            and all(c == per_eval for c in inference),
            f"h1d256 efs2-torch-train, train_tuned.yaml (batch "
            f"{cfg.train.optimizer.batch_size}, amp {cfg.train.amp_dtype}, "
            f"steps_per_call {cfg.train.steps_per_call}, heads "
            f"{t.encoder_head}/{t.decoder_head}) under {impl!r}: {n_steps} "
            f"train steps in {len(train_calls)} compiled calls in "
            f"{run['seconds']:.2f} s, each step launching (flash_all_counts:"
            f" float32, bf16 at D = 128, float32, bf16 at D = 256) "
            f"{sorted({tuple(x // k for x in c) for k, c, _ in train_calls})}"
            f" (expected {per_step}); {len(calls['eval_step'])} val and "
            f"{len(calls['synth_step'])} synth steps, each "
            f"{sorted(set(inference))} (expected {per_eval}); the run's "
            f"bf16 D = 256 launches {run['launches']} [{card}]")
        series = [x for (k, _, _), x in zip(train_calls, run["losses"])
                  for _ in range(k)]
        first, last = sum(series[:5]) / 5, sum(series[-5:]) / 5
        means = [r["total_loss"] for r in run["log"]]
        smoke.check([r["step"] for r in run["log"]] == [10, 20]
                    and all(math.isfinite(x) for x in series + means)
                    and last < first,
                    f"h1d256 amp bf16 {impl!r}: total loss, mean of the "
                    f"first and the last 5 steps {first:.4f} -> {last:.4f} "
                    f"(falling); logged chunk means {means}; each compiled "
                    f"call's ms a step "
                    f"{[round(ms / k, 2) for k, _, ms in train_calls]}")
    logged = {impl: [r["total_loss"] for r in run["log"]]
              for impl, run in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(logged["flash"],
                                               logged["auto"])]
    smoke.check(len(rel) == 2 and rel[0] <= BF16_D256_FIRST_RTOL
                and rel[-1] <= BF16_D256_LAST_RTOL,
                f"h1d256 amp bf16 logged total losses, 'flash' "
                f"{logged['flash']} vs 'auto' {logged['auto']}: relative "
                f"differences {[f'{x:.3e}' for x in rel]} (bounds "
                f"{BF16_D256_FIRST_RTOL}, {BF16_D256_LAST_RTOL})")

    # The graphed train step of each at the recipe's batch, in turns.
    b, s, t = TUNED_TIMED[-1]
    batch = stage_batch(synthetic_train_batch(b, s, t, seed=5), device)
    steps, ms, counts = {}, {}, {}
    for impl, run in runs.items():
        state = create_train_state(run["cfg"], None, device)
        steps[impl] = (state, make_train_step(state, run["cfg"]))
        ms[impl] = []
    for _ in range(3):
        for _, step in steps.values():
            step(batch)
    for _ in range(GRAPH_TUNED_STEPS):
        for impl, (_, step) in steps.items():
            ms[impl].append(synced_ms(lambda: step(batch)))
    for impl, (_, step) in steps.items():
        before = flash_all_counts()
        step(batch)
        counts[impl] = tuple(a - b for a, b in zip(flash_all_counts(),
                                                   before))
    print("  " + f"h1d256 amp bf16 train step graphed, B = {b}, bucket "
          f"({s}, {t}), {GRAPH_TUNED_STEPS} steps after 3, in turns: "
          + "; ".join(f"{k} median {float(np.median(v)):.3f} ms "
                      f"({min(v):.3f}-{max(v):.3f}), launches {counts[k]}"
                      for k, v in ms.items())
          + f"; 'flash' / 'auto' "
          f"{float(np.median(ms['flash'])) / float(np.median(ms['auto'])):.3f}"
          f" [{card}]", flush=True)
    del steps, batch
    return {"launches": runs["flash"]["launches"],
            "step_ms": {k: float(np.median(v)) for k, v in ms.items()}}


def phase_bf16_d256_times(smoke: Smoke) -> dict:
    """17c: the bf16 kernels at D = 256, each call timed from a CUDA graph,
    at the recipe's (32, 1, 1000, 256) with seeded key lengths and at
    (4, 1, 4096, 256) with phase 11b's masks, against their bounds (bf16
    rate over the live 32-key tiles, the function's flops: 4, 6 and 8·D per
    query and live key, not the column split's recomputation), their plain
    versions and SDPA in bf16 with the same bool mask (its backend named;
    its backward timed with CUDA events, as phase 11b's).
    Returns the rows at the recipe's shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fa

    card = nvidia_smi_line()
    gen = torch.Generator().manual_seed(17)
    scale = D256 ** -0.5
    rows = {}
    b0, t0 = BF16_D256_TIMED
    cases = ((b0, t0, recipe_lengths(b0, t0), recipe_lengths(b0, t0)),
             (4, 4096, (4096, 1, 0, 3001), (4096, 3072, 2048, 1024)))

    def backend(q, k, v, keep):
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, keep, 0.0, False, scale=scale)).name.lower()

    for b, t, fwd_lens, bwd_lens in cases:
        shown = (f"key lengths {b} seeded in [{t // 2}, {t}]" if b > 4
                 else None)
        # The forward.
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, prefixes(*fwd_lens),
                                               gen, 1, D256))
        keep = ~mask[:, None, None, :]
        ms, how = graph_time_ms(lambda: fa.flash_mha(q, k, v, mask, scale))
        plain = cuda_time_ms(lambda: fa.flash_mha_blocked_plain(
            q, k, v, mask, scale, 64), 10)
        lib, _ = graph_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, scale=scale))
        ran = backend(q, k, v, keep)
        bd = flash_bf16_bounds_ms(mask, "fwd", 1, D256)
        what = shown or f"valid keys {fwd_lens}"
        rows[("fwd", b, t)] = {
            "shape": f"({b}, 1, {t}, 256) bf16, {what}", "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bd["live"],
            "bound_by": bd["bound_by"]}
        print(f"  flash_mha bf16 D = 256 ({b}, 1, {t}, 256), {what}: kernel "
              f"{ms:.4f} ms ({how}; {bd['flops_live'] / ms / 1e9:.1f} TF/s "
              f"over the {bd['live_tiles']} of {bd['tiles']} live "
              f"{bd['tile']}-key tiles, {bd['live'] / ms:.3f} of the bound); "
              f"bound (bf16 rate) {bd['live']:.4f} ms live, "
              f"{bd['dense']:.4f} dense ({bd['bound_by']}); plain "
              f"{plain:.4f} ms; SDPA bf16 {lib:.4f} ms (the {ran} backend); "
              f"kernel / SDPA {ms / lib:.3f} [{card}]", flush=True)
        del q, k, v, mask, keep
        # The backward pair.
        q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                         for x in flash_inputs(b, t, prefixes(*bwd_lens),
                                               gen, 1, D256))
        dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
        out, lse = fa._flash_mha_cuda(q, k, v, mask, scale, with_lse=True)
        _, delta = fa._flash_mha_bwd_dq_cuda(q, k, v, mask, out, dout, lse,
                                             scale)
        dq_ms, how = graph_time_ms(lambda: fa._flash_mha_bwd_dq_cuda(
            q, k, v, mask, out, dout, lse, scale))
        dkv_ms, _ = graph_time_ms(lambda: fa._flash_mha_bwd_dkv_cuda(
            q, k, v, mask, dout, lse, delta, scale))
        plain = cuda_time_ms(lambda: fa.flash_mha_bwd_plain(
            q, k, v, mask, out, dout, scale), 10)
        keep = ~mask[:, None, None, :]
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep,
                                           scale=scale)
        # CUDA events, as phase 11b: autograd's backward may not capture
        # into a graph (and the profiler's fallback misses its kernels).
        lib = cuda_time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dout, retain_graph=True), 10)
        ran = backend(qs, ks, vs, keep)
        bd = {name: flash_bf16_bounds_ms(mask, name, 1, D256)
              for name in ("dq", "dkv", "both")}
        what = shown or f"key lengths {bwd_lens}"
        for name, kms in (("dq", dq_ms), ("dkv", dkv_ms)):
            rows[(name, b, t)] = {
                "shape": f"({b}, 1, {t}, 256) bf16, {what}", "ms": kms,
                "plain_ms": plain, "bound_ms": bd[name]["live"],
                "bound_by": bd[name]["bound_by"], "library_ms": lib}
        flops = 14 * t * BOUND_KEY_TILE * bd["both"]["live_tiles"] * D256
        print(f"  flash_mha backward bf16 D = 256 ({b}, 1, {t}, 256), {what}"
              f": dQ kernel {dq_ms:.4f} ms (bound {bd['dq']['live']:.4f} "
              f"live, {bd['dq']['live'] / dq_ms:.3f} of it), dK/dV kernel "
              f"{dkv_ms:.4f} ms (bound {bd['dkv']['live']:.4f} live, "
              f"{bd['dkv']['live'] / dkv_ms:.3f} of it) ({how}), together "
              f"{dq_ms + dkv_ms:.4f} ms = "
              f"{flops / (dq_ms + dkv_ms) / 1e9:.1f} TF/s over the live "
              f"tiles; whole-backward bound {bd['both']['live']:.4f} ms; "
              f"plain backward {plain:.4f} ms; SDPA bf16 backward "
              f"{lib:.4f} ms (CUDA events; the {ran} backend); pair / SDPA "
              f"{(dq_ms + dkv_ms) / lib:.3f} [{card}]", flush=True)
        del q, k, v, mask, dout, out, lse, delta, qs, ks, vs, o, keep
    smoke.check(all(math.isfinite(r["ms"]) and r["ms"] > 0
                    for r in rows.values()),
                "bf16 D = 256 kernel times measured")
    return {name: rows[(name, b0, t0)] for name in ("fwd", "dq", "dkv")}


def phase_bf16_d256(smoke: Smoke, device):
    """Phase 17: returns the bf16 D = 256 kernels' rows of the kernels
    line."""
    worst = phase_flash_bf16_vs_plain(smoke, h=1, d=D256)
    train = phase_bf16_d256_training(smoke, device)
    times = phase_bf16_d256_times(smoke)
    return {name: {"launches": n, "max_abs_err": err, **times[name]}
            for name, n, err in zip(("fwd", "dq", "dkv"), train["launches"],
                                    worst)}


PHASES = ("1", "2", "2b", "2c", "2d", "2e", "3", "3b", "4", "4b", "5", "6",
          "7", "8", "8b", "9", "10", "11", "11b", "12", "13", "14", "14c",
          "15", "16", "17")
# Phases run only when named: the 5,000-step deep convergence runs.
EXTRA_PHASES = ("15d", "15s", "15t")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA GPU and check it.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all "
                             "but 15d, 15s and 15t, and the result lines); "
                             "3b, 4 and 4b need 3")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose package to drive (default: "
                             "this script's)")
    parser.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dp_worker:  # one rank of phase 13
        return dp_worker(args.dp_worker)
    chosen = args.phases.split(",")
    whole = tuple(chosen) == PHASES
    unknown = sorted(set(chosen) - set(PHASES + EXTRA_PHASES))
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
    dp = run("13", "data-parallel training: efs2-torch-train --coordinator "
             "on two ranks", phase_data_parallel, smoke, device, root)
    run("14", "compiled steps: synthesis and training replayed from CUDA "
        "graphs against eager", phase_compiled_steps, smoke, device)
    gan = run("14c", "compiled steps: the GAN step, its chunk, the vocoder "
              "loop, evaluation, samples and the GTA forward replayed from "
              "CUDA graphs against eager", phase_compiled_gan, smoke, device)
    examples = run("15", "the example drivers: convergence_demo under "
                   "'flash' and 'auto', train_demo, synthesize_demo",
                   phase_examples, smoke, device)
    head_dims = run("16", "flash attention at head dims other than 128: "
                    "the float32 kernels at D = 256 through h1d256 "
                    "long-form synthesis and training, D = 64 through the "
                    "padding", phase_head_dims, smoke, device)
    bf16_d256 = run("17", "the bf16 flash kernels at D = 256 through amp "
                    "bf16 training of h1d256 on the tuned recipe",
                    phase_bf16_d256, smoke, device)
    run("15d", "convergence_deep: 5,000 steps under 'auto' and 'flash'",
        phase_deep_convergence, smoke, device)
    run("15s", "convergence_deep again, the mel targets staged in "
        "float32", phase_deep_spread, smoke, device)
    run("15t", "times: where convergence_deep's step goes",
        phase_deep_times, smoke, device)
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
                    "mrf_resblock.py:186",
        "launches": (launches + entry["launches"]["mrf_resblock"]
                     + fronts["launches"]["mrf_resblock"]
                     + examples["launches"]["mrf_resblock"]),
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
        "launches": (f32_launches + fronts["launches"]["mrf_resblock_f32"]
                     + gan["mrf_resblock_f32"]),
        "max_abs_err": max(worst[1], worst_long[1]),
        "shape": f"{len(STAGE_SHAPES) * len(KERNEL_SIZES)} resblocks float32 "
                 f"(TF32 off), B = {BATCH}, (C, T) in {list(STAGE_SHAPES)}, "
                 f"k in {list(KERNEL_SIZES)}",
        "design": "mrf_conv_f32_tc_kernel: implicit GEMM on TF32 wgmma at "
                  "float32 accuracy (3xTF32: split operands, three products "
                  "a product), weights by cp.async.bulk through an mbarrier "
                  "ring",
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
                     + fronts["launches"]["flash_mha"] + dp["launches"][0]
                     + gan["flash_mha"] + examples["launches"]["flash_mha"]),
        "max_abs_err": max(worst_flash, examples["worst"][0]),
        **flash_row,
    }, {
        "name": "flash_mha_bwd_dq",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "launches": (train_launches[1] + entry["launches"]["flash_mha_bwd_dq"]
                     + fronts["launches"]["flash_mha_bwd_dq"]
                     + dp["launches"][1]
                     + examples["launches"]["flash_mha_bwd_dq"]),
        "max_abs_err": max(worst_bwd[0], examples["worst"][1]),
        **bwd_rows["dq"],
    }, {
        "name": "flash_mha_bwd_dkv",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": (train_launches[2]
                     + entry["launches"]["flash_mha_bwd_dkv"]
                     + fronts["launches"]["flash_mha_bwd_dkv"]
                     + dp["launches"][2]
                     + examples["launches"]["flash_mha_bwd_dkv"]),
        "max_abs_err": max(worst_bwd[1], examples["worst"][2]),
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/{source}.cu",
        "replaces": replaces,
        **head_dims[key],
    } for name, key, source, replaces in (
        ("flash_mha_d256", "fwd", "flash_mha_d256",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:589"),
        ("flash_mha_bwd_dq_d256", "dq", "flash_mha_bwd_d256",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
        ("flash_mha_bwd_dkv_d256", "dkv", "flash_mha_bwd_d256",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:941"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_mha_bf16_d256.cu",
        "replaces": replaces,
        **bf16_d256[key],
    } for name, key, replaces in (
        ("flash_mha_bf16_d256", "fwd",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:589"),
        ("flash_mha_bwd_dq_bf16_d256", "dq",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
        ("flash_mha_bwd_dkv_bf16_d256", "dkv",
         "jax/experimental/pallas/ops/tpu/flash_attention.py:941"))]
    print(f"card: {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
