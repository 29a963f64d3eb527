"""End-to-end demo of the PyTorch port: hanzi text → phoneme IDs →
FastSpeech2 → HiFi-GAN (in the vocoder's compute dtype, bf16 by default:
every MRF resblock through the bf16 CUDA kernel) → wav; the counterpart of
``examples/synthesize_demo.py``.

Runs on the card unless given ``--device cpu``, both models replayed from
CUDA graphs there. Without a trained checkpoint the weights are random
(from fixed seeds) and the audio is noise: the point is to exercise the
whole public pipeline at real shapes.

Usage: python examples_torch/synthesize_demo.py [--text 今天天气真好]
           [--out DIR/demo.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MAX_SRC, MAX_MEL = 32, 512
# With random weights the duration predictor emits ~0, so round(exp(0) - 1)
# = 0 frames: its bias is raised by log 7, ~6 frames a phoneme.
DURATION_BIAS = math.log(7.0)
AROUSAL = VALENCE = 2


def phoneme_ids(text: str) -> list[int]:
    """The demo's front end: hanzi (or ``{phones}``) → pinyin-table IDs;
    a hanzi without a reading in the builtin table is skipped with a
    warning."""
    from expressive_fastspeech2_mandarin_tpu_torch.text import (
        chinese_text_to_ids,
    )

    return chinese_text_to_ids(text)


def seeded_models(cfg, device):
    """FastSpeech2 (seed 0, the duration bias raised) and the HiFi-GAN
    generator (seed 1, in the vocoder's compute dtype) on ``device``."""
    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.models import (
        FastSpeech2,
        Generator,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FastSpeech2(cfg.model, cfg.preprocess)
        torch.manual_seed(1)
        vocoder = Generator(cfg.model.vocoder,
                            cfg.preprocess.mel.n_mel_channels)
    with torch.no_grad():
        model.variance_adaptor.duration_predictor.linear_layer.bias += (
            DURATION_BIAS)
    dtype = getattr(torch, cfg.model.vocoder.compute_dtype)
    return model.to(device).eval(), vocoder.to(device, dtype).eval()


def main(argv: list[str] | None = None) -> dict:
    """Synthesize ``--text`` twice (the first call captures, the second is
    steady-state) and write the wav; returns the IDs, mel length, times
    and the bf16 MRF kernel's launches in each generator call."""
    from expressive_fastspeech2_mandarin_tpu_torch.cli.common import (
        add_device_arg,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--text", default="今天天气真好")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "demo.wav"))
    ap.add_argument("--speaker", type=int, default=0)
    ap.add_argument("--emotion", type=int, default=1)
    ap.add_argument("--pitch-control", type=float, default=1.0)
    ap.add_argument("--energy-control", type=float, default=1.0)
    ap.add_argument("--duration-control", type=float, default=1.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from expressive_fastspeech2_mandarin_tpu_torch.config import Config
    from expressive_fastspeech2_mandarin_tpu_torch.device import (
        resolve_device,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.graphs import (
        Graphs,
        module_tensors,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.ops import (
        mrf_resblock as mrf,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import save_wav

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "CPU")
    print(f"device: {device} ({name})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg = Config()
    pre_cfg = cfg.preprocess
    model, vocoder = seeded_models(cfg, device)
    print(f"FastSpeech2 params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")
    print(f"HiFi-GAN params: "
          f"{sum(p.numel() for p in vocoder.parameters()) / 1e6:.1f}M "
          f"({cfg.model.vocoder.compute_dtype})")

    ids = phoneme_ids(args.text)
    print(f"text: {args.text} -> {len(ids)} phonemes: {ids}")
    texts = torch.zeros((1, MAX_SRC), dtype=torch.long)
    texts[0, :len(ids)] = torch.tensor(ids)

    graphs = Graphs(state=lambda: module_tensors(model, vocoder))

    def forward(texts, src_lens, spk, emo, aro, val):
        out = model(spk, emo, aro, val, texts, src_lens,
                    max_mel_len=MAX_MEL, p_control=args.pitch_control,
                    e_control=args.energy_control,
                    d_control=args.duration_control)
        return out.postnet_mel, out.mel_lens

    synthesize = graphs.jit(forward)
    vocode = graphs.jit(lambda mel: vocoder(mel.to(
        next(vocoder.parameters()).dtype)).float())
    batch_args = (texts.to(device), *(
        torch.tensor(x, device=device) for x in (
            [len(ids)], [args.speaker], [args.emotion], [AROUSAL],
            [VALENCE])))
    launches = []

    def generator(mel):
        before = mrf.tc_launch_count
        wav = vocode(mel)
        launches.append(mrf.tc_launch_count - before)
        return wav

    with torch.inference_mode():
        t0 = time.perf_counter()
        mel, mel_lens = synthesize(*batch_args)
        sync()
        mel_len = int(mel_lens[0])
        print(f"acoustic model: capture+run {time.perf_counter() - t0:.1f}s, "
              f"mel {tuple(mel.shape)}, mel_len {mel_len}")
        t0 = time.perf_counter()
        wav = generator(mel)
        sync()
        print(f"vocoder: capture+run {time.perf_counter() - t0:.1f}s, "
              f"wav {tuple(wav.shape)}")

        t0 = time.perf_counter()
        mel2, _ = synthesize(*batch_args)
        wav2 = generator(mel2)
        sync()
        dt = time.perf_counter() - t0
    n_samples = mel_len * pre_cfg.stft.hop_length
    audio_s = n_samples / pre_cfg.audio.sampling_rate
    rtf = dt / audio_s if audio_s else math.inf
    print(f"steady-state on {name}: {dt * 1000:.1f}ms for {audio_s:.2f}s "
          f"audio (RTF {rtf:.4f}, "
          f"{audio_s / dt if dt else math.inf:.1f} audio-s/s)")

    samples = wav2[0, :n_samples].cpu().numpy()
    save_wav(args.out, samples, pre_cfg.audio.sampling_rate)
    print(f"wrote {args.out} ({audio_s:.2f}s @ "
          f"{pre_cfg.audio.sampling_rate}Hz)")
    return {"ids": ids, "mel_len": mel_len, "audio_s": audio_s,
            "steady_ms": dt * 1000, "rtf": rtf, "mrf_launches": launches,
            "wav": samples}


if __name__ == "__main__":
    main()
