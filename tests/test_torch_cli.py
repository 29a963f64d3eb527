"""The port's command lines on the CPU (``--device cpu``), called in-process
through ``main(argv)``: the README's Quick start on a toy ESD corpus —
``preprocess esd`` → ``align`` → ``validate textgrids`` → ``preprocess
features`` → ``validate data`` → ``train`` (chunks of 2) → ``evaluate`` →
``train-vocoder`` (context mode, then ``--gta``) → ``validate vocoder`` →
``synthesize`` (single, streamed, batch, grid) → ``validate synth`` /
``checkpoint`` → ``ipa`` → ``pipeline --skip-train``; and ``synthesize
--torch_ckpt`` against the JAX CLI on the same files. Without ``--device
cpu`` the entry points that run models raise ``RuntimeError`` here.

The toy configuration is the shipped ESD triplet with its paths moved into
a temporary directory and the acoustic model cut to one block of width 32;
the vocoder keeps HiFi-GAN V1's width. Bound for the JAX comparison:
tests/test_torch_synth.py's float32 one (durations exact, mel 1e-4,
waveform 1e-5), which the int16 wav files carry as at most one step.
"""

import io
import json
import os
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu_torch.cli import (
    align as cli_align,
    evaluate as cli_evaluate,
    ipa as cli_ipa,
    pipeline as cli_pipeline,
    preprocess as cli_preprocess,
    synthesize as cli_synthesize,
    train as cli_train,
    train_vocoder as cli_train_vocoder,
    validate as cli_validate,
)
from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import (
    load_wav,
    save_wav,
)

from .test_aligner import _render

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs" / "ESD-Chinese-Singing-MFA"
EMOTIONS = ("Angry", "Happy", "Neutral", "Sad", "Surprise")
ESD_SR = 16000
TEXT = "{b a n h ao}"


def _set(text: str, key: str, value: str) -> str:
    """The YAML ``text`` with the first ``key:`` line's value replaced."""
    out, n = re.subn(rf"^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text,
                     count=1, flags=re.M)
    assert n == 1, key
    return out


def write_configs(root: Path, esd: Path, **train_extra) -> tuple[str, ...]:
    """The shipped ESD triplet with its paths under ``root``, a toy-width
    acoustic model, a short run and a small GAN recipe."""
    pre = (CONFIGS / "preprocess.yaml").read_text()
    for key, value in (("corpus_path", esd), ("raw_path", root / "raw"),
                       ("preprocessed_path", root / "pre"),
                       ("lexicon_path", '""'), ("val_size", 4)):
        pre = _set(pre, key, f'"{value}"' if isinstance(value, Path)
                   else value)
    model = (CONFIGS / "model.yaml").read_text()
    for key, value in (("encoder_layer", 1), ("decoder_layer", 1),
                       ("encoder_hidden", 32), ("decoder_hidden", 32),
                       ("conv_filter_size", 64), ("filter_size", 32)):
        model = _set(model, key, value)
    train = (CONFIGS / "train.yaml").read_text()
    for key in ("ckpt_path", "log_path", "result_path"):
        train = _set(train, key, f'"{root / key.split("_")[0]}"')
    for key, value in (("total_step", 4), ("log_step", 1),
                       ("synth_step", 100), ("val_step", 4),
                       ("save_step", 2), ("warm_up_step", 10),
                       *train_extra.items()):
        train = _set(train, key, value)
    train += ("\nsteps_per_call: 2\n"
              "vocoder_train:\n  batch_size: 2\n  segment_size: 4096\n"
              "  mpd_periods: [2, 3]\n  msd_scales: 1\n  log_step: 1\n"
              "  save_step: 2\n  val_step: 100\n")
    paths = []
    for name, text in (("preprocess", pre), ("model", model),
                       ("train", train)):
        (root / f"{name}.yaml").write_text(text)
        paths.append(str(root / f"{name}.yaml"))
    return tuple(paths)


def write_esd(root: Path, n: int = 3, seed: int = 0) -> Path:
    """An ESD-layout tree of "ban hao" utterances (tests/test_aligner.py's
    renders at 16 kHz): 2 speakers × 5 emotions × ``n``."""
    rng = np.random.default_rng(seed)
    for speaker in ("0001", "0002"):
        lines = []
        for e, emotion in enumerate(EMOTIONS):
            os.makedirs(root / speaker / emotion)
            for k in range(n):
                base = f"{speaker}_{e * n + k:06d}"
                wav = _render(rng, ["b", "a", "n", "h", "ao"],
                              rng.uniform(0.08, 0.2, 5))
                save_wav(str(root / speaker / emotion / f"{base}.wav"), wav,
                         ESD_SR)
                lines.append(f"{base}\t半好\t{emotion}")
        (root / speaker / f"{speaker}.txt").write_text(
            "\n".join(lines) + "\n", encoding="utf-8")
    return root


def run(main, argv: list[str]) -> str:
    """``main(argv)``'s standard output."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        main([str(a) for a in argv])
    return buf.getvalue()


def _json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    """The Quick start through the port's CLIs on the CPU; returns the
    root, the config arguments and each step's output."""
    root = tmp_path_factory.mktemp("quickstart")
    esd = write_esd(root / "esd")
    p, m, t = write_configs(root, esd)
    cfg = ["-p", p, "-m", m, "-t", t]
    cpu = ["--device", "cpu"]
    out = {}
    out["esd"] = run(cli_preprocess.main, ["esd", "--esd-root", esd,
                                           "--raw-path", root / "raw"])
    out["align"] = run(cli_align.main, [
        "--corpus", root / "raw", "--out", root / "pre" / "TextGrid",
        "--iters", 4, "--threads", 2])
    out["textgrids"] = run(cli_validate.main, [
        "textgrids", "--textgrid-dir", root / "pre" / "TextGrid",
        "--report", root / "tg_report.json"])
    out["features"] = run(cli_preprocess.main, [
        "features", *cfg, "--num-workers", 1, *cpu])
    out["data"] = run(cli_validate.main, [
        "data", "--preprocessed-path", root / "pre"])
    out["train"] = run(cli_train.main, [*cfg, *cpu])
    out["evaluate"] = run(cli_evaluate.main, [*cfg, *cpu])
    voc = root / "voc"
    out["vocoder"] = run(cli_train_vocoder.main, [
        *cfg, "--out", voc, "--total_steps", 2, "--no-packed-generator",
        *cpu])
    out["gta"] = run(cli_train_vocoder.main, [
        *cfg, "--out", root / "voc_gta", "--total_steps", 2, "--gta",
        root / "ckpt", "--init_ckpt", voc / "generator.npz", *cpu])
    out["paired_gt"] = run(cli_train_vocoder.main, [
        *cfg, "--out", root / "voc_gt", "--total_steps", 1, "--paired_gt",
        "--limit", 4, *cpu])
    out["validate_vocoder"] = run(cli_validate.main, [
        "vocoder", *cfg, "--vocoder-ckpt", voc / "generator.npz",
        "--wav-dir", root / "raw", "--n", 2, "--baseline", *cpu])
    out["validate_gta"] = run(cli_validate.main, [
        "vocoder", *cfg, "--vocoder-ckpt", root / "voc_gta" /
        "generator.npz", "--wav-dir", root / "raw", "--n", 1, "--mel-dir",
        root / "voc_gta" / "gta_mels", *cpu])
    out["resample"] = run(cli_preprocess.main, [
        "resample", "--in-dir", esd / "0001" / "Sad", "--out-dir",
        root / "resampled", "--sampling-rate", 8000, "--peak-normalize",
        0.5])
    npz = ["--vocoder_ckpt", voc / "generator.npz"]
    res = root / "result"
    out["single"] = run(cli_synthesize.main, [
        *cfg, "--mode", "single", "--text", TEXT, "--speaker_id", "0002",
        "--emotion", "Sad", *npz, "--save_mel", "--out_dir", res, *cpu])
    out["stream"] = run(cli_synthesize.main, [
        *cfg, "--mode", "single", "--text", TEXT, "--speaker_id", "0002",
        "--emotion", "Sad", *npz, "--stream_chunk_frames", 32,
        "--output_name", "streamed", "--out_dir", res, *cpu])
    out["batch"] = run(cli_synthesize.main, [
        *cfg, "--mode", "batch", "--source", root / "pre" / "val.txt",
        "--vocoder", "griffin_lim", "--out_dir", root / "batch", *cpu])
    out["grid"] = run(cli_synthesize.main, [
        *cfg, "--mode", "grid", "--text", TEXT, "--vocoder", "griffin_lim",
        "--restore_step", 4, "--out_dir", root / "grid", *cpu])
    out["synth"] = run(cli_validate.main, [
        "synth", "--result-dir", res, "--min-duration", 0.1])
    out["checkpoint"] = run(cli_validate.main, ["checkpoint", *cfg])
    return root, cfg, out


def test_quickstart_prepares_aligns_and_extracts(quickstart):
    root, _, out = quickstart
    assert "prepared ESD corpus" in out["esd"]
    assert len(list((root / "raw").glob("*/*.wav"))) == 30
    assert "aligned 30 utterances" in out["align"]
    tg = _json(out["textgrids"])
    assert tg["files_validated"] == 30 and not tg["errors"]
    assert tg["files_with_words_tier"] == 30
    m = re.search(r"wrote (\d+) utterances", out["features"])
    assert m and int(m.group(1)) >= 26
    data = _json(out["data"])
    assert data["problem_count"] == 0 and data["utterances_checked"] >= 26
    assert "resampled 3 wavs to 8000 Hz" in out["resample"]
    wav, sr = load_wav(str(root / "resampled" / "0001_000009.wav"), None)
    assert sr == 8000 and abs(np.abs(wav).max() - 0.5) < 1e-3


def test_quickstart_trains_in_chunks_and_evaluates(quickstart):
    root, _, out = quickstart
    with open(root / "log" / "train" / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [2, 4]  # log_step 1, read at the ends of chunks of 2
    assert sorted(os.listdir(root / "ckpt")) == ["2.pt", "4.pt"]
    assert re.search(r"Validation at step 4: total_loss=\d", out["evaluate"])


def test_quickstart_trains_the_vocoder_and_scores_it(quickstart):
    root, _, out = quickstart
    for d in ("voc", "voc_gta"):
        assert (root / d / "generator.npz").exists()
    assert len(os.listdir(root / "voc_gta" / "gta_mels")) >= 26
    assert "paired/GTA" in out["gta"] and "paired):" in out["paired_gt"]
    assert (root / "voc_gt" / "generator.npz").exists()
    g = _json(out["validate_gta"])
    assert g["mode"] == "predicted-mel" and np.isfinite(
        g["mcd_hifigan_mean"])
    v = _json(out["validate_vocoder"])
    assert len(v["files"]) == 2 and v["mode"] == "copy-synthesis"
    for key in ("mel_l1_hifigan_mean", "mcd_hifigan_mean",
                "mel_l1_griffin_lim_mean", "mcd_griffin_lim_mean"):
        assert np.isfinite(v[key]), key


def test_quickstart_synthesizes_every_mode(quickstart):
    root, _, out = quickstart
    res = root / "result"
    single, sr = load_wav(str(res / "synthesis_0002_Sad.wav"), None)
    mel = np.load(res / "synthesis_0002_Sad_mel.npy")
    assert sr == 22050 and single.size == mel.shape[0] * 256 > 0
    streamed, _ = load_wav(str(res / "streamed.wav"), None)
    # Streaming vocodes the trimmed mel, the monolithic call its padded
    # bucket, so only their tails differ (tests/test_torch_streaming.py).
    assert streamed.size == single.size and np.abs(streamed).max() > 0
    assert "chunk 0:" in out["stream"]
    n_val = len((root / "pre" / "val.txt").read_text().split("\n")) - 1
    assert len(list((root / "batch").glob("*.wav"))) == n_val
    assert len(list((root / "grid").glob("grid_*.wav"))) == 2 * 5
    health = _json(out["synth"])
    assert health["n_files"] == 2 and all(
        np.isfinite(f["rms"]) for f in health["files"])
    ck = _json(out["checkpoint"])
    assert ck["ok"] and ck["step"] == 4 and ck["non_finite_params"] == 0


def test_ipa_harvest_and_reencode(quickstart, tmp_path):
    root, _, _ = quickstart
    inv = tmp_path / "inv.json"
    out = run(cli_ipa.main, ["harvest", "--textgrid-dir",
                             root / "pre" / "TextGrid", "--out", inv])
    assert "unique phones" in out and inv.exists()
    meta = tmp_path / "val.txt"
    meta.write_text((root / "pre" / "val.txt").read_text())
    out = run(cli_ipa.main, ["reencode", "--metadata", meta,
                             "--textgrid-dir", root / "pre" / "TextGrid"])
    assert _json(out)["written"] > 0 and (tmp_path / "val_ipa.txt").exists()


def test_pipeline_skip_train_runs_stages_one_to_three(quickstart, tmp_path):
    root, _, _ = quickstart
    p, m, t = write_configs(tmp_path, root / "esd")
    out = run(cli_pipeline.main, ["-p", p, "-m", m, "-t", t, "--skip-train",
                                  "--align-iters", 4, "--device", "cpu"])
    assert "[1/4] preparing corpus" in out and "[4/4] training: skipped" in out
    assert (tmp_path / "pre" / "train.txt").exists()
    assert len(list((tmp_path / "pre" / "TextGrid").glob("*/*.TextGrid"))
               ) == 30


@pytest.mark.parametrize("main,argv", [
    (cli_train.main, []), (cli_evaluate.main, []),
    (cli_synthesize.main, ["--mode", "single", "--text", TEXT]),
    (cli_train_vocoder.main, []), (cli_pipeline.main, []),
    (cli_preprocess.main, None), (cli_validate.main, None),
])
def test_entry_points_need_the_card_unless_asked_for_cpu(
        main, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p, m, t = write_configs(tmp_path, tmp_path / "esd")
    cfg = ["-p", p, "-m", m, "-t", t]
    if main is cli_preprocess.main:
        argv = ["features", *cfg]
    elif main is cli_validate.main:
        argv = ["vocoder", *cfg, "--vocoder-ckpt", "x.npz", "--wav-dir", "."]
    else:
        argv = cfg + argv
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_train_refuses_multi_process_flags(tmp_path):
    p, m, t = write_configs(tmp_path, tmp_path / "esd")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        cli_train.main(["-p", p, "-m", m, "-t", t, "--num-processes", "2",
                        "--device", "cpu"])


def _stage1_call(tmp_path, monkeypatch, dataset: str, prep: str) -> tuple:
    """(corpus, raw, keyword arguments) of the one call stage 1 of
    ``pipeline`` makes to ``preprocess.<prep>`` for ``dataset``."""
    from expressive_fastspeech2_mandarin_tpu_torch import preprocess

    p, m, t = write_configs(tmp_path, tmp_path / "esd")
    Path(p).write_text(_set(Path(p).read_text(), "dataset", f'"{dataset}"'))
    os.makedirs(tmp_path / "esd")
    calls = []

    class Stop(Exception):
        pass

    def fake(corpus, raw, **kw):
        calls.append((corpus, raw, kw))
        raise Stop  # before the aligner

    monkeypatch.setattr(preprocess, prep, fake)
    with pytest.raises(Stop):
        cli_pipeline.main(["-p", p, "-m", m, "-t", t, "--device", "cpu"])
    [call] = calls
    return call


def test_pipeline_refuses_unported_corpora(tmp_path, monkeypatch):
    """Stage 1 hands an IEMOCAP release to its adapter (once refused, hence
    the name), with the JAX CLI's arguments: the default sub-directory, no
    fixed texts, the configured cleaners (tests/test_torch_corpus_prep.py
    runs the stages)."""
    corpus, _, kw = _stage1_call(tmp_path, monkeypatch, "IEMOCAP",
                                 "prepare_iemocap")
    assert corpus == str(tmp_path / "esd")
    assert kw == dict(sampling_rate=22050, sub_dir_name="sessions",
                      fixed_text_path=None, cleaners=("basic_cleaners",))


def test_pipeline_takes_aihub_corpora(tmp_path, monkeypatch):
    corpus, _, kw = _stage1_call(tmp_path, monkeypatch, "AIHub-MMV",
                                 "prepare_aihub_mmv")
    assert corpus == str(tmp_path / "esd")
    assert kw == dict(sampling_rate=22050, sub_dir_name="clips",
                      fixed_text_path=None, cleaners=("basic_cleaners",))


def test_synthesize_torch_ckpt_matches_the_jax_cli(tmp_path, monkeypatch):
    """One reference checkpoint pair, written from seeded torch modules,
    through both packages' ``synthesize`` CLIs in float32."""
    import dataclasses

    from expressive_fastspeech2_mandarin_tpu.cli import (
        synthesize as jax_cli_synthesize,
    )
    from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
    from expressive_fastspeech2_mandarin_tpu_torch.models import (
        FastSpeech2,
        Generator,
    )
    from expressive_fastspeech2_mandarin_tpu_torch.models.hifigan import (
        save_generator_npz,
    )

    p, m, t = write_configs(tmp_path, tmp_path / "esd")
    cfg = tcfg.load_config(p, m, t)
    torch.manual_seed(0)
    fs2 = FastSpeech2(cfg.model, cfg.preprocess).state_dict()
    fs2["variance_adaptor.duration_predictor.linear_layer.bias"] += 2.0
    ckpt = tmp_path / "900000.pth.tar"
    torch.save({"model": fs2}, ckpt)
    npz = tmp_path / "generator.npz"
    save_generator_npz(str(npz), Generator(cfg.model.vocoder).state_dict())

    def float32(config_from_args):
        def load(args):
            c = config_from_args(args)
            return dataclasses.replace(c, model=dataclasses.replace(
                c.model, vocoder=dataclasses.replace(
                    c.model.vocoder, compute_dtype="float32")))
        return load

    for mod in (cli_synthesize, jax_cli_synthesize):
        monkeypatch.setattr(mod, "config_from_args",
                            float32(mod.config_from_args))
    argv = ["-p", p, "-m", m, "-t", t, "--mode", "single", "--text",
            "{b a n h ao sh i j ie}", "--speaker_id", "1", "--emotion",
            "Happy", "--torch_ckpt", ckpt, "--vocoder_ckpt", npz,
            "--save_mel"]
    argv = [str(a) for a in argv]
    run(cli_synthesize.main, argv + ["--out_dir", tmp_path / "port",
                                     "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["efs2-synthesize", *argv, "--out_dir",
                                      str(tmp_path / "jax")])
    with redirect_stdout(io.StringIO()):
        jax_cli_synthesize.main()
    name = "synthesis_1_Happy"
    ours, sr = load_wav(str(tmp_path / "port" / f"{name}.wav"), None)
    ref, ref_sr = load_wav(str(tmp_path / "jax" / f"{name}.wav"), None)
    mel = np.load(tmp_path / "port" / f"{name}_mel.npy")
    ref_mel = np.load(tmp_path / "jax" / f"{name}_mel.npy")
    assert sr == ref_sr and mel.shape == ref_mel.shape and mel.shape[0] > 0
    assert np.abs(mel - ref_mel).max() < 1e-4
    assert ours.shape == ref.shape and np.abs(ref).max() > 0
    assert np.abs(ours - ref).max() <= 1 / 32768
