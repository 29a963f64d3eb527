"""The port's aligner driver against the JAX package's on a tiny seeded
corpus like tests/test_aligner.py's (two speakers, "ban hao"): the port
builds ``native/aligner`` into ``build/aligner/`` with g++ and writes the
same TextGrids as the JAX driver's tracked binary. Measured: the files are
byte for byte equal (0 s between any two boundaries), so the test holds
them equal; nothing under ``native/`` changes. The two drivers pass the
aligner the same command lines."""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

import expressive_fastspeech2_mandarin_tpu.align as jax_align
import expressive_fastspeech2_mandarin_tpu_torch.align as port_align
from expressive_fastspeech2_mandarin_tpu.utils.wav import save_wav
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import read_textgrid

from .test_aligner import SR, _render

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


def _native_digest() -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(port_align.NATIVE_DIR.iterdir()) if p.is_file()}


def _corpus(root) -> str:
    rng = np.random.default_rng(0)
    for spk in ("0001", "0002"):
        os.makedirs(root / "corpus" / spk)
        for i in range(12):
            durs = rng.uniform(0.08, 0.2, 5)
            base = root / "corpus" / spk / f"{spk}_{i:06d}"
            save_wav(f"{base}.wav",
                     _render(rng, ["b", "a", "n", "h", "ao"], durs), SR)
            (root / "corpus" / spk / f"{spk}_{i:06d}.lab").write_text(
                "ban hao\n")
    return str(root / "corpus")


def test_port_driver_writes_the_jax_drivers_textgrids(tmp_path):
    before = _native_digest()
    binary = port_align.ensure_built()
    assert binary.startswith(str(port_align.BUILD_DIR))
    assert os.path.samefile(binary, port_align.binary_path())
    corpus = _corpus(tmp_path)
    ref_log = jax_align.align_corpus(corpus, str(tmp_path / "tg_jax"),
                                     iters=4, threads=2)
    log = port_align.align_corpus(corpus, str(tmp_path / "tg_port"),
                                  model_path=str(tmp_path / "am.bin"),
                                  iters=4, threads=2)
    assert "aligned 24 utterances" in log and "aligned 24" in ref_log
    assert os.path.exists(tmp_path / "am.bin")
    n = 0
    for spk in ("0001", "0002"):
        names = sorted(os.listdir(tmp_path / "tg_jax" / spk))
        assert names == sorted(os.listdir(tmp_path / "tg_port" / spk))
        for name in names:
            ours = tmp_path / "tg_port" / spk / name
            ref = tmp_path / "tg_jax" / spk / name
            for tier in ("phones", "words"):
                a = read_textgrid(str(ours)).get_tier_by_name(tier)
                b = read_textgrid(str(ref)).get_tier_by_name(tier)
                assert [(i.text, i.start, i.end) for i in a.intervals] == [
                    (i.text, i.start, i.end) for i in b.intervals]
            assert ours.read_bytes() == ref.read_bytes()
            n += 1
    assert n == 24
    # The saved model is loaded, not retrained.
    log2 = port_align.align_corpus(corpus, str(tmp_path / "tg2"),
                                   model_path=str(tmp_path / "am.bin"),
                                   threads=2)
    assert "loaded model" in log2
    assert _native_digest() == before


def test_drivers_pass_the_same_command_lines(monkeypatch, tmp_path):
    seen = {}

    def fake_run(name):
        def run(cmd, **kwargs):
            seen.setdefault(name, []).append(cmd[1:])
            return subprocess.CompletedProcess(cmd, 0, "", "log")
        return run

    monkeypatch.setattr(port_align, "ensure_built", lambda: "port-binary")
    monkeypatch.setattr(jax_align, "ensure_built", lambda: "jax-binary")
    calls = [dict(), dict(model_path="m.bin", iters=3, mix_up=2, threads=4,
                          speaker_adapt=False, triphone=False,
                          lexicon="lex.dict", extra_args=["--x"]),
             dict(triphone=True)]
    for mod, name in ((port_align, "port"), (jax_align, "jax")):
        monkeypatch.setattr(mod.subprocess, "run", fake_run(name))
        for kw in calls:
            assert mod.align_corpus("c", str(tmp_path / "o"), **kw) == "log"
        assert mod.train_model("c", "m.bin", threads=3) == "log"
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 4


def test_failed_alignment_raises(tmp_path):
    with pytest.raises(port_align.AlignerError, match="alignment failed"):
        port_align.align_corpus(str(tmp_path / "missing"),
                                str(tmp_path / "out"), iters=1)
