"""The port's IEMOCAP and AIHub-MMV corpus preparation against the JAX
package's, on tests/port_corpus.py's release layouts (tests/
test_corpus_prep.py's fixtures): filelists, labs and speaker lists equal
byte for byte, WAVs within 1e-6; and ``efs2-torch-pipeline`` stages 1-3 on
the IEMOCAP release with a lexicon the test writes, on the CPU."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from expressive_fastspeech2_mandarin_tpu import preprocess as jprep
from expressive_fastspeech2_mandarin_tpu_torch import preprocess as tprep
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import aihub_mmv
from expressive_fastspeech2_mandarin_tpu_torch.utils.wav import load_wav

from .port_corpus import (
    CORPUS_SR,
    IEMOCAP_UTTS,
    write_aihub,
    write_iemocap,
    write_letter_lexicon,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs" / "ESD-Chinese-Singing-MFA"
WAV_ATOL = 1e-6


def _same_tree(ours: Path, ref: Path) -> list[str]:
    """Every file of both trees: text files equal byte for byte, WAVs
    within WAV_ATOL at the same rate; returns the relative paths."""
    names = sorted(str(p.relative_to(ours)) for p in ours.rglob("*")
                   if p.is_file())
    assert names == sorted(str(p.relative_to(ref)) for p in ref.rglob("*")
                           if p.is_file())
    for name in names:
        if name.endswith(".wav"):
            a, sr_a = load_wav(str(ours / name), None)
            b, sr_b = load_wav(str(ref / name), None)
            assert sr_a == sr_b and a.shape == b.shape, name
            assert np.abs(a - b).max() <= WAV_ATOL, name
        else:
            assert (ours / name).read_bytes() == (ref / name).read_bytes(), (
                name)
    return names


@pytest.mark.parametrize("cleaners", [("english_cleaners",),
                                      ("basic_cleaners",)])
def test_prepare_iemocap_matches_jax(cleaners, tmp_path):
    corpus = tmp_path / "IEMOCAP_full_release"
    os.makedirs(corpus)
    dialog = write_iemocap(str(corpus))
    fixed = tmp_path / "fixed.txt"
    fixed.write_text("Ses01F_impro01_M003|Nothing else, Dr. Who, 2 times.\n")
    for name, prep in (("ours", tprep.prepare_iemocap),
                       ("ref", jprep.prepare_iemocap)):
        n = prep(str(corpus), str(tmp_path / name), sampling_rate=22050,
                 sub_dir_name="sessions", fixed_text_path=str(fixed),
                 cleaners=cleaners)
        assert n == len(IEMOCAP_UTTS)
    names = _same_tree(tmp_path / "ours", tmp_path / "ref")
    assert f"sessions/{dialog}/F000_Ses01F_impro01.wav" in names
    lines = (tmp_path / "ours" / "filelist.txt").read_text().splitlines()
    assert lines[0].split("|")[2:] == ["Ses01F", "neu", "2.5", "2.5"]
    lab = (tmp_path / "ours" / "sessions" / dialog /
           "M003_Ses01F_impro01.lab").read_text()
    assert lab == {"english_cleaners": "nothing else, doctor who, two times.",
                   "basic_cleaners": "nothing else, dr. who, 2 times."}[
        cleaners[0]]
    assert (tmp_path / "ours" / "speaker_info.txt").read_text() == (
        "Ses01F|F\n")


@pytest.mark.parametrize("numbers", [False, True])
def test_aihub_create_dataset_and_prepare_match_jax(numbers, tmp_path):
    corpus, audio = tmp_path / "mmv", tmp_path / "mmv_audio"
    write_aihub(str(corpus), str(audio), numbers=numbers)
    for name, pkg in (("ours", tprep), ("ref", jprep)):
        n = pkg.create_aihub_dataset(str(corpus), str(audio),
                                     str(tmp_path / f"{name}_ds"),
                                     sampling_rate=CORPUS_SR)
        assert n == 2
    _same_tree(tmp_path / "ours_ds", tmp_path / "ref_ds")
    parts = (tmp_path / "ours_ds" / "filelist.txt").read_text(
        encoding="utf-8").splitlines()[0].split("|")
    assert len(parts) == 17 and parts[0] == "0_p001_c0001_30-90"
    assert parts[5:8] == ["happy", "0.7", "0.8"] and parts[8:11] == [
        "0", "0", "0"]

    fixed = tmp_path / "fixed.txt"
    fixed.write_text("1_p002_c0001_120-200|네 12시에 봐요\n", encoding="utf-8")
    for name, pkg in (("ours", tprep), ("ref", jprep)):
        n = pkg.prepare_aihub_mmv(str(tmp_path / f"{name}_ds"),
                                  str(tmp_path / f"{name}_raw"),
                                  sampling_rate=22050, sub_dir_name="clips",
                                  fixed_text_path=str(fixed),
                                  cleaners=("korean_cleaners",))
        assert n == 2
    names = _same_tree(tmp_path / "ours_raw", tmp_path / "ref_raw")
    labs = [n for n in names if n.endswith(".lab")]
    assert len(labs) == 2
    for lab in labs:
        text = (tmp_path / "ours_raw" / lab).read_text(encoding="utf-8")
        assert text and not any(c.isdigit() for c in text)
    lines = (tmp_path / "ours_raw" / "filelist.txt").read_text(
        encoding="utf-8").splitlines()
    assert [len(line.split("|")) for line in lines] == [17, 17]
    assert lines[1].split("|")[1] == "네 12시에 봐요"


def test_extract_audio_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="ffmpeg not found"):
        aihub_mmv.extract_audio(str(tmp_path), str(tmp_path / "audio"))


def _set(text: str, key: str, value) -> str:
    import re

    out, n = re.subn(rf"^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text,
                     count=1, flags=re.M)
    assert n == 1, key
    return out


def test_iemocap_pipeline_stages_1_to_3(tmp_path):
    """efs2-torch-pipeline stages 1-3 from an IEMOCAP preprocess.yaml
    (english_cleaners, sub_dir_name "sessions") on the release layout,
    aligned with a lexicon of the cleaned words' letters: what the JAX
    package's test of the same name asserts."""
    from expressive_fastspeech2_mandarin_tpu_torch.cli import pipeline

    corpus = tmp_path / "IEMOCAP_full_release"
    os.makedirs(corpus)
    write_iemocap(str(corpus))
    # The lexicon covers the words the cleaner leaves in the labs.
    labs = tmp_path / "labs"
    tprep.prepare_iemocap(str(corpus), str(labs), sub_dir_name="sessions")
    lexicon = write_letter_lexicon(str(labs), str(tmp_path / "en.dict"))
    pre = (CONFIGS / "preprocess.yaml").read_text()
    for key, value in (("dataset", '"IEMOCAP"'),
                       ("corpus_path", f'"{corpus}"'),
                       ("sub_dir_name", '"sessions"'),
                       ("lexicon_path", f'"{lexicon}"'),
                       ("raw_path", f'"{tmp_path / "raw"}"'),
                       ("preprocessed_path", f'"{tmp_path / "pre"}"'),
                       ("val_size", 1),
                       ("text_cleaners", '["english_cleaners"]'),
                       ("language", '"en"')):
        pre = _set(pre, key, value)
    pre_yaml = tmp_path / "preprocess.yaml"
    pre_yaml.write_text(pre)
    pipeline.main(["-p", str(pre_yaml), "-m", str(CONFIGS / "model.yaml"),
                   "-t", str(CONFIGS / "train.yaml"), "--skip-train",
                   "--align-iters", "4", "--device", "cpu"])
    out = tmp_path / "pre"
    assert (out / "train.txt").exists() and (out / "stats.json").exists()
    assert len(list((out / "TextGrid").rglob("*.TextGrid"))) == 4
    emos = json.loads((out / "emotions.json").read_text())
    assert set(emos["emotion_dict"]) == {"neu", "ang", "hap", "sad"}
    meta = [line for f in ("train.txt", "val.txt")
            for line in (out / f).read_text().splitlines() if line.strip()]
    assert len(meta) == 4
    # The features are filed under the dialog folder's name, which
    # speakers.json (from speaker_info.txt) does not hold: the port's
    # dataset reads the filelist's speaker there, where the JAX package's
    # raises KeyError.
    from expressive_fastspeech2_mandarin_tpu.data import (
        BucketedDataset as JaxBucketedDataset,
        PreprocessedCorpus as JaxCorpus,
    )
    from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
    from expressive_fastspeech2_mandarin_tpu_torch.data import (
        BucketedDataset,
        PreprocessedCorpus,
    )

    assert json.loads((out / "speakers.json").read_text()) == {"Ses01F": 0}
    assert {line.split("|")[1] for line in meta} == {"Ses01F_impro01"}
    ds = BucketedDataset(PreprocessedCorpus(str(out)), "train.txt", 1,
                         tcfg.BucketConfig(), 2000)
    assert len(ds) == 3 and {e.speaker_id for e in ds.examples} == {0}
    with pytest.raises(KeyError, match="Ses01F_impro01"):
        JaxBucketedDataset(JaxCorpus(str(out)), "train.txt", 1,
                           tcfg.BucketConfig(), 2000)
    # Every aligned phone is a letter the pinyin table holds.
    phones = {p for line in meta for p in line.split("|")[2].strip("{}")
              .split()}
    assert phones and phones <= set("abcdefghijklmnopqrstuvwxyz") | {"sp"}
