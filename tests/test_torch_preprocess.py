"""The port's feature extraction against the JAX package's, on the CPU:
TextGrid I/O, ``get_alignment``, the three array helpers, ``estimate_f0``
(both on the numpy backend), ``Preprocessor.build_from_path``,
``prepare_esd``, the custom symbol tables, ``ids_to_phonemes`` and
``ipa_harvest``.

The corpus is tests/port_corpus.py's: tests/test_pipeline.py's 2 speakers
× 6 utterances with an empty gap mark (kept), a silent utterance and an
all-silence tier (both rejected).

Bounds: what is computed in numpy in both packages is equal (metadata,
speakers, emotions, durations, pitch, F0 within rtol 1e-12); the mel STFT
(torch against JAX FFTs) within tests/test_torch_dsp.py's ``mel_energy``
bounds, log-mel atol 1e-4 and energy rtol 1e-4 (energy compared
de-normalized with each run's own stats); WAVs within one int16 step.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu import text as jtext
from expressive_fastspeech2_mandarin_tpu.data import (
    BucketedDataset as JaxBucketedDataset,
    PreprocessedCorpus as JaxCorpus,
)
from expressive_fastspeech2_mandarin_tpu.dsp import pitch as jpitch
from expressive_fastspeech2_mandarin_tpu.preprocess import (
    Preprocessor as JaxPreprocessor,
    esd as jesd,
    ipa_harvest as jharvest,
    preprocessor as jpre,
    textgrid as jtg,
)
from expressive_fastspeech2_mandarin_tpu.text import symbols as jsymbols
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch import text as ttext
from expressive_fastspeech2_mandarin_tpu_torch.data import (
    BucketedDataset,
    PreprocessedCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch.dsp import pitch as tpitch
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import (
    Preprocessor,
    esd as tesd,
    ipa_harvest as tharvest,
    preprocessor as tpre,
    textgrid as ttg,
)
from expressive_fastspeech2_mandarin_tpu_torch.text import symbols as tsymbols

from .port_corpus import preprocess_config, write_pipeline_corpus

torch.set_num_threads(2)
MEL_ATOL = 1e-4
ENERGY_RTOL = 1e-4
KINDS = ("duration", "pitch", "energy", "mel")
DTYPES = {"duration": np.int64, "pitch": np.float64, "energy": np.float32,
          "mel": np.float32}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The corpus built by the JAX package (one worker) and by the port on
    the CPU with one worker and with a pool of two."""
    root = tmp_path_factory.mktemp("preprocess")
    raw, tg_root = write_pipeline_corpus(root)
    out = {}
    for name in ("jax", "port", "port_pool"):
        pre = root / name
        shutil.copytree(tg_root, pre / "TextGrid")
        if name == "jax":
            lines = JaxPreprocessor(preprocess_config(jcfg, raw, pre),
                                    num_workers=1).build_from_path()
            timings = None
        else:
            p = Preprocessor(preprocess_config(tcfg, raw, pre),
                             num_workers=1 if name == "port" else 2,
                             device="cpu")
            lines = p.build_from_path()
            timings = p.timings
        out[name] = {"dir": str(pre), "lines": lines, "timings": timings}
    out["raw"] = str(raw)
    return out


def _npy(d, kind):
    folder = os.path.join(d, kind)
    return {n: np.load(os.path.join(folder, n))
            for n in sorted(os.listdir(folder))}


def _read(d, name):
    with open(os.path.join(d, name), encoding="utf-8") as f:
        return f.read()


def test_preprocessor_metadata_durations_and_pitch_equal_jax(built):
    jax_dir, port_dir = built["jax"]["dir"], built["port"]["dir"]
    assert len(built["port"]["lines"]) == 13  # 12 + the gap; 2 rejected
    assert built["port"]["lines"] == built["jax"]["lines"]
    for name in ("train.txt", "val.txt", "speakers.json", "emotions.json"):
        assert _read(port_dir, name) == _read(jax_dir, name), name
    gap = [ln for ln in built["port"]["lines"]
           if ln.startswith("0001_000006|")]
    assert gap[0].split("|")[2] == "{b a sp n h ao}"
    for kind in ("duration", "pitch"):
        ours, ref = _npy(port_dir, kind), _npy(jax_dir, kind)
        assert ours.keys() == ref.keys() and len(ours) == 13
        for name, r in ref.items():
            assert ours[name].dtype == r.dtype == DTYPES[kind]
            np.testing.assert_array_equal(ours[name], r, err_msg=name)
    ours = json.loads(_read(port_dir, "stats.json"))
    ref = json.loads(_read(jax_dir, "stats.json"))
    assert ours["pitch"] == ref["pitch"]


def test_preprocessor_mel_energy_and_stats_within_dsp_bounds(built):
    jax_dir, port_dir = built["jax"]["dir"], built["port"]["dir"]
    ours_mel, ref_mel = _npy(port_dir, "mel"), _npy(jax_dir, "mel")
    assert ours_mel.keys() == ref_mel.keys()
    for name, r in ref_mel.items():
        assert ours_mel[name].dtype == r.dtype == np.float32
        assert ours_mel[name].shape == r.shape and r.shape[1] == 80
        np.testing.assert_allclose(ours_mel[name], r, rtol=0, atol=MEL_ATOL)
    ours_st = json.loads(_read(port_dir, "stats.json"))["energy"]
    ref_st = json.loads(_read(jax_dir, "stats.json"))["energy"]
    np.testing.assert_allclose(ours_st[2:], ref_st[2:], rtol=ENERGY_RTOL)

    def raw(values, st):  # de-normalized with the run's own mean and std
        return np.asarray(values, np.float64) * st[3] + st[2]

    np.testing.assert_allclose(raw(ours_st[:2], ours_st),
                               raw(ref_st[:2], ref_st), rtol=ENERGY_RTOL)
    ours_en, ref_en = _npy(port_dir, "energy"), _npy(jax_dir, "energy")
    for name, r in ref_en.items():
        assert ours_en[name].dtype == r.dtype == np.float32
        np.testing.assert_allclose(raw(ours_en[name], ours_st),
                                   raw(r, ref_st), rtol=ENERGY_RTOL)


def test_preprocessor_pool_gives_identical_outputs(built):
    """Two spawn workers (14 jobs > 8: the pool path) against one: the
    same job order, so the same shuffle, and the same arrays."""
    one, pool = built["port"], built["port_pool"]
    assert pool["lines"] == one["lines"]
    for name in ("train.txt", "val.txt", "speakers.json", "emotions.json",
                 "stats.json"):
        assert _read(pool["dir"], name) == _read(one["dir"], name), name
    for kind in KINDS:
        a, b = _npy(pool["dir"], kind), _npy(one["dir"], kind)
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])
    t = pool["timings"]
    assert 0 < t["first_s"] < t["extract_s"]
    assert 0 < t["mel_s"] < t["extract_s"]
    # The 13 kept utterances, trimmed to their phones.
    assert abs(t["audio_s"] - 8.95) < 1e-3


def test_preprocessor_needs_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Preprocessor(preprocess_config(tcfg, tmp_path, tmp_path))


def test_worker_hides_the_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    tpre._hide_card()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_textgrid_files_read_across_packages(tmp_path):
    """Port-written files read back in JAX and the other way round, with a
    quoted mark, an empty mark and IPA; and the short text format."""
    marks = [(0.0, 0.12, "sil"), (0.12, 0.3, 'a "quoted"'), (0.3, 0.31, ""),
             (0.31, 0.5, "ʂ˥˩"), (0.5, 0.61, "sp")]
    for writer, reader in ((ttg, jtg), (jtg, ttg)):
        tg = writer.TextGrid(0.0, 0.61, [
            writer.Tier("phones", [writer.Interval(*m) for m in marks]),
            writer.Tier("words", [writer.Interval(0.0, 0.61, "ban")])])
        path = str(tmp_path / f"{writer.__name__}.TextGrid")
        writer.write_textgrid(tg, path)
        back = reader.read_textgrid(path)
        assert [t.name for t in back.tiers] == ["phones", "words"]
        got = [(iv.start, iv.end, iv.text)
               for iv in back.get_tier_by_name("phones").intervals]
        assert got == [(pytest.approx(s, abs=1e-6), pytest.approx(e, abs=1e-6),
                        p) for s, e, p in marks]
    short = ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n0\n1.5\n'
             '<exists>\n2\n"TextTier"\n"points"\n0\n1.5\n1\n0.7\n"mark"\n'
             '"IntervalTier"\n"phones"\n0\n1.5\n2\n0\n0.5\n""\n0.5\n1.5\n'
             '"b ""x"""\n')
    ours, ref = ttg.parse_textgrid(short), jtg.parse_textgrid(short)
    assert [(t.name, [(i.start, i.end, i.text) for i in t.intervals])
            for t in ours.tiers] == [
        (t.name, [(i.start, i.end, i.text) for i in t.intervals])
        for t in ref.tiers]
    assert ours.tiers[1].intervals[1].text == 'b "x"'


def _same_alignment(tier_marks, sr, hop):
    ours = tpre.get_alignment(ttg.Tier("phones", [
        ttg.Interval(*m) for m in tier_marks]), sr, hop)
    ref = jpre.get_alignment(jtg.Tier("phones", [
        jtg.Interval(*m) for m in tier_marks]), sr, hop)
    assert (ours.phones, ours.durations, ours.start, ours.end) == (
        ref.phones, ref.durations, ref.start, ref.end)
    return ours


def test_get_alignment_matches_jax():
    """tests/test_ipa_harvest.py's gap-mark case, then seeded random tiers
    (silences, empty marks and phones) with boundaries on half frames,
    where round-half-to-even decides, and off them."""
    marks = [(0.1 * i, 0.1 * (i + 1), p) for i, p in
             enumerate(["sil", "b", "", "a", "sil", ""])]
    got = _same_alignment(marks, 16000, 200)
    assert got.phones == ["b", "sp", "a"] and len(got.durations) == 3
    rng = np.random.default_rng(0)
    pool = ["sil", "sp", "spn", "", "b", "a", "n", "zh"]
    half_hits = 0
    for trial in range(200):
        sr, hop = [(22050, 256), (16000, 200)][trial % 2]
        n = int(rng.integers(1, 12))
        if trial % 4 < 2:  # half-frame boundaries
            edges = (np.cumsum(rng.integers(1, 30, n + 1)) + 0.5) * hop / sr
            half_hits += int(np.sum(np.round(edges * sr / hop) % 2 == 0))
        else:
            edges = np.cumsum(rng.uniform(0.005, 0.3, n + 1))
        marks = [(float(edges[i]), float(edges[i + 1]),
                  pool[int(rng.integers(0, len(pool)))]) for i in range(n)]
        _same_alignment(marks, sr, hop)
    assert half_hits > 0


def test_array_helpers_match_jax():
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.normal(0, 1, 200), [40.0, -35.0]])
    for v in (vals, np.array([]), vals.astype(np.float32)):
        ours, ref = tpre.remove_outlier(v), jpre.remove_outlier(v)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    pitch = np.where(rng.random(60) < 0.4, 0.0, rng.uniform(80, 300, 60))
    pitch[:3] = pitch[-2:] = 0.0
    for p in (pitch, np.zeros(7)):
        np.testing.assert_array_equal(tpre.interpolate_unvoiced(p),
                                      jpre.interpolate_unvoiced(p))
    durations = [3, 0, 5, 1, 0, 7, 4]
    for v in (rng.normal(size=20), rng.normal(size=12).astype(np.float32)):
        ours = tpre.phoneme_average(v, durations)
        ref = jpre.phoneme_average(v, durations)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_estimate_f0_matches_jax(monkeypatch):
    """Harmonic with vibrato, silent, noisy and pure noise, at both
    corpus rates; both packages on the numpy backend."""
    monkeypatch.setenv("EFS2_PITCH_BACKEND", "numpy")
    for mod in (tpitch, jpitch):
        mod._native_lib.cache_clear()
    try:
        assert tpitch.pitch_backend() == "numpy"
        rng = np.random.default_rng(2)
        for sr, hop in ((22050, 256), (16000, 200)):
            t = np.arange(int(0.8 * sr)) / sr
            f0 = 170 * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            harmonic = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.3
            for x in (harmonic, np.zeros_like(t),
                      harmonic + 0.3 * rng.standard_normal(len(t)),
                      0.2 * rng.standard_normal(len(t))):
                ours = tpitch.estimate_f0(x, sr, hop)
                ref = jpitch.estimate_f0(x, sr, hop)
                assert ours.shape == ref.shape
                np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
        assert (tpitch.estimate_f0(harmonic, sr, hop) > 0).mean() > 0.9
    finally:
        for mod in (tpitch, jpitch):
            mod._native_lib.cache_clear()


def _esd_tree(root):
    rng = np.random.default_rng(3)
    texts = ["今天天气真好", "我们明天见", "你好世界", "他说这个很好看",
             "谢谢大家", "我爱你们"]
    for s, speaker in enumerate(["0001", "0002"]):
        lines = []
        for e, emotion in enumerate(["Happy", "Neutral"]):
            os.makedirs(root / speaker / emotion)
            for k in range(3):
                base = f"{speaker}_{e * 3 + k:06d}"
                n = int(16000 * rng.uniform(0.3, 0.6))
                wav = (0.3 * np.sin(2 * np.pi * (120 + 30 * k) * np.arange(n)
                                    / 16000) + 0.05 * rng.standard_normal(n))
                wavfile.write(str(root / speaker / emotion / f"{base}.wav"),
                              16000, (wav * 20000).astype(np.int16))
                label = emotion if k else ("中立" if e else "")
                lines.append(f"{base}\t{texts[(s + e + k) % 6]}\t{label}")
        with open(root / speaker / f"{speaker}.txt", "w",
                  encoding="utf-8-sig") as f:
            f.write("\n".join(lines) + "\n")


def test_prepare_esd_matches_jax(tmp_path):
    _esd_tree(tmp_path / "esd")
    for mod, name in ((tesd, "port"), (jesd, "jax")):
        mod.prepare_esd(str(tmp_path / "esd"), str(tmp_path / name),
                        val_per_speaker_emotion=1,
                        test_per_speaker_emotion=1, seed=5)
    ours, ref = tmp_path / "port", tmp_path / "jax"
    utts = [u.basename for u in tesd.discover_esd(str(tmp_path / "esd"))]
    assert utts == [u.basename for u in jesd.discover_esd(
        str(tmp_path / "esd"))] and len(utts) == 12
    names = ["filelist.txt", "filelist_train.txt", "filelist_val.txt",
             "filelist_test.txt", "speaker_info.txt"]
    names += [f"{b[:4]}/{b}.lab" for b in utts]
    for name in names:
        assert filecmp.cmp(ours / name, ref / name, shallow=False), name
    assert "wo men ming tian jian" in _read(ours, "filelist.txt")
    for b in utts:
        sr_o, a = wavfile.read(ours / b[:4] / f"{b}.wav")
        sr_r, r = wavfile.read(ref / b[:4] / f"{b}.wav")
        assert sr_o == sr_r == 22050 and a.dtype == r.dtype == np.int16
        assert a.shape == r.shape
        assert np.abs(a.astype(np.int32) - r).max() <= 1
    assert tesd.text_to_lab("今天天气真好") == jesd.text_to_lab("今天天气真好")


def _gap_textgrids(root):
    """tests/test_ipa_harvest.py's three TextGrids."""
    for spk, name, phones in (("0001", "a", ["", "tɕ˥˩", "a˧˥", "", "n"]),
                              ("0001", "b", ["a˧˥", "ʂ", "n"]),
                              ("0002", "c", ["n", "a˧˥"])):
        os.makedirs(root / spk, exist_ok=True)
        ttg.write_textgrid(ttg.TextGrid(0.0, 0.1 * len(phones), [ttg.Tier(
            "phones", [ttg.Interval(0.1 * i, 0.1 * (i + 1), p)
                       for i, p in enumerate(phones)])]),
            str(root / spk / f"{name}.TextGrid"))


def test_ipa_harvest_matches_jax(tmp_path):
    root = tmp_path / "tg"
    _gap_textgrids(root)
    counts = tharvest.harvest_phones(str(root))
    assert counts == jharvest.harvest_phones(str(root))
    assert counts["sp"] == 2 and "" not in counts
    for mod, name in ((tharvest, "port"), (jharvest, "jax")):
        data = mod.write_inventory(counts, str(tmp_path / f"{name}.json"),
                                   name="harvest-cmp")
        assert data["phonemes"] == sorted(counts)
    assert _read(tmp_path, "port.json") == _read(tmp_path, "jax.json")
    for spk, name in (("0001", "a"), ("0001", "b"), ("0002", "c")):
        path = str(root / spk / f"{name}.TextGrid")
        assert tharvest.textgrid_phones(path) == jharvest.textgrid_phones(path)
    meta = tmp_path / "train.txt"
    meta.write_text("a|0001|{x y}|raw|0001|text|Happy|0.7|0.8\n"
                    "missing|0001|{x}|raw|0001|text|Sad|0.2|0.3\n"
                    "c|0002|{x}|raw|0002|text|Angry|0.9|0.1\n")
    for mod, name in ((tharvest, "port"), (jharvest, "jax")):
        assert mod.reencode_metadata(str(meta), str(root),
                                     str(tmp_path / f"{name}.txt")) == (2, 1)
    assert _read(tmp_path, "port.txt") == _read(tmp_path, "jax.txt")
    assert "{@tɕ˥˩ @a˧˥ @sp @n}" in _read(tmp_path, "port.txt")


def test_symbol_tables_match_jax(tmp_path):
    root = tmp_path / "tg"
    _gap_textgrids(root)
    inv = str(tmp_path / "inv.json")
    jharvest.write_inventory(jharvest.harvest_phones(str(root)), inv,
                             name="harvest-load")
    assert tsymbols.load_symbol_table(inv) == jsymbols.load_symbol_table(
        inv) == "harvest-load"
    assert (tsymbols.get_symbol_table("harvest-load")
            == jsymbols.get_symbol_table("harvest-load"))
    assert tsymbols.load_symbol_table(inv, name="other") == "other"
    # A path names a table: loaded on first use, registered under the path.
    auto = str(tmp_path / "auto.json")
    shutil.copy(inv, auto)
    assert tsymbols.get_symbols(auto) == jsymbols.get_symbols(auto)
    assert tsymbols.get_symbol_table(auto) == jsymbols.get_symbol_table(auto)
    assert tsymbols.get_symbols(auto)[tsymbols.PAD_ID] == tsymbols.PAD
    assert (tsymbols.build_symbol_list(["b", "@a", "b"])
            == jsymbols.build_symbol_list(["b", "@a", "b"]))
    assert (tsymbols.PAD_ID, tsymbols.UNK_ID, tsymbols.BOS_ID,
            tsymbols.EOS_ID) == (0, 1, 2, 3)
    assert tsymbols.ID_TO_PINYIN == jsymbols.ID_TO_PINYIN
    assert tsymbols.ID_TO_IPA == jsymbols.ID_TO_IPA
    ids = ttext.phonemes_to_ids(["@a˧˥", "@n", "@sp", "@zz"], table=auto)
    assert ids == jtext.phonemes_to_ids(["@a˧˥", "@n", "@sp", "@zz"],
                                        table=auto) and len(ids) == 3
    for name in ("pinyin", "ipa"):
        with pytest.raises(ValueError, match="builtin"):
            tsymbols.register_symbol_table(name, ["a"])
    with pytest.raises(ValueError, match="unknown symbol inventory"):
        tsymbols.get_symbol_table(str(tmp_path / "absent.json"))


def test_ids_to_phonemes_matches_jax():
    ids = list(np.random.default_rng(4).integers(0, 160, 50))
    ids = [int(i) for i in ids]
    for table in ("pinyin", "ipa"):
        assert ttext.ids_to_phonemes(ids, table) == jtext.ids_to_phonemes(
            ids, table)


def test_corpus_with_a_harvested_table_reads_as_in_jax(built):
    """The port-built corpus, its phones harvested and its metadata
    re-encoded with ``@`` phones: both packages' datasets give the same
    batches under the inventory's path, and no phone is dropped."""
    pre = built["port"]["dir"]
    tg_root = os.path.join(pre, "TextGrid")
    inv = os.path.join(pre, "inventory.json")
    tharvest.write_inventory(tharvest.harvest_phones(tg_root), inv)
    assert tharvest.reencode_metadata(
        os.path.join(pre, "train.txt"), tg_root,
        os.path.join(pre, "train_ipa.txt")) == (11, 0)
    buckets = tcfg.BucketConfig(src_buckets=(8, 16), mel_buckets=(128, 256))
    ours = BucketedDataset(PreprocessedCorpus(pre), "train_ipa.txt", 2,
                           buckets, symbol_table=inv)
    ref = JaxBucketedDataset(JaxCorpus(pre), "train_ipa.txt", 2,
                             jcfg.BucketConfig(src_buckets=(8, 16),
                                               mel_buckets=(128, 256)),
                             symbol_table=inv)
    n = 0
    for a, b in zip(ours.epoch(0), ref.epoch(0), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["texts"] > 0).sum(axis=1).tolist() == a["src_lens"].tolist()
        n += 1
    assert n == 6
    utt = PreprocessedCorpus(pre).metadata("train_ipa.txt")[0]
    assert len(utt.phone_ids(inv)) == len(
        PreprocessedCorpus(pre).duration(utt))


def test_process_utterance_matches_jax(tmp_path):
    """One utterance through ``process_utterance`` (its four arrays saved
    before normalization, the metadata line, the outlier-trimmed values):
    the gap utterance kept, the silent one rejected."""
    raw, tg_root = write_pipeline_corpus(tmp_path)
    preps = {}
    for name, mod, cls, kw in (("port", tcfg, Preprocessor, {"device": "cpu"}),
                               ("jax", jcfg, JaxPreprocessor, {})):
        pre = tmp_path / name
        shutil.copytree(tg_root, pre / "TextGrid")
        for kind in KINDS:
            os.makedirs(pre / kind)
        preps[name] = cls(preprocess_config(mod, raw, pre), num_workers=1,
                          **kw)
    assert preps["port"].process_utterance("0002", "0002_000006") is None
    ours = preps["port"].process_utterance("0001", "0001_000006")
    ref = preps["jax"].process_utterance("0001", "0001_000006")
    assert ours[0] == ref[0] and ours[3] == ref[3]
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=ENERGY_RTOL)
    for kind in ("duration", "pitch"):
        name = f"0001-{kind}-0001_000006.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "port" / kind / name),
                                      np.load(tmp_path / "jax" / kind / name))
