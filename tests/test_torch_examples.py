"""The port's example drivers (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU.

* Both corpus builders write the same bytes as JAX's (every wav, lab,
  TextGrid, filelist and speaker list).
* The port's ``Preprocessor(device="cpu")`` on a 24-utterance cut of the
  deep corpus agrees with JAX's ``Preprocessor(num_workers=1)`` within
  tests/test_torch_preprocess.py's bounds.
* ``build_config`` equals the JAX script's ``Config`` field by field (the
  JAX script's ``main`` run with its corpus, feature extraction and
  ``train`` stubbed, the ``Config`` it builds captured).
* One train step from ``train_state_from_jax`` on a batch of that corpus
  agrees with JAX's, within tests/test_torch_train.py's bounds, with its
  numpy dropout masks.
* ``synthesize_demo``'s IDs equal JAX's for the default text and the two
  probes; ``synthesize_demo`` runs on the CPU, and duration control 2.0
  doubles the mel length.
* ``convergence_deep.main`` runs 20 steps on the CPU at toy width (2
  layers, hidden 64) and writes a report with every check and the
  health verdict, raising nothing when that verdict is ``ok: false``.
* Every script raises without a card unless given ``--device cpu``.
"""

import copy
import dataclasses
import filecmp
import importlib.util
import json
import logging
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu import text as jtext
from expressive_fastspeech2_mandarin_tpu.models import FastSpeech2 as JaxFS2
from expressive_fastspeech2_mandarin_tpu.preprocess import (
    Preprocessor as JaxPreprocessor,
)
from expressive_fastspeech2_mandarin_tpu.train import (
    create_train_state as jax_create_train_state,
    make_optimizer,
    make_train_step,
)
from expressive_fastspeech2_mandarin_tpu.train import loop as jax_loop
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.cli import validate
from expressive_fastspeech2_mandarin_tpu_torch.data import (
    BucketedDataset,
    PreprocessedCorpus,
)
from expressive_fastspeech2_mandarin_tpu_torch.interop import (
    train_state_from_jax,
)
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import Preprocessor
from expressive_fastspeech2_mandarin_tpu_torch.train import (
    create_train_state,
    loss_and_grads,
    train_step,
)
from expressive_fastspeech2_mandarin_tpu_torch.train.loop import stage_batch
from expressive_fastspeech2_mandarin_tpu_torch.train.state import (
    load_checkpoint,
)
from examples_torch import (
    convergence_deep,
    convergence_demo,
    synthesize_demo,
    train_demo,
)

from .test_torch_preprocess import ENERGY_RTOL, MEL_ATOL, _npy, _read
from .test_torch_train import (
    LOSS_RTOL,
    _assert_grads,
    _assert_params,
    _jax_grads,
    _named_grads,
    _np,
    shared_masks,  # noqa: F401  (a fixture)
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CUT = 24      # utterances of the deep corpus in the cut (6 a speaker)
CUT_VAL = 4


def _load_jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_EXAMPLES = {name: _load_jax_example(name)
                for name in ("convergence_deep", "convergence_demo")}
PORT_EXAMPLES = {"convergence_deep": convergence_deep,
                 "convergence_demo": convergence_demo}


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("name", sorted(PORT_EXAMPLES))
def test_build_corpus_writes_jax_bytes(name, tmp_path):
    """The default corpus (480 and 120 utterances), file for file."""
    ours = PORT_EXAMPLES[name].build_corpus(str(tmp_path / "port"))
    ref = JAX_EXAMPLES[name].build_corpus(str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == [
        os.path.relpath(p, tmp_path / "jax") for p in ref]
    files = _files(tmp_path / "port")
    n = 480 if name == "convergence_deep" else 120
    assert files == _files(tmp_path / "jax")
    for kind in (".wav", ".lab", ".TextGrid"):
        assert sum(f.endswith(kind) for f in files) == n, kind
    assert {"raw_data/filelist.txt", "raw_data/speaker_info.txt"} <= set(
        files)
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", files, shallow=False)
    assert not mismatch and not errors, (mismatch[:5], errors[:5])


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The first 24 utterances of the deep corpus, features extracted by
    the JAX package (one worker) and by the port on the CPU."""
    root = tmp_path_factory.mktemp("cut")
    raw, pre = convergence_deep.build_corpus(str(root / "corpus"), CUT)
    out = {"raw": raw}
    for name in ("jax", "port"):
        out_dir = root / name
        shutil.copytree(os.path.join(pre, "TextGrid"), out_dir / "TextGrid")
        mod = jcfg if name == "jax" else tcfg
        cfg = mod.PreprocessConfig(
            path=mod.PathConfig(raw_path=raw,
                                preprocessed_path=str(out_dir)),
            val_size=CUT_VAL)
        if name == "jax":
            lines = JaxPreprocessor(cfg, num_workers=1).build_from_path()
        else:
            lines = Preprocessor(cfg, num_workers=1,
                                 device="cpu").build_from_path()
        out[name] = {"dir": str(out_dir), "lines": lines}
    return out


def test_preprocessor_on_the_cut_agrees_with_jax(cut):
    jax_dir, port_dir = cut["jax"]["dir"], cut["port"]["dir"]
    assert len(cut["port"]["lines"]) == CUT
    assert cut["port"]["lines"] == cut["jax"]["lines"]
    for name in ("train.txt", "val.txt", "speakers.json", "emotions.json"):
        assert _read(port_dir, name) == _read(jax_dir, name), name
    for kind in ("duration", "pitch"):
        ours, ref = _npy(port_dir, kind), _npy(jax_dir, kind)
        assert ours.keys() == ref.keys() and len(ours) == CUT
        for name, r in ref.items():
            assert ours[name].dtype == r.dtype
            np.testing.assert_array_equal(ours[name], r, err_msg=name)
    ours_mel, ref_mel = _npy(port_dir, "mel"), _npy(jax_dir, "mel")
    for name, r in ref_mel.items():
        assert ours_mel[name].shape == r.shape and r.shape[1] == 80
        np.testing.assert_allclose(ours_mel[name], r, rtol=0, atol=MEL_ATOL)
    ours_st = json.loads(_read(port_dir, "stats.json"))
    ref_st = json.loads(_read(jax_dir, "stats.json"))
    assert ours_st["pitch"] == ref_st["pitch"]
    np.testing.assert_allclose(ours_st["energy"][2:], ref_st["energy"][2:],
                               rtol=ENERGY_RTOL)
    ours_en, ref_en = _npy(port_dir, "energy"), _npy(jax_dir, "energy")
    for name, r in ref_en.items():  # de-normalized with each run's stats
        np.testing.assert_allclose(
            ours_en[name] * ours_st["energy"][3] + ours_st["energy"][2],
            r * ref_st["energy"][3] + ref_st["energy"][2], rtol=ENERGY_RTOL)


def _jax_script_config(name: str, tmp_path: Path, monkeypatch):
    """The ``Config`` the JAX script's ``main`` builds, captured at its
    ``train`` call, with its corpus and feature extraction stubbed."""
    mod = JAX_EXAMPLES[name]
    raw, pre = str(tmp_path / "raw_data"), str(tmp_path / "preprocessed")
    os.makedirs(pre)
    with open(os.path.join(pre, "train.txt"), "w"):
        pass  # the demo extracts features only without it

    class Captured(Exception):
        pass

    def capture(cfg, **kwargs):
        raise Captured(cfg)

    monkeypatch.setattr(mod, "build_corpus", lambda workdir: (raw, pre))
    if hasattr(mod, "preprocess"):
        monkeypatch.setattr(mod, "preprocess", lambda *args: None)
    monkeypatch.setattr(jax_loop, "train", capture)
    argv = [name, "--workdir", str(tmp_path)]
    if name == "convergence_deep":
        argv += ["--report-dir", str(tmp_path / "report")]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(Captured) as err:
        mod.main()
    return err.value.args[0], raw, pre


@pytest.mark.parametrize("name", sorted(PORT_EXAMPLES))
def test_build_config_equals_the_jax_scripts(name, tmp_path, monkeypatch):
    ref, raw, pre = _jax_script_config(name, tmp_path, monkeypatch)
    steps = 5000 if name == "convergence_deep" else 300
    ours = PORT_EXAMPLES[name].build_config(raw, pre, str(tmp_path), steps)
    assert tcfg.config_to_dict(ours) == jcfg.config_to_dict(ref)
    flash = PORT_EXAMPLES[name].build_config(raw, pre, str(tmp_path), steps,
                                             attention_impl="flash")
    assert flash.model.transformer.attention_impl == "flash"
    assert ours.model.transformer.attention_impl == "auto"
    if name == "convergence_deep":
        assert (ours.train.optimizer.batch_size, ours.train.steps_per_call,
                ours.model.transformer.encoder_hidden) == (16, 10, 256)


def _tiny(mod):
    """tests/test_torch_train.py's tiny model at the corpus's speaker and
    emotion counts, positions for its 128-frame bucket."""
    model = mod.ModelConfig(
        transformer=mod.TransformerConfig(
            encoder_layer=1, decoder_layer=1, encoder_hidden=32,
            decoder_hidden=32, conv_filter_size=64),
        variance_predictor=mod.VariancePredictorConfig(filter_size=32),
        n_speakers=4, n_emotions=3, n_arousals=3, n_valences=3,
        max_seq_len=256)
    return mod.Config(preprocess=mod.PreprocessConfig(), model=model,
                      train=mod.TrainConfig(optimizer=mod.OptimizerConfig(
                          warm_up_step=10)))


def test_train_step_on_the_corpus_matches_jax(cut, shared_masks):  # noqa: F811
    """One step from one init on the cut's first train batch (4 rows at
    the (16, 128) bucket): gradients 1e-4 · max|g|, the loss 1e-5
    relative, the updated parameters 1e-6."""
    jc, tc = _tiny(jcfg), _tiny(tcfg)
    ds = BucketedDataset(PreprocessedCorpus(cut["port"]["dir"]), "train.txt",
                         4, tcfg.BucketConfig(src_buckets=(16,),
                                              mel_buckets=(128,)), 256)
    batch = next(ds.epoch(0, shuffle=False))
    assert batch["texts"].shape == (4, 16) and batch["mels"].shape == (
        4, 128, 80)
    jmodel = JaxFS2(jc.model, jc.preprocess)
    params, bn = jmodel.init(jax.random.PRNGKey(0))
    tx = make_optimizer(jc.train.optimizer, 32)
    jstate = jax_create_train_state(params, bn, tx, jax.random.PRNGKey(1))
    state = create_train_state(tc, None, CPU)
    consts = {k: np.asarray(v) for k, v in jmodel.consts.items()}
    load_checkpoint(state, train_state_from_jax(
        _np(params), _np(bn), _np(jstate.opt_state), 0, consts=consts))
    shared_masks(tc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = _jax_grads(jmodel, jc, jstate.params, jstate.bn_state, jbatch)
    _, grads = loss_and_grads(copy.deepcopy(state.model),
                              stage_batch(batch, CPU), tc, state.generator)
    grads = _named_grads(state.model, grads)
    _assert_grads(grads, jgrads, jstate.bn_state)
    jstate, jrep = make_train_step(jmodel, tx, jc, donate=False)(jstate,
                                                                 jbatch)
    rep = train_step(state, stage_batch(batch, CPU), tc)
    np.testing.assert_allclose(float(rep.total), float(jrep.total),
                               rtol=LOSS_RTOL)
    _assert_params(state.model, jstate.params, jstate.bn_state, grads,
                   atol=1e-6)


@pytest.mark.parametrize("text,n_ids,missing", [
    ("今天天气真好", 16, 0),
    ("今天魑魅魍魉", 16, 0),   # every hanzi in both builtin tables
    ("今天龘靐", 6, 2),        # two hanzi without a reading
])
def test_synthesize_demo_ids_match_jax(text, n_ids, missing, caplog):
    with caplog.at_level(logging.WARNING):
        ids = synthesize_demo.phoneme_ids(text)
    warned = [r for r in caplog.records
              if r.name.startswith("expressive_fastspeech2_mandarin_tpu_"
                                   "torch.text")
              and "no pinyin reading" in r.getMessage()]
    assert ids == jtext.chinese_text_to_ids(text)
    assert len(ids) == n_ids and len(warned) == missing


def test_synthesize_demo_runs_on_cpu(tmp_path):
    """The default text at full width; duration control 2.0 doubles the
    mel length (the verify skill's probe); the wav is written."""
    runs = [synthesize_demo.main(["--device", "cpu", "--out",
                                  str(tmp_path / f"d{dc}.wav"),
                                  "--duration-control", str(dc)])
            for dc in (1.0, 2.0)]
    assert runs[0]["ids"] == jtext.chinese_text_to_ids("今天天气真好")
    assert 0 < runs[0]["mel_len"] and runs[1]["mel_len"] == (
        2 * runs[0]["mel_len"])
    for r in runs:
        assert np.isfinite(r["wav"]).all() and r["wav"].size == (
            r["mel_len"] * 256)
        # CPU tensors take the plain version: no kernel launch.
        assert r["mrf_launches"] == [0, 0]
    assert (tmp_path / "d1.0.wav").stat().st_size > 44


@pytest.mark.parametrize("module", [convergence_deep, convergence_demo,
                                    synthesize_demo, train_demo],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_scripts_raise_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ([] if module in (synthesize_demo, train_demo)
            else ["--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not any(tmp_path.iterdir())


def test_train_demo_loss_drops_on_cpu():
    out = train_demo.main(["--device", "cpu", "--steps", "8"])
    assert out["steps"] == 8
    assert out["final"]["total"] < out["first"]["total"]


def test_convergence_deep_main_on_cpu_at_toy_width(tmp_path, monkeypatch):
    """20 steps of the deep run at toy width on the 24-utterance cut, the
    health check forced to ``ok: false``: the report holds every check
    and the verdict, and nothing raises."""
    build_corpus, build_config = (convergence_deep.build_corpus,
                                  convergence_deep.build_config)

    def toy_config(*args, **kwargs):
        cfg = build_config(*args, **kwargs)
        t = dataclasses.replace(cfg.model.transformer, encoder_layer=2,
                                decoder_layer=2, encoder_hidden=64,
                                decoder_hidden=64, conv_filter_size=128)
        return dataclasses.replace(
            cfg,
            preprocess=dataclasses.replace(cfg.preprocess, val_size=CUT_VAL),
            model=dataclasses.replace(cfg.model, transformer=t),
            train=dataclasses.replace(cfg.train, step=dataclasses.replace(
                cfg.train.step, log_step=5)))

    real_validate = validate.validate_synth

    def failing_health(*args, **kwargs):
        return {**real_validate(*args, **kwargs), "ok": False}

    monkeypatch.setattr(convergence_deep, "build_corpus",
                        lambda workdir: build_corpus(workdir, CUT))
    monkeypatch.setattr(convergence_deep, "build_config", toy_config)
    monkeypatch.setattr(validate, "validate_synth", failing_health)
    report_dir = tmp_path / "report"
    out = convergence_deep.main(["--steps", "20", "--workdir",
                                 str(tmp_path / "work"), "--report-dir",
                                 str(report_dir), "--device", "cpu"])
    assert [r["step"] for r in out["records"]] == [10, 20]
    assert [v["step"] for v in out["vals"]] == [10, 20]
    assert all(np.isfinite(r["total_loss"]) for r in out["records"])
    assert out["health"]["ok"] is False
    report = (report_dir / "CONVERGENCE.md").read_text()
    for key in ("speaker_mel_l1", "emotion_mel_l1", "happy_frames",
                "sad_frames", "duration_control_lens",
                "duration_monotonic"):
        assert f'"{key}"' in report and key in out["checks"], key
    assert "ok = false" in report and "Device: CPU" in report
    for name in ("pred", "gt_reconstruction", "synth_happy", "synth_sad"):
        assert (report_dir / f"{name}.wav").stat().st_size > 44
    health = json.loads((report_dir / "synth_health.json").read_text())
    assert health["ok"] is False and len(health["files"]) == 4
    # The train loop's samples at steps 10 and 20 (synth_step 5).
    samples = tmp_path / "work" / "result" / "train_samples"
    assert (samples / "step20_mel.npy").exists()
