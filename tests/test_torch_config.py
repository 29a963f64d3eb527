"""The port's YAML reader against PyYAML's ``safe_load``, and its
``load_config`` against the JAX package's, on every shipped configuration:
equal values, key for key, with the speaker and emotion tables sized from
``speakers.json``/``emotions.json``; the TPU-only values still raise and
name their key."""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from expressive_fastspeech2_mandarin_tpu import config as jcfg
from expressive_fastspeech2_mandarin_tpu_torch import config as tcfg
from expressive_fastspeech2_mandarin_tpu_torch.parallel import make_layout
from expressive_fastspeech2_mandarin_tpu_torch.utils import yaml_reader

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted(glob.glob(str(ROOT / "configs" / "*" / "*.yaml")))
TRIPLETS = sorted(glob.glob(str(ROOT / "configs" / "*" / "train*.yaml")))


def test_every_shipped_configuration_is_found():
    assert len(YAMLS) >= 11 and len(TRIPLETS) == 5


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(
    p, ROOT / "configs"))
def test_reader_equals_safe_load_on_shipped_files(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = yaml_reader.load(path)
    assert got == ref
    assert repr(got) == repr(ref)  # the same types: 1 is not 1.0 or True


EDGE_CASES = [
    "a: 1e-4", "a: 1.0e-4", "a: 1.0e4", "a: 12e3", "a: 6.8523015e+5",
    "a: 0.000000001", "a: 1.", "a: .5", "a: .inf", "a: -.INF",
    "a: yes", "a: No", "a: On", "a: OFF", "a: y", "a: TRUE", "a: tRUE",
    "a: ~", "a: null", "a: Null", "a:", "a: # only a comment\nb: 2",
    "a: '12'", 'a: "1.5"', "a: 'yes'", "a: '~'", "a: 'it''s'",
    'a: "t\\tx \\"q\\""', "a: 017", "a: 0x1F", "a: 0b1010", "a: 0o17",
    "a: 1_000", "a: +12", "a: -0", "a: 1:30", "a: 190:20:30.15",
    "a: [1, 'x', 2.0, yes, ~]", "a: []", "a: [a,]", "a: [9, 1]  # k",
    "a: foo#bar", "a: x y  # c", "1: 2", "'k': v", "a: ./raw/ESD",
    "a:\n  b:\n    c: 3\n  d: x # c\n\n# end\n",
]


@pytest.mark.parametrize("text", EDGE_CASES)
def test_reader_resolves_scalars_as_safe_load(text):
    ref = yaml.safe_load(text)
    got = yaml_reader.loads(text)
    assert repr(got) == repr(ref), (got, ref)


OUTSIDE = [
    ("x:\n  - 1\n  - 2", 2), ("x:\n- 1", 2), ("a: {b: 1}", 1),
    ("a: &x 1", 1), ("a: *x", 1), ("a: !!str 1", 1), ("a: |\n  t\n", 1),
    ("a: >\n  t\n", 1), ("a: [1, [2]]", 1), ("a: [1,\n  2]", 1),
    ("a: 'x\n  y'", 1), ("a: b: c", 1), ("---\na: 1", 1), ("a: 1\n b: 2", 2),
    ("a:\n    b: 1\n  c: 2", 3), ("\ta: 1", 1), ("a: 1\nb:\n\tc: 2", 3),
    ("a: 'x' y", 1), ("a: 2001-12-14", 1), ("a: <<", 1), ("ok: 1\nbad", 2),
]


@pytest.mark.parametrize("text,line", OUTSIDE)
def test_reader_raises_with_the_line_outside_its_subset(text, line):
    with pytest.raises(ValueError, match=f"^line {line}:"):
        yaml_reader.loads(text)


def test_reader_never_imports_yaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from expressive_fastspeech2_mandarin_tpu_torch.config import "
            "load_config\n"
            "import glob\n"
            "for t in sorted(glob.glob('configs/*/train*.yaml')):\n"
            "    d = t.rsplit('/', 1)[0]\n"
            "    load_config(d + '/preprocess.yaml', d + '/model.yaml', t)\n"
            "print('LOADED', sys.modules['yaml'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED None" in out.stdout
    source = (ROOT / "expressive_fastspeech2_mandarin_tpu_torch" / "utils" /
              "yaml_reader.py").read_text()
    assert "import yaml" not in source


def _with_corpus(tmp_path: Path, triplet: str) -> tuple[str, str, str]:
    """The triplet with its preprocessed_path moved to a directory that
    holds speakers.json and emotions.json."""
    d = os.path.dirname(triplet)
    pre = tmp_path / "pre"
    pre.mkdir()
    (pre / "speakers.json").write_text(json.dumps(
        {f"{i:04d}": i for i in range(7)}))
    (pre / "emotions.json").write_text(json.dumps({
        "emotion_dict": {e: i for i, e in enumerate("ABCDEFGH")},
        "arousal_dict": {"0.1": 0, "0.5": 1, "0.9": 2},
        "valence_dict": {"0.2": 0, "0.8": 1}}))
    text = Path(d, "preprocess.yaml").read_text()
    old = yaml.safe_load(text)["path"]["preprocessed_path"]
    p = tmp_path / "preprocess.yaml"
    p.write_text(text.replace(f'"{old}"', f'"{pre}"'))
    return str(p), os.path.join(d, "model.yaml"), triplet


@pytest.mark.parametrize("triplet", TRIPLETS, ids=lambda p: os.path.relpath(
    p, ROOT / "configs"))
def test_load_config_equals_jax(triplet, tmp_path):
    d = os.path.dirname(triplet)
    plain = (os.path.join(d, "preprocess.yaml"), os.path.join(d, "model.yaml"),
             triplet)
    assert (tcfg.config_to_dict(tcfg.load_config(*plain))
            == jcfg.config_to_dict(jcfg.load_config(*plain)))
    sized = _with_corpus(tmp_path, triplet)
    ours = tcfg.config_to_dict(tcfg.load_config(*sized))
    assert ours == jcfg.config_to_dict(jcfg.load_config(*sized))
    assert (ours["model"]["n_speakers"], ours["model"]["n_emotions"],
            ours["model"]["n_arousals"], ours["model"]["n_valences"]) == (
        7, 8, 3, 2)


@pytest.mark.parametrize("extra,key", [
    ("matmul_precision: highest", "matmul_precision"),
    ("vocoder_train:\n  steps_per_call: 10", "vocoder_train.steps_per_call"),
    ("vocoder_train:\n  packed_generator: true",
     "vocoder_train.packed_generator"),
])
def test_tpu_only_values_in_yaml_raise_naming_the_key(extra, key, tmp_path):
    """The JAX settings that once meant something only on a TPU: the port
    loads each of these as the JAX package does, to the same values (the
    test's name is the one it had when the port refused them)."""
    d = os.path.dirname(TRIPLETS[0])
    t = tmp_path / "train.yaml"
    t.write_text(Path(TRIPLETS[0]).read_text() + "\n" + extra + "\n")
    files = (os.path.join(d, "preprocess.yaml"),
             os.path.join(d, "model.yaml"), str(t))
    ref = jcfg.config_to_dict(jcfg.load_config(*files))
    ours = tcfg.config_to_dict(tcfg.load_config(*files))
    assert ours == ref
    section, _, name = key.rpartition(".")
    value = (ours[section or "train"][name])
    assert value == {"matmul_precision": "highest",
                     "vocoder_train.steps_per_call": 10,
                     "vocoder_train.packed_generator": True}[key]


@pytest.mark.parametrize("kwargs,key", [
    (dict(mesh=tcfg.MeshConfig(model_parallel_size=2)),
     "mesh.model_parallel_size"),
    (dict(profile_start_step=5), "profile_start_step"),
])
def test_tpu_only_train_fields_raise_naming_the_key(kwargs, key):
    """Both are taken (the test's name is the one it had when the port
    refused them): the profiler window (``train.loop.ProfileWindow``), and
    the model-parallel mesh, which lays out the training processes; a
    size that does not divide the world (here one process) raises, naming
    the key."""
    if key == "mesh.model_parallel_size":
        cfg = tcfg.TrainConfig(**kwargs)
        assert cfg.mesh.model_parallel_size == 2
        with pytest.raises(ValueError, match=f"{key}=2 does not divide"):
            make_layout(cfg.mesh.model_parallel_size)
    else:
        assert tcfg.TrainConfig(**kwargs).profile_start_step == 5


@pytest.mark.parametrize("value", ["default", "highest", "float32", "high",
                                   "tensorfloat32", "bfloat16",
                                   "bfloat16_3x"])
def test_matmul_precision_takes_jax_names(value):
    assert tcfg.TrainConfig(matmul_precision=value).matmul_precision == value


def test_matmul_precision_unknown_name_raises():
    with pytest.raises(ValueError, match="matmul_precision must be one of"):
        tcfg.TrainConfig(matmul_precision="fastest")

def test_profiler_window_reads_from_train_yaml(tmp_path):
    """train.yaml's profile_start_step/profile_stop_step reach TrainConfig
    (the JAX package takes the window from Python only: its loader drops
    them); every other field loads as in JAX."""
    d = os.path.dirname(TRIPLETS[0])
    t = tmp_path / "train.yaml"
    t.write_text(Path(TRIPLETS[0]).read_text()
                 + "\nprofile_start_step: 3\nprofile_stop_step: 5\n")
    files = (os.path.join(d, "preprocess.yaml"),
             os.path.join(d, "model.yaml"), str(t))
    ours = tcfg.load_config(*files)
    assert (ours.train.profile_start_step, ours.train.profile_stop_step) == (
        3, 5)
    ref = jcfg.config_to_dict(jcfg.load_config(*files))
    assert (ref["train"]["profile_start_step"],
            ref["train"]["profile_stop_step"]) == (-1, -1)
    mine = tcfg.config_to_dict(ours)
    mine["train"].update(profile_start_step=-1, profile_stop_step=-1)
    assert mine == ref
