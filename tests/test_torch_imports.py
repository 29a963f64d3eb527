"""The PyTorch port (its package, ``chip_smoke.py`` and the example
drivers of ``examples_torch/``) imports neither JAX nor the JAX package,
nor names its dotted module path in a string (a subprocess's ``-m``
target, say); the
feature extractor's pool workers never touch CUDA; every port command line
offers each option of its JAX counterpart."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "expressive_fastspeech2_mandarin_tpu_torch"
EXAMPLES = ROOT / "examples_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import expressive_fastspeech2_mandarin_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
import examples_torch
for m in pkgutil.iter_modules(examples_torch.__path__, "examples_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib",
                                    "expressive_fastspeech2_mandarin_tpu"))
print("FORBIDDEN", bad)
"""

_IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.MULTILINE)


def test_port_import_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def _port_files() -> list[Path]:
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted(EXAMPLES.glob("*.py")))


def test_port_sources_name_no_jax_module():
    files = _port_files()
    assert len(files) > 10
    assert {p.name for p in EXAMPLES.glob("*.py")} >= {
        "convergence_deep.py", "convergence_demo.py", "train_demo.py",
        "synthesize_demo.py"}
    for path in files:
        for name in _IMPORT_RE.findall(path.read_text()):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "expressive_fastspeech2_mandarin_tpu"), (
                f"{path.relative_to(ROOT)} imports {name}")


_JAX_DOTTED = re.compile(r"expressive_fastspeech2_mandarin_tpu\.[\w.]*")


def test_port_sources_name_no_jax_module_path_in_strings():
    """``expressive_fastspeech2_mandarin_tpu.`` (the JAX package's dotted
    path; the port's own is ``..._tpu_torch.``) appears nowhere in the
    port's sources, chip_smoke.py or examples_torch/, in code, strings or
    comments."""
    files = _port_files()
    found = [(str(p.relative_to(ROOT)), m)
             for p in files for m in _JAX_DOTTED.findall(p.read_text())]
    assert not found, found
    assert _JAX_DOTTED.search("expressive_fastspeech2_mandarin_tpu.cli.x")
    assert not _JAX_DOTTED.search("expressive_fastspeech2_mandarin_tpu_torch"
                                  ".cli.preprocess")


CLIS = {"align": [[]], "evaluate": [[]], "ipa": [["harvest"], ["reencode"]],
        "pipeline": [[]], "preprocess": [["features"], ["esd"], ["resample"]],
        "synthesize": [[]], "train": [[]], "train_vocoder": [[]],
        "validate": [["textgrids"], ["data"], ["checkpoint"], ["vocoder"],
                     ["synth"]]}

# Runs each JAX CLI's main() on --help in one process (they exit before
# they import jax) and prints {"<cli> <sub>": help text}.
_JAX_HELPS = """
import contextlib, importlib, io, json, sys
clis = json.loads(sys.argv[1])
out = {}
for name, subs in clis.items():
    mod = importlib.import_module(
        "expressive_fastspeech2_mandarin_tpu.cli." + name)
    for sub in subs:
        sys.argv = [name, *sub, "--help"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                mod.main()
            except SystemExit:
                pass
        out[" ".join([name, *sub])] = buf.getvalue()
print(json.dumps(out))
"""
_OPTION = re.compile(r"(?<![\w-])(--?[A-Za-z][\w-]*)")


def _options(help_text: str) -> set[str]:
    return set(_OPTION.findall(help_text.split("options:", 1)[-1]))


def test_every_port_cli_offers_the_jax_clis_options():
    import contextlib
    import importlib
    import io
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _JAX_HELPS,
                          json.dumps(CLIS)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    jax_helps = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(jax_helps) == sum(len(v) for v in CLIS.values())
    for name, subs in CLIS.items():
        mod = importlib.import_module(
            f"expressive_fastspeech2_mandarin_tpu_torch.cli.{name}")
        for sub in subs:
            key = " ".join([name, *sub])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
                mod.main([*sub, "--help"])
            ref = _options(jax_helps[key])
            assert len(ref) >= 2, key
            missing = ref - _options(buf.getvalue())
            assert not missing, (key, missing)


def test_walk_covers_every_slice_module():
    """The import check above walks these modules of every slice."""
    import pkgutil

    import expressive_fastspeech2_mandarin_tpu_torch as port

    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")}
    for mod in ("ops.mrf_resblock", "ops.flash_mha", "ops.attention",
                "synth.synthesizer", "synth.streaming", "interop.from_jax",
                "interop.torch_ckpt", "data.metadata", "kernels.build",
                "ops.dropout", "data.dataset", "train.loss",
                "train.schedule", "train.state", "train.step", "train.loop",
                "utils.logging", "dsp.mel", "dsp.stft", "utils.wav",
                "models.melgan", "models.hifigan_disc", "models.layers",
                "train.vocoder", "train.sampling", "dsp.pitch",
                "preprocess.textgrid", "preprocess.preprocessor",
                "preprocess.esd", "preprocess.ipa_harvest",
                "utils.yaml_reader", "dsp.quality", "align", "cli.common",
                "cli.align", "cli.evaluate", "cli.ipa", "cli.pipeline",
                "cli.preprocess", "cli.synthesize", "cli.train",
                "cli.train_vocoder", "cli.validate", "text.cleaners",
                "text.numbers_en", "text.english", "text.korean",
                "text.normalizer_zh", "text.lexicon", "preprocess.iemocap",
                "preprocess.aihub_mmv", "utils.plotting", "parallel",
                "parallel.mesh", "graphs"):
        assert f"{port.__name__}.{mod}" in names, mod


# The JAX package's modules without a module of the same path in the
# port: JAX parameter init (the port's nn.Modules and interop.from_jax
# stand in for it) and the Pallas kernels (ported as csrc/*.cu behind
# ops.mrf_resblock and ops.flash_mha). The multi-process mesh is ported
# (parallel.mesh), so the test's name is historical.
NOT_PORTED = {"models.init", "ops.pallas.flash_mha",
              "ops.pallas.mrf_resblock"}


def test_port_has_every_jax_module_but_parallel():
    jax_pkg = ROOT / "expressive_fastspeech2_mandarin_tpu"

    def modules(root):
        return {str(p.relative_to(root).with_suffix("")).replace(os.sep, ".")
                .removesuffix(".__init__") for p in root.rglob("*.py")}

    missing = modules(jax_pkg) - modules(PORT)
    assert missing == NOT_PORTED, sorted(missing)


# Every torch.cuda entry that could initialize or query the card raises;
# then the preprocess package is imported and a worker's whole job runs.
_WORKER_NO_CUDA = """
import pathlib, shutil, sys
import torch

def touched(*args, **kwargs):
    raise AssertionError("CUDA touched")

for name in ("_lazy_init", "init", "is_available", "device_count",
             "current_device", "set_device", "synchronize"):
    setattr(torch.cuda, name, touched)
from expressive_fastspeech2_mandarin_tpu_torch import config
from expressive_fastspeech2_mandarin_tpu_torch.preprocess import preprocessor
from tests.port_corpus import preprocess_config, write_pipeline_corpus

root = pathlib.Path(sys.argv[1])
raw, tg = write_pipeline_corpus(root)
shutil.copytree(tg, root / "pre" / "TextGrid")
preprocessor._hide_card()
ex = preprocessor.extract_utterance(
    preprocess_config(config, raw, root / "pre"), "0001", "0001_000003")
print("EXTRACTED", len(ex.phones), ex.pitch.dtype, torch.cuda.is_initialized())
"""


def test_preprocess_worker_never_touches_cuda(tmp_path):
    """What a spawn worker of ``Preprocessor`` imports and runs
    (``extract_utterance``) calls no ``torch.cuda`` entry and leaves CUDA
    uninitialized; the pool's jobs hold only the config and names."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _WORKER_NO_CUDA,
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "EXTRACTED 5 float64 False" in out.stdout, out.stdout
