"""The PyTorch port imports neither JAX nor the JAX package, and the
feature extractor's pool workers never touch CUDA."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "expressive_fastspeech2_mandarin_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import expressive_fastspeech2_mandarin_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
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


def test_port_sources_name_no_jax_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _IMPORT_RE.findall(path.read_text()):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "expressive_fastspeech2_mandarin_tpu"), (
                f"{path.relative_to(ROOT)} imports {name}")


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
                "preprocess.esd", "preprocess.ipa_harvest"):
        assert f"{port.__name__}.{mod}" in names, mod


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
