"""Driver for the repo's native C++ forced aligner (``native/aligner``); the
JAX package's ``align/__init__.py`` with the same functions and command
lines.

The aligner is built from its sources at first use, never taken from the
tracked ``native/aligner/efs2-aligner``, which was built with
``-march=native`` on another host, and never by ``make`` there, which
would rewrite the tracked objects: one ``g++`` per source, all started
together, with the Makefile's flags, then one link, into
``build/aligner/efs2-aligner-<hash>`` at the root of the checkout (listed
in ``.gitignore``). The hash covers the sources, the headers, the compiler,
the flags and the host's CPU (``-march=native``), so an edited source, or
a checkout moved to another kind of host, is rebuilt and a built one
reused.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native" / "aligner"
BUILD_DIR = ROOT / "build" / "aligner"
# native/aligner/Makefile's CXXFLAGS.
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra",
            "-pthread")

_lock = threading.Lock()


class AlignerError(RuntimeError):
    pass


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise AlignerError("no C++ compiler (g++) to build the aligner")
    return cxx


def _host_cpu() -> str:
    """The CPU that ``-march=native`` builds for: its model and feature
    flags where ``/proc/cpuinfo`` gives them."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") and all(
                        not seen.startswith(key) for seen in lines):
                    lines.append(line.strip())
    except OSError:
        pass
    return "\n".join(lines)


def binary_path() -> Path:
    """Where the build of the current sources and flags for this host's
    CPU lives."""
    digest = hashlib.sha256(" ".join((_cxx(), *CXXFLAGS)).encode())
    digest.update(_host_cpu().encode())
    for src in sorted(NATIVE_DIR.glob("*.cc")) + sorted(
            NATIVE_DIR.glob("*.h")):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"efs2-aligner-{digest.hexdigest()[:12]}"


def ensure_built(quiet: bool = True) -> str:
    """Build the aligner if this build does not exist yet; returns its
    path."""
    sources = sorted(NATIVE_DIR.glob("*.cc"))
    if not sources:
        raise AlignerError(f"native aligner sources not found at "
                           f"{NATIVE_DIR}")
    with _lock:
        binary = binary_path()
        if binary.exists():
            return str(binary)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            procs = [(src, subprocess.Popen(
                [_cxx(), *CXXFLAGS, "-c", str(src), "-o",
                 os.path.join(tmp, src.stem + ".o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                for src in sources]
            logs, failed = [], []
            for src, proc in procs:
                log, _ = proc.communicate()
                logs.append(log)
                if proc.returncode != 0:
                    failed.append(f"g++ failed for {src.name}:\n{log}")
            if failed:
                raise AlignerError("aligner build failed:\n"
                                   + "\n".join(failed))
            out = os.path.join(tmp, binary.name)
            proc = subprocess.run(
                [_cxx(), *CXXFLAGS, "-o", out,
                 *(os.path.join(tmp, s.stem + ".o") for s in sources)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise AlignerError(f"aligner link failed:\n{proc.stderr}")
            os.replace(out, binary)
        if not quiet:
            print("".join(logs))
    return str(binary)


def align_corpus(
    corpus_path: str,
    out_dir: str,
    model_path: str | None = None,
    iters: int = 8,
    mix_up: int = 4,
    threads: int | None = None,
    timeout: float = 7200.0,
    speaker_adapt: bool = True,
    triphone: bool | str = "auto",
    lexicon: str | None = None,
    extra_args: list[str] | None = None,
) -> str:
    """Train (or load) the acoustic model and force-align the corpus
    (``<speaker>/<utt>.wav`` + ``.lab``), writing MFA-style TextGrids under
    ``out_dir/<speaker>/``.

    ``triphone``: ``"auto"`` (the aligner engages its tied-state triphone
    stage only where its per-state data volume says it beats monophones),
    ``True`` (always) or ``False`` (the monophone and fMLLR stages only).
    ``lexicon``: an MFA-format pronunciation dictionary consulted before
    the built-in pinyin decomposition. Returns the aligner's log (its
    stderr)."""
    binary = ensure_built()
    cmd = [binary, "align", "--corpus", corpus_path, "--out", out_dir,
           "--iters", str(iters), "--mix-up", str(mix_up)]
    if not speaker_adapt:
        cmd += ["--no-adapt"]
    if triphone == "auto":
        cmd += ["--tri-auto"]
    elif not triphone:
        cmd += ["--no-triphone"]
    if lexicon:
        cmd += ["--lexicon", lexicon]
    if extra_args:
        cmd += list(extra_args)
    if model_path:
        cmd += ["--model", model_path]
    if threads:
        cmd += ["--threads", str(threads)]
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AlignerError(
            f"alignment failed (rc {proc.returncode}):\n{proc.stderr}")
    return proc.stderr


def train_model(corpus_path: str, model_path: str, iters: int = 8,
                mix_up: int = 4, threads: int | None = None) -> str:
    """Train only; saves the acoustic model to ``model_path``."""
    binary = ensure_built()
    cmd = [binary, "train", "--corpus", corpus_path, "--model", model_path,
           "--iters", str(iters), "--mix-up", str(mix_up)]
    if threads:
        cmd += ["--threads", str(threads)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AlignerError(f"training failed:\n{proc.stderr}")
    return proc.stderr


__all__ = ["AlignerError", "ensure_built", "align_corpus", "train_model",
           "binary_path"]
