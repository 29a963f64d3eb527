"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (listed in ``.gitignore``). The hash covers the source,
the headers of ``csrc/`` (``*.cuh``) and the flags, so an edited source or
header is rebuilt and a built one is reused.
``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the CUDA sources in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what the sources include
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    return (src, BUILD_DIR / f"lib{name}-{tag}.so",
            BUILD_DIR / f"lib{name}-{tag}.ptxas.txt")


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source that is not built yet, one ``nvcc`` per source,
    all started together. Returns {name: library path}."""
    names = sources() if names is None else names
    procs = []
    for name in names:
        src, lib, report = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, proc, tmp, lib, report))
    failed = []
    for name, proc, tmp, lib, report in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        report.write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _paths(name)[1] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """``-Xptxas -v`` output of the build of ``csrc/<name>.cu`` (registers,
    shared memory, spills per kernel), empty if it was not built here."""
    report = _paths(name)[2]
    return report.read_text() if report.exists() else ""
