"""chip_smoke.py's two refusals, on the CPU.

The script must fail, printing no result line, where it cannot drive the
port on a card: alone in a directory without the port's package (it exits
1 naming the package it lacks) and beside the package on a machine with no
CUDA device (it exits 1 saying so). Exit code 1 in either place is the
refusal working, not a fault of a run.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd: Path, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **env))


def test_chip_smoke_alone_exits_1_naming_the_package_it_lacks(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run(tmp_path)
    assert out.returncode == 1
    assert ("the package expressive_fastspeech2_mandarin_tpu_torch is not "
            f"in {tmp_path.resolve()}") in out.stderr
    assert out.stdout == ""


def test_chip_smoke_without_a_cuda_device_exits_1():
    out = _run(ROOT, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 1
    assert "chip_smoke: no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
