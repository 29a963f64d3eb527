"""Whether the first float32 ``torch.exp`` of a process comes out off.

    python reports/first_exp/first_exp_probe.py [--processes 160]
        [--threads 2] [--jobs 4]

Each child (a fresh interpreter, ``torch.set_num_threads(threads)``) forms
the scores q kᵀ / 16 of seeded (2, 1, 300, 256) float32 inputs, subtracts
each row's max and takes ``torch.exp`` of the result twice, as the CPU
attention's softmax does. It reports each call's max |error| against the
float64 exp and, where the first call differs from the second, the range of
flat indices that differ and a sample of the inputs and the first call's
values there. One more child computes oneMKL's ``vmsExp`` (which torch's
CPU build links statically) in EP mode under
``MKL_ENABLE_INSTRUCTIONS=AVX2`` on the sampled inputs; the parent says
whether every sampled wrong value equals it bit for bit. It prints one
JSON line. CPU only; imports torch and numpy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VML_EP = 3  # oneMKL's vml.h: VML_LA 1, VML_HA 2, VML_EP 3


def exponent_input(threads: int):
    import torch

    torch.set_num_threads(threads)
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(2, 1, 300, 256))
                             .astype(np.float32)) for _ in range(2))
    s = torch.matmul(q, k.transpose(-1, -2)) * 256 ** -0.5
    return s - s.amax(dim=-1, keepdim=True)


def child(threads: int) -> dict:
    import torch

    d = exponent_input(threads)
    first, second = torch.exp(d), torch.exp(d)
    ref = torch.exp(d.double())
    out = {"first": float((first.double() - ref).abs().max()),
           "second": float((second.double() - ref).abs().max())}
    off = torch.nonzero((first != second).reshape(-1)).reshape(-1)
    if off.numel():
        sample = off[:: max(1, off.numel() // 16)][:16]
        out["off"] = [int(off.min()), int(off.max()) + 1, int(off.numel())]
        out["sample"] = [[float(d.reshape(-1)[i]), float(first.reshape(-1)[i])]
                         for i in sample]
    return out


def vml_ep_child() -> dict:
    """vmsExp in EP mode on the float32 inputs read as a JSON list from
    standard input."""
    import torch

    d = np.asarray(json.load(sys.stdin), np.float32)
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    lib.vmsExp.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong]
    y = np.empty_like(d)
    lib.vmsExp(d.size, d.ctypes.data, y.ctypes.data, VML_EP)
    return {"ep_avx2": y.tolist()}


def run_child(args: list[str], env=None, stdin: str = "") -> dict:
    out = subprocess.run([sys.executable, __file__, *args], input=stdin,
                         capture_output=True, text=True, check=True, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--processes", type=int, default=160)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--child", choices=("exp", "vml"), default=None,
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.child == "exp":
        print(json.dumps(child(a.threads)))
        return 0
    if a.child == "vml":
        print(json.dumps(vml_ep_child()))
        return 0
    import torch

    args = ["--child", "exp", "--threads", str(a.threads)]
    with ThreadPoolExecutor(a.jobs) as pool:
        runs = list(pool.map(lambda _: run_child(args), range(a.processes)))
    off = [r for r in runs if "off" in r]
    result = {"torch": torch.__version__, "threads": a.threads,
              "processes": a.processes, "first_call_off": len(off),
              "second_call_off": sum(r["second"] != runs[0]["second"]
                                     for r in runs),
              "worst_first_error": max(r["first"] for r in runs),
              "exact_error": min(r["first"] for r in runs),
              "off_ranges": sorted({tuple(r["off"]) for r in off})}
    if off:
        env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS="AVX2")
        pairs = [xy for r in off for xy in r["sample"]]
        ep = run_child(["--child", "vml"], env=env,
                       stdin=json.dumps([x for x, _ in pairs]))["ep_avx2"]
        result["off_values_equal_mkl_ep_avx2"] = all(
            np.float32(y) == np.float32(e) for (_, y), e in zip(pairs, ep))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
