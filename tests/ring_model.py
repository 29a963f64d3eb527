"""A model of the bf16 flash kernels' rings, shared by their CPU tests.

The warp-specialised bf16 kernels (``csrc/flash_mha_bf16.cu``,
``csrc/flash_mha_bwd_bf16.cu``) stream 64-row tiles from a producer warp
into a ring of stages, each with a full and an empty mbarrier; stream slot
n lies in stage n % stages. The model here gives the index maps, the
barriers' phases (``MBarrier``) and the named barriers by which two
consumer warpgroups take turns (``NamedBarrier``), and runs tasks written
as generators in a random interleaving (``interleave``). The kernels'
constants are read from their sources (``source_int``), so the models
follow the kernels.
"""

import re
from pathlib import Path

from expressive_fastspeech2_mandarin_tpu_torch.ops import flash_mha as fm

CSRC = Path(fm.__file__).resolve().parents[1] / "csrc"


def source_int(name: str, pattern: str) -> int:
    """The one integer ``pattern`` captures in ``csrc/<name>``."""
    found = re.findall(pattern, (CSRC / name).read_text())
    assert len(found) == 1, (name, pattern, found)
    return int(found[0])


def stage(n: int, stages: int) -> int:
    return n % stages


def full_parity(n: int, stages: int) -> int:
    """The parity a consumer waits for on slot n's full barrier."""
    return (n // stages) & 1


def empty_parity(n: int, stages: int) -> int:
    """The parity the producer waits for on slot n's empty barrier before
    loading it (a fresh barrier passes parity 1 at once)."""
    return full_parity(n, stages) ^ 1


class MBarrier:
    """An mbarrier's phases: ``count`` arrivals complete a phase;
    try_wait.parity(p) passes once the phase of parity p has completed
    (a fresh barrier, in phase 0, passes parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.completed = count, count, 0

    def arrive(self, n=1):
        self.pending -= n
        assert self.pending >= 0
        if self.pending == 0:
            self.completed += 1
            self.pending = self.count

    def passes(self, parity):
        return self.completed % 2 != parity


class NamedBarrier:
    """``bar.sync id, count`` / ``bar.arrive id, count``: a phase completes
    once ``count`` threads have arrived; a sync arrives and waits for the
    phase it arrived in, an arrive does not wait."""

    def __init__(self, count):
        self.count, self.arrived, self.completed = count, 0, 0

    def arrive(self, n):
        self.arrived += n
        assert self.arrived <= self.count
        if self.arrived == self.count:
            self.completed += 1
            self.arrived = 0

    def sync(self, n):
        """Arrive; returns a predicate that holds once the phase is over."""
        phase = self.completed
        self.arrive(n)
        return lambda: self.completed > phase


def interleave(tasks, rng, steps=100000):
    """Runs generator ``tasks`` in a random order until all end; fails if
    they stall (every one still waiting after ``steps`` turns)."""
    live = list(tasks)
    for _ in range(steps):
        if not live:
            return
        task = rng.choice(live)
        try:
            next(task)
        except StopIteration:
            live.remove(task)
    assert not live, "the ring stalled"
