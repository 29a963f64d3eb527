"""The data-parallel steps replayed from CUDA graphs over NCCL, on the card:
each run is a spawned world of one (one card a rank; the card's machine
has one), through tests/torch_parallel_worker.py under its timeout.

* a replayed NCCL collective runs: an all-reduce with a pre-multiplied sum
  by 2 (which NCCL applies at one rank too, where a plain sum is a copy
  or nothing) captured once and replayed 3 times reads 8× its start;
* the data-parallel train step graphed against the same step eager, from
  one state over the same batches, at toy width with the recipe's
  warm-up, both after one eager step (Adam's first update is the sign of
  each gradient, so the eager step's round-off there becomes whole
  steps): each loss within 1e-5 relative, the parameters' change within
  1e-2 (but for the parameters whose gradients are round-off, which Adam
  moves by a random sign), the eval step's losses within 1e-5; graphs
  held after the first call;
* a checkpoint restored into the graphed state through
  ``broadcast_state`` drops its graphs, and the steps after it, captured
  anew, give the eager run's losses.

Marked ``gpu``; each test skips without a CUDA device. This file imports
no JAX, so on a machine without it run it with the root conftest off:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import pytest
import torch

from .torch_parallel_worker import run_workers

STEPS = 5
LOSS_RTOL, DELTA_RTOL = 1e-5, 1e-2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


def _world_of_one(tmp_path, mode: str, **options) -> dict:
    (result,) = run_workers(str(tmp_path), {mode: (1, dict(
        mode=mode, backend="nccl", **options))})[mode]
    return result


@pytest.fixture(scope="module")
def graphed(tmp_path_factory):
    _cuda_or_skip()
    return _world_of_one(tmp_path_factory.mktemp("graphed"), "graphed",
                         steps=STEPS, batch_size=4)


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_a_replayed_nccl_collective_runs(tmp_path):
    _cuda_or_skip()
    r = _world_of_one(tmp_path, "witness")
    assert r["after_capture"] == [1.0]
    assert r["after_replays"] == [8.0]


@pytest.mark.gpu
def test_graphed_dp_step_equals_eager(graphed):
    r = graphed
    assert r["backend"] == "nccl" and r["capturable"]
    assert len(r["graphed"]) == len(r["eager"]) == STEPS
    assert _rel(r["graphed"], r["eager"]) <= LOSS_RTOL
    assert r["delta_rel"] <= DELTA_RTOL and r["move"] > 0
    assert _rel(r["graphed_eval"], r["eager_eval"]) <= LOSS_RTOL


@pytest.mark.gpu
def test_graphs_are_held_after_the_first_call(graphed):
    assert graphed["counts"][0] > 0
    assert graphed["counts"] == [graphed["counts"][0]] * STEPS


@pytest.mark.gpu
def test_a_restore_drops_the_graphs_and_a_recapture_gives_eager_losses(
        graphed):
    r = graphed
    assert r["dropped"] is True
    assert r["resumed_count"] > 0 and r["step"] == STEPS + 1
    assert _rel(r["resumed"], r["eager"][2:]) <= LOSS_RTOL
    assert r["resumed_delta_rel"] <= DELTA_RTOL
