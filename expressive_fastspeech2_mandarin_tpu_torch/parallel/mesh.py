"""Data-parallel training over processes; the JAX package's
``parallel/mesh.py`` in ``torch.distributed``.

The JAX package lays its devices out on a ('data', 'model') mesh: the
batch is split over ``data`` and nothing is split over ``model``, whose
devices compute the same rows. Here one process drives one card (tests and
the one-card check run several processes on the CPU or on one card, over
gloo). ``make_layout`` gives a process its place on the same grid: rank
``r`` sits at data index ``r // model_parallel``. Every collective runs
over the whole world: the ``model_parallel`` ranks of a data index hold
the same rows, so each sum over the world counts every row
``model_parallel`` times, numerator and denominator alike.

The semantics are the JAX package's, not DistributedDataParallel's:

* ``batch_size`` is the global batch; each rank collates its contiguous
  row slice (``data.BucketedDataset(num_shards=...)``);
* every loss term is the rank's masked sum over the all-reduced valid
  count, so the summed gradients are the global batch's gradient and the
  reported losses (all-reduced) are the global ones;
* BatchNorm's batch moments are all-reduced through autograd
  (``Layout.sum``), so they are the global batch's;
* dropout draws its masks at the global batch's shape from the generator
  every rank holds alike and keeps the rank's rows;
* the gradients are summed by one flat, bucketed float32 all-reduce
  (``all_reduce_``) before clipping and Adam.

The training step hands its ``Layout`` down to the model's dropout and
BatchNorm, to the loss and to the checkpoint manager, as it hands down
the dropout generator; without one (a single process) nothing is
collective.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs no other
collective on CUDA tensors, and so one code path serves gloo (CPU; several
ranks on one card) and NCCL (one card a rank).

The layout records the process group's backend, and with it whether its
collectives can be captured into a CUDA graph (``Layout.capturable``):
NCCL's can, gloo's cannot. The compiled steps (``train.step``) read that
before they are made, so a run over NCCL replays its steps, collectives
inside, and a run over gloo runs them eagerly; no step decides after a
failed capture.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator
from dataclasses import dataclass

import torch
import torch.distributed as dist

# Elements a flat all-reduce or broadcast moves at once (32 MiB of
# float32).
BUCKET_ELEMENTS = 1 << 23


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str = "nccl") -> None:
    """Join the process group at ``tcp://<coordinator>`` as rank
    ``process_id`` of ``num_processes``; a no-op for one process, as in
    the JAX package. The backend is taken as given: a failed init
    raises."""
    if not num_processes or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("more than one process needs --coordinator "
                         "host:port and --process-id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def default_backend(device: torch.device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


@dataclass(frozen=True)
class Layout:
    """This process's place on the ('data', 'model') grid."""

    world_size: int
    rank: int
    model_parallel: int = 1
    backend: str | None = None  # the process group's, as dist names it

    @property
    def data_parallel(self) -> int:
        return self.world_size // self.model_parallel

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured into a CUDA graph: NCCL
        (one card a rank) can, gloo cannot."""
        return self.backend == "nccl"

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    def rows(self, global_rows: int) -> slice:
        """This rank's contiguous slice of ``global_rows`` rows."""
        n = global_rows // self.data_parallel
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the world, through autograd: the gradient
        of each rank's input is the sum of the ranks' output gradients."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x)


def make_layout(model_parallel: int = 1) -> Layout | None:
    """The layout of this process in the initialized process group, or
    None without one (a single process). Raises ``ValueError`` naming
    ``mesh.model_parallel_size`` when it does not divide the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"mesh.model_parallel_size={model_parallel} does not divide the "
            f"{world} process(es) of this run")
    if not dist.is_initialized():
        return None
    return Layout(world, dist.get_rank(), model_parallel,
                  str(dist.get_backend()))


def _buckets(tensors: Iterable[torch.Tensor]
             ) -> Iterator[list[torch.Tensor]]:
    """Runs of same-dtype tensors of at most ``BUCKET_ELEMENTS`` elements
    (a larger tensor alone)."""
    bucket: list[torch.Tensor] = []
    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or size + t.numel() > BUCKET_ELEMENTS):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def _flat_apply(tensors: Iterable[torch.Tensor], collective) -> None:
    """``collective`` on each bucket's flat copy, written back in place."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_(tensors: list[torch.Tensor]) -> None:
    """Sum tensors (the float32 gradients) over the world in place, a flat
    bucket at a time."""
    _flat_apply(tensors, dist.all_reduce)


@torch.no_grad()
def replicated(tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 to every rank, in place."""
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src=0))
