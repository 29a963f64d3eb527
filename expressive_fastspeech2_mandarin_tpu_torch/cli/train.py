"""Train CLI (reference: train.py:172-198): FastSpeech2 on one device, or
data-parallel over processes.

More than one process: run one per card with the same configuration and
``--coordinator host:port --num-processes N --process-id i`` (process 0's
address); each takes ``cuda:(i % device_count)`` and joins over NCCL
(``--backend gloo`` for several processes on one card, and the default
with ``--device cpu``). Over NCCL the steps replay from CUDA graphs with
their collectives inside, as in one process; over gloo, whose collectives
cannot be captured, they run eagerly.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed

from ..device import resolve_device
from ..parallel import default_backend, initialize_distributed
from .common import (
    add_config_args,
    add_device_arg,
    config_from_args,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-train")
    add_config_args(ap)
    ap.add_argument("--restore_step", type=int, default=None)
    ap.add_argument("--total_steps", type=int, default=None,
                    help="override train.step.total_step")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 for multi-host")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend (default: nccl on the "
                         "card, gloo on the CPU)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and (args.num_processes or 1) > 1:
        device = torch.device("cuda", (args.process_id or 0)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id,
                           args.backend or default_backend(device))

    from ..train.loop import train

    cfg = config_from_args(args)
    try:
        train(cfg, restore_step=args.restore_step,
              total_steps=args.total_steps, device=device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
