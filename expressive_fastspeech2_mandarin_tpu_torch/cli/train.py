"""Train CLI (reference: train.py:172-198): FastSpeech2 on one device."""

from __future__ import annotations

import argparse

from ..device import resolve_device
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
                    help="host:port of process 0 for multi-host (not "
                         "ported yet: raises)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if (args.coordinator, args.num_processes, args.process_id) != (
            None, None, None):
        raise NotImplementedError(
            "multi-process training (--coordinator, --num-processes, "
            "--process-id) is not ported yet: ROADMAP queue 1 item 7 "
            "(parallel/mesh.py)")
    device = resolve_device(args.device)

    from ..train.loop import train

    cfg = config_from_args(args)
    train(cfg, restore_step=args.restore_step, total_steps=args.total_steps,
          device=device)


if __name__ == "__main__":
    main()
