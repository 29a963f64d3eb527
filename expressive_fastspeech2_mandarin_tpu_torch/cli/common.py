"""Shared plumbing of the command lines: the reference's ``-p/-m/-t``
configuration triplet (reference: train.py:172-198) and ``--device``.

Every ``main(argv=None)`` parses ``argv`` (``sys.argv[1:]`` when None), so
scripts and tests can call an entry point in-process. An entry point that
runs models takes ``--device``: the card (``cuda``) unless the caller asks
for the CPU; without a card it raises ``RuntimeError``.
"""

from __future__ import annotations

import argparse

from ..config import Config, load_config


def add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-p", "--preprocess_config", required=True,
                    help="preprocess YAML (reference format)")
    ap.add_argument("-m", "--model_config", required=True,
                    help="model YAML (reference format)")
    ap.add_argument("-t", "--train_config", required=True,
                    help="train YAML (reference format)")


def config_from_args(args) -> Config:
    return load_config(args.preprocess_config, args.model_config,
                       args.train_config)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; the default) or cpu; cuda without "
                         "a card raises (device.resolve_device)")
