"""Where the port's entry points run.

They run on the card unless the caller asks for the CPU. With no card
and no explicit device they raise: the port never carries on silently
on the CPU.
"""

from __future__ import annotations

import argparse

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def add_device_flag(p: argparse.ArgumentParser) -> None:
    """The ``--device`` option of the port's command lines (the CLI's
    subcommands, the experiment drivers)."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "without one, pass --device cpu to run the plain "
                        "versions on the CPU)")
