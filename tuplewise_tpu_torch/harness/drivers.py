"""Shared plumbing of the experiment drivers in ``scripts_torch/``.

The drivers are the port's counterparts of the JAX package's
``scripts/config_suite.py``, ``northstar.py``, ``stat_check.py``,
``learning_suite.py`` and ``trace_summary.py``. Their rules:

* they run on the card unless ``--device`` names another torch device;
  with no card and no ``--device`` they exit with status 2 and never
  carry on on the CPU (:func:`driver_device`);
* ``main(argv, results=...)`` writes into ``results`` (default
  ``results/torch/`` of the checkout), never into ``results/*.jsonl``,
  which belong to the JAX package;
* rows keep the JAX scripts' schema, with ``"backend": "torch"`` where
  those write ``"jax"``; every row that holds a time or a rate also
  carries ``card``, the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them (None
  off the card), and ``platform`` is the torch device type the row ran
  on (:func:`platform_of`).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time
from typing import Optional

import torch

from tuplewise_tpu_torch.utils.device import resolve_device


def driver_device(ap: argparse.ArgumentParser,
                  device: Optional[str]) -> torch.device:
    """The device a driver runs on (``utils.device.resolve_device``): with
    no card and no ``device``, ``ap.error`` (exit status 2)."""
    try:
        return resolve_device(device)
    except RuntimeError:
        ap.error("no CUDA device is available; pass --device cpu to run "
                 "the plain versions on the CPU")


def platform_of(device: torch.device) -> str:
    """The generation stamp of a row: the torch device type. torch draws
    differ between the CPU and the card, so a fix_data row is
    regenerated only where this stamp matches (``scripts_torch/
    stat_check.py``)."""
    return torch.device(device).type


@functools.lru_cache(maxsize=None)
def _nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_of(device: torch.device) -> Optional[str]:
    """The card's name and power limit for a CUDA device, None for any
    other device."""
    if torch.device(device).type != "cuda":
        return None
    return _nvidia_smi_card()


def n_devices(device: torch.device) -> int:
    """How many devices of ``device``'s type this host has: the card
    count on CUDA (the JAX scripts' ``jax.device_count()``), else 1."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def utc_stamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def read_jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def sync(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
