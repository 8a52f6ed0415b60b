"""The port's generator derivation, frozen.

Copied from ``tuplewise_tpu_torch/utils/rng.py`` (``derive_seed`` and
``generator``, without the key audit): a chain (seed, purpose, *indices)
is hashed with SHA-256 into a 63-bit seed of a ``torch.Generator``. The
references draw the port's rows and partitions from the same chains, so
the frozen copy must stay as it is: a port that changes its derivation
changes its draws, and the comparison shows it.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, purpose: str, *indices) -> int:
    """A 63-bit seed for the chain (seed, purpose, *indices); an index is
    an int or a str tag."""
    chain = ":".join([str(int(seed)), purpose,
                      *(i if isinstance(i, str) else str(int(i))
                        for i in indices)])
    h = hashlib.sha256(chain.encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def generator(seed: int, purpose: str, *indices, device) -> torch.Generator:
    """A fresh generator on ``device`` for the chain."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, purpose, *indices))
    return g
