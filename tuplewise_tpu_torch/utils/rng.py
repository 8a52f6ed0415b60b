"""Generator discipline: every draw comes from a ``torch.Generator``
derived from ``(seed, purpose, *indices)``.

The counterpart of ``tuplewise_tpu.utils.rng``'s fold chains, with the
same purpose tags. The derivation hashes the chain, so two consumers
with different purposes or indices never share a stream and every run
is reproducible from one integer seed. torch and jax generators give
different bits from the same seed: tests that compare the two packages
feed both the same numpy-made indices, or compare statistically.
"""

from __future__ import annotations

import hashlib

import torch

PURPOSES = (
    "local_average",
    "repartition_round",
    "incomplete",
    "mc_rep",
    "partition",
    "data",
    "pairs",
    # the learners: worker blocks drawn at repartition boundary t, and the
    # sampled pairs or triplets of step t (the JAX chains (root,
    # "repartition", t), (root, "step", t), (kt, "pair_sample", w) and
    # (kt, "triplet_sample", w))
    "repartition",
    "step",
    "pair_sample",
    "triplet_sample",
)


def derive_seed(seed: int, purpose: str, *indices: int) -> int:
    """A 63-bit seed for the chain (seed, purpose, *indices)."""
    if purpose not in PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}; known: {PURPOSES}")
    chain = ":".join([str(int(seed)), purpose, *(str(int(i)) for i in indices)])
    h = hashlib.sha256(chain.encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def generator(seed: int, purpose: str, *indices: int,
              device="cpu") -> torch.Generator:
    """A fresh generator on ``device`` for the chain (seed, purpose,
    *indices)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, purpose, *indices))
    return g
