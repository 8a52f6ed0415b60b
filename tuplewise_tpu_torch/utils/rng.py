"""Generator discipline: every draw comes from a ``torch.Generator``
derived from ``(seed, purpose, *indices)``.

The counterpart of ``tuplewise_tpu.utils.rng``'s fold chains, with the
same purpose tags. The derivation hashes the chain, so two consumers
with different purposes or indices never share a stream and every run
is reproducible from one integer seed. torch and jax generators give
different bits from the same seed: tests that compare the two packages
feed both the same numpy-made indices, or compare statistically.

``audit_keys()`` is the key-discipline check of the JAX module: inside
its scope every derived chain (seed, purpose, *indices) is recorded, and
a chain derived twice (two consumers that would draw the same stream)
raises ``AssertionError`` at once.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading

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
    # the incomplete estimator's distinct designs ("design"); the harness
    # draws rep block k from (seed, "mc_rep", k) and a fix_data run its
    # one frozen dataset from (seed, "data_fixed")
    "design",
    "data_fixed",
    # the mesh's within-shard incomplete draws: the random packing and
    # every worker's tuples
    "incomplete_shard",
)

_AUDIT = threading.local()


def derive_seed(seed: int, purpose: str, *indices,
                record: bool = True) -> int:
    """A 63-bit seed for the chain (seed, purpose, *indices); an index is
    an int or a str tag (the mesh runner's (seed, "mc_rep", k, "shard",
    w)).

    ``record=False`` leaves the chain out of an ``audit_keys`` scope: for
    a chain that several consumers share by design, each taking rows of
    its draws that no other takes (the harness's rep blocks, which every
    chunk of a run cut mid-block draws whole)."""
    if purpose not in PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}; known: {PURPOSES}")
    chain = ":".join([str(int(seed)), purpose,
                      *(i if isinstance(i, str) else str(int(i))
                        for i in indices)])
    seen = getattr(_AUDIT, "seen", None)
    if record and seen is not None:
        if chain in seen:
            raise AssertionError(
                f"key-discipline violation: chain {chain!r} derived twice; "
                "two consumers would draw identical randomness. Give each "
                "consumer a distinct purpose or index."
            )
        seen.add(chain)
    h = hashlib.sha256(chain.encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def generator(seed: int, purpose: str, *indices, device="cpu",
              record: bool = True) -> torch.Generator:
    """A fresh generator on ``device`` for the chain (seed, purpose,
    *indices); ``record``: see :func:`derive_seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, purpose, *indices, record=record))
    return g


@contextlib.contextmanager
def audit_keys():
    """``with audit_keys(): ...`` — raise on any chain derived twice
    inside the scope (nested scopes share the outer record)."""
    prev = getattr(_AUDIT, "seen", None)
    _AUDIT.seen = set() if prev is None else prev
    try:
        yield
    finally:
        _AUDIT.seen = prev


# --------------------------------------------------------------------- #
# mutable host-RNG state capture                                        #
# --------------------------------------------------------------------- #
# The serving reservoirs draw from a ``numpy.random.Generator`` that
# carries state; these two helpers round-trip it exactly (the
# bit_generator state dict is plain ints and strings, so it survives the
# JSON config block of a snapshot).

def capture_np_rng(gen) -> dict:
    """JSON-safe snapshot of a ``numpy.random.Generator``'s full state."""
    return gen.bit_generator.state


def restore_np_rng(gen, state: dict) -> None:
    """Restore a state captured by :func:`capture_np_rng`: the generator
    continues the original stream bit for bit."""
    gen.bit_generator.state = state
