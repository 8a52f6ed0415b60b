"""Tuple-sampling designs drawn on the device (the counterpart of
``tuplewise_tpu.ops.device_design``).

The host sampler (``parallel.partition.draw_pair_design``) is the
oracle; this module draws the same designs on the card with static
shapes and no host synchronisation, for the budgeted learners (every
step of every worker), the incomplete estimator and the harness (every
rep). All shapes are fixed by (budget, design):

  swr        B i.i.d. uniform grid draws (``pair_tiles.sample_pair_indices``
             with a single generator: the learners' historical draws).
  swor       overdraw K with replacement so that the distinct count
             D >= B with ~8-sigma headroom (K solves G(1 - e^{-K/G}) =
             B + 8 sqrt(B), the coupon-collector expectation), sort the
             columns lexicographically to mark repeated tuples, then
             keep EXACTLY B of the D distinct ones, chosen uniformly by
             sorting on random keys (+inf for repeats). Every B-subset of
             the grid is equally likely, conditional on D >= B; the
             astronomically rare shortfall D < B shows in the weight mask
             (a renormalized mean, never a wrong estimate).
  bernoulli  realized size K_real ~ Binomial(G, B/G): EXACT for
             G <= _EXACT_BINOMIAL_MAX_G (a sum of G device Bernoulli
             bits, 0 included), the normal approximation above it
             (inside its G >= 10^4 validity bound). The swor machinery
             keeps the first min(K_real, D, L) selected tuples.

Returns (i, j[, k], w): [*batch, L] int64 indices and a {0, 1} float32
weight mask, L = ``design_pad_len(B, design)`` (B, or B + 8 sqrt(B) + 8
for bernoulli), capped at G. LEARNING consumers compute
sum(vals * w) / max(sum(w), 1): an empty bernoulli realization is a
zero-loss, zero-gradient step, not NaN. ESTIMATION consumers pass
``floor_one=True``: bernoulli's size clamps at >= 1, the host oracle's
semantics (a mean over no tuple has no value). A budget above 0.8 G
raises ``ValueError``: near the full grid the overdraw blows up (K ~ G
ln G) and the complete estimator is cheaper anyway.

The one-sample grid (the off-diagonal of n x n) is encoded with n - 1
columns, deduplicated in encoded coordinates and shifted past i after;
the triplet grid {i != j in [0, n1)} x [0, n2) the same way in j.

Dedup never linearizes the grid: a triplet grid n1 (n1 - 1) n2 passes
2^63 at about 2^21 rows a class, so the lexicographic order comes from
stable ``torch.sort`` passes, least significant column first, exact at
any grid size.

``gen`` is one ``torch.Generator``, from which the rows of ``batch``
draw jointly (the N workers of a learner step, the reps of a harness
block): a call is the same few batched launches, whatever the row count.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from tuplewise_tpu_torch.ops import pair_tiles
from tuplewise_tpu_torch.parallel.partition import design_pad_len

# bernoulli realized-size threshold: at or below this grid size the
# Binomial draw is EXACT (G Bernoulli bits a row); above it the normal
# approximation runs, always inside its G >= 10^4 validity bound
_EXACT_BINOMIAL_MAX_G = 65536
# elements of one chunk of those bits (float64): bounds the exact
# Binomial's temporaries at batch x G beyond 2^24
_BITS_CHUNK = 1 << 24

DESIGNS = ("swr", "swor", "bernoulli")


def _overdraw(grid: int, budget: int) -> int:
    """With-replacement draw count K such that the expected distinct
    count G(1 - e^{-K/G}) covers budget + 8 sqrt(budget). Callers bound
    budget <= 0.8 grid, so the coverage fraction stays below ~0.95 and
    K below ~3 G."""
    target = min(budget + 8.0 * math.sqrt(budget) + 8.0, 0.95 * grid)
    frac = target / grid
    k = -grid * math.log1p(-frac)
    return max(budget, int(math.ceil(k)))


def _bernoulli_count(g: torch.Generator, batch, grid: int, p: float):
    """[*batch] int64 Binomial(grid, p) draws: sums of grid Bernoulli
    bits, drawn in chunks of columns of at most _BITS_CHUNK bits."""
    per = max(1, _BITS_CHUNK // max(1, math.prod(batch)))
    count = torch.zeros(batch, dtype=torch.int64, device=g.device)
    for c0 in range(0, grid, per):
        u = torch.rand((*batch, min(per, grid - c0)), generator=g,
                       device=g.device, dtype=torch.float64)
        count += (u < p).sum(-1)
    return count


def _lex_order(cols):
    """[*batch, K] permutation sorting the rows of ``cols`` (a list of
    [*batch, K] int64 columns, most significant first) lexicographically:
    stable sorts, least significant column first."""
    order = None
    for c in reversed(cols):
        key = c if order is None else c.gather(-1, order)
        idx = torch.sort(key, dim=-1, stable=True).indices
        order = idx if order is None else order.gather(-1, idx)
    return order


def _distinct_design(gen: torch.Generator, dims, budget: int, design: str,
                     what: str, floor_one: bool = False,
                     batch: Tuple[int, ...] = ()):
    """(cols, w): a ``budget``-sized distinct-tuple draw from the product
    grid prod(dims) in ENCODED coordinates (off-diagonal encodings are
    the callers' business): the overdraw, lexicographic dedup and
    uniform subselection for every arity."""
    grid = math.prod(dims)
    if budget > 0.8 * grid:
        raise ValueError(
            f"cannot draw {budget} distinct {what} from a {grid} grid "
            "on device (> 0.8 * grid); use the complete estimator or "
            "the host sampler"
        )
    L = min(design_pad_len(budget, design), grid)
    K = _overdraw(grid, L)
    dev = gen.device
    cols = [torch.randint(0, d, (*batch, K), generator=gen, device=dev)
            for d in dims]
    rnd = torch.rand((*batch, K), generator=gen, device=dev,
                     dtype=torch.float64)
    # pass 1: lexicographic order marks repeats (a tuple equal to the one
    # before it)
    order = _lex_order(cols)
    cols = [c.gather(-1, order) for c in cols]
    dup = functools.reduce(
        lambda a, c: a & (c == c.roll(1, dims=-1)), cols,
        torch.ones_like(cols[0], dtype=torch.bool))
    dup[..., 0] = False
    # pass 2: uniform subselection — distinct tuples sort by a random key,
    # repeats to the back (+inf); the first L slots are kept
    sel = torch.where(dup, torch.inf, rnd)
    pick = torch.sort(sel, dim=-1).indices[..., :L]
    outs = [c.gather(-1, pick) for c in cols]
    keep = ~dup.gather(-1, pick)
    if design != "swor":
        p = budget / grid
        if grid <= _EXACT_BINOMIAL_MAX_G:
            size = _bernoulli_count(gen, batch, grid, p).to(torch.float64)
        else:
            z = torch.randn(batch, generator=gen, device=dev,
                            dtype=torch.float64)
            size = torch.round(budget + math.sqrt(grid * p * (1.0 - p)) * z)
        take = size.clamp(1.0 if floor_one else 0.0, float(L))
        slot = torch.arange(L, device=keep.device, dtype=torch.float64)
        keep = keep & (slot < take[..., None])
    return outs, keep.to(torch.float32)


def _check_design(design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(
            f"unknown sampling design {design!r}; "
            "choose 'swr', 'swor', or 'bernoulli'"
        )


def draw_pair_design_device(gen: torch.Generator, n1: int, n2: int,
                            n_pairs: int, design: str = "swr", *,
                            one_sample: bool = False,
                            floor_one: bool = False,
                            batch: Tuple[int, ...] = ()):
    """(i, j, w) [*batch, L] sampling the n1 x n2 grid under ``design``:
    the device mirror of ``parallel.partition.draw_pair_design``.

    one_sample encodes the off-diagonal of an (n1 x n1) grid with
    n2 = n1 - 1 columns, as the host sampler does: dedup happens in
    encoded coordinates, the returned j is shifted past i.

    floor_one: clamp bernoulli's realized size at >= 1 (estimation);
    the learners leave it False and price an empty draw as a
    zero-weight step. gen, batch: see the module docstring.
    """
    _check_design(design)
    if design == "swr":
        cols = n2 + (1 if one_sample else 0)
        i, j = pair_tiles.sample_pair_indices(gen, n1, cols, n_pairs,
                                              one_sample, batch=batch)
        return i, j, torch.ones(i.shape, dtype=torch.float32, device=i.device)
    (i, j), w = _distinct_design(gen, (n1, n2), n_pairs, design, "tuples",
                                 floor_one=floor_one, batch=batch)
    if one_sample:
        j = torch.where(j >= i, j + 1, j)
    return i, j, w


def draw_triplet_design_device(gen: torch.Generator, n1: int, n2: int,
                               n_triplets: int, design: str = "swr", *,
                               floor_one: bool = False,
                               batch: Tuple[int, ...] = ()):
    """(i, j, k, w) [*batch, L] sampling the off-diagonal triple grid
    {i != j in [0, n1)} x [0, n2) under ``design``. swr draws i and the
    shifted j (``sample_pair_indices``), then k: the triplet learner's
    and the incomplete estimator's historical sequence. The distinct
    designs encode j off-diagonal (n1 - 1 columns) during dedup and
    shift it past i on return. floor_one, gen, batch: see
    :func:`draw_pair_design_device`."""
    _check_design(design)
    if design == "swr":
        i, j = pair_tiles.sample_pair_indices(gen, n1, n1, n_triplets,
                                              True, batch=batch)
        k = torch.randint(0, n2, (*batch, n_triplets), generator=gen,
                          device=gen.device)
        return i, j, k, torch.ones(i.shape, dtype=torch.float32,
                                   device=i.device)
    (i, jp, k), w = _distinct_design(gen, (n1, n1 - 1, n2), n_triplets,
                                     design, "triples", floor_one=floor_one,
                                     batch=batch)
    return i, torch.where(jp >= i, jp + 1, jp), k, w


def weighted_mean(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(vals * w) / sum(w) over the last dim, summed in float64: the
    estimators' mean over a drawn design (floor_one keeps sum(w) >= 1;
    a {0, 1} weight makes the product exact in the values' dtype)."""
    return ((vals * w).sum(-1, dtype=torch.float64)
            / w.sum(-1, dtype=torch.float64))


def shard_design_blocks(cols, w: torch.Tensor, n_shards: int):
    """Pad a [L] draw to n_shards * per and shape it into [N, per]
    worker blocks plus the weight mask (padding: index 0, weight 0):
    the mesh's split of a designed tuple set (the JAX
    ``shard_design_blocks``)."""
    L = cols[0].shape[0]
    per = -(-L // n_shards)
    pad = n_shards * per - L
    out = [torch.nn.functional.pad(c, (0, pad)).reshape(n_shards, per)
           for c in cols]
    out.append(torch.nn.functional.pad(w, (0, pad)).reshape(n_shards, per))
    return out
