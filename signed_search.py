"""Kernel 6's search designs, emulated on the CPU probe for probe:
``tuplewise_tpu_torch/csrc/signed_count.cu`` (the committed design) and
``bench_signed_count_thread.cu`` (the other design, which
``bench_torch_variants.py --flat`` times). ``tests/test_torch_signed_search.py``
holds the emulation against the port's plain version, its
``torch.searchsorted`` route and the JAX package's kernel;
``bench_torch_variants.py --flat`` reads each design's dependent chain
from it.

The search of one (query, run) cell: the bound lies in a window [lo, lo +
n) of the run; a cut into P parts loads the splitters at lo + floor(i (n
+ 1) / P) - 1, i = 1 .. P - 1, at once, and the splitters below the bound
(a prefix; those below lo are virtual and count as below) pick the part
that holds it. The first cut comes from the run's top, 2^top_levels - 1
splitters a block loads into shared memory in one round; the others are
rounds of lanes x probes splitters. A design is (top levels, lanes a
bound, splitters a lane a round). With lanes > 1 (the committed design)
the lower and upper bounds search side by side; with lanes == 1 one
thread takes the lower bound and searches the upper bound again only
where the value at the lower bound equals the query.
"""

import torch

from tuplewise_tpu_torch.ops import count_kernels as ck

I64 = torch.int64
COMMITTED = (ck.SIGNED_TOP_LEVELS, ck.SIGNED_LANES, 1)


def _before(v, q, upper):
    return v <= q if upper else v < q


def _cut(run, q, upper, lo, n, s, live):
    """One cut of the windows [lo, lo + n) of the live queries q at the
    splitters s [Q, P - 1] (those below lo virtual): the new (lo, n), and
    the value at the new window's end with whether it was set."""
    virt = s < lo[:, None]
    v = run[s.clamp(0, max(len(run) - 1, 0))] if len(run) else \
        torch.zeros(s.shape)
    below = virt | _before(v, q[:, None], upper)
    c = below.sum(1)
    k = s.shape[1]
    prefix = torch.arange(k)[None] < c[:, None]
    assert torch.equal(below[live], prefix[live]), "not a prefix"
    at = c.clamp(max=k - 1)[:, None]
    nlo = torch.where(c == 0, lo, s.gather(1, (c - 1).clamp(min=0)[:, None])
                      [:, 0] + 1)
    nhi = torch.where(c == k, lo + n, s.gather(1, at)[:, 0])
    hit = live & (c < k)
    return (torch.where(live, nlo, lo), torch.where(live, nhi - nlo, n),
            v.gather(1, at)[:, 0], hit)


def _top_cut(run, q, upper, top_levels):
    """The first cut, from the top's 2^top_levels - 1 splitters: (lo, n,
    value at the window's end, whether it is one)."""
    parts = 1 << top_levels
    N = len(run)
    s = (torch.arange(1, parts, dtype=I64) * (N + 1)) // parts - 1
    # the kernel starts its search of the top past the virtual splitters
    assert int((s < 0).sum()) == (parts + N) // (N + 1) - 1
    zero = torch.zeros(len(q), dtype=I64)
    live = torch.ones(len(q), dtype=torch.bool)
    return _cut(run, q, upper, zero, torch.full_like(zero, N),
                s[None].expand(len(q), -1), live)


def _rounds(run, q, upper, lo, n, at_hi, has_hi, parts):
    """Rounds of parts - 1 splitters until every window is empty: (the
    bound, the value at it, whether it is one, each query's rounds)."""
    rounds = torch.zeros(len(q), dtype=I64)
    i = torch.arange(1, parts, dtype=I64)[None]
    while bool((n > 0).any()):
        live = n > 0
        s = lo[:, None] + (i * (n[:, None] + 1)) // parts - 1
        lo, n, v, hit = _cut(run, q, upper, lo, n, s, live)
        at_hi = torch.where(hit, v, at_hi)
        has_hi = has_hi | hit
        rounds += live.long()
    return lo, at_hi, has_hi, rounds


def flat_search(run, q, design=COMMITTED):
    """(less, leq, chain, tie chain) of each query against one sorted run
    by the kernel's search: int64 counts, each query's dependent rounds
    (the top's load round, then its rounds) and, for the one-thread design,
    the rounds its tie search adds."""
    top_levels, lanes, probes = design
    parts = lanes * probes + 1
    N = len(run)
    zero = torch.zeros(len(q), dtype=I64)
    if N == 0:
        return zero, zero.clone(), zero.clone(), zero.clone()
    bounds, chains = [], []
    for upper in ((False, True) if lanes > 1 else (False,)):
        lo, n, at_hi, has_hi = _top_cut(run, q, upper, top_levels)
        b, at_hi, has_hi, r = _rounds(run, q, upper, lo, n, at_hi, has_hi,
                                      parts)
        bounds.append(b)
        chains.append(r)
    if lanes > 1:
        less, leq = bounds
        return less, leq, 1 + torch.maximum(*chains), zero
    less = bounds[0]
    assert bool((has_hi == (less < N)).all())
    tie = (less < N) & (at_hi == q)
    lo = torch.where(tie, less + 1, less)
    n = torch.where(tie, N - less - 1, zero)
    leq, _, _, tie_rounds = _rounds(run, q, True, lo, n, at_hi, has_hi,
                                    parts)
    return less, leq, 1 + chains[0], tie_rounds
