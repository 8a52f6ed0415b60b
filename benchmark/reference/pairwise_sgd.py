"""Plain reference of the pairwise SGD learner's first calls, and the
inputs that the benchmark hands to both sides.

Inputs (made here from the seed, given to the port and to the
reference alike): the rows, n_pos positives and n_neg negatives of
``dim`` standard normal features, the positives shifted by
``separation / sqrt(dim)`` on every feature (a mean distance of
``separation``); a linear scorer's parameters, w standard normal over
sqrt(dim) and b = 0; and the seed of each trainer call k, the chain
(seed, "train_call", k).

What it works out again, as the port's trainer
(``models/pairwise_sgd.py``) derives it: a call under seed s counts its
steps t from 0 and draws its worker blocks at every t that is a multiple
of ``repartition_every`` (t = 0 first) from the chain (s, "repartition",
t): a permutation of the positives and then one of the negatives, each
cut into N blocks of n // N rows. A step scores every row, takes the
mean over the N workers of each worker's mean over its m1 x m2 local
pairs of the surrogate l(d), d = s(x) - s(y) (``surrogates/``), and
moves the parameters by -lr times the gradient of that mean.

The reference keeps the parameters, the rows' products and every sum
in float64 and computes each pair's loss and derivative in float32, the
configuration's precision, from float32 scores; the pairs go in blocks
of rows. With ``dtype=torch.bfloat16`` it computes the rows, the
parameters, the scores and every pair's loss and derivative in bfloat16
and accumulates in float32: the control that the comparison must fail.
The faults it can plant in the program's place: ``workers`` keeps only
some workers' pairs (half the batch left out), ``regather=False`` keeps
a call's first blocks for all its steps, ``update=False`` leaves the
parameters unchanged.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import surrogates
from benchmark.reference.rng import derive_seed, generator


def make_rows(seed: int, n_pos: int, n_neg: int, dim: int,
              separation: float, device):
    """(positives [n_pos, dim], negatives [n_neg, dim]) float32."""
    g = generator(seed, "rows", device=device)
    X = torch.randn(n_pos + n_neg, dim, generator=g, device=device)
    X[:n_pos] += separation / math.sqrt(dim)
    return X[:n_pos].contiguous(), X[n_pos:].contiguous()


def init_params(seed: int, dim: int, device) -> dict:
    """The linear scorer's first parameters: w [dim], b [] float32."""
    g = generator(seed, "init", device=device)
    w = torch.randn(dim, generator=g, device=device) / math.sqrt(dim)
    return {"w": w, "b": torch.zeros((), device=device)}


def call_seed(seed: int, k: int) -> int:
    """The seed of trainer call k."""
    return derive_seed(seed, "train_call", k)


def _blocks(n: int, n_workers: int, g):
    m = n // n_workers
    return torch.randperm(n, generator=g, device=g.device)[
        : n_workers * m].reshape(n_workers, m)


def _divisor(n: int, most: int) -> int:
    """The largest divisor of n that is at most ``most``."""
    return max(k for k in range(1, min(n, most) + 1) if n % k == 0)


def _pair_sums(s1, s2, surrogate, acc, block_rows: int):
    """(loss sum, row [m1], col [m2]) in ``acc`` of l(d) and l'(d) over
    the pairs d = s1_i - s2_j, computed in s1's dtype. Each sum runs in
    two levels: float32 over runs of at most about a thousand terms, then
    ``acc`` over the runs (float64 reductions of the whole block take
    twice as long and gain nothing)."""
    m2 = s2.shape[0]
    run2 = _divisor(m2, 1024)
    row = torch.empty(s1.shape[0], dtype=acc, device=s1.device)
    col = torch.zeros(m2, dtype=acc, device=s1.device)
    loss = torch.zeros((), dtype=acc, device=s1.device)
    f32 = torch.float32
    for i0 in range(0, s1.shape[0], block_rows):
        d = s1[i0:i0 + block_rows, None] - s2[None, :]
        b = d.shape[0]
        run1 = _divisor(b, 128)
        lv, lp = surrogate.terms(d)
        loss += lv.view(b, -1, run2).sum(2, dtype=f32).sum(dtype=acc)
        row[i0:i0 + b] = lp.view(b, -1, run2).sum(2, dtype=f32).sum(
            1, dtype=acc)
        col += lp.view(-1, run1, m2).sum(1, dtype=f32).sum(0, dtype=acc)
    return loss, row, col


def sgd_calls(Xp, Xn, p0: dict, calls, *, n_workers: int, lr: float,
              repartition_every: int, surrogate: str = "logistic",
              dtype=torch.float32, workers=None, regather: bool = True,
              update: bool = True, block_rows: int = 1024):
    """The trainer calls ``calls``, (seed, steps) each, every call
    continuing from the last: {"loss": [float], "grad": [{leaf:
    tensor}], "params": [{leaf: tensor}]}, one entry a step (params[0]
    is p0), float64 tensors on the rows' device."""
    sur = surrogates.get(surrogate)
    full = dtype in (torch.float32, torch.float64)
    # the type of the rows' products and of the sums
    wide, acc = ((torch.float64, torch.float64) if full
                 else (dtype, torch.float32))
    keep = list(range(n_workers)) if workers is None else list(workers)
    params = {k: v.to(torch.float64) for k, v in p0.items()}
    out = {"loss": [], "grad": [], "params": [dict(params)]}
    n1, n2 = Xp.shape[0], Xn.shape[0]
    for s, steps in calls:
        for t in range(steps):
            if t % repartition_every == 0 and (t == 0 or regather):
                g = generator(s, "repartition", t, device=Xp.device)
                i1 = _blocks(n1, n_workers, g)
                i2 = _blocks(n2, n_workers, g)
            w, b = params["w"].to(wide), params["b"].to(wide)
            m1, m2 = i1.shape[1], i2.shape[1]
            loss_w, gw, gb = [], [], []
            for k in keep:
                A, B = Xp[i1[k]].to(wide), Xn[i2[k]].to(wide)
                loss, row, col = _pair_sums((A @ w + b).to(dtype),
                                            (B @ w + b).to(dtype), sur, acc,
                                            block_rows)
                loss_w.append(float(loss) / (m1 * m2))
                gw.append((row @ A.to(acc) - col @ B.to(acc)).to(
                    torch.float64) / (m1 * m2))
                gb.append(float(row.sum() - col.sum()) / (m1 * m2))
            grad = {"w": torch.stack(gw).mean(0),
                    "b": torch.tensor(math.fsum(gb) / len(keep),
                                      dtype=torch.float64, device=Xp.device)}
            if update:
                params = {k: params[k] - lr * grad[k] for k in params}
            out["loss"].append(math.fsum(loss_w) / len(keep))
            out["grad"].append(grad)
            out["params"].append(dict(params))
    return out


def leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's gap between the norms of ``prog`` and ``ref``
    (dicts of tensors), over the larger of the reference leaf's norm and
    the median leaf's. Leaves whose reference gradient (``ref_grad``) is
    under a thousandth of the median leaf's are left out: they move by
    round-off alone."""
    gnorm = {k: float(v.norm()) for k, v in ref_grad.items()}
    med_g = _median(list(gnorm.values()))
    leaves = [k for k in ref if gnorm[k] >= 1e-3 * med_g]
    norms = {k: float(ref[k].norm()) for k in ref}
    med = _median([norms[k] for k in leaves])
    return max(abs(float(prog[k].double().norm()) - norms[k])
               / max(norms[k], med) for k in leaves)


def _median(xs):
    xs = sorted(xs)
    h = len(xs) // 2
    return xs[h] if len(xs) % 2 else (xs[h - 1] + xs[h]) / 2
