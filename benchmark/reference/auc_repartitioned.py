"""The repartitioned AUC of a rep: the mean over ``runner["n_rounds"]``
rounds t of a partitioned round from the chain (seed, "partition", rep,
t)."""

import math

from benchmark.reference.auc_mc import partition_round


def estimate(a, b, *, seed, rep, n_workers, runner) -> float:
    T = runner.get("n_rounds", 1)
    return math.fsum(partition_round(a, b, seed, (rep, t), n_workers)
                     for t in range(T)) / T
