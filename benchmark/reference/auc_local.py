"""The local-average AUC of a rep: one partitioned round from the chain
(seed, "partition", rep)."""

from benchmark.reference.auc_mc import partition_round


def estimate(a, b, *, seed, rep, n_workers, runner) -> float:
    return partition_round(a, b, seed, (rep,), n_workers)
