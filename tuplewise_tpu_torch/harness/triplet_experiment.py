"""BASELINE config 4: degree-3 triplet statistics on MNIST embeddings.

The counterpart of ``tuplewise_tpu.harness.triplet_experiment``. For each
class c, the degree-(2,1) triplet U-statistic takes (anchor, positive)
pairs from class c and negatives from the other classes,

    U_c = mean_{i != j in c, k not in c} h(x_i, x_j, y_k),

and the reported statistic averages U_c over classes; with the indicator
kernel it is the class-balanced triplet accuracy of the embedding.

Progress is checkpointed after every completed class (the JAX layout of
``utils.checkpoint``); a cut sweep resumes at the next class. ``chaos``
fires at ``"checkpoint"`` after each save (where a ``sigkill`` action
models preemption with durable state). Per-class
values depend only on the class data and ``seed``, never on the loop, so
a resumed sweep equals the straight one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tuplewise_tpu_torch.data.loaders import load_mnist_embeddings
from tuplewise_tpu_torch.estimators.estimator import Estimator
from tuplewise_tpu_torch.utils.checkpoint import (
    resume_progress, save_checkpoint,
)


def triplet_mnist_statistic(
    kernel: str = "triplet_indicator",
    backend: str = "torch",
    n: int = 2000,
    n_pairs: Optional[int] = 20_000,
    classes: Optional[list] = None,
    seed: int = 0,
    path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    chaos=None,
    device=None,
    **backend_opts,
) -> dict:
    """Per-class triplet U-statistics over MNIST embeddings (the
    surrogate when no MNIST file is on disk).

    n_pairs None -> the complete statistic (the factorised CUDA kernel on
    the card); otherwise the incomplete estimator with B = n_pairs
    sampled triplets. ``checkpoint_path``: persist (class, U_c) after
    every class and resume a cut sweep from the next one. ``chaos``: a
    ``testing.chaos.FaultInjector``, fired at ``"checkpoint"`` after
    each save and passed to the Estimator. ``device``:
    None runs on the card (and raises where there is none), "cpu" the
    plain versions.
    """
    E, labels, meta = load_mnist_embeddings(path=path, n=n, seed=seed)
    est = Estimator(kernel, backend=backend, device=device, chaos=chaos,
                    **backend_opts)
    todo = sorted(set(classes or np.unique(labels).tolist()))
    ck_config = {"kernel": kernel, "backend": backend, "n": n,
                 "n_pairs": n_pairs, "classes": [int(c) for c in todo],
                 "seed": seed, "n_done": len(todo)}
    start, ck = resume_progress(
        checkpoint_path, ck_config, progress_key="n_done",
        requested=len(todo))
    per_class = {}
    if ck is not None:
        per_class = {int(c): float(v) for c, v in zip(
            ck["extra"]["class_ids"], ck["extra"]["values"])}
    for i in range(start, len(todo)):
        c = todo[i]
        Xc, Yc = E[labels == c], E[labels != c]
        if len(Xc) >= 2 and len(Yc) >= 1:
            if n_pairs is None:
                per_class[int(c)] = est.complete(Xc, Yc)
            else:
                per_class[int(c)] = est.incomplete(Xc, Yc, n_pairs=n_pairs,
                                                   seed=seed)
        if checkpoint_path:
            save_checkpoint(
                checkpoint_path, step=i + 1,
                extra={
                    "class_ids": np.asarray(sorted(per_class),
                                            dtype=np.int64),
                    "values": np.asarray(
                        [per_class[k] for k in sorted(per_class)]),
                },
                config=ck_config,
            )
            if chaos is not None:
                chaos.fire("checkpoint")
    return {
        "per_class": per_class,
        "mean": float(np.mean(list(per_class.values()))),
        "kernel": kernel,
        "backend": backend,
        "n": n,
        "n_pairs": n_pairs,
        "data_meta": meta,
        "recovery": {"resumed_from": int(start)},
    }
