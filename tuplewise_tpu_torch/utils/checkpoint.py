"""Checkpoint/resume for the learner (numpy only).

A copy of ``tuplewise_tpu.utils.checkpoint`` with the same ``.npz``
layout, so a checkpoint written by either package's trainer resumes in
the other (the configs must compare equal, as they do for the two
``TrainConfig``s).

Single-file ``.npz`` checkpoints, written atomically (tmp + rename):

* ``step``          — how far the run has progressed (SGD steps or
                      Monte-Carlo reps);
* ``param/<name>``  — model parameter arrays (learner);
* ``extra/<name>``  — partial result arrays (loss curves, estimates);
* ``config``        — the run config as a JSON string; on resume the
                      stored config must match the requested one (the
                      progress dimension — steps/reps — excluded), so a
                      checkpoint can never silently continue a different
                      experiment.

Resume is EXACT because every source of randomness is
keyed by absolute step index via utils.rng (never by "time since start"):
a run chunked at any boundary reproduces the unchunked run bit-for-bit.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np


def save_checkpoint(
    path: str,
    *,
    step: int,
    params: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
    config: Optional[dict] = None,
) -> None:
    """Atomically write a checkpoint (tmp file + os.replace)."""
    blob: Dict[str, Any] = {"step": np.asarray(int(step))}
    for name, arr in (params or {}).items():
        blob[f"param/{name}"] = np.asarray(arr)
    for name, arr in (extra or {}).items():
        blob[f"extra/{name}"] = np.asarray(arr)
    if config is not None:
        blob["config"] = np.asarray(json.dumps(config, sort_keys=True))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **blob)
            # fsync BEFORE the rename: os.replace makes the new name
            # atomic against a crashed writer, but without the data
            # fsync a machine crash can leave the (renamed) file with
            # torn contents.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)       # persist the rename itself
            finally:
                os.close(dfd)
        except OSError:
            pass  # directory fsync unsupported on this platform
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> Optional[dict]:
    """Load a checkpoint, or None if ``path`` doesn't exist.

    Returns {"step": int, "params": {...}, "extra": {...}, "config": dict|None}.
    """
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as blob:
        out = {"step": int(blob["step"]), "params": {}, "extra": {},
               "config": None}
        for key in blob.files:
            if key.startswith("param/"):
                out["params"][key[len("param/"):]] = blob[key]
            elif key.startswith("extra/"):
                out["extra"][key[len("extra/"):]] = blob[key]
            elif key == "config":
                out["config"] = json.loads(str(blob[key]))
    return out


def resume_progress(
    path: Optional[str],
    config: dict,
    *,
    progress_key: str,
    requested: int,
):
    """Resume preamble for chunked runs.

    Returns (start, checkpoint-or-None). Validates the stored config
    against ``config`` (ignoring ``progress_key``, the resumable
    dimension) and refuses checkpoints whose progress exceeds the
    request — progress cannot be rewound without producing results
    mislabeled as a shorter run.
    """
    ck = load_checkpoint(path) if path else None
    if ck is None:
        return 0, None
    check_config(ck["config"], config, ignore=(progress_key,))
    start = ck["step"]
    if start > requested:
        raise ValueError(
            f"checkpoint at {progress_key}={start} is past the requested "
            f"{progress_key}={requested}; delete {path!r} to start fresh"
        )
    return start, ck


def iter_chunks(start: int, total: int, every: Optional[int]):
    """Yield (offset, length) chunk bounds covering [start, total).

    ``every`` of None/0 means one chunk; negative values are rejected
    (both consumers share this guard so they cannot diverge)."""
    if not every:
        every = max(total - start, 1)
    if every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {every}")
    m = start
    while m < total:
        c = min(every, total - m)
        yield m, c
        m += c


def prepare_resume(path: Optional[str], resume: bool) -> None:
    """The CLI's ``--resume`` discipline: without ``--resume`` an existing
    checkpoint file is removed (a fresh run), so a stale file from an
    earlier experiment never turns a new run into a continuation. With
    ``--resume`` the file is left for :func:`resume_progress` (which
    still validates the stored config). Library callers keep
    auto-resume by not calling this."""
    if path and not resume and os.path.exists(path):
        os.unlink(path)


def params_digest(params: Dict[str, Any]) -> str:
    """Order-independent SHA-256 of a params dict — the cheap
    bit-identity witness the preemption smoke and resume tests compare
    across processes (equal digests <=> equal bytes in every array)."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        arr = np.ascontiguousarray(np.asarray(params[name]))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def check_config(
    stored: Optional[dict], requested: dict, *, ignore: tuple = ()
) -> None:
    """Raise if a checkpoint's config doesn't match the requested run
    (modulo ``ignore`` — the progress dimensions like steps/n_reps)."""
    if stored is None:
        return
    a = {k: v for k, v in stored.items() if k not in ignore}
    b = {k: v for k, v in requested.items() if k not in ignore}
    if a != b:
        diff = {
            k: (a.get(k), b.get(k))
            for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)
        }
        raise ValueError(
            f"checkpoint config mismatch (stored vs requested): {diff}; "
            "refusing to resume a different experiment — delete the "
            "checkpoint file to start fresh"
        )
