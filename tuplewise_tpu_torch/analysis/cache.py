"""Incremental analysis cache.

``tuplewise-torch check`` re-parses ~100 modules per run; CI runs it on
every push. Parsed modules are immutable functions of their source
bytes, so they cache perfectly: each file's :class:`ModuleInfo`
(AST + index tables) is pickled under its content sha — a repeat run
reparses ONLY changed files and the report carries the hit/miss
counters. ``--no-cache`` is the escape hatch; the cache directory
(``.tuplewise_torch_check_cache/``, gitignored) is safe to delete at any
time.

Keys include an ``ANALYSIS_CACHE_VERSION`` stamp and the Python
version: bumping the version whenever ``core.ModuleInfo``'s shape
changes invalidates every stale entry at once — a wrong hit can never
outlive the code that wrote it.

Keys ALSO include a **global cache epoch**: the
content digest of the checker package itself plus the committed
waiver/budget/bounds files (``compute_epoch``). Content-sha-of-the-
analyzed-file alone is not a sound key for anything derived from the
ANALYZER: a waivers.toml edit, a checker bugfix, or a budget change
must force a cold re-run, never replay results computed under the old
rules. The epoch folds all of that state into every key, so editing
any of it invalidates the whole cache at once.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys

#: bump when core.ModuleInfo's pickled shape changes
ANALYSIS_CACHE_VERSION = 1

DEFAULT_CACHE_DIR = ".tuplewise_torch_check_cache"


def _stamp() -> str:
    return (f"v{ANALYSIS_CACHE_VERSION}-py{sys.version_info[0]}."
            f"{sys.version_info[1]}")


def compute_epoch(root: str) -> str:
    """Global cache epoch: digest of the checker
    package sources AND the committed waivers/budget/bounds TOMLs
    under ``tuplewise_tpu_torch/analysis/``. Any edit to the analyzer or
    its committed inputs changes the epoch, so every cached entry
    goes cold at once — stale results can never replay across a
    checker-version bump or a waiver/budget change."""
    h = hashlib.sha256()
    h.update(_stamp().encode())
    adir = os.path.join(root, "tuplewise_tpu_torch", "analysis")
    if os.path.isdir(adir):
        for fn in sorted(os.listdir(adir)):
            if not fn.endswith((".py", ".toml")):
                continue
            h.update(fn.encode())
            try:
                with open(os.path.join(adir, fn), "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"<unreadable>")
    return h.hexdigest()[:16]


class ParseCache:
    """Content-sha keyed store of pickled ModuleInfo objects. One file
    per module path (sha inside), so stale entries replace themselves
    and the directory never grows past the corpus size. ``epoch``
    (see :func:`compute_epoch`) folds the analyzer's own state into
    every key."""

    def __init__(self, root: str,
                 subdir: str = DEFAULT_CACHE_DIR,
                 epoch: str = ""):
        self.dir = os.path.join(root, subdir)
        self.epoch = epoch if epoch else compute_epoch(root)
        self.hits = 0
        self.misses = 0
        self._ready = False

    def _ensure_dir(self) -> bool:
        if not self._ready:
            try:
                os.makedirs(self.dir, exist_ok=True)
                self._ready = True
            except OSError:
                return False
        return True

    def key(self, path: str, source: str) -> str:
        h = hashlib.sha256()
        h.update(_stamp().encode())
        h.update(self.epoch.encode())
        h.update(path.encode())
        h.update(source.encode())
        return h.hexdigest()

    def _entry_path(self, path: str) -> str:
        safe = path.replace("/", "__").replace("\\", "__")
        return os.path.join(self.dir, safe + ".pkl")

    def get(self, path: str, source: str):
        """The cached ModuleInfo for (path, source), or None."""
        try:
            with open(self._entry_path(path), "rb") as f:
                sha, mi = pickle.load(f)
        except (OSError, pickle.PickleError, EOFError,
                AttributeError, ImportError):
            self.misses += 1
            return None
        if sha != self.key(path, source):
            self.misses += 1
            return None
        self.hits += 1
        return mi

    def put(self, path: str, source: str, mi) -> None:
        if not self._ensure_dir():
            return
        tmp = self._entry_path(path) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump((self.key(path, source), mi), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._entry_path(path))
        except (OSError, pickle.PickleError):
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def stats(self) -> dict:
        return {"enabled": True, "hits": self.hits,
                "misses": self.misses, "epoch": self.epoch}
