"""Results-file naming shared by the experiment suites (a copy of
``tuplewise_tpu.utils.results_io``).

The rule: --quick smoke runs write to ``*_quick`` sibling files so they
can never truncate or replace committed full-run artifacts, and the
results audit ignores the siblings entirely.
"""

from __future__ import annotations

import os

QUICK_SUFFIX = "_quick"


def quick_sibling(name: str, quick: bool) -> str:
    """``name`` unchanged for full runs; ``stem_quick.ext`` for quick."""
    if not quick:
        return name
    stem, ext = os.path.splitext(name)
    return f"{stem}{QUICK_SUFFIX}{ext}"


def strip_quick(name: str) -> str:
    """Base name of a possibly-quick-suffixed results file."""
    stem, ext = os.path.splitext(name)
    if stem.endswith(QUICK_SUFFIX):
        stem = stem[: -len(QUICK_SUFFIX)]
    return stem + ext


def is_quick(name: str) -> bool:
    return os.path.splitext(name)[0].endswith(QUICK_SUFFIX)
