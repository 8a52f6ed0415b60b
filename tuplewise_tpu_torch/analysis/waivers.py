"""Waiver file + ratchet semantics.

Findings are suppressible ONLY through the committed
``analysis/waivers.toml``. Each entry must carry a written
justification, names one finding fingerprint family, and absorbs a
BOUNDED number of findings::

    [[waiver]]
    rule = "lock-held-blocking"
    file = "tuplewise_tpu_torch/serving/index.py"
    symbol = "ExactAucIndex.insert_batch::*"
    count = 3
    reason = "the cv IS the statistic's consistency boundary: ..."

Matching: ``rule`` and ``file`` exact, ``symbol`` a glob (``*``
matches everything when omitted — but then ``count`` bounds it).
**Ratchet**: a waiver matches at most ``count`` findings (default 1);
finding number ``count+1`` under the same pattern is NEW damage and
fails the run even though its older siblings are waived. Waivers that
match nothing are reported (``unused_waivers``) so stale entries get
pruned; ``strict`` turns them into failures.

The parser is a deliberate TOML subset (``[[waiver]]`` tables with
string/int scalar keys and ``#`` comments) — the container has neither
``tomllib`` (3.10) nor a third-party toml package, and the waiver
format needs nothing more.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Tuple

from tuplewise_tpu_torch.analysis.core import Finding

_MIN_REASON = 20    # characters; "perf" is not a justification


class WaiverError(ValueError):
    """The waiver file is malformed or an entry lacks justification."""


@dataclasses.dataclass
class Waiver:
    rule: str
    file: str
    reason: str
    symbol: str = "*"
    count: int = 1
    line: int = 0

    def matches(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.file == self.file
                and fnmatch.fnmatchcase(f.symbol, self.symbol))


def parse_toml_subset(text: str) -> List[dict]:
    """``[[waiver]]`` tables of scalar keys; raises WaiverError on
    anything outside the subset so a typo never silently un-waives."""
    entries: List[dict] = []
    current: dict = {}
    in_table = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[waiver]]":
            if in_table:
                entries.append(current)
            current = {"__line__": lineno}
            in_table = True
            continue
        if line.startswith("["):
            raise WaiverError(
                f"waivers.toml:{lineno}: only [[waiver]] tables are "
                f"supported, got {line!r}")
        if "=" not in line or not in_table:
            raise WaiverError(
                f"waivers.toml:{lineno}: expected 'key = value' "
                f"inside a [[waiver]] table, got {line!r}")
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            parsed: object = val[1:-1]
        elif val.lstrip("-").isdigit():
            parsed = int(val)
        else:
            raise WaiverError(
                f"waivers.toml:{lineno}: value for {key!r} must be a "
                f'"double-quoted string" or an integer, got {val!r}')
        current[key] = parsed
    if in_table:
        entries.append(current)
    return entries


def load_waivers(text: str) -> List[Waiver]:
    out = []
    for ent in parse_toml_subset(text):
        line = ent.pop("__line__", 0)
        unknown = set(ent) - {"rule", "file", "symbol", "count",
                              "reason"}
        if unknown:
            raise WaiverError(
                f"waivers.toml:{line}: unknown keys {sorted(unknown)}")
        for req in ("rule", "file", "reason"):
            if not ent.get(req):
                raise WaiverError(
                    f"waivers.toml:{line}: missing required key "
                    f"{req!r}")
        if len(str(ent["reason"]).strip()) < _MIN_REASON:
            raise WaiverError(
                f"waivers.toml:{line}: reason too short — every "
                "waiver carries a real written justification "
                f"(≥ {_MIN_REASON} chars)")
        count = int(ent.get("count", 1))
        if count < 1:
            raise WaiverError(
                f"waivers.toml:{line}: count must be >= 1")
        out.append(Waiver(rule=str(ent["rule"]), file=str(ent["file"]),
                          reason=str(ent["reason"]),
                          symbol=str(ent.get("symbol", "*")),
                          count=count, line=line))
    return out


def apply_waivers(findings: List[Finding], waivers: List[Waiver]
                  ) -> Tuple[List[Finding], List[Tuple[Finding, Waiver]],
                             List[Waiver]]:
    """(unwaived, [(finding, waiver)], unused_waivers). Each waiver
    absorbs at most ``count`` findings — the ratchet: the count+1'th
    match is returned as unwaived."""
    budget: Dict[int, int] = {i: w.count for i, w in enumerate(waivers)}
    used: Dict[int, int] = {i: 0 for i in range(len(waivers))}
    unwaived: List[Finding] = []
    waived: List[Tuple[Finding, Waiver]] = []
    for f in findings:
        hit = None
        for i, w in enumerate(waivers):
            if w.matches(f) and budget[i] > 0:
                hit = i
                break
        if hit is None:
            unwaived.append(f)
        else:
            budget[hit] -= 1
            used[hit] += 1
            waived.append((f, waivers[hit]))
    unused = [w for i, w in enumerate(waivers) if used[i] == 0]
    return unwaived, waived, unused
