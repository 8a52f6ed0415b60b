"""Summarize a trace into a small text table (the counterpart of the JAX
package's ``scripts/trace_summary.py``).

Four input shapes, auto-detected:

* a **directory** — a ``torch.profiler`` trace (``utils.profiling.trace``
  writes ``<dir>/trace.json``; ``*.trace.json`` and ``*.trace.json.gz``
  below the directory are read too): the DEVICE work, the events
  torch.profiler files under the categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``, digested into per-kernel totals (each kernel by
  its own name: no ``void``, namespace, template arguments or
  parameters). A trace with no device event (a CPU-only run) raises:
  the digest never falls back to host events;
* a ``*.jsonl`` **file** — the span JSONL of ``obs.tracing.Tracer``:
  top spans by SELF time (total minus child time), plus a per-stage
  insert-latency p99 table;
* a ``*.json`` **file** — the Chrome trace-event export of the spans:
  the same summary, from the ``X`` events' span and parent ids;
* a ``*.collapsed`` / ``*.txt`` / ``*.speedscope.json`` **file** — the
  sampling profiler's export (``obs.prof.SamplingProfiler``): samples
  classified into a host-tax table plus the top leaf frames.

Usage: python scripts_torch/trace_summary.py
           <dir | spans.jsonl | trace.json | prof.collapsed> [top_n]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

# torch.profiler's categories of work done on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_files(trace_dir: str):
    pats = ("trace.json", "*.trace.json", "*.trace.json.gz")
    return sorted({f for p in pats for f in glob.glob(
        os.path.join(trace_dir, "**", p), recursive=True)})


def load_events(trace_dir: str):
    """The complete ('X') events of every trace file under trace_dir."""
    files = trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no trace json under {trace_dir!r}")
    events = []
    for f in files:
        op = gzip.open if f.endswith(".gz") else open
        with op(f, "rt") as fh:
            data = json.load(fh)
        events += [e for e in data.get("traceEvents", [])
                   if e.get("ph") == "X"]
    return events


def kernel_name(name: str) -> str:
    """A device event's name without ``void``, the anonymous namespace,
    scopes, template arguments or parameters; copies keep their name."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    m = re.match(r"[\w:]+", n)
    if m and n[m.end():m.end() + 1] in ("<", "("):
        return m.group(0).split("::")[-1]
    return name


def summarize(trace_dir: str, top_n: int = 15) -> str:
    events = load_events(trace_dir)
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not dev:
        raise ValueError(
            f"{trace_dir!r} holds {len(events)} complete events and none "
            f"of the device categories {DEVICE_CATEGORIES}: a CPU-only "
            f"trace, or one where the profiler saw no kernel")
    per_op = defaultdict(float)
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e.get("dur", 0) for e in dev)
    for e in dev:
        per_op[kernel_name(e["name"])] += e.get("dur", 0.0)
    total = sum(per_op.values())
    lines = [
        f"trace: {trace_dir}",
        f"device events: {len(dev)}  span: {(t1 - t0) / 1e6:.3f}s  "
        f"summed op time: {total / 1e6:.3f}s",
        f"{'op':<58} {'total_ms':>10} {'share':>7}",
    ]
    for name, dur in sorted(per_op.items(), key=lambda kv: -kv[1])[:top_n]:
        nm = name if len(name) <= 57 else name[:54] + "..."
        share = dur / total if total else 0.0
        lines.append(f"{nm:<58} {dur / 1e3:>10.2f} {share:>6.1%}")
    return "\n".join(lines)


# --------------------------------------------------------------------- #
# span-trace summaries                                                   #
# --------------------------------------------------------------------- #

def load_spans(path: str):
    """Spans as dicts with trace_id/span_id/parent_id/name/t0_s/dur_s,
    from either the span JSONL or the Chrome trace-event export."""
    if path.endswith(".jsonl"):
        spans = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if "meta" in rec:
                    continue
                spans.append(rec)
        return spans
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    spans = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        spans.append({
            "trace_id": args.get("trace_id"),
            "span_id": args.get("span_id"),
            "parent_id": args.get("parent_id"),
            "name": e["name"],
            "t0_s": e["ts"] / 1e6,
            "dur_s": e.get("dur", 0.0) / 1e6,
        })
    return spans


def _quantile(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def summarize_spans(path: str, top_n: int = 15) -> str:
    spans = load_spans(path)
    if not spans:
        raise ValueError(f"{path!r} contains no spans")
    # self time: total minus the time of DIRECT children
    child_time = defaultdict(float)
    for s in spans:
        if s.get("parent_id") is not None:
            child_time[s["parent_id"]] += s["dur_s"]
    agg = defaultdict(lambda: {"n": 0, "total": 0.0, "self": 0.0,
                               "durs": []})
    for s in spans:
        a = agg[s["name"]]
        a["n"] += 1
        a["total"] += s["dur_s"]
        a["self"] += max(0.0, s["dur_s"] - child_time.get(s["span_id"],
                                                          0.0))
        a["durs"].append(s["dur_s"])
    n_traces = len({s["trace_id"] for s in spans})
    t0 = min(s["t0_s"] for s in spans)
    t1 = max(s["t0_s"] + s["dur_s"] for s in spans)
    lines = [
        f"trace: {path}",
        f"spans: {len(spans)}  traces: {n_traces}  "
        f"span window: {t1 - t0:.3f}s",
        "",
        f"{'span (by self time)':<34} {'n':>7} {'self_ms':>10} "
        f"{'total_ms':>10} {'p99_ms':>9}",
    ]
    by_self = sorted(agg.items(), key=lambda kv: -kv[1]["self"])
    for name, a in by_self[:top_n]:
        nm = name if len(name) <= 33 else name[:30] + "..."
        lines.append(
            f"{nm:<34} {a['n']:>7} {a['self'] * 1e3:>10.2f} "
            f"{a['total'] * 1e3:>10.2f} "
            f"{_quantile(a['durs'], 0.99) * 1e3:>9.3f}")
    # per-stage insert-latency table: the insert.* children tile each
    # request's lifetime, so these p99s are the latency decomposition
    stages = {n: a for n, a in agg.items() if n.startswith("insert.")}
    if stages:
        lines += ["", f"{'insert stage':<24} {'n':>7} {'p50_ms':>9} "
                      f"{'p99_ms':>9} {'max_ms':>9}"]
        for name, a in sorted(stages.items(),
                              key=lambda kv: -kv[1]["total"]):
            lines.append(
                f"{name:<24} {a['n']:>7} "
                f"{_quantile(a['durs'], 0.5) * 1e3:>9.3f} "
                f"{_quantile(a['durs'], 0.99) * 1e3:>9.3f} "
                f"{max(a['durs']) * 1e3:>9.3f}")
    return "\n".join(lines)


# --------------------------------------------------------------------- #
# host-tax digest of sampling-profiler exports                           #
# --------------------------------------------------------------------- #

# (category, substring-match over the frame's trimmed path) — first
# match wins, checked leaf-to-root so the innermost classifiable frame
# decides; order encodes specificity
_HOST_TAX_CATEGORIES = (
    ("wait_idle", ("threading.py:wait", "threading.py:_wait",
                   "queue.py:get", "queue.py:put", "selectors.py:",
                   "socket.py:", "ssl.py:")),
    ("gc_or_prof", ("obs/prof.py:", "obs/ledger.py:")),
    ("wal_snapshot_io", ("serving/recovery.py:",)),
    ("jax_dispatch", ("jax/", "jaxlib/", "jax\\", "/pjit.py:",
                      "pallas/")),
    ("mesh_glue", ("parallel/sharded_counts.py:", "parallel/mesh.py:",
                   "parallel/self_heal.py:")),
    ("serving_python", ("serving/", "estimators/")),
    ("observability", ("obs/", "utils/profiling.py:")),
    ("numpy_host", ("numpy/", "numpy\\")),
)


def classify_frame(frame: str):
    for cat, pats in _HOST_TAX_CATEGORIES:
        for p in pats:
            if p in frame:
                return cat
    return None  # unclassified — caller falls back toward the root


def classify_stack(stack) -> str:
    """Walk leaf to root; the innermost frame with a known category
    names the sample."""
    for frame in reversed(stack):
        cat = classify_frame(frame)
        if cat is not None:
            return cat
    return "other_host"


def load_collapsed(path: str):
    """[(stack tuple root->leaf, count)] from a collapsed-stack file or
    a speedscope "sampled" export."""
    if path.endswith(".speedscope.json") or path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        frames = [fr["name"] for fr in doc["shared"]["frames"]]
        out = []
        for prof in doc.get("profiles", []):
            if prof.get("type") != "sampled":
                continue
            for sample in prof.get("samples", []):
                out.append((tuple(frames[i] for i in sample), 1))
        return out
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            stack, _, n = line.rpartition(" ")
            out.append((tuple(stack.split(";")), int(n)))
    return out


def summarize_collapsed(path: str, top_n: int = 15) -> str:
    """The host-tax table: sample share per stack layer, plus the top
    leaf frames."""
    stacks = load_collapsed(path)
    if not stacks:
        raise ValueError(f"{path!r} contains no stack samples")
    by_cat = defaultdict(int)
    by_leaf = defaultdict(int)
    total = 0
    for stack, n in stacks:
        total += n
        by_cat[classify_stack(stack)] += n
        by_leaf[stack[-1]] += n
    lines = [
        f"profile: {path}",
        f"samples: {total}  distinct stacks: {len(stacks)}",
        "",
        f"{'host-tax category':<24} {'samples':>8} {'share':>7}",
    ]
    for cat, n in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        lines.append(f"{cat:<24} {n:>8} {n / total:>6.1%}")
    lines += ["", f"{'top leaf frame':<52} {'samples':>8} {'share':>7}"]
    for leaf, n in sorted(by_leaf.items(),
                          key=lambda kv: (-kv[1], kv[0]))[:top_n]:
        nm = leaf if len(leaf) <= 51 else leaf[:48] + "..."
        lines.append(f"{nm:<52} {n:>8} {n / total:>6.1%}")
    return "\n".join(lines)


def digest(path: str, top_n: int = 15) -> str:
    """The summary of any of the four input shapes."""
    if os.path.isdir(path):
        return summarize(path, top_n)
    if path.endswith((".collapsed", ".txt", ".speedscope.json")):
        return summarize_collapsed(path, top_n)
    return summarize_spans(path, top_n)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[-2].strip(), file=sys.stderr)
        return 2
    print(digest(argv[0], int(argv[1]) if len(argv) > 1 else 15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
