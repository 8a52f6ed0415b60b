"""Pass 3 — telemetry cross-reference.

The doctor, the SLO engine, the run report and the perf gate
consume metric names, flight-event kinds and bench-row fields by
STRING MATCH — a typo'd producer ships silently and the consumer just
sees nothing. This pass closes the namespace:

* **producers** — every ``registry.counter/gauge/histogram("name")``
  (f-strings become glob patterns), every ``flight.record("kind")`` /
  ``_flight_event("kind")``, every span name
  (``tracer.start`` / ``maybe_span`` / ``record_span``), and every
  string dict key written into bench/replay result rows.
* **consumers** — string literals in the consumer modules
  (obs/doctor, obs/slo, obs/report, scripts_torch/perf_gate, serving/control)
  appearing in *consuming positions*: the accessor helpers
  (``_v`` / ``_sum_v`` / ``_metric_value`` / ``_g`` / ``_p_ms``),
  ``m.get("...")`` / ``metrics.get("...")``, ``"..." in metrics``,
  declared consumer sequences (``_RECOVERY_COUNTERS``), SLO spec
  literals (``"metric"`` / ``"errors"`` / ``"total"`` values),
  flight-kind positions (``by_kind.get`` / ``_after`` /
  ``e["kind"] == "..."``), and the perf-gate stage table's dotted
  value paths.
* **docs** — backticked telemetry-shaped tokens in README/DESIGN
  (suffixes ``_total`` / ``_s`` / ``_live``, or ``name{label=...}``
  forms) must name a real producer.

Rules: ``telemetry-consumed-unproduced`` (code consumer with no
producer), ``doc-telemetry-unknown`` (documented name with no
producer), ``telemetry-type-conflict`` (one name registered as two
different metric types), ``metric-direct-construction`` (a
Counter/Gauge/Histogram built outside the registry's create-or-return
helpers — the duplicate-registration race the registry exists to
prevent).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted, glob_match, literal_str,
    name_or_glob,
)

_METRIC_METHODS = {"counter": "counter", "gauge": "gauge",
                   "histogram": "histogram"}
# accessor -> index of the metric-name argument
_METRIC_ACCESSORS = {"_v": 1, "_sum_v": 1, "_metric_value": 1,
                     "_g": 0, "_p_ms": 1}
_FLIGHT_ACCESSORS = {"_after": 0}
_GET_RECEIVERS = {"m", "metrics"}
_KIND_RECEIVERS = {"by_kind", "kinds"}
_SPEC_KEYS = {"metric", "total"}
_SPEC_LIST_KEYS = {"errors"}
# spec-literal extraction only applies where dict literals ARE specs;
# the controller builds signal payloads whose "metric" values are
# derived names (tenant_insert_rate), not registry reads
_SPEC_LITERAL_FILES = ("tuplewise_tpu_torch/obs/slo.py",
                       "tuplewise_tpu_torch/obs/doctor.py")
_CONSUMER_SEQUENCES = {"_RECOVERY_COUNTERS"}

_DEFAULT_CONSUMERS = (
    "tuplewise_tpu_torch/obs/doctor.py",
    "tuplewise_tpu_torch/obs/slo.py",
    "tuplewise_tpu_torch/obs/report.py",
    "tuplewise_tpu_torch/serving/control.py",
    "scripts_torch/perf_gate.py",
)

_DOC_SUFFIXES = ("_total", "_s", "_live")
_NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")
_BACKTICK_RE = re.compile(r"`([^`\n]+)`")


def _strip_labels(name: str) -> str:
    i = name.find("{")
    return name[:i] if i >= 0 else name


def collect_producers(ms: ModuleSet
                      ) -> Tuple[Dict[str, Set[str]], Set[str],
                                 Set[str], Set[str]]:
    """(metric name -> {types}, flight kinds, span names, row keys).
    Names from f-strings land as glob patterns (contain ``*``)."""
    metrics: Dict[str, Set[str]] = {}
    flights: Set[str] = set()
    spans: Set[str] = set()
    row_keys: Set[str] = set()
    for path, mi in ms.modules.items():
        is_fixture = path.startswith("tests/")
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    s = literal_str(k) if k is not None else None
                    if s is not None:
                        row_keys.add(s)
            # out["kernel_calls_per_batch"] = ... — subscript writes
            # produce row fields just like dict literals do; augmented
            # writes (out["n"] += 1) and .setdefault("k", ...) too
            #
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        s = literal_str(t.slice)
                        if s is not None:
                            row_keys.add(s)
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Subscript):
                s = literal_str(node.target.slice)
                if s is not None:
                    row_keys.add(s)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "setdefault" and node.args:
                s = literal_str(node.args[0])
                if s is not None:
                    row_keys.add(s)
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            if cn is None or is_fixture:
                continue
            leaf = cn.split(".")[-1]
            if leaf in _METRIC_METHODS and node.args:
                name = name_or_glob(node.args[0])
                if name is not None:
                    metrics.setdefault(name, set()).add(
                        _METRIC_METHODS[leaf])
            elif leaf == "record" and node.args \
                    and not cn.endswith("record_span"):
                k = name_or_glob(node.args[0])
                if k is not None:
                    flights.add(k)
            elif leaf == "_flight_event" and node.args:
                k = name_or_glob(node.args[0])
                if k is not None:
                    flights.add(k)
            elif leaf in ("record_span", "start", "maybe_span"):
                # tracer.start("name") / maybe_span(tracer, "name")
                idx = 1 if leaf == "maybe_span" else 0
                if len(node.args) > idx:
                    s = name_or_glob(node.args[idx])
                    if s is not None:
                        spans.add(s)
    return metrics, flights, spans, row_keys


def collect_consumers(ms: ModuleSet, consumer_paths
                      ) -> Tuple[List[Tuple[str, int, str]],
                                 List[Tuple[str, int, str]],
                                 List[Tuple[str, int, str]]]:
    """(metric consumers, flight-kind consumers, row-field consumers)
    as (path, line, name) triples."""
    m_cons: List[Tuple[str, int, str]] = []
    f_cons: List[Tuple[str, int, str]] = []
    r_cons: List[Tuple[str, int, str]] = []
    for path in consumer_paths:
        mi = ms.modules.get(path)
        if mi is None:
            continue
        is_gate = path.endswith("perf_gate.py")
        for node in ast.walk(mi.tree):
            # accessor calls
            if isinstance(node, ast.Call):
                cn = call_name(node)
                leaf = cn.split(".")[-1] if cn else ""
                recv = cn.rsplit(".", 1)[0] if cn and "." in cn else ""
                if cn in _METRIC_ACCESSORS:
                    idx = _METRIC_ACCESSORS[cn]
                    if idx < len(node.args):
                        s = literal_str(node.args[idx])
                        if s is not None:
                            m_cons.append((path, node.lineno,
                                           _strip_labels(s)))
                elif leaf == "get" and recv in _GET_RECEIVERS \
                        and node.args:
                    s = literal_str(node.args[0])
                    if s is not None:
                        m_cons.append((path, node.lineno,
                                       _strip_labels(s)))
                elif leaf == "get" and recv in _KIND_RECEIVERS \
                        and node.args:
                    s = literal_str(node.args[0])
                    if s is not None:
                        f_cons.append((path, node.lineno, s))
                elif cn in _FLIGHT_ACCESSORS and node.args:
                    s = literal_str(node.args[_FLIGHT_ACCESSORS[cn]])
                    if s is not None:
                        f_cons.append((path, node.lineno, s))
            # "name" in metrics
            elif isinstance(node, ast.Compare) and node.ops:
                if isinstance(node.ops[0], ast.In) \
                        and isinstance(node.comparators[0], ast.Name) \
                        and node.comparators[0].id in _GET_RECEIVERS:
                    s = literal_str(node.left)
                    if s is not None:
                        m_cons.append((path, node.lineno,
                                       _strip_labels(s)))
                # e["kind"] == "batcher_restart" / base == "..."
                elif isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                    lhs, rhs = node.left, node.comparators[0]
                    sub = lhs if isinstance(lhs, ast.Subscript) else (
                        rhs if isinstance(rhs, ast.Subscript) else None)
                    lit = literal_str(rhs) or literal_str(lhs)
                    if sub is not None and lit is not None:
                        key = literal_str(sub.slice)
                        if key == "kind":
                            f_cons.append((path, node.lineno, lit))
                        elif key == "name":
                            pass    # span-name comparisons: info only
                    elif lit is not None and isinstance(lhs, ast.Name) \
                            and lhs.id == "base":
                        m_cons.append((path, node.lineno,
                                       _strip_labels(lit)))
            # declared consumer sequences (tuple-of-strings constants)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) \
                        and t.id in _CONSUMER_SEQUENCES \
                        and isinstance(node.value, (ast.Tuple,
                                                    ast.List)):
                    for el in node.value.elts:
                        s = literal_str(el)
                        if s is not None:
                            m_cons.append((path, node.lineno, s))
            # SLO spec literals: {"metric": "x", "errors": [...]}
            elif isinstance(node, ast.Dict) \
                    and path in _SPEC_LITERAL_FILES:
                for k, v in zip(node.keys, node.values):
                    ks = literal_str(k) if k is not None else None
                    if ks in _SPEC_KEYS:
                        s = literal_str(v)
                        if s is not None:
                            m_cons.append((path, v.lineno,
                                           _strip_labels(s)))
                    elif ks in _SPEC_LIST_KEYS and isinstance(
                            v, (ast.Tuple, ast.List)):
                        for el in v.elts:
                            s = literal_str(el)
                            if s is not None:
                                m_cons.append((path, el.lineno,
                                               _strip_labels(s)))
        # perf gate: _STAGE_METRICS dotted value paths + stage names
        if is_gate:
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == "_STAGE_METRICS" \
                        and isinstance(node.value, ast.Dict):
                    for k, v in zip(node.value.keys, node.value.values):
                        s = literal_str(k)
                        if s is not None:
                            r_cons.append((path, k.lineno,
                                           f"stage:{s}"))
                        for el in ast.walk(v):
                            if isinstance(el, ast.Tuple) \
                                    and len(el.elts) == 3:
                                fld = literal_str(el.elts[2])
                                if fld is not None:
                                    last = fld.split(".")[-1]
                                    if not last.isdigit():
                                        r_cons.append(
                                            (path, el.lineno, last))
    return m_cons, f_cons, r_cons


def doc_tokens(ms: ModuleSet) -> List[Tuple[str, str]]:
    """Backticked telemetry-shaped tokens in the doc files."""
    out = []
    for path, text in ms.texts.items():
        for tok in _BACKTICK_RE.findall(text):
            base = _strip_labels(tok.strip())
            if not _NAME_RE.match(base):
                continue
            if "{" in tok and "=" in tok:
                out.append((path, base))
            elif base.endswith(_DOC_SUFFIXES) and "_" in base \
                    and "." not in base:
                out.append((path, base))
    return out


def _produced(name: str, metrics: Dict[str, Set[str]]) -> bool:
    if name in metrics:
        return True
    pats = [p for p in metrics if "*" in p]
    return glob_match(name, pats)


def run(ms: ModuleSet, consumer_paths=_DEFAULT_CONSUMERS
        ) -> List[Finding]:
    metrics, flights, spans, row_keys = collect_producers(ms)
    m_cons, f_cons, r_cons = collect_consumers(ms, consumer_paths)
    findings: List[Finding] = []

    for path, line, name in m_cons:
        if not _produced(name, metrics):
            findings.append(Finding(
                "telemetry-consumed-unproduced", path, line, name,
                f"metric {name!r} is consumed here but no code "
                "registers it (typo or dead consumer — doctor/SLO "
                "would silently see nothing)"))
    for path, line, kind in f_cons:
        if kind not in flights and not glob_match(
                kind, [p for p in flights if "*" in p]):
            findings.append(Finding(
                "telemetry-consumed-unproduced", path, line,
                f"flight:{kind}",
                f"flight-event kind {kind!r} is consumed here but "
                "never recorded by any producer"))
    for path, line, field in r_cons:
        if field.startswith("stage:"):
            stage = field[len("stage:"):]
            if stage not in row_keys and not any(
                    stage == v for v in _stage_values(ms)):
                findings.append(Finding(
                    "telemetry-consumed-unproduced", path, line,
                    field,
                    f"perf-gate stage {stage!r} never appears as a "
                    "result-row stage value"))
        elif field not in row_keys:
            findings.append(Finding(
                "telemetry-consumed-unproduced", path, line, field,
                f"perf-gate row field {field!r} never appears as a "
                "result-row key in any producer — the gate check "
                "passes vacuously"))

    known = set(flights) | row_keys | _config_fields(ms) \
        | _param_names(ms) | _attr_names(ms)
    for path, base in doc_tokens(ms):
        if not _produced(base, metrics) and base not in known:
            findings.append(Finding(
                "doc-telemetry-unknown", path, 0, base,
                f"{path} documents telemetry name {base!r} but no "
                "code produces it (not a metric, flight kind, result-"
                "row key, or parameter either)"))

    # type conflicts: one name, two metric types
    for name, types in sorted(metrics.items()):
        if len(types) > 1:
            findings.append(Finding(
                "telemetry-type-conflict", "<registry>", 0, name,
                f"metric {name!r} registered as multiple types "
                f"({'/'.join(sorted(types))}) — the registry raises "
                "at runtime on whichever call site loses the race"))

    # direct construction outside the registry
    for path, mi in ms.modules.items():
        if path.endswith("utils/profiling.py") \
                or path.startswith("tests/"):
            continue
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call):
                cn = call_name(node)
                if cn in ("Counter", "Gauge", "Histogram") \
                        and node.args \
                        and literal_str(node.args[0]) is not None:
                    # the import TABLE decides (the profiling module
                    # need not be in the analyzed corpus — fixtures)
                    target = mi.imports.get(cn, "")
                    if target.startswith(
                            "tuplewise_tpu_torch.utils.profiling:"):
                        findings.append(Finding(
                            "metric-direct-construction", path,
                            node.lineno,
                            f"{cn}:{literal_str(node.args[0])}",
                            f"{cn}({literal_str(node.args[0])!r}) "
                            "constructed directly — metrics must come "
                            "from the registry's create-or-return "
                            "helpers so concurrent registration can't "
                            "produce twin series"))
    return findings


def _stage_values(ms: ModuleSet) -> Set[str]:
    """Every literal value assigned to a "stage" dict key anywhere —
    the stage names result rows are tagged with."""
    out: Set[str] = set()
    for path, mi in ms.modules.items():
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if k is not None and literal_str(k) == "stage":
                        s = literal_str(v)
                        if s is not None:
                            out.add(s)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "stage":
                        s = literal_str(kw.value)
                        if s is not None:
                            out.add(s)
    return out


def _param_names(ms: ModuleSet) -> Set[str]:
    """Function parameter and property names across the corpus — docs
    legitimately backtick those (``timeout_s``, ``retries_total``)."""
    out: Set[str] = set()
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            node = fi.node
            args = getattr(node, "args", None)
            if args is None:
                continue
            for a in (args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                out.add(a.arg)
            out.add(getattr(node, "name", ""))
    return out


def _attr_names(ms: ModuleSet) -> Set[str]:
    """Instance-attribute names assigned anywhere (``self.x = ...``):
    docs legitimately backtick object state (``n_evicted``,
    ``retry_backoff_s``) that is neither a metric nor a config field
   ."""
    out: Set[str] = set()
    for path, mi in ms.modules.items():
        for node in ast.walk(mi.tree):
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = (node.target,)
            for t in targets:
                d = dotted(t)
                if d and d.startswith("self.") \
                        and "." not in d[len("self."):]:
                    out.add(d[len("self."):])
    return out


def _config_fields(ms: ModuleSet) -> Set[str]:
    """Dataclass field names across the corpus — doc tokens ending in
    ``_s`` are often config knobs, not metrics; exclude them."""
    from tuplewise_tpu_torch.analysis.config_drift import dataclass_fields

    out: Set[str] = set()
    for fields in dataclass_fields(ms).values():
        out.update(f for f, _ in fields)
    out.update({"retry_after_s", "window_s", "ts_mono", "t_wall",
                "dur_s", "t0_s", "self_s", "total_s", "build_s",
                "waited_s", "t_mono", "duration_s"})
    return out
