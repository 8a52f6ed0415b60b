"""Pass — integer-exactness + int32 overflow certification.

Every bit-identity claim of the port (worker axis vs single device,
kernel vs searchsorted twin, fleet vs independents) rests on ONE
invariant the other passes cannot see: win counts stay on an integer
path end to end, so the per-worker sums added over the mesh are exact.
Two analyses enforce it:

**1. Float-taint of the wins2 accumulators** (int lattice over the
dataflow substrate). An abstract interpretation chases every value
through assignments, calls, returns and attribute reads with the
lattice

    pyint  — Python int (arbitrary precision: the wins2 contract)
    int    — int64-family host integer (np.searchsorted, .astype(i64))
    int32  — device-width integer (the count launchers' blocks,
             ``out_int32=True`` searches, .int(), .to(torch.int32))
    float  — float-tainted (float literals, true division, np
             default-dtype constructors, .astype(float), 0.5 * x)

and judges every store/augmented-store into a ``*wins2*`` attribute:

* ``count-float-taint``        — a float-tainted value flows into a
  wins2 accumulator: the statistic silently stops being exact.
* ``count-narrow-accumulator`` — a raw int32 device value flows in
  without widening (``int()`` / ``.astype(np.int64)``): host
  accumulation inherits the device width and can wrap.

**2. Overflow certification of the int32 accumulators.** The
reference classifies the bodies of its jit factories. The port's int32
accumulators live in the CUDA sources (``csrc/*.cu``) and in the
``torch.searchsorted(..., out_int32=True)`` twins, where the body is no
Python the AST could classify, so the certificate is a declared table,
:data:`ACCUMULATORS`: one entry for each kernel launcher and each int32
count, merge or append path, with the reference counterpart it stands
for, that counterpart's category (``count``, ``psum-count``,
``planned-rank``) and its symbolic bound over the compile-ladder maxima
(S, cap, q_bucket, t_bucket, max_runs), the same maxima. The evaluated
table is the **overflow certificate** (report key
``overflow_certificate``; committed baseline
``analysis/exactness_bounds.toml`` — the CI gate diffs them, so a
ladder-maximum bump that breaks int32 safety fails with the violating
bound named). A public function of a module that loads a count kernel
(``signed_count.cu``, ``tenant_count.cu``) through ``ops/_build.py``
without a table entry is a finding (``overflow-unproved``), as is a
bound exceeding 2^31 − 1 at the declared maxima (``overflow-int32``).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted,
)
from tuplewise_tpu_torch.analysis import dataflow

INT32_LIMIT = 2 ** 31 - 1

#: The certified compile-ladder envelope. These are the maxima the
#: ladders are allowed to reach (DESIGN §17); the committed baseline
#: (analysis/exactness_bounds.toml) must declare the SAME values, and
#: the CI gate re-derives every bound from them — bump one here or
#: there without the other and the gate fails.
DEFAULT_MAXIMA: Dict[str, int] = {
    "S": 256,            # mesh width
    "cap": 2 ** 21,      # per-shard row bucket (base/delta/tomb caps)
    "q_bucket": 2 ** 16,  # query-block bucket
    "t_bucket": 2 ** 16,  # tenant-slot bucket
    "max_runs": 3,       # signed runs per side: base + delta + tomb
}

_P = "tuplewise_tpu_torch/"
_R = "tuplewise_tpu/"


class Accumulator(NamedTuple):
    """One declared int32 accumulator: the port function, the reference
    factory it stands for, that factory's category and bound terms
    (each a maxima key; ``extra`` multiplies their product)."""

    file: str
    function: str
    counterpart: str
    category: str
    terms: Tuple[str, ...]
    extra: int = 1


_PLANNED = "iinfo(int32).max sentinel (planned positions; ranks <= S*cap)"

#: every int32 accumulator of the port's count, merge and append paths
ACCUMULATORS: Tuple[Accumulator, ...] = (
    Accumulator(_P + "ops/count_kernels.py", "signed_count",
                _R + "ops/pallas_counts.py::flat_signed_count_fn",
                "count", ("max_runs", "cap")),
    Accumulator(_P + "ops/count_kernels.py", "signed_count_mesh",
                _R + "ops/pallas_counts.py::sharded_signed_count_fn",
                "psum-count", ("S", "max_runs", "cap")),
    Accumulator(_P + "ops/count_kernels.py", "tenant_count",
                _R + "ops/pallas_counts.py::tenant_signed_count_local_fn",
                "count", ("max_runs", "cap")),
    Accumulator(_P + "ops/count_kernels.py", "tenant_count_mesh",
                _R + "ops/pallas_counts.py::tenant_signed_count_fn",
                "psum-count", ("S", "max_runs", "cap")),
    Accumulator(_P + "parallel/sharded_counts.py",
                "signed_count_searchsorted",
                _R + "ops/pallas_counts.py::flat_signed_count_fn",
                "count", ("max_runs", "cap")),
    Accumulator(_P + "parallel/sharded_counts.py",
                "signed_count_searchsorted_mesh",
                _R + "parallel/sharded_counts.py::_xla_signed_pair_fn",
                "psum-count", ("S", "max_runs", "cap")),
    Accumulator(_P + "parallel/sharded_counts.py",
                "tenant_count_searchsorted",
                _R + "parallel/sharded_counts.py::tenant_count_local_fn",
                "count", ("cap",)),
    Accumulator(_P + "parallel/sharded_counts.py",
                "tenant_count_searchsorted_mesh",
                _R + "parallel/sharded_counts.py::tenant_count_fn",
                "psum-count", ("S", "cap")),
    Accumulator(_P + "parallel/sharded_counts.py", "delta_append",
                _R + "parallel/sharded_counts.py::delta_append_fn",
                "count", ("cap",), 2),
    Accumulator(_P + "parallel/sharded_counts.py", "sharded_major_merge",
                _R + "parallel/sharded_counts.py::_merge_chunk_fn",
                "planned-rank", ()),
)

#: the CUDA sources of the count kernels (kernels 6 and 7)
COUNT_SOURCES = ("signed_count.cu", "tenant_count.cu")


# --------------------------------------------------------------------- #
# int lattice                                                            #
# --------------------------------------------------------------------- #

PYINT = "pyint"
INT = "int"        # int64-family host value/array
INT32 = "int32"    # device-width integer
FLOAT = "float"    # float-tainted

_INT64_CTORS = {"np.searchsorted", "numpy.searchsorted"}
#: torch's int32 producers: the count launchers and their searchsorted
#: twins return int32 blocks (``torch.searchsorted`` itself is int32
#: only with ``out_int32=True``, see :meth:`IntDomain.call`)
_INT32_CTORS = {"signed_count", "signed_count_mesh", "tenant_count",
                "tenant_count_mesh", "signed_count_searchsorted",
                "signed_count_searchsorted_mesh",
                "tenant_count_searchsorted",
                "tenant_count_searchsorted_mesh"}
#: default-dtype constructors: numpy's float64, torch's float32
_FLOAT_CTORS = {"np.zeros", "np.ones", "np.full", "np.empty",
                "torch.zeros", "torch.ones", "torch.full", "torch.empty",
                "torch.rand", "torch.randn", "np.linspace",
                "torch.linspace"}
_SHAPE_PRESERVING = {"ravel", "reshape", "copy", "flatten",
                     "squeeze", "transpose", "clip"}


def _dtype_value(node: Optional[ast.AST]) -> Optional[str]:
    """Lattice value named by a dtype expression, if recognizable."""
    if node is None:
        return None
    d = dotted(node)
    if d is None:
        if isinstance(node, ast.Constant) \
                and isinstance(node.value, str):
            d = node.value
        else:
            return None
    leaf = d.split(".")[-1]
    if leaf in ("int64", "intp", "int_"):
        return INT
    if leaf in ("int32", "int16", "int8"):
        return INT32
    if leaf in ("float16", "float32", "float64", "bfloat16", "float"):
        return FLOAT
    if leaf == "int":
        return PYINT
    return None


class IntDomain(dataflow.Domain):
    """The integer-exactness lattice. ``top`` = unknown (NOT tainted:
    the pass under-approximates rather than spraying false floats)."""

    top = None

    def join(self, a, b):
        if a == b:
            return a
        if a is None or b is None:
            return None
        if FLOAT in (a, b):
            return FLOAT
        if INT32 in (a, b):
            return INT32
        return INT

    def const(self, value):
        if isinstance(value, bool):
            return PYINT
        if isinstance(value, int):
            return PYINT
        if isinstance(value, float):
            return FLOAT
        return None

    def binop(self, op, left, right):
        if isinstance(op, ast.Div):
            return FLOAT
        if left is None and right is None:
            return None
        if FLOAT in (left, right):
            return FLOAT
        if left is None or right is None:
            return None
        if INT32 in (left, right):
            return INT32
        if left == PYINT and right == PYINT:
            return PYINT
        return INT

    def call(self, cn, node, argvals, kwvals, recv=None):
        if cn is None:
            return None
        leaf = cn.split(".")[-1]
        if cn == "len":
            return PYINT
        if cn == "int":
            return PYINT
        if cn == "float":
            return FLOAT
        if cn in _INT64_CTORS:
            return INT
        if cn in _INT32_CTORS or leaf in _INT32_CTORS:
            return INT32
        if cn in ("torch.searchsorted", "torch.bucketize"):
            out32 = next((k.value for k in node.keywords
                          if k.arg == "out_int32"), None)
            return INT32 if isinstance(out32, ast.Constant) \
                and out32.value is True else INT
        if "." in cn and leaf in ("int", "long", "double", "float",
                                  "half"):
            # tensor casts: x.int() is int32, x.long() int64
            return {"int": INT32, "long": INT}.get(leaf, FLOAT)
        if leaf == "to":
            v = _dtype_value(next((k.value for k in node.keywords
                                   if k.arg == "dtype"), None))
            for a in node.args:
                v = v or _dtype_value(a)
            return v if v is not None else recv
        if leaf == "astype":
            v = _dtype_value(node.args[0]) if node.args else \
                _dtype_value(next((k.value for k in node.keywords
                                   if k.arg == "dtype"), None))
            return v
        if cn in _FLOAT_CTORS or leaf in ("arange", "asarray",
                                          "array", "zeros", "full",
                                          "ones", "empty"):
            v = _dtype_value(next(
                (k.value for k in node.keywords if k.arg == "dtype"),
                None))
            if v is not None:
                return v
            if cn in _FLOAT_CTORS:
                return FLOAT     # numpy default dtype is float64
            return None
        if leaf in ("sum", "cumsum", "prod", "max", "min", "dot"):
            return recv
        if leaf in _SHAPE_PRESERVING or leaf in ("cpu", "numpy",
                                                  "contiguous", "clone"):
            return recv
        if leaf in ("searchsorted",):
            # method form: arr.searchsorted(...) — host numpy
            return INT
        if leaf in ("mean", "std", "var", "item"):
            return FLOAT if leaf != "item" else recv
        if leaf in ("concatenate", "stack", "hstack", "vstack",
                    "where", "sort"):
            vals = [v for v in argvals if v is not None]
            if len(argvals) == 1 and isinstance(argvals[0],
                                                dataflow.Seq):
                vals = [v for v in argvals[0].elts if v is not None]
            out = None
            for v in vals:
                out = v if out is None else self.join(out, v)
            return out
        return None

    def attribute(self, base, attr):
        if attr == "size":
            return PYINT
        return None

    def subscript(self, base, index):
        # an element/slice of an int array is int-family; of a float
        # array float — the array value IS the element value here
        return base

    def unaryop(self, op, operand):
        return operand


# --------------------------------------------------------------------- #
# float-taint of the wins2 accumulators                                  #
# --------------------------------------------------------------------- #

def _is_wins2_target(node: ast.AST) -> Optional[str]:
    d = dotted(node)
    if d is None:
        return None
    leaf = d.split(".")[-1]
    if "wins2" in leaf:
        return d
    return None


def taint_findings(ms: ModuleSet,
                   engine: Optional[dataflow.Engine] = None
                   ) -> List[Finding]:
    if engine is None:
        engine = dataflow.Engine(ms, IntDomain())
    findings: List[Finding] = []
    seen: Set[str] = set()

    for key, node in engine.graph.functions.items():
        path, cls, qual = key
        hits: List[Tuple[str, int, Any]] = []

        def hook(walker, st, _hits=hits):
            target = value = None
            if isinstance(st, ast.AugAssign):
                target = _is_wins2_target(st.target)
                if target is not None:
                    value = walker.eval(st.value)
            elif isinstance(st, ast.Assign) and len(st.targets) == 1:
                target = _is_wins2_target(st.targets[0])
                if target is not None:
                    value = walker.eval(st.value)
            if target is not None:
                _hits.append((target, st.lineno, value))

        has_wins2 = any(
            isinstance(n, (ast.Assign, ast.AugAssign))
            and _is_wins2_target(
                n.target if isinstance(n, ast.AugAssign)
                else n.targets[0] if len(n.targets) == 1 else n)
            for n in ast.walk(node)
            if isinstance(n, (ast.Assign, ast.AugAssign)))
        if not has_wins2:
            continue
        engine.trace_function(key, hook)
        for target, line, value in hits:
            if value == FLOAT:
                f = Finding(
                    "count-float-taint", path, line,
                    f"{qual}::{target}",
                    f"{qual} stores a float-tainted value into the "
                    f"integer win-count accumulator {target} — the "
                    "statistic silently stops being exact (summed "
                    "worker blocks, kernel-vs-twin parity and every "
                    "bit-identity claim depend on the pure-integer "
                    "path, DESIGN §15)")
            elif value == INT32:
                f = Finding(
                    "count-narrow-accumulator", path, line,
                    f"{qual}::{target}",
                    f"{qual} accumulates a raw int32 device value "
                    f"into {target} without widening — host "
                    "accumulation inherits the device width and can "
                    "wrap; widen with int() or .astype(np.int64) "
                    "first")
            else:
                continue
            if f.fingerprint not in seen:
                seen.add(f.fingerprint)
                findings.append(f)
    return findings


# --------------------------------------------------------------------- #
# int32 overflow certification                                           #
# --------------------------------------------------------------------- #

def count_launchers(ms: ModuleSet) -> List[Tuple[str, str, int]]:
    """``(path, function, line)`` of every public module-level function
    that launches a count kernel: in a module where some function loads
    one of :data:`COUNT_SOURCES` through ``ops/_build.py``
    (``_build.load(<source>)``), each public function that reaches such
    a loader through module-local calls (the loaders themselves
    excluded)."""
    out: List[Tuple[str, str, int]] = []
    for path, mi in sorted(ms.modules.items()):
        consts = {}
        for st in mi.tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and isinstance(st.value, ast.Constant):
                consts[st.targets[0].id] = st.value.value

        def loads_count(fn: ast.AST) -> bool:
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call) or not sub.args:
                    continue
                cn = call_name(sub) or ""
                if cn.split(".")[-2:] != ["_build", "load"]:
                    continue
                arg = sub.args[0]
                val = arg.value if isinstance(arg, ast.Constant) else \
                    consts.get(arg.id) if isinstance(arg, ast.Name) \
                    else None
                if val in COUNT_SOURCES:
                    return True
            return False

        loaders = {n for n, fn in mi.functions.items() if loads_count(fn)}
        if not loaders:
            continue
        calls = {n: {call_name(c) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
                 for n, fn in mi.functions.items()}
        reach = set(loaders)
        changed = True
        while changed:
            changed = False
            for n, cs in calls.items():
                if n not in reach and cs & reach:
                    reach.add(n)
                    changed = True
        for n in sorted(reach - loaders):
            if not n.startswith("_"):
                out.append((path, n, mi.functions[n].lineno))
    return out


def certificates(ms: ModuleSet,
                 maxima: Optional[Dict[str, int]] = None,
                 accumulators: Tuple[Accumulator, ...] = ACCUMULATORS
                 ) -> Dict[str, Any]:
    """The overflow certificate: the declared accumulators' worst-case
    int32 bounds at the compile-ladder maxima. ``{"maxima": ...,
    "bounds": [...], "unproved": [...], "ok": bool}`` — each bound entry
    carries the function, its reference counterpart, category, symbolic
    expression, evaluated bound, and its verdict. An entry whose file is
    in the corpus but whose function is not, and a count launcher with
    no entry, are unproved."""
    maxima = dict(DEFAULT_MAXIMA if maxima is None else maxima)
    entries: List[Dict[str, Any]] = []
    unproved: List[Tuple[str, str, int]] = []
    declared = {(a.file, a.function) for a in accumulators}
    for acc in accumulators:
        mi = ms.modules.get(acc.file)
        if mi is None:
            continue
        node = mi.functions.get(acc.function)
        if node is None:
            unproved.append((acc.file, acc.function, 0))
            continue
        if acc.category == "planned-rank":
            bound, expr = INT32_LIMIT, _PLANNED
        else:
            missing = [t for t in acc.terms if t not in maxima]
            if missing:
                unproved.append((acc.file, acc.function, node.lineno))
                continue
            bound = acc.extra
            for t in acc.terms:
                bound *= maxima[t]
            expr = " * ".join(acc.terms) + \
                (f" * {acc.extra}" if acc.extra > 1 else "")
        entries.append({
            "function": acc.function,
            "file": acc.file,
            "line": node.lineno,
            "counterpart": acc.counterpart,
            "category": acc.category,
            "expr": expr,
            "bound": bound,
            "ok": bound <= INT32_LIMIT,
        })
    for path, name, line in count_launchers(ms):
        if (path, name) not in declared:
            unproved.append((path, name, line))
    entries.sort(key=lambda e: (e["file"], e["function"]))
    return {
        "maxima": maxima,
        "limit": INT32_LIMIT,
        "bounds": entries,
        "unproved": [{"file": p, "function": f, "line": ln}
                     for p, f, ln in sorted(unproved)],
        "ok": all(e["ok"] for e in entries) and not unproved,
    }


def overflow_findings(cert: Dict[str, Any]) -> List[Finding]:
    findings: List[Finding] = []
    for e in cert["bounds"]:
        if not e["ok"]:
            findings.append(Finding(
                "overflow-int32", e["file"], e["line"], e["function"],
                f"int32 accumulator in {e['function']} has worst-case "
                f"magnitude {e['bound']} ( = {e['expr']} at the "
                "declared compile-ladder maxima) > 2^31-1 — shrink "
                "the ladder envelope in analysis/exactness_bounds."
                "toml or widen the accumulator to int64"))
    for u in cert["unproved"]:
        findings.append(Finding(
            "overflow-unproved", u["file"], u["line"], u["function"],
            f"{u['function']} launches a count kernel (or is declared "
            "in ACCUMULATORS) but the certificate holds no bound for "
            "it — add its entry to analysis/exactness.ACCUMULATORS "
            "(or fix the stale one); an unbounded int32 accumulator is "
            "exactly how a ladder bump corrupts counts silently"))
    return findings


# --------------------------------------------------------------------- #
# baseline file (committed envelope)                                     #
# --------------------------------------------------------------------- #

class BaselineError(ValueError):
    """exactness_bounds.toml is malformed."""


def parse_baseline(text: str) -> Dict[str, Any]:
    """Parse the committed envelope: one ``[maxima]`` table plus
    ``[[bound]]`` entries — the same deliberate TOML subset as
    waivers.toml (no tomllib in this container)."""
    maxima: Dict[str, int] = {}
    bounds: List[Dict[str, Any]] = []
    current: Optional[Dict[str, Any]] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[maxima]":
            current = maxima
            continue
        if line == "[[bound]]":
            current = {}
            bounds.append(current)
            continue
        if line.startswith("["):
            raise BaselineError(
                f"exactness_bounds.toml:{lineno}: only [maxima] and "
                f"[[bound]] tables are supported, got {line!r}")
        if "=" not in line or current is None:
            raise BaselineError(
                f"exactness_bounds.toml:{lineno}: expected "
                f"'key = value' inside a table, got {line!r}")
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            current[key] = val[1:-1]
        elif val.lstrip("-").isdigit():
            current[key] = int(val)
        else:
            raise BaselineError(
                f"exactness_bounds.toml:{lineno}: value for {key!r} "
                f"must be a string or integer, got {val!r}")
    return {"maxima": maxima, "bounds": bounds}


def compare_to_baseline(cert: Dict[str, Any],
                        baseline_text: str) -> List[str]:
    """Diff the freshly-derived certificate against the committed
    envelope; returns human-readable violations (empty = in sync).
    The gate fails CI on any entry — a ladder bump, a new unproved
    accumulator, or a bound drift all land here with the bound NAMED."""
    try:
        base = parse_baseline(baseline_text)
    except BaselineError as e:
        return [str(e)]
    errors: List[str] = []
    if base["maxima"] != cert["maxima"]:
        errors.append(
            "ladder maxima drifted: committed "
            f"{base['maxima']} vs derived {cert['maxima']} — "
            "exactness_bounds.toml [maxima] and "
            "analysis/exactness.DEFAULT_MAXIMA must move together")
    by_key = {(b.get("file"), b.get("function")): b
              for b in base["bounds"]}
    for e in cert["bounds"]:
        k = (e["file"], e["function"])
        b = by_key.pop(k, None)
        if b is None:
            errors.append(
                "new int32 accumulator not in the committed "
                f"envelope: {e['function']} ({e['file']}) bound "
                f"{e['bound']} — re-baseline after review")
            continue
        if int(b.get("bound", -1)) != int(e["bound"]):
            errors.append(
                f"bound drifted for {e['function']} ({e['file']}): "
                f"committed {b.get('bound')} vs derived {e['bound']} "
                f"( = {e['expr']})")
        if not e["ok"]:
            errors.append(
                f"int32 safety violated: {e['function']} "
                f"({e['file']}) worst-case {e['bound']} = "
                f"{e['expr']} > 2^31-1")
    for (path, fac) in sorted(k for k in by_key):
        errors.append(
            f"stale baseline entry: {fac} ({path}) no longer derived "
            "— prune it from exactness_bounds.toml")
    for u in cert["unproved"]:
        errors.append(
            f"unproved int32 accumulator: {u['function']} ({u['file']})")
    return errors


# --------------------------------------------------------------------- #
# the pass                                                               #
# --------------------------------------------------------------------- #

def run(ms: ModuleSet,
        maxima: Optional[Dict[str, int]] = None) -> List[Finding]:
    engine = dataflow.Engine(ms, IntDomain())
    findings = taint_findings(ms, engine)
    findings.extend(overflow_findings(certificates(ms, maxima)))
    return findings
