"""Pass — host-cost certification of the request path.

The serving request path is Python, not device: on the card the
runtime ledger measures a host fraction near 1 (PERF.md §5). The
one-dispatch-core refactor on the roadmap exists to cut that, and this
pass is its STATIC twin, so the refactor's progress ratchets in CI (the
compile_ladder → exactness_bounds pattern, applied to host cost) and a
regression fails by name instead of surfacing as a perf-gate breach
later.

For every **request-path root** (`MicroBatchEngine.submit/insert/
score` + batcher apply, the `MultiTenantEngine` twins, the index and
fleet insert paths, the sharded/fused/tenant-axis count dispatchers)
the pass walks everything reachable through the corpus call graph and
derives an abstract **cost summary**: how many of each cost-bearing
construct execute, classified by loop multiplicity:

* ``alloc``     — dict/list/tuple/set displays + comprehensions
                  (every one is a Python object construction)
* ``ctor``      — class constructions (repo classes and stdlib
                  container ctors: per-event object graphs are
                  exactly what the arena/SoA refactor removes)
* ``np_alloc``  — numpy/torch array-allocating calls (asarray,
                  concatenate, zeros, sort, insert, …)
* ``attr_hop``  — attribute / subscript indirection loads (the
                  per-tenant dict-hop tax the ledger measured)
* ``lock``      — lock acquisitions (``with self._lock``)
* ``dispatch``  — device dispatches (the lock pass's
                  ``DISPATCH_NAMES``: the count layer, the kernel
                  launchers and the collectives); a launcher is a
                  leaf, the walk does not enter its plain version

**Loop classification.** Each site's multiplicity is the join of its
enclosing loops, inferred by a dataflow chase over the loop iterable
(local assignment chase, then token classification over the serving
stack's wave/batch/tenant collection vocabulary):

* ``O(1)``        — not in a loop, constant-tuple iteration,
                    ``range(<const>)``
* ``O(tenants)``  — loops over tenants-in-wave collections
                    (``groups``/``segs``/``_pending``/``wave``/…)
* ``O(events)``   — loops over request/event collections (``run``/
                    ``batch``/``scores``/``reqs``/…); unknown
                    iterables conservatively land here

Interprocedural propagation carries the caller's site multiplicity
into callees (a helper called per event pays per event), visited once
per (function, multiplicity) per root.

The evaluated table is the **hotpath certificate** (report key
``hotpath_certificate``), diffed by the CI gate against the committed
``tuplewise_tpu_torch/analysis/hotpath_budget.toml``: any root whose loop
class worsens or whose counter GROWS fails CI naming the root, the
contributing sites, and the violated budget line; any counter that
SHRINKS ratchets the budget file downward (the gate rewrites it, the
PR commits the improvement). A root the corpus no longer defines is a
finding (``hotpath-root-missing``) so a rename can never silently
drop certification.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted,
)
from tuplewise_tpu_torch.analysis import lock_order

FuncKey = Tuple[str, str, str]

#: the certified request-path roots: (path, class, method). submit /
#: insert / score are the caller-facing edge; the batcher apply
#: functions are the per-wave hot loop; the index / fleet insert
#: paths and the count dispatchers are what they reach.
ROOTS: Tuple[Tuple[str, str, str], ...] = (
    ("tuplewise_tpu_torch/serving/engine.py", "MicroBatchEngine", "submit"),
    ("tuplewise_tpu_torch/serving/engine.py", "MicroBatchEngine", "insert"),
    ("tuplewise_tpu_torch/serving/engine.py", "MicroBatchEngine", "score"),
    ("tuplewise_tpu_torch/serving/engine.py", "MicroBatchEngine",
     "_apply_inserts_wave"),
    ("tuplewise_tpu_torch/serving/tenancy.py", "MultiTenantEngine", "submit"),
    ("tuplewise_tpu_torch/serving/tenancy.py", "MultiTenantEngine", "insert"),
    ("tuplewise_tpu_torch/serving/tenancy.py", "MultiTenantEngine", "score"),
    ("tuplewise_tpu_torch/serving/tenancy.py", "MultiTenantEngine",
     "_apply_insert_wave_ledgered"),
    ("tuplewise_tpu_torch/serving/index.py", "ExactAucIndex", "insert_batch"),
    ("tuplewise_tpu_torch/serving/tenancy.py", "TenantFleetIndex",
     "apply_inserts"),
    ("tuplewise_tpu_torch/parallel/sharded_counts.py", "", "sharded_counts"),
    ("tuplewise_tpu_torch/parallel/sharded_counts.py", "",
     "signed_pair_counts"),
    ("tuplewise_tpu_torch/parallel/sharded_counts.py", "",
     "tenant_pack_counts"),
)

#: multiplicity lattice (index = severity order)
O1 = "O(1)"
OTEN = "O(tenants)"
OEV = "O(events)"
_MULT_ORDER = (O1, OTEN, OEV)
_MULT_SUFFIX = {O1: "per_wave", OTEN: "per_tenant", OEV: "per_event"}

#: counter families
COUNTERS = ("alloc", "ctor", "np_alloc", "attr_hop", "lock",
            "dispatch")

#: iterable-name tokens that classify a loop bound. Matched against
#: the (chased) dotted source of the iterable, token-wise.
_EVENT_TOKENS = {"run", "runs", "batch", "reqs", "requests", "scores",
                 "labels", "queue_waits", "events", "stale", "expired",
                 "dq", "live", "vals", "values", "items", "keep",
                 "records", "plan", "batches"}
_TENANT_TOKENS = {"groups", "segs", "tenants", "sts", "wave", "waves",
                  "pending", "_pending", "rotation", "tids",
                  "by_tenant", "packs", "slots", "dirty"}

#: loop iterables that enumerate the sorted runs of ONE count, by file:
#: a count takes at most ``ops.count_kernels.MAX_RUNS`` runs (the
#: launch limit its ``_check`` enforces; the searchsorted twin is given
#: the same lists), so such a loop is O(1) a wave. The reference's count
#: layer runs these loops inside its jitted bodies; the port runs them on
#: the host, so their bound is declared here.
RUN_BOUNDED: Dict[str, Set[str]] = {
    "tuplewise_tpu_torch/parallel/sharded_counts.py": {
        "deltas", "delta_devs", "rs", "runs_a", "runs_b"},
}

#: array-allocating numpy/torch call leaves
_NP_ALLOC_LEAVES = {"asarray", "array", "atleast_1d", "concatenate",
                    "zeros", "ones", "empty", "full", "arange",
                    "linspace", "sort", "insert", "searchsorted",
                    "stack", "hstack", "vstack", "copy", "astype",
                    "repeat", "tile", "where", "cumsum", "unique",
                    "split", "pad"}
_NP_HEADS = {"np", "numpy", "torch"}

#: stdlib container constructors (counted as ctor when called)
_STDLIB_CTORS = {"dict", "list", "set", "tuple", "deque",
                 "OrderedDict", "defaultdict", "Counter", "Future"}

_MAX_SITES = 8          # example sites kept per (root, counter key)


def _join_mult(a: str, b: str) -> str:
    return _MULT_ORDER[max(_MULT_ORDER.index(a), _MULT_ORDER.index(b))]


def _tokens(expr: str) -> Set[str]:
    out: Set[str] = set()
    for part in expr.replace("(", ".").replace(")", ".").split("."):
        part = part.strip().strip("_")
        if part:
            out.add(part)
            out.add("_" + part)
    return out


def classify_source(expr: str) -> str:
    """Multiplicity class of a loop iterable named ``expr`` (after
    the local chase): tenant tokens beat event tokens beat the
    conservative O(events) default for unknowns."""
    toks = _tokens(expr)
    if toks & _TENANT_TOKENS:
        return OTEN
    if toks & _EVENT_TOKENS:
        return OEV
    return OEV      # unknown collection: price it conservatively


class _CostWalker:
    """One (function, multiplicity) context walk for one root:
    records cost sites and enqueues resolved callees at the call
    site's multiplicity."""

    def __init__(self, cost: "_CostAnalysis", key: FuncKey,
                 mult: str):
        self.cost = cost
        self.an = cost.an
        self.ms = cost.ms
        self.key = key
        self.entry_mult = mult
        path, cls, qual = key
        self.path = path
        self.cls = cls or None
        self.qual = qual
        self.model = (self.an.model(path, self.cls)
                      if self.cls else None)
        # local name -> source expression string (one-step chase for
        # loop-iterable classification)
        self.sources: Dict[str, str] = {}

    # ------------------------------------------------------------------ #
    def loop_class(self, it: ast.AST) -> str:
        """Multiplicity of one loop's iterable."""
        # constant displays iterate a fixed small number of times
        if isinstance(it, (ast.Tuple, ast.List, ast.Set)):
            return O1
        if isinstance(it, ast.Call):
            cn = call_name(it) or ""
            leaf = cn.split(".")[-1]
            if leaf == "range":
                if all(isinstance(a, ast.Constant) for a in it.args):
                    return O1
                args = " ".join(dotted(a) or "" for a in it.args)
                return self.loop_class_of_name(args)
            if leaf in ("items", "keys", "values", "enumerate", "zip",
                        "sorted", "reversed", "list"):
                inner = (it.func.value
                         if isinstance(it.func, ast.Attribute)
                         else (it.args[0] if it.args else None))
                if inner is not None:
                    return self.loop_class(inner)
            if leaf == "_waves" or "wave" in leaf:
                return OTEN
            return self.loop_class_of_name(cn)
        d = dotted(it)
        if d is not None:
            return self.loop_class_of_name(d)
        if isinstance(it, (ast.ListComp, ast.GeneratorExp)):
            return self.loop_class(it.generators[0].iter)
        return OEV

    def loop_class_of_name(self, name: str) -> str:
        # chase one local assignment: groups = wave["insert"] etc.
        head = name.split(".")[0].split(" ")[0]
        if head in RUN_BOUNDED.get(self.path, ()):
            return O1
        src = self.sources.get(head)
        if src is not None and src != name:
            return classify_source(f"{src} {name}")
        return classify_source(name)

    # ------------------------------------------------------------------ #
    def run(self, node: ast.AST) -> None:
        for sub in ast.iter_child_nodes(node):
            self.visit(sub, self.entry_mult)

    def visit(self, node: ast.AST, mult: str) -> None:
        """Record ``node``'s own cost at ``mult`` and recurse, raising
        the multiplicity for loop bodies (a For's header still bills
        once per enclosing iteration)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return      # nested defs priced when called / linked
        self._record(node, mult)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self.visit(node.iter, mult)
            inner = _join_mult(mult, self.loop_class(node.iter))
            for st in [node.target] + node.body + node.orelse:
                self.visit(st, inner)
            return
        if isinstance(node, ast.While):
            # a while on the request path prices conservatively: a
            # drain/retry loop scales with what it drains
            inner = _join_mult(mult, OEV)
            self.visit(node.test, inner)
            for st in node.body + node.orelse:
                self.visit(st, inner)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            inner = _join_mult(mult,
                               self.loop_class(node.generators[0].iter))
            for gen in node.generators:
                self.visit(gen.iter, mult)
                for cond in gen.ifs:
                    self.visit(cond, inner)
            for part in ("elt", "key", "value"):
                sub = getattr(node, part, None)
                if sub is not None:
                    self.visit(sub, inner)
            return
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            src = dotted(node.value)
            if src is None and isinstance(node.value, ast.Call):
                src = call_name(node.value)
            if src is None and isinstance(node.value, ast.Subscript):
                src = dotted(node.value.value)
            if src is not None:
                self.sources[node.targets[0].id] = src
        for sub in ast.iter_child_nodes(node):
            self.visit(sub, mult)

    # ------------------------------------------------------------------ #
    def _record(self, sub: ast.AST, mult: str) -> None:
        """Record cost sites on ``sub`` itself at ``mult``."""
        add = self.cost.add_site
        if isinstance(sub, (ast.Dict, ast.List, ast.Set, ast.Tuple)) \
                and isinstance(getattr(sub, "ctx", ast.Load()),
                               ast.Load):
            add("alloc", self.key, sub.lineno, mult)
        elif isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp)):
            add("alloc", self.key, sub.lineno, mult)
        elif isinstance(sub, ast.Attribute) \
                and isinstance(sub.ctx, ast.Load):
            add("attr_hop", self.key, sub.lineno, mult)
        elif isinstance(sub, ast.Subscript) \
                and isinstance(sub.ctx, ast.Load):
            add("attr_hop", self.key, sub.lineno, mult)
        elif isinstance(sub, ast.With):
            for item in sub.items:
                lid = self._lock_of(item)
                if lid is not None:
                    add("lock", self.key, sub.lineno, mult,
                        detail=lid)
        if isinstance(sub, ast.Call):
            self._record_call(sub, mult)

    def _lock_of(self, item: ast.withitem) -> Optional[str]:
        if self.model is not None:
            lid = self.model.lock_id(item.context_expr)
            if lid is not None:
                return lid
        d = dotted(item.context_expr)
        if d is not None:
            return self.an.module_locks.get(self.path, {}).get(d)
        return None

    def _record_call(self, call: ast.Call, mult: str) -> None:
        add = self.cost.add_site
        cn = call_name(call)
        b = self.an.direct_blocking(self.path, self.cls, call)
        if b is not None and b[0] == "device_dispatch":
            add("dispatch", self.key, call.lineno, mult, detail=b[1])
        if cn is not None:
            leaf = cn.split(".")[-1]
            head = cn.split(".")[0]
            if head in _NP_HEADS and leaf in _NP_ALLOC_LEAVES:
                add("np_alloc", self.key, call.lineno, mult, detail=cn)
            elif leaf in _NP_ALLOC_LEAVES and "." in cn \
                    and head not in ("self",):
                # method form: arr.astype(...), arr.copy()
                add("np_alloc", self.key, call.lineno, mult,
                    detail=cn)
            if cn in _STDLIB_CTORS:
                add("ctor", self.key, call.lineno, mult, detail=cn)
            else:
                rc = self.ms.resolve_class(
                    self.ms.modules[self.path], cn)
                if rc is not None:
                    add("ctor", self.key, call.lineno, mult,
                        detail=rc)
        # a kernel launcher is a dispatch leaf: the walk prices the call
        # and stops, as it stops at a jitted body in the reference (the
        # launcher's plain CPU version is not the request path's cost)
        if cn is not None and not cn.startswith("self.") \
                and cn.split(".")[-1] in lock_order.LAUNCHERS:
            return
        # propagate multiplicity into resolved callees (+ nested defs
        # handed as callbacks, the healer's ``attempt`` protocol)
        r = self.an.resolve_call(self.path, self.cls, call,
                                 prefix=self.qual)
        if r is not None and r != self.key:
            self.cost.enqueue(r, mult)
        for a in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(a, ast.Name):
                cand = (self.path, self.cls or "",
                        f"{self.qual}.{a.id}")
                if cand in self.an.known_funcs and cand != self.key:
                    self.cost.enqueue(cand, mult)


class _CostAnalysis:
    """Per-root accumulation: (counter, multiplicity) -> count +
    example sites."""

    def __init__(self, ms: ModuleSet, an: "lock_order._Analysis"):
        self.ms = ms
        self.an = an
        self.counts: Dict[Tuple[str, str], int] = {}
        self.sites: Dict[Tuple[str, str], List[str]] = {}
        self.worst: str = O1
        self.seen: Set[Tuple[FuncKey, str]] = set()
        self.worklist: List[Tuple[FuncKey, str]] = []
        self.funcs_reached: Set[FuncKey] = set()

    def add_site(self, counter: str, key: FuncKey, line: int,
                 mult: str, detail: str = "") -> None:
        k = (counter, mult)
        self.counts[k] = self.counts.get(k, 0) + 1
        sites = self.sites.setdefault(k, [])
        if len(sites) < _MAX_SITES:
            tag = f"{key[0]}:{line} ({key[2]}"
            tag += f" {detail})" if detail else ")"
            sites.append(tag)
        if counter in ("alloc", "ctor", "np_alloc", "lock",
                       "dispatch"):
            self.worst = _join_mult(self.worst, mult)

    def enqueue(self, key: FuncKey, mult: str) -> None:
        if key not in self.an.known_funcs:
            return
        # one visit per (function, multiplicity): a helper called
        # both per-wave and per-event pays in BOTH classes — that is
        # the semantics, and it keeps the counters stable under
        # traversal-order churn
        if (key, mult) in self.seen or len(self.seen) > 4000:
            return
        self.seen.add((key, mult))
        self.worklist.append((key, mult))

    def drain(self, func_nodes: Dict[FuncKey, ast.AST]) -> None:
        depth = 0
        while self.worklist and depth < 200000:
            depth += 1
            key, mult = self.worklist.pop()
            node = func_nodes.get(key)
            if node is None:
                continue
            self.funcs_reached.add(key)
            _CostWalker(self, key, mult).run(node)


def _root_key(ms: ModuleSet, path: str, cls: str,
              meth: str) -> Optional[FuncKey]:
    mi = ms.modules.get(path)
    if mi is None:
        return None
    if cls:
        if meth in mi.classes.get(cls, {}):
            return (path, cls, f"{cls}.{meth}")
        return None
    if meth in mi.functions:
        return (path, "", meth)
    return None


def certificates(ms: ModuleSet,
                 roots: Tuple[Tuple[str, str, str], ...] = ROOTS
                 ) -> Dict[str, object]:
    """The hotpath certificate: one cost summary per request-path
    root. ``{"roots": [...], "missing": [...]}`` — each root entry
    carries the flattened ``<counter>_<class>`` table, the worst loop
    class, and example sites per counter."""
    an, funcs = lock_order.build_analysis(ms)
    func_nodes: Dict[FuncKey, ast.AST] = {
        (path, fi.cls or "", fi.qualname): fi.node
        for path, fi in funcs}
    entries: List[dict] = []
    missing: List[dict] = []
    for path, cls, meth in roots:
        key = _root_key(ms, path, cls, meth)
        name = f"{cls}.{meth}" if cls else meth
        if key is None:
            missing.append({"root": name, "file": path})
            continue
        cost = _CostAnalysis(ms, an)
        cost.enqueue(key, O1)
        cost.drain(func_nodes)
        counters: Dict[str, int] = {}
        sites: Dict[str, List[str]] = {}
        for c in COUNTERS:
            for m in _MULT_ORDER:
                v = cost.counts.get((c, m), 0)
                if v:
                    k = f"{c}_{_MULT_SUFFIX[m]}"
                    counters[k] = v
                    sites[k] = cost.sites.get((c, m), [])
        entries.append({
            "root": name,
            "file": path,
            "line": func_nodes[key].lineno,
            "loop_class": cost.worst,
            "functions_reached": len(cost.funcs_reached),
            "counters": counters,
            "sites": sites,
        })
    entries.sort(key=lambda e: (e["file"], e["root"]))
    return {"roots": entries, "missing": missing}


# --------------------------------------------------------------------- #
# committed budget (the downward ratchet)                                 #
# --------------------------------------------------------------------- #

class BudgetError(ValueError):
    """hotpath_budget.toml is malformed."""


def parse_budget(text: str) -> List[Dict[str, object]]:
    """``[[root]]`` tables of scalar keys (the waivers.toml TOML
    subset); every value keeps its line number so a violated budget
    line can be NAMED in the gate failure."""
    entries: List[Dict[str, object]] = []
    current: Optional[Dict[str, object]] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[root]]":
            current = {"__lines__": {}}
            entries.append(current)
            continue
        if line.startswith("["):
            raise BudgetError(
                f"hotpath_budget.toml:{lineno}: only [[root]] tables "
                f"are supported, got {line!r}")
        if "=" not in line or current is None:
            raise BudgetError(
                f"hotpath_budget.toml:{lineno}: expected 'key = "
                f"value' inside a [[root]] table, got {line!r}")
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            current[key] = val[1:-1]
        elif val.lstrip("-").isdigit():
            current[key] = int(val)
        else:
            raise BudgetError(
                f"hotpath_budget.toml:{lineno}: value for {key!r} "
                f"must be a string or integer, got {val!r}")
        current["__lines__"][key] = lineno       # type: ignore[index]
    for e in entries:
        for req in ("root", "file", "loop_class"):
            if req not in e:
                raise BudgetError(
                    f"hotpath_budget.toml: [[root]] entry missing "
                    f"required key {req!r}")
    return entries


def format_budget(cert: Dict[str, object]) -> str:
    """Render a certificate as the committed budget file — the exact
    text the gate rewrites when every drift is downward."""
    out = [
        "# Committed host-cost budget of the port's request path — "
        "DESIGN §17.",
        "#",
        "# One [[root]] table per certified request-path root: the "
        "abstract cost",
        "# counters (<counter>_<multiplicity>) that",
        "# scripts_torch/analysis_gate.py derives from the corpus every "
        "run. A",
        "# counter that GROWS (or a loop class that worsens) fails CI "
        "naming the",
        "# root, the contributing sites, and the violated line below; a "
        "counter",
        "# that SHRINKS is ratcheted down — the gate rewrites this file "
        "and the",
        "# improvement is committed with the change.",
        "# Regenerate: python scripts_torch/analysis_gate.py "
        "--update-hotpath-budget",
        "",
    ]
    for e in cert["roots"]:
        out.append("[[root]]")
        out.append(f'root = "{e["root"]}"')
        out.append(f'file = "{e["file"]}"')
        out.append(f'loop_class = "{e["loop_class"]}"')
        for k in sorted(e["counters"]):
            out.append(f"{k} = {e['counters'][k]}")
        out.append("")
    return "\n".join(out)


def compare_to_budget(cert: Dict[str, object], budget_text: str
                      ) -> Tuple[List[str], List[str]]:
    """(violations, shrinks). Violations fail the gate: a grown
    counter, a worsened loop class, a root missing from either side,
    or a malformed budget — each naming the root, the budget line,
    and (for growth) the contributing sites. Shrinks are the downward
    ratchet: the gate rewrites the budget file from the fresh
    certificate."""
    try:
        budget = parse_budget(budget_text)
    except BudgetError as e:
        return [str(e)], []
    errors: List[str] = []
    shrinks: List[str] = []
    by_root = {b["root"]: b for b in budget}
    for e in cert["roots"]:
        b = by_root.pop(e["root"], None)
        if b is None:
            errors.append(
                f"root {e['root']} ({e['file']}) has no committed "
                "budget — add its [[root]] table to "
                "hotpath_budget.toml (or run analysis_gate.py "
                "--update-hotpath-budget) after review")
            continue
        lines = b.get("__lines__", {})
        bc = _join_mult(str(b.get("loop_class", O1)), O1)
        if _MULT_ORDER.index(e["loop_class"]) > _MULT_ORDER.index(bc):
            errors.append(
                f"loop class worsened for root {e['root']}: budget "
                f"says {bc} (hotpath_budget.toml:"
                f"{lines.get('loop_class', '?')}), derived "
                f"{e['loop_class']} — a new request-path loop now "
                "scales with the wave")
        keys = set(e["counters"]) | {
            k for k in b if k not in ("root", "file", "loop_class",
                                      "__lines__")}
        for k in sorted(keys):
            derived = int(e["counters"].get(k, 0))
            committed = int(b.get(k, 0))        # type: ignore[arg-type]
            if derived > committed:
                where = lines.get(k)
                sites = e["sites"].get(k, [])
                errors.append(
                    f"host-cost budget exceeded: root {e['root']} "
                    f"counter {k} = {derived} > budgeted {committed} "
                    f"(hotpath_budget.toml:"
                    f"{where if where is not None else 'missing key'}"
                    f"); contributing sites: "
                    + ("; ".join(sites) if sites else "<none kept>"))
            elif derived < committed:
                shrinks.append(
                    f"{e['root']}: {k} {committed} -> {derived}")
    for name in sorted(by_root):
        errors.append(
            f"stale budget entry: root {name} is no longer derived "
            "— prune its [[root]] table (or rename it in "
            "analysis/hotpath.ROOTS)")
    for m in cert["missing"]:
        errors.append(
            f"request-path root {m['root']} not found in "
            f"{m['file']} — update analysis/hotpath.ROOTS alongside "
            "the rename so the certificate keeps covering it")
    return errors, shrinks


# --------------------------------------------------------------------- #
# the pass                                                               #
# --------------------------------------------------------------------- #

def run(ms: ModuleSet) -> List[Finding]:
    """Findings from certification itself: a declared root the corpus
    no longer defines. Budget drift is the CI gate's job (the
    exactness_bounds pattern) — it needs the committed file."""
    return missing_findings(certificates(ms))


def missing_findings(cert: Dict[str, object]) -> List[Finding]:
    findings: List[Finding] = []
    for m in cert["missing"]:
        findings.append(Finding(
            "hotpath-root-missing", m["file"], 0, m["root"],
            f"request-path root {m['root']} is declared in "
            "analysis/hotpath.ROOTS but not defined in "
            f"{m['file']} — a renamed/moved hot-path entry point "
            "must move in ROOTS too, or its host-cost certification "
            "silently vanishes"))
    return findings
