"""Pass 1 — lock-order / thread-discipline.

Extracts the static lock-acquisition graph across the whole package:

* **lock identities** — ``self.X = threading.Lock()/RLock()/Condition``
  become ``Class.X``; a ``Condition(self.Y)`` aliases to ``Class.Y``
  (same underlying mutex); module-level locks become ``module.X``;
  ``with self.q.mutex`` is the queue's internal mutex ``Class.q.mutex``.
* **order edges** — ``with A: ... with B:`` (directly nested, or
  through calls resolved via the class/attribute type map) add edge
  A -> B. A cycle in that graph is an acquisition-order inversion —
  two threads taking the same pair of locks in opposite orders can
  deadlock (rule ``lock-order-cycle``).
* **blocking ops under a lock** (rule ``lock-held-blocking``) — inside
  a ``with <lock>`` block, directly or through resolved repo calls:

    - unbounded ``Queue.put/get`` (no timeout, not ``_nowait``) on
      attributes typed ``queue.Queue``
    - ``time.sleep``
    - ``Thread.join`` / ``Queue.join`` without timeout
    - ``Future.result()`` without timeout
    - ``os.fsync``
    - device dispatch (``DISPATCH_NAMES``): the kernel launchers of
      ``ops.count_kernels`` and their ``torch.searchsorted`` twins, the
      count-layer entry points of ``parallel.sharded_counts``, the
      ``parallel.comm`` collectives and ``torch.cuda.synchronize``.
      Torch eager has no trace marker, so the set is a declared table.

Intentional holds (e.g. the index cv held across the count dispatch —
that lock IS the statistic's consistency boundary) are waived in
``analysis/waivers.toml`` with written justification, never silenced
in code.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleInfo, ModuleSet, call_name, dotted,
)

_LOCK_CTORS = ("threading.Lock", "threading.RLock",
               "threading.Condition", "Lock", "RLock", "Condition")
_QUEUE_CTORS = ("queue.Queue", "Queue", "queue.LifoQueue",
                "queue.PriorityQueue")
_THREAD_CTORS = ("threading.Thread", "Thread")

#: the kernel launchers: each call is one launch of a count kernel
#: (kernels 6 and 7) or of its batched ``torch.searchsorted`` twin
LAUNCHERS = frozenset({
    "signed_count", "signed_count_mesh", "tenant_count",
    "tenant_count_mesh", "signed_count_searchsorted",
    "signed_count_searchsorted_mesh", "tenant_count_searchsorted",
    "tenant_count_searchsorted_mesh"})
#: the count layer's entry points, which share the reference's names
COUNT_LAYER = frozenset({
    "sharded_counts", "place_base", "signed_pair_counts",
    "tenant_pack_counts", "sharded_major_merge", "place_tenant_pack"})
#: the worker-axis collectives of ``parallel.comm`` (any receiver)
COLLECTIVES = frozenset({"all_reduce_sum", "all_gather", "start_rotate",
                         "sum_partials"})
#: call targets that ARE device dispatch
DISPATCH_NAMES = LAUNCHERS | COUNT_LAYER | COLLECTIVES
_SYNC_CALLS = {"torch.cuda.synchronize"}


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


class _ClassModel:
    """Lock/queue/thread attribute typing for one class."""

    def __init__(self, ms: ModuleSet, mi: ModuleInfo, cname: str):
        self.ms = ms
        self.mi = mi
        self.cname = cname
        self.locks: Dict[str, str] = {}     # attr -> lock id
        self.queues: Set[str] = set()
        self.threads: Set[str] = set()
        self.attr_class: Dict[str, str] = {}  # attr -> repo class name
        for attr, ctor in mi.attr_ctors.get(cname, {}).items():
            if ctor in _LOCK_CTORS:
                self.locks[attr] = f"{cname}.{attr}"
            elif ctor in _QUEUE_CTORS:
                self.queues.add(attr)
            elif ctor in _THREAD_CTORS:
                self.threads.add(attr)
            else:
                if ctor.startswith("self."):
                    # self._wal = self._open_wal(): type through the
                    # factory method's return expression, one level
                    meth = mi.classes.get(cname, {}).get(
                        ctor[len("self."):])
                    if meth is not None:
                        for st in ast.walk(meth):
                            if isinstance(st, ast.Return) \
                                    and isinstance(st.value, ast.Call):
                                ctor = call_name(st.value) or ctor
                                break
                rc = ms.resolve_class(mi, ctor)
                if rc is not None:
                    self.attr_class[attr] = rc
        # Condition(self.X) aliases to the lock it wraps
        for node in ast.walk(mi.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            cn = call_name(node.value)
            if cn not in ("threading.Condition", "Condition"):
                continue
            tgt = dotted(node.targets[0]) if node.targets else None
            if not (tgt and tgt.startswith("self.")):
                continue
            attr = tgt[len("self."):]
            if node.value.args:
                arg = dotted(node.value.args[0])
                if arg and arg.startswith("self."):
                    wrapped = arg[len("self."):]
                    if wrapped in self.locks:
                        self.locks[attr] = self.locks[wrapped]
                        continue
                # Condition(threading.RLock()) and friends
            self.locks.setdefault(attr, f"{cname}.{attr}")

    def lock_id(self, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self."):
            attr = d[len("self."):]
            if attr in self.locks:
                return self.locks[attr]
            if attr.endswith(".mutex"):
                return f"{self.cname}.{attr}"
        return None


class _Analysis:
    def __init__(self, ms: ModuleSet):
        self.ms = ms
        self.models: Dict[Tuple[str, str], _ClassModel] = {}
        # function key -> set of lock ids it (transitively) acquires
        self.acquires: Dict[Tuple[str, str, str], Set[str]] = {}
        # function key -> [(category, detail, line)] blocking ops
        self.blocking: Dict[Tuple[str, str, str],
                            List[Tuple[str, str, int]]] = {}
        self.calls: Dict[Tuple[str, str, str],
                         Set[Tuple[str, str, str]]] = {}
        self.module_locks: Dict[str, Dict[str, str]] = {}
        self.known_funcs: Set[Tuple[str, str, str]] = set()

    def model(self, path: str, cname: str) -> _ClassModel:
        key = (path, cname)
        if key not in self.models:
            self.models[key] = _ClassModel(
                self.ms, self.ms.modules[path], cname)
        return self.models[key]

    # -------------------------------------------------------------- #
    def resolve_call(self, path: str, cls: Optional[str],
                     call: ast.Call, prefix: str = ""
                     ) -> Optional[Tuple[str, str, str]]:
        """Map a call to a (path, class, qualname) key inside the
        corpus, through self-methods, typed self-attributes, local and
        nested functions, and imported repo functions. ``prefix`` is
        the enclosing function's qualname, so a bare call to a nested
        def (the healer's ``attempt`` closures) resolves too."""
        mi = self.ms.modules[path]
        cn = call_name(call)
        if cn is None:
            return None
        if "." not in cn and prefix:
            nested = (path, cls or "", f"{prefix}.{cn}")
            if nested in self.acquires or nested in self.known_funcs:
                return nested
        if cn.startswith("self.") and cls is not None:
            rest = cn[len("self."):]
            if "." not in rest:
                if rest in mi.classes.get(cls, {}):
                    return (path, cls, f"{cls}.{rest}")
                return None
            attr, meth = rest.split(".", 1)
            if "." in meth:
                return None
            model = self.model(path, cls)
            tcls = model.attr_class.get(attr)
            if tcls is not None:
                tpath, methods = self.ms.class_defs[tcls]
                if meth in methods:
                    return (tpath, tcls, f"{tcls}.{meth}")
            return None
        if "." not in cn:
            if cn in mi.functions:
                return (path, "", cn)
            if cls is not None and cn in mi.classes.get(cls, {}):
                return (path, cls, f"{cls}.{cn}")
            resolved = self.ms.resolve_import(mi, cn)
            if resolved is not None:
                tpath, sym = resolved
                tmi = self.ms.modules.get(tpath)
                if tmi is not None and sym in tmi.functions:
                    return (tpath, "", sym)
        return None

    # -------------------------------------------------------------- #
    def direct_blocking(self, path: str, cls: Optional[str],
                        call: ast.Call
                        ) -> Optional[Tuple[str, str]]:
        """(category, detail) when this call is itself a blocking op."""
        cn = call_name(call)
        if cn is None:
            return None
        leaf = cn.split(".")[-1]
        if cn in ("time.sleep", "sleep") and cn.startswith("time."):
            return ("sleep", cn)
        if cn == "os.fsync":
            return ("fsync", cn)
        if leaf == "result" and not call.args \
                and not _has_kw(call, "timeout"):
            return ("future_result", cn)
        if leaf == "join" and not call.args \
                and not _has_kw(call, "timeout"):
            # Thread.join()/Queue.join() without bound; plain
            # "sep".join(...) always takes an argument, so zero-arg
            # join is a synchronization join
            return ("join", cn)
        if leaf in ("put", "get") and cn.startswith("self.") \
                and not _has_kw(call, "timeout"):
            parts = cn.split(".")
            if len(parts) == 3 and cls is not None:
                model = self.model(path, cls)
                if parts[1] in model.queues:
                    if any(isinstance(a, ast.Constant)
                           and a.value is False
                           for a in call.args[1:2]):
                        return None
                    return ("queue_" + leaf, cn)
        if cn in _SYNC_CALLS:
            return ("device_dispatch", cn)
        if leaf in COLLECTIVES:
            return ("device_dispatch", cn)
        if leaf in DISPATCH_NAMES:
            if cn.startswith("self."):
                return None     # a method that shares the name
            return ("device_dispatch", cn)
        return None

    # -------------------------------------------------------------- #
    def scan_function(self, path: str, fi) -> None:
        key = (path, fi.cls or "", fi.qualname)
        acq: Set[str] = set()
        blocking: List[Tuple[str, str, int]] = []
        calls: Set[Tuple[str, str, str]] = set()
        mi = self.ms.modules[path]
        model = self.model(path, fi.cls) if fi.cls else None

        def lock_of(item: ast.withitem) -> Optional[str]:
            if model is not None:
                lid = model.lock_id(item.context_expr)
                if lid is not None:
                    return lid
            d = dotted(item.context_expr)
            if d is not None and d in self.module_locks.get(path, {}):
                return self.module_locks[path][d]
            return None

        def walk(node: ast.AST) -> None:
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    continue     # nested defs analyzed separately;
                    # callback REFERENCES to them are linked below.
                    # Lambda bodies are walked inline: a lambda handed
                    # to healer.run / _fused_counts executes under
                    # whatever the caller holds.
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        lid = lock_of(item)
                        if lid is not None:
                            acq.add(lid)
                if isinstance(sub, ast.Call):
                    b = self.direct_blocking(path, fi.cls, sub)
                    if b is not None:
                        blocking.append((b[0], b[1], sub.lineno))
                    r = self.resolve_call(path, fi.cls, sub,
                                          prefix=fi.qualname)
                    if r is not None and r != key:
                        calls.add(r)
                    # a nested def passed as a callback (the healer's
                    # ``attempt`` protocol) runs under the caller's
                    # locks — link it as if called here
                    for a in list(sub.args) + [k.value for k in
                                               sub.keywords]:
                        if isinstance(a, ast.Name):
                            cand = (path, fi.cls or "",
                                    f"{fi.qualname}.{a.id}")
                            if cand in self.known_funcs \
                                    and cand != key:
                                calls.add(cand)
                walk(sub)

        # start at the function node itself so a With that IS the
        # first statement registers (it appears as a CHILD of the
        # FunctionDef — the walk detects With nodes as children)
        walk(fi.node)
        self.acquires[key] = acq
        self.blocking[key] = blocking
        self.calls[key] = calls

    # -------------------------------------------------------------- #
    def closure(self, mapping: Dict, merge) -> Dict:
        """Fixpoint over the call graph: propagate callees' sets into
        callers."""
        out = {k: merge(v, None) for k, v in mapping.items()}
        changed = True
        while changed:
            changed = False
            for key, callees in self.calls.items():
                cur = out.get(key)
                if cur is None:
                    continue
                for callee in callees:
                    sub = out.get(callee)
                    if not sub:
                        continue
                    before = len(cur)
                    cur = merge(cur, sub)
                    if len(cur) != before:
                        out[key] = cur
                        changed = True
        return out


def build_analysis(ms: ModuleSet) -> Tuple["_Analysis", List]:
    """Shared setup for this pass AND the guard-inference pass
   : module-level lock identities, per-function scan
    (acquisitions, blocking ops, resolved calls). Returns the
    populated analysis plus the ``(path, FunctionInfo)`` list."""
    an = _Analysis(ms)
    # module-level locks
    for path, mi in ms.modules.items():
        mod_locks: Dict[str, str] = {}
        for node in mi.tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                cn = call_name(node.value)
                if cn in _LOCK_CTORS:
                    for t in node.targets:
                        d = dotted(t)
                        if d:
                            mod_locks[d] = \
                                f"{ms.module_name(path)}.{d}"
        an.module_locks[path] = mod_locks

    funcs = []
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            funcs.append((path, fi))
            an.known_funcs.add((path, fi.cls or "", fi.qualname))
    for path, fi in funcs:
        an.scan_function(path, fi)
    return an, funcs


def run(ms: ModuleSet) -> List[Finding]:
    an, funcs = build_analysis(ms)

    # transitive acquisitions and blocking ops
    acq_star = an.closure(
        an.acquires,
        lambda cur, sub: set(cur) | (set(sub) if sub else set()))
    blk_star = an.closure(
        an.blocking,
        lambda cur, sub: list(dict.fromkeys(
            list(cur) + (list(sub) if sub else []))))

    findings: List[Finding] = []
    edges: Dict[Tuple[str, str], Tuple[str, str, int]] = {}

    for path, fi in funcs:
        key = (path, fi.cls or "", fi.qualname)
        mi = ms.modules[path]
        model = an.model(path, fi.cls) if fi.cls else None

        def lock_of(item: ast.withitem) -> Optional[str]:
            if model is not None:
                lid = model.lock_id(item.context_expr)
                if lid is not None:
                    return lid
            d = dotted(item.context_expr)
            return an.module_locks.get(path, {}).get(d)

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    continue
                now = held
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        lid = lock_of(item)
                        if lid is not None:
                            for h in now:
                                if h != lid:
                                    edges.setdefault(
                                        (h, lid),
                                        (path, fi.qualname,
                                         sub.lineno))
                            now = now + (lid,)
                if isinstance(sub, ast.Call) and held:
                    hits = []
                    b = an.direct_blocking(path, fi.cls, sub)
                    if b is not None:
                        hits.append((b[0], b[1], sub.lineno, ""))
                    r = an.resolve_call(path, fi.cls, sub,
                                        prefix=fi.qualname)
                    if r is not None:
                        for cat, detail, line in blk_star.get(r, ()):
                            hits.append((cat, detail, sub.lineno,
                                         f" via {r[2]}"))
                        for lid in acq_star.get(r, ()):
                            for h in held:
                                if h != lid:
                                    edges.setdefault(
                                        (h, lid),
                                        (path, fi.qualname,
                                         sub.lineno))
                    for cat, detail, line, via in hits:
                        sym = (f"{fi.qualname}::{held[-1]}"
                               f"::{cat}")
                        findings.append(Finding(
                            "lock-held-blocking", path, line, sym,
                            f"{fi.qualname} holds {held[-1]} across "
                            f"{cat} ({detail}{via})"))
                walk(sub, now)

        walk(fi.node, ())

    # acquisition-order cycles over the edge graph
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    for cyc in _cycles(graph):
        a, b = cyc[0], cyc[1 % len(cyc)]
        path, func, line = edges.get((a, b), ("", "?", 0))
        findings.append(Finding(
            "lock-order-cycle", path or "<graph>", line,
            "->".join(sorted(set(cyc))),
            "lock acquisition-order cycle: "
            + " -> ".join(cyc + [cyc[0]])))

    # dedupe lock-held-blocking by fingerprint (one finding per
    # function x lock x category — chains repeat per call site)
    seen = set()
    out = []
    for f in findings:
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        out.append(f)
    return out


def _cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycle detection via SCCs (every SCC with a cycle is
    reported once, as some cycle through it)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    stack: List[str] = []
    on: Set[str] = set()
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or node in graph.get(node, ()):
                    sccs.append(list(reversed(scc)))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs
