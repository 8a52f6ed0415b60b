"""Pass — exception-flow + resource-lifecycle analysis.

The serving stack's liveness rests on conventions no pass checked:
every ``Future`` handed to a caller MUST resolve on every path of its
owning scope (the historical fleet-close leak left "block"-policy
producers hanging forever; the historical reaper-vs-apply race
double-resolved and crashed the batcher), every thread must be
daemonized or joined, every WAL/snapshot/metrics handle must close on
exception paths, and every typed serving error must be visible to the
wire protocol, the doctor, and the docs. Five rule families:

* ``future-leak`` — a function resolves futures (``set_result``) but
  an exception between dispatch and resolution leaves them
  unresolved: no enclosing ``try`` (in the function or, transitively,
  in a caller up to 3 frames) has a handler that ``set_exception``\\ s
  the stranded futures. This is the hole class behind the historical
  fleet close leak.
* ``future-double-resolve`` — in a class that resolves futures from
  ≥ 2 methods (apply path + reaper + close are different threads), a
  resolution site with neither a ``.done()`` guard nor a
  ``try``-arbitration wrapper: the loser of the race raises
  ``InvalidStateError`` on the resolving thread (the historical
  reaper-vs-apply shape).
* ``future-close-leak`` — a class that queues future-carrying
  requests whose ``close()``/``shutdown()`` never reaches a drain
  that fails them: producers blocked on the dead engine hang forever.
* ``thread-undisciplined`` — a ``Thread``/``Timer`` constructed
  neither ``daemon=True`` nor joined/cancelled from a lifecycle
  method (``close``/``stop``/``shutdown``/``__exit__``/``join``):
  process exit (or SIGTERM) wedges on it.
* ``handle-leak`` — ``open()`` outside a ``with``: a local handle
  with no ``try/finally`` close leaks on the exception path; an
  attribute-stored handle is accepted only when the owning class has
  a close-like method that closes it.

* error taxonomy (the telemetry_xref discipline extended to errors):
  every typed ``*Error`` class DEFINED AND RAISED in ``serving/*``
  must be (a) protocol-handled — an ``except`` clause whose handler
  builds a ``{"error": ...}`` wire response (the serve JSONL loop),
  else ``error-unhandled-protocol``; (b) doctor-visible — the class
  name, or a counter incremented in the raising function, appears in
  ``obs/report.py``/``obs/doctor.py``, else
  ``error-not-doctor-visible``; (c) documented — mentioned in
  README/DESIGN, else ``error-undocumented``.

Both historical bugs are seeded regression fixtures in
``tests/test_analysis_lifecycle.py``; the live repo is
clean-modulo-waivers with written justifications (first-run triage,
like PRs 12/13).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleInfo, ModuleSet, call_name, dotted, parent_map,
)

FuncKey = Tuple[str, str, str]

_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}
_FUTURE_CTORS = {"Future", "concurrent.futures.Future",
                 "futures.Future"}
_CLOSE_METHODS = ("close", "stop", "shutdown", "__exit__", "join",
                  "checkpoint_and_close")
_MAX_CALLER_DEPTH = 3

#: error-taxonomy scope: typed errors defined+raised here are part of
#: the serving contract
_ERROR_SCOPE = "tuplewise_tpu_torch/serving/"
_OBS_CONSUMERS = ("tuplewise_tpu_torch/obs/report.py",
                  "tuplewise_tpu_torch/obs/doctor.py")


def _is_future_expr(node: ast.AST) -> bool:
    """``<x>.future`` or a name bound from request iteration — the
    attribute spelling is the repo-wide convention."""
    if isinstance(node, ast.Attribute) and node.attr == "future":
        return True
    d = dotted(node)
    return d is not None and d.split(".")[-1] == "future"


def _resolution_calls(node: ast.AST) -> List[Tuple[ast.Call, str]]:
    """(call, kind) for every ``*.future.set_result/set_exception``
    under ``node`` (excluding nested defs)."""
    out: List[Tuple[ast.Call, str]] = []
    stack = [node]
    while stack:
        cur = stack.pop()
        for sub in ast.iter_child_nodes(cur):
            if isinstance(sub, (ast.FunctionDef,
                                ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in ("set_result",
                                          "set_exception") \
                    and _is_future_expr(sub.func.value):
                out.append((sub, sub.func.attr))
            stack.append(sub)
    return out


def _protecting_try(pm: Dict[ast.AST, ast.AST],
                    node: ast.AST) -> Optional[ast.Try]:
    """The nearest enclosing Try whose HANDLERS contain a
    ``set_exception`` resolution (the fail-the-run pattern) — the
    exception path that resolves stranded futures. ``try/finally``
    without such a handler does not protect."""
    cur: Optional[ast.AST] = node
    while cur is not None:
        parent = pm.get(cur)
        if isinstance(parent, ast.Try) and cur in parent.body:
            for h in parent.handlers:
                for call, kind in _resolution_calls(h):
                    if kind == "set_exception":
                        return parent
        if isinstance(parent, (ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            return None
        cur = parent
    return None


def _arbitration_try(pm: Dict[ast.AST, ast.AST],
                     node: ast.AST) -> bool:
    """True when ``node`` sits in a TIGHT Try whose handlers swallow
    the lost race: ``try: fut.set_exception(...) except ...: ...``
    (engine._expire_request). A broad umbrella try does NOT count —
    inside one, the InvalidStateError of a lost race would be
    mis-filed as a dispatch failure, which is exactly the historical
    confusion; tight means the try body is (nearly) just the
    resolution."""
    cur: Optional[ast.AST] = node
    while cur is not None:
        parent = pm.get(cur)
        if isinstance(parent, ast.Try) and cur in parent.body \
                and parent.handlers and len(parent.body) == 1:
            return True
        if isinstance(parent, (ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            return False
        cur = parent
    return False


def _done_guarded(pm: Dict[ast.AST, ast.AST], node: ast.AST) -> bool:
    """True when an enclosing If/While test (or a comprehension
    filter) consults ``.done()`` — the winner-takes-the-resolution
    idiom. A guard anywhere up the chain counts: the done-filter may
    select the loop's elements rather than wrap the call."""
    cur: Optional[ast.AST] = node
    while cur is not None:
        parent = pm.get(cur)
        if isinstance(parent, (ast.If, ast.While, ast.IfExp)):
            for sub in ast.walk(parent.test):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "done":
                    return True
        if isinstance(parent, (ast.For, ast.AsyncFor)) \
                and isinstance(parent.iter, (ast.ListComp,
                                             ast.GeneratorExp)):
            for gen in parent.iter.generators:
                for cond in gen.ifs:
                    for sub in ast.walk(cond):
                        if isinstance(sub, ast.Call) \
                                and isinstance(sub.func,
                                               ast.Attribute) \
                                and sub.func.attr == "done":
                            return True
        if isinstance(parent, (ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            return False
        cur = parent
    return False


class _Corpus:
    """Shared indices: function nodes, parent maps, resolved callers."""

    def __init__(self, ms: ModuleSet):
        self.ms = ms
        self.funcs: Dict[FuncKey, ast.AST] = {}
        self.pmaps: Dict[str, Dict[ast.AST, ast.AST]] = {}
        for path, mi in ms.modules.items():
            self.pmaps[path] = parent_map(mi.tree)
            for fi in mi.iter_functions():
                self.funcs[(path, fi.cls or "", fi.qualname)] = fi.node
        # callee -> [(caller key, call node)] via the lock pass's
        # resolver semantics (self methods, typed attrs, local defs)
        from tuplewise_tpu_torch.analysis import lock_order

        self.an, _ = lock_order.build_analysis(ms)
        self.callers: Dict[FuncKey,
                           List[Tuple[FuncKey, ast.Call]]] = {}
        for key, node in self.funcs.items():
            path, cls, qual = key
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    r = self.an.resolve_call(path, cls or None, sub,
                                             prefix=qual)
                    if r is not None and r != key:
                        self.callers.setdefault(r, []).append(
                            (key, sub))

    def enclosing_func(self, path: str,
                       node: ast.AST) -> Optional[FuncKey]:
        pm = self.pmaps[path]
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = pm.get(cur)
            if isinstance(cur, (ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                for key, fnode in self.funcs.items():
                    if key[0] == path and fnode is cur:
                        return key
        return None


# --------------------------------------------------------------------- #
# future resolution rules                                                #
# --------------------------------------------------------------------- #

def _caller_protected(corpus: _Corpus, key: FuncKey,
                      depth: int, seen: Set[FuncKey]) -> bool:
    """Every known caller path wraps the call (transitively) in a Try
    whose handlers set_exception — the engine's _dispatch umbrella."""
    if depth > _MAX_CALLER_DEPTH or key in seen:
        return False
    seen.add(key)
    sites = corpus.callers.get(key, [])
    if not sites:
        return False
    for caller, call in sites:
        pm = corpus.pmaps[caller[0]]
        if _protecting_try(pm, call) is not None:
            continue
        if _caller_protected(corpus, caller, depth + 1, seen):
            continue
        return False
    return True


def future_findings(ms: ModuleSet, corpus: _Corpus) -> List[Finding]:
    findings: List[Finding] = []
    resolver_methods: Dict[Tuple[str, str], Set[str]] = {}
    all_sites: List[Tuple[FuncKey, ast.Call, str]] = []
    for key, node in corpus.funcs.items():
        for call, kind in _resolution_calls(node):
            all_sites.append((key, call, kind))
            if key[1]:
                resolver_methods.setdefault(
                    (key[0], key[1]), set()).add(key[2])

    # future-leak: a set_result with no exception path that would
    # resolve the stranded futures
    leak_seen: Set[str] = set()
    for key, call, kind in all_sites:
        if kind != "set_result":
            continue
        path, cls, qual = key
        pm = corpus.pmaps[path]
        if _protecting_try(pm, call) is not None:
            continue
        if _caller_protected(corpus, key, 1, set()):
            continue
        sym = f"{qual}::set_result"
        if sym in leak_seen:
            continue
        leak_seen.add(sym)
        findings.append(Finding(
            "future-leak", path, call.lineno, sym,
            f"{qual} resolves request futures with set_result but no "
            "enclosing try (here or in any resolved caller, depth "
            f"<= {_MAX_CALLER_DEPTH}) has a handler that "
            "set_exception's them — an exception before this line "
            "strands every future in the batch and its callers hang "
            "until timeout (the fleet-close hole class)"))

    # future-double-resolve: unguarded resolution in a multi-resolver
    # class (two threads can race to resolve the same future)
    dbl_seen: Set[str] = set()
    for key, call, kind in all_sites:
        path, cls, qual = key
        if not cls or len(resolver_methods.get((path, cls),
                                               ())) < 2:
            continue
        pm = corpus.pmaps[path]
        if _done_guarded(pm, call) or _arbitration_try(pm, call):
            continue
        sym = f"{qual}::{kind}"
        if sym in dbl_seen:
            continue
        dbl_seen.add(sym)
        findings.append(Finding(
            "future-double-resolve", path, call.lineno, sym,
            f"{qual} calls {kind} without a .done() guard or a "
            f"try-arbitration wrapper, and {cls} resolves futures "
            f"from {len(resolver_methods[(path, cls)])} methods "
            "(different threads: apply / reaper / close) — the loser "
            "of the race raises InvalidStateError on the resolving "
            "thread (the reaper-vs-apply shape)"))

    # future-close-leak: queue-of-futures class whose close path
    # never reaches a set_exception drain
    for (path, cls), methods in sorted(resolver_methods.items()):
        mi = ms.modules[path]
        model_queues = _queue_attrs(mi, cls)
        if not model_queues or not _constructs_futures(mi, cls):
            continue
        close_keys = [
            (path, cls, f"{cls}.{m}")
            for m in mi.classes.get(cls, {})
            if m in _CLOSE_METHODS]
        if not close_keys:
            findings.append(Finding(
                "future-close-leak", path, 0, f"{cls}.close",
                f"{cls} queues future-carrying requests but has no "
                "close()/shutdown() at all — producers blocked on a "
                "dead engine hang forever"))
            continue
        if not any(_reaches_set_exception(corpus, k, 0, set())
                   for k in close_keys):
            node = corpus.funcs.get(close_keys[0])
            findings.append(Finding(
                "future-close-leak", path,
                getattr(node, "lineno", 0),
                f"{cls}.{close_keys[0][2].rsplit('.', 1)[-1]}",
                f"{cls}.close never reaches a drain that "
                "set_exception's the queued futures — every "
                "unapplied request (and every 'block'-policy "
                "producer waiting on queue capacity) hangs at "
                "shutdown (the historical fleet-close leak)"))
    return findings


def _queue_attrs(mi: ModuleInfo, cls: str) -> Set[str]:
    out = set()
    for attr, ctor in mi.attr_ctors.get(cls, {}).items():
        if ctor in ("queue.Queue", "Queue", "queue.LifoQueue",
                    "collections.deque", "deque"):
            out.add(attr)
    # dict-of-deques fleets: a dict attr written via setdefault(deque)
    for mnode in mi.classes.get(cls, {}).values():
        for sub in ast.walk(mnode):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "setdefault" \
                    and len(sub.args) >= 2:
                cn = call_name(sub.args[1]) if isinstance(
                    sub.args[1], ast.Call) else None
                if cn in ("collections.deque", "deque"):
                    d = dotted(sub.func.value)
                    if d and d.startswith("self."):
                        out.add(d[len("self."):])
    return out


def _constructs_futures(mi: ModuleInfo, cls: str) -> bool:
    """The class (or a request class it instantiates in-module)
    creates Futures."""
    req_classes = set()
    for mnode in mi.classes.get(cls, {}).values():
        for sub in ast.walk(mnode):
            if isinstance(sub, ast.Call):
                cn = call_name(sub)
                if cn in _FUTURE_CTORS:
                    return True
                if cn in mi.classes:
                    req_classes.add(cn)
    for rc in req_classes:
        for mnode in mi.classes.get(rc, {}).values():
            for sub in ast.walk(mnode):
                if isinstance(sub, ast.Call) \
                        and call_name(sub) in _FUTURE_CTORS:
                    return True
    return False


def _reaches_set_exception(corpus: _Corpus, key: FuncKey,
                           depth: int, seen: Set[FuncKey]) -> bool:
    if depth > 4 or key in seen:
        return False
    seen.add(key)
    node = corpus.funcs.get(key)
    if node is None:
        return False
    for _call, kind in _resolution_calls(node):
        if kind == "set_exception":
            return True
    path, cls, qual = key
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            r = corpus.an.resolve_call(path, cls or None, sub,
                                       prefix=qual)
            if r is not None and r != key \
                    and _reaches_set_exception(corpus, r, depth + 1,
                                               seen):
                return True
    return False


# --------------------------------------------------------------------- #
# thread / timer lifecycle                                               #
# --------------------------------------------------------------------- #

def thread_findings(ms: ModuleSet, corpus: _Corpus) -> List[Finding]:
    findings: List[Finding] = []
    for path, mi in sorted(ms.modules.items()):
        pm = corpus.pmaps[path]
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            is_timer = cn in _TIMER_CTORS
            if cn not in _THREAD_CTORS and not is_timer:
                continue
            if any(k.arg == "daemon"
                   and isinstance(k.value, ast.Constant)
                   and k.value.value is True
                   for k in node.keywords):
                continue
            # stored where? self.attr = Thread(...) -> accept when a
            # lifecycle method joins/cancels it; local t = Thread(...)
            # -> accept a join/cancel in the same function, or an
            # immediate daemon flag assignment
            parent = pm.get(node)
            target_attr = None
            local_name = None
            if isinstance(parent, ast.Assign) and parent.targets:
                d = dotted(parent.targets[0])
                if d and d.startswith("self."):
                    target_attr = d[len("self."):]
                elif d and "." not in d:
                    local_name = d
            key = corpus.enclosing_func(path, node)
            fname = key[2] if key else "<module>"
            cls = key[1] if key else ""
            ok = False
            closers = ("cancel",) if is_timer else ("join",)
            if target_attr and cls:
                ok = _attr_closed(mi, cls, target_attr,
                                  closers + ("daemon",))
            elif local_name and key is not None:
                fnode = corpus.funcs[key]
                ok = _local_closed(fnode, local_name, closers)
            if ok:
                continue
            kind = "Timer" if is_timer else "Thread"
            findings.append(Finding(
                "thread-undisciplined", path, node.lineno,
                f"{fname}::{kind}",
                f"{fname} constructs a {kind} that is neither "
                "daemon=True nor joined/cancelled from a lifecycle "
                "method — process exit wedges on it (or the timer "
                "fires into a torn-down object)"))
    return findings


def _attr_closed(mi: ModuleInfo, cls: str, attr: str,
                 closers: Tuple[str, ...]) -> bool:
    for mnode in mi.classes.get(cls, {}).values():
        for sub in ast.walk(mnode):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in closers:
                d = dotted(sub.func.value)
                if d == f"self.{attr}":
                    return True
            if isinstance(sub, ast.Assign) and sub.targets:
                d = dotted(sub.targets[0])
                if d == f"self.{attr}.daemon" \
                        and isinstance(sub.value, ast.Constant) \
                        and sub.value.value is True:
                    return True
    return False


def _local_closed(fnode: ast.AST, name: str,
                  closers: Tuple[str, ...]) -> bool:
    for sub in ast.walk(fnode):
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in closers \
                and dotted(sub.func.value) == name:
            return True
        if isinstance(sub, ast.Assign) and sub.targets:
            d = dotted(sub.targets[0])
            if d == f"{name}.daemon" \
                    and isinstance(sub.value, ast.Constant) \
                    and sub.value.value is True:
                return True
    return False


# --------------------------------------------------------------------- #
# file-handle lifecycle                                                  #
# --------------------------------------------------------------------- #

def handle_findings(ms: ModuleSet, corpus: _Corpus) -> List[Finding]:
    findings: List[Finding] = []
    for path, mi in sorted(ms.modules.items()):
        pm = corpus.pmaps[path]
        for node in ast.walk(mi.tree):
            if not (isinstance(node, ast.Call)
                    and call_name(node) in ("open", "io.open",
                                            "os.fdopen")):
                continue
            parent = pm.get(node)
            if isinstance(parent, ast.withitem):
                continue            # with open(...) as f: fine
            if isinstance(parent, ast.Attribute):
                continue            # open(...).read() one-shot chain
            key = corpus.enclosing_func(path, node)
            fname = key[2] if key else "<module>"
            target_attr = local_name = None
            if isinstance(parent, ast.Assign) and parent.targets:
                d = dotted(parent.targets[0])
                if d and d.startswith("self."):
                    target_attr = d[len("self."):]
                elif d and "." not in d:
                    local_name = d
            ok = False
            if target_attr and key and key[1]:
                ok = _attr_closed(mi, key[1], target_attr, ("close",))
            elif local_name and key is not None:
                ok = _finally_closed(corpus.funcs[key], pm, node,
                                     local_name)
            if ok:
                continue
            findings.append(Finding(
                "handle-leak", path, node.lineno,
                f"{fname}::open",
                f"{fname} opens a file outside `with` and no "
                "try/finally (local) or owning close() method "
                "(attribute) closes it — the handle leaks on the "
                "exception path; WAL/snapshot/metrics files must "
                "close deterministically"))
    return findings


def _finally_closed(fnode: ast.AST, pm: Dict[ast.AST, ast.AST],
                    node: ast.AST, name: str) -> bool:
    """The open site sits inside (or immediately before) a Try whose
    finalbody closes the local — or the function returns the handle
    (ownership transferred)."""
    for sub in ast.walk(fnode):
        if isinstance(sub, ast.Try) and sub.finalbody:
            for f in sub.finalbody:
                for c in ast.walk(f):
                    if isinstance(c, ast.Call) \
                            and isinstance(c.func, ast.Attribute) \
                            and c.func.attr == "close" \
                            and dotted(c.func.value) == name:
                        return True
        if isinstance(sub, ast.Return) and sub.value is not None \
                and dotted(sub.value) == name:
            return True
    return False


# --------------------------------------------------------------------- #
# error taxonomy cross-reference                                         #
# --------------------------------------------------------------------- #

def _serving_errors(ms: ModuleSet) -> List[Tuple[str, str, int]]:
    """(class name, defining path, line) for typed errors defined AND
    raised in serving/*."""
    defined: Dict[str, Tuple[str, int]] = {}
    for path, mi in ms.modules.items():
        if not path.startswith(_ERROR_SCOPE):
            continue
        for node in mi.tree.body:
            if isinstance(node, ast.ClassDef) \
                    and node.name.endswith("Error"):
                defined.setdefault(node.name, (path, node.lineno))
    raised: Set[str] = set()
    for path, mi in ms.modules.items():
        if not path.startswith(_ERROR_SCOPE):
            continue
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                if isinstance(exc, ast.Call):
                    exc = exc.func
                d = dotted(exc)
                if d is not None and d.split(".")[-1] in defined:
                    raised.add(d.split(".")[-1])
    return sorted((n,) + defined[n] for n in raised)


def _protocol_handlers(ms: ModuleSet) -> Set[str]:
    """Error class names caught by an except clause whose handler
    builds a ``{"error": ...}`` wire response (the serve JSONL
    protocol loop)."""
    out: Set[str] = set()
    for path, mi in ms.modules.items():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.ExceptHandler) \
                    or node.type is None:
                continue
            types = node.type.elts if isinstance(
                node.type, ast.Tuple) else [node.type]
            names = {(dotted(t) or "").split(".")[-1] for t in types}
            has_wire = any(
                isinstance(sub, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "error"
                    for k in sub.keys)
                for sub in ast.walk(node))
            if has_wire:
                out.update(n for n in names if n)
    return out


def _raise_site_counters(ms: ModuleSet, ename: str) -> Set[str]:
    """Metric-name literals adjacent to the raises of ``ename``: a
    counter incremented in the raising function, resolved through the
    ``self._c_x = m.counter("lit")`` registry idiom or inline
    ``...counter("lit"...)`` calls."""
    out: Set[str] = set()
    for path, mi in ms.modules.items():
        if not path.startswith(_ERROR_SCOPE):
            continue
        # class attr -> counter literal map for this module
        attr_lit: Dict[Tuple[str, str], str] = {}
        for cname, methods in mi.classes.items():
            for mnode in methods.values():
                for sub in ast.walk(mnode):
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1 \
                            and isinstance(sub.value, ast.Call):
                        cn = call_name(sub.value) or ""
                        if cn.split(".")[-1] in ("counter",):
                            d = dotted(sub.targets[0])
                            lit = (sub.value.args
                                   and isinstance(sub.value.args[0],
                                                  ast.Constant)
                                   and sub.value.args[0].value)
                            if d and d.startswith("self.") and lit:
                                attr_lit[(cname,
                                          d[len("self."):])] = lit
        for fi in mi.iter_functions():
            raises_here = any(
                isinstance(n, ast.Raise) and n.exc is not None
                and (dotted(n.exc.func) if isinstance(n.exc, ast.Call)
                     else dotted(n.exc) or "").split(".")[-1] == ename
                for n in ast.walk(fi.node))
            if not raises_here:
                continue
            for sub in ast.walk(fi.node):
                if not isinstance(sub, ast.Call):
                    continue
                cn = call_name(sub) or ""
                leaf = cn.split(".")[-1]
                if leaf == "inc" and cn.startswith("self."):
                    attr = cn[len("self."):-len(".inc")]
                    lit = attr_lit.get((fi.cls or "", attr))
                    if lit:
                        out.add(lit)
                elif leaf == "counter" and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str):
                    out.add(sub.args[0].value)
                elif leaf == "record" and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str):
                    out.add(sub.args[0].value)   # flight event kind
    return out


def error_findings(ms: ModuleSet) -> List[Finding]:
    findings: List[Finding] = []
    handled = _protocol_handlers(ms)
    obs_src = "\n".join(ms.modules[p].source for p in _OBS_CONSUMERS
                        if p in ms.modules)
    doc_src = "\n".join(ms.texts.values())
    for ename, path, line in _serving_errors(ms):
        if ename not in handled:
            findings.append(Finding(
                "error-unhandled-protocol", path, line, ename,
                f"typed serving error {ename} is raised on the "
                "request path but no except handler maps it to a "
                '{"error": ...} wire response — a serve-loop client '
                "sees a broken pipe instead of a typed, retryable "
                "failure"))
        visible = re.search(rf"\b{re.escape(ename)}\b", obs_src)
        if not visible:
            counters = _raise_site_counters(ms, ename)
            visible = any(
                re.search(rf"\b{re.escape(c)}\b", obs_src)
                for c in counters)
        if not visible:
            findings.append(Finding(
                "error-not-doctor-visible", path, line, ename,
                f"typed serving error {ename} has no doctor/report "
                "consumer: neither the class name nor any counter "
                "incremented at its raise sites appears in "
                "obs/report.py or obs/doctor.py — operators cannot "
                "see this failure mode post-hoc"))
        if not re.search(rf"\b{re.escape(ename)}\b", doc_src):
            findings.append(Finding(
                "error-undocumented", path, line, ename,
                f"typed serving error {ename} is part of the serving "
                "contract but README.md/docs/DESIGN.md never mention "
                "it — callers cannot code against an error taxonomy "
                "the docs hide"))
    return findings


# --------------------------------------------------------------------- #
# the pass                                                               #
# --------------------------------------------------------------------- #

def run(ms: ModuleSet) -> List[Finding]:
    corpus = _Corpus(ms)
    findings: List[Finding] = []
    findings.extend(future_findings(ms, corpus))
    findings.extend(thread_findings(ms, corpus))
    findings.extend(handle_findings(ms, corpus))
    findings.extend(error_findings(ms))
    return findings
