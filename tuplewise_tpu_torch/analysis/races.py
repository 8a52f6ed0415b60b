"""Pass — RacerD-style guard inference.

The lock pass checks lock *order* and blocking ops; it never
asks the question the one-dispatch-core refactor will stress: **which
lock guards which field?** This pass infers it:

* **thread roles** — every ``threading.Thread(target=...)`` /
  ``threading.Timer(..., fn)`` construction names a role (batcher,
  compactor, reaper, flusher, snapshotter, prober, ... — from the
  thread's ``name=`` literal or the target function). Public methods
  of the analyzed classes are the ``caller`` role: whatever thread
  the API user brings.

* **guard contexts** — from each role's entry point, the corpus call
  graph is walked carrying the set of locks held: ``with`` blocks add
  locks (class-attribute and module locks, ``Condition(lock)``
  aliasing, ``q.mutex`` — the lock pass's identity model), and every
  confidently-resolved call propagates the held set into the callee.
  An attribute access observed under context (role, held-locks) is
  one **access-site evidence** record.

* **attribute accesses** — loads and stores of ``self.attr`` (and of
  attributes reached through typed references: ``self._pos.buf``,
  annotated parameters like ``side: _ClassSide``). Container-mutator
  method calls (``.append`` / ``.pop`` / ``.remove`` / ...) count as
  writes. Constructor (``__init__``/``__post_init__``) accesses are
  ignored — the object is not shared yet — and lock / queue / thread
  attributes themselves are exempt (queues lock internally).

Rules, for every attribute reachable from >= 2 roles with at least
one non-constructor write:

* ``race-unguarded-shared`` — some access holds NO lock: that site
  bypasses whatever guard the others use.
* ``race-inconsistent-guard`` — every access is guarded but no single
  lock is common to all of them: two sites believe different locks
  protect the field, which is how the deadline-reaper hole
  and the block-policy shutdown hazard shipped (both are
  seeded regression fixtures in tests/test_analysis_dataflow.py).

Findings carry the access-site evidence chain (role, site, locks
held). Intentional protocols the checker cannot see locally — the
compactor's worker-claim ownership of snapshotted container prefixes,
idempotent shutdown flags — are waived in ``analysis/waivers.toml``
with written justifications, never silenced in code.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted,
)
from tuplewise_tpu_torch.analysis.dataflow import annotation_class
from tuplewise_tpu_torch.analysis import lock_order

#: packages whose classes are analyzed by default — the serving stack
#: the one-dispatch-core churn will rewrite
DEFAULT_SCOPE = ("tuplewise_tpu_torch/serving/",
                 "tuplewise_tpu_torch/parallel/", "tuplewise_tpu_torch/obs/")

_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}

#: substrings that canonicalize a thread name / target into a role
_ROLE_HINTS = ("batcher", "compactor", "reaper", "flusher",
               "snapshotter", "writer", "probe", "controller",
               "healer", "watchdog", "supervisor")

#: method calls that mutate the receiver container (write accesses)
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "pop",
             "popleft", "remove", "clear", "insert", "add", "discard",
             "update", "setdefault", "sort"}

#: contexts kept per (function, role) before collapsing to their
#: intersection — bounds the walk on diamond-heavy call graphs
_MAX_CONTEXTS = 6

_INIT_METHODS = {"__init__", "__post_init__"}

FuncKey = Tuple[str, str, str]


class Access:
    __slots__ = ("cls", "attr", "path", "line", "write", "role",
                 "held")

    def __init__(self, cls: str, attr: str, path: str, line: int,
                 write: bool, role: str, held: FrozenSet[str]):
        self.cls = cls
        self.attr = attr
        self.path = path
        self.line = line
        self.write = write
        self.role = role
        self.held = held


def _role_of(name_literal: Optional[str], target: str) -> str:
    """Canonical role from the thread's ``name=`` literal (preferred)
    or its target function name."""
    for source in (name_literal or "", target):
        low = source.lower()
        for hint in _ROLE_HINTS:
            if hint in low:
                return hint
    base = (name_literal or target).rsplit(".", 1)[-1]
    return base.lstrip("_") or "thread"


def thread_roles(ms: ModuleSet, an: "lock_order._Analysis"
                 ) -> Dict[FuncKey, str]:
    """{entry function key -> role} from every Thread/Timer
    construction in the corpus."""
    roles: Dict[FuncKey, str] = {}
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node)
                target_expr = None
                if cn in _THREAD_CTORS:
                    for k in node.keywords:
                        if k.arg == "target":
                            target_expr = k.value
                elif cn in _TIMER_CTORS and len(node.args) >= 2:
                    target_expr = node.args[1]
                if target_expr is None:
                    continue
                tname = dotted(target_expr)
                if tname is None:
                    continue
                name_lit = None
                for k in node.keywords:
                    if k.arg == "name" \
                            and isinstance(k.value, ast.Constant) \
                            and isinstance(k.value.value, str):
                        name_lit = k.value.value
                key: Optional[FuncKey] = None
                if tname.startswith("self.") and fi.cls:
                    meth = tname[len("self."):]
                    if "." not in meth \
                            and meth in mi.classes.get(fi.cls, {}):
                        key = (path, fi.cls, f"{fi.cls}.{meth}")
                elif "." not in tname:
                    cand = (path, fi.cls or "",
                            f"{fi.qualname}.{tname}")
                    if cand in an.known_funcs:
                        key = cand
                    elif tname in mi.functions:
                        key = (path, "", tname)
                if key is not None:
                    roles[key] = _role_of(name_lit, tname)
    return roles


class _Walker:
    """One (function, role, inherited-held) context walk: records
    attribute accesses under the locks held and propagates contexts
    into resolved callees via the shared worklist."""

    def __init__(self, race: "_RaceAnalysis", key: FuncKey,
                 role: str, held: FrozenSet[str]):
        self.race = race
        self.an = race.an
        self.ms = race.ms
        self.key = key
        self.role = role
        self.entry_held = held
        path, cls, qual = key
        self.path = path
        self.cls = cls or None
        self.qual = qual
        self.mi = self.ms.modules[path]
        self.model = (self.an.model(path, self.cls)
                      if self.cls else None)
        # local name -> repo class (annotated params, typed aliases)
        self.local_types: Dict[str, str] = {}
        fnode = race.func_nodes[key]
        args = getattr(fnode, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                c = annotation_class(self.ms, self.mi, a.annotation)
                if c is not None:
                    self.local_types[a.arg] = c

    # ------------------------------------------------------------------ #
    def lock_of(self, item: ast.withitem) -> Optional[str]:
        if self.model is not None:
            lid = self.model.lock_id(item.context_expr)
            if lid is not None:
                return lid
        d = dotted(item.context_expr)
        if d is not None:
            return self.an.module_locks.get(self.path, {}).get(d)
        return None

    def _owner_of(self, expr: ast.AST) -> Optional[str]:
        """Repo class owning an attribute accessed as
        ``<expr>.attr`` — self, a typed self-attribute, or a typed
        local."""
        d = dotted(expr)
        if d is None:
            return None
        if d == "self":
            return self.cls
        if d.startswith("self.") and self.cls is not None:
            rest = d[len("self."):]
            if "." not in rest:
                model = self.an.model(self.path, self.cls)
                return model.attr_class.get(rest)
            return None
        if "." not in d:
            return self.local_types.get(d)
        return None

    def _is_exempt(self, owner: str, attr: str) -> bool:
        """Locks themselves, queues (internally synchronized), thread
        handles, and dunders are not race subjects."""
        if attr.startswith("__"):
            return True
        cdef = self.race.class_paths.get(owner)
        if cdef is None:
            return True
        model = self.an.model(cdef, owner)
        return (attr in model.locks or attr in model.queues
                or attr in model.threads)

    # ------------------------------------------------------------------ #
    def run(self, node: ast.AST) -> None:
        self.walk(node, self.entry_held)

    def walk(self, node: ast.AST, held: FrozenSet[str]) -> None:
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                continue    # nested defs get contexts via callback
                # linking in lock_order's call resolution
            now = held
            if isinstance(sub, ast.With):
                for item in sub.items:
                    lid = self.lock_of(item)
                    if lid is not None:
                        now = now | {lid}
            elif isinstance(sub, ast.Assign) \
                    and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                # typed alias: side = self._pos
                src = dotted(sub.value)
                if src is not None and src.startswith("self.") \
                        and self.cls is not None:
                    rest = src[len("self."):]
                    if "." not in rest:
                        model = self.an.model(self.path, self.cls)
                        t = model.attr_class.get(rest)
                        if t is not None:
                            self.local_types[sub.targets[0].id] = t
            elif isinstance(sub, (ast.For, ast.AsyncFor)) \
                    and isinstance(sub.target, ast.Name) \
                    and isinstance(sub.iter, (ast.Tuple, ast.List)):
                # for side in (self._pos, self._neg): type the target
                # when every element agrees
                owners = {self._attr_type(e) for e in sub.iter.elts}
                owners.discard(None)
                if len(owners) == 1:
                    self.local_types[sub.target.id] = owners.pop()
            if isinstance(sub, ast.Attribute):
                self._record(sub, now)
            if isinstance(sub, ast.Call):
                self._record_mutator(sub, now)
                self._propagate(sub, now)
            self.walk(sub, now)

    def _attr_type(self, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d is None or not d.startswith("self.") \
                or self.cls is None:
            return None
        rest = d[len("self."):]
        if "." in rest:
            return None
        model = self.an.model(self.path, self.cls)
        return model.attr_class.get(rest)

    # ------------------------------------------------------------------ #
    def _record(self, node: ast.Attribute,
                held: FrozenSet[str]) -> None:
        owner = self._owner_of(node.value)
        if owner is None or self._is_exempt(owner, node.attr):
            return
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        self.race.add_access(Access(
            owner, node.attr, self.path, node.lineno, write,
            self.role, held))

    def _record_mutator(self, call: ast.Call,
                        held: FrozenSet[str]) -> None:
        """``self._pending.append(x)`` — a container-mutator method
        call is a WRITE to the attribute's object."""
        if not isinstance(call.func, ast.Attribute):
            return
        if call.func.attr not in _MUTATORS:
            return
        recv = call.func.value
        if not isinstance(recv, ast.Attribute):
            return
        owner = self._owner_of(recv.value)
        if owner is None or self._is_exempt(owner, recv.attr):
            return
        self.race.add_access(Access(
            owner, recv.attr, self.path, call.lineno, True,
            self.role, held))

    def _propagate(self, call: ast.Call,
                   held: FrozenSet[str]) -> None:
        r = self.an.resolve_call(self.path, self.cls, call,
                                 prefix=self.qual)
        if r is None or r == self.key:
            return
        if r[2].rsplit(".", 1)[-1] in _INIT_METHODS:
            return      # constructing a FRESH object: not shared yet
        self.race.enqueue(r, self.role, held)
        # nested defs passed as callbacks run under the caller's locks
        for a in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(a, ast.Name):
                cand = (self.path, self.cls or "",
                        f"{self.qual}.{a.id}")
                if cand in self.an.known_funcs and cand != self.key:
                    self.race.enqueue(cand, self.role, held)


class _RaceAnalysis:
    def __init__(self, ms: ModuleSet, an, funcs, scope):
        self.ms = ms
        self.an = an
        self.scope = scope
        self.func_nodes: Dict[FuncKey, ast.AST] = {
            (path, fi.cls or "", fi.qualname): fi.node
            for path, fi in funcs}
        self.func_infos = {(path, fi.cls or "", fi.qualname): fi
                           for path, fi in funcs}
        # class name -> defining path (scoped classes only)
        self.class_paths: Dict[str, str] = {}
        for cname, (path, _) in ms.class_defs.items():
            if any(path.startswith(p) for p in scope):
                self.class_paths[cname] = path
        self.accesses: Dict[Tuple[str, str], List[Access]] = {}
        self.seen_ctx: Dict[FuncKey,
                            Set[Tuple[str, FrozenSet[str]]]] = {}
        self.worklist: List[Tuple[FuncKey, str, FrozenSet[str]]] = []

    def add_access(self, acc: Access) -> None:
        self.accesses.setdefault((acc.cls, acc.attr), []).append(acc)

    def enqueue(self, key: FuncKey, role: str,
                held: FrozenSet[str]) -> None:
        if key not in self.func_nodes:
            return
        ctxs = self.seen_ctx.setdefault(key, set())
        if (role, held) in ctxs:
            return
        same_role = [h for r, h in ctxs if r == role]
        if len(same_role) >= _MAX_CONTEXTS:
            # collapse: keep the intersection — the locks GUARANTEED
            # held however this function was reached in this role
            inter = frozenset.intersection(held, *same_role)
            if any(h == inter for h in same_role):
                return
            held = inter
            if (role, held) in ctxs:
                return
        ctxs.add((role, held))
        self.worklist.append((key, role, held))

    def drain(self) -> None:
        while self.worklist:
            key, role, held = self.worklist.pop()
            walker = _Walker(self, key, role, held)
            walker.run(self.func_nodes[key])


def run(ms: ModuleSet, scope: Tuple[str, ...] = DEFAULT_SCOPE
        ) -> List[Finding]:
    an, funcs = lock_order.build_analysis(ms)
    race = _RaceAnalysis(ms, an, funcs, scope)
    roles = thread_roles(ms, an)

    # entries: thread/timer targets + public API ("caller" role).
    # Caller entries exist only for CONCURRENCY-OWNING classes (a lock
    # attribute or a thread spawn): passive helpers (_ClassSide,
    # StreamingIncompleteU, the health monitors) are externally
    # synchronized by contract — their accesses are judged along the
    # owner paths that reach them, not from a phantom bare-API entry.
    for key, role in roles.items():
        race.enqueue(key, role, frozenset())
    for (path, cls, qual), fi in race.func_infos.items():
        if not any(path.startswith(p) for p in scope):
            continue
        leaf = qual.rsplit(".", 1)[-1]
        if leaf.startswith("_") or leaf in _INIT_METHODS:
            continue
        if (path, cls, qual) in roles:
            continue
        if qual != (f"{cls}.{leaf}" if cls else leaf):
            continue    # nested def, not API surface (a method's
            # callback closures run under whatever their method holds:
            # they are reached through it, never as a bare entry)
        if cls and not _owns_concurrency(race, path, cls):
            continue
        race.enqueue((path, cls, qual), "caller", frozenset())
    race.drain()

    findings: List[Finding] = []
    for (cls, attr), accs in sorted(race.accesses.items()):
        roles_seen = {a.role for a in accs}
        if len(roles_seen) < 2:
            continue
        writes = [a for a in accs if a.write]
        if not writes:
            continue
        unguarded = [a for a in accs if not a.held]
        common = frozenset.intersection(*[a.held for a in accs]) \
            if not unguarded else frozenset()
        if unguarded:
            rule = "race-unguarded-shared"
            head = (f"{cls}.{attr} is shared across roles "
                    f"{sorted(roles_seen)} with at least one write, "
                    "but some sites access it with NO lock held")
        elif not common:
            rule = "race-inconsistent-guard"
            head = (f"{cls}.{attr} is shared across roles "
                    f"{sorted(roles_seen)} with at least one write, "
                    "and no single lock guards every access — sites "
                    "disagree about which lock protects it")
        else:
            continue    # consistently guarded: the invariant holds
        evidence = _evidence(accs, unguarded)
        first = (unguarded or writes or accs)[0]
        findings.append(Finding(
            rule, race.class_paths.get(cls, first.path), first.line,
            f"{cls}.{attr}",
            head + "; evidence: " + "; ".join(evidence)))
    return findings


def _owns_concurrency(race: _RaceAnalysis, path: str,
                      cls: str) -> bool:
    """True when the class owns a lock or spawns a thread — the
    classes whose public API is a real cross-thread entry surface."""
    model = race.an.model(path, cls)
    if model.locks or model.threads:
        return True
    mi = race.ms.modules[path]
    for mnode in mi.classes.get(cls, {}).values():
        for node in ast.walk(mnode):
            if isinstance(node, ast.Call) and call_name(node) in (
                    _THREAD_CTORS | _TIMER_CTORS):
                return True
    return False


def _evidence(accs: List[Access],
              unguarded: List[Access]) -> List[str]:
    """A compact access-site chain: one site per (role, guardedness),
    unguarded and write sites first."""
    picked: List[Access] = []
    seen: Set[Tuple[str, bool, FrozenSet[str]]] = set()
    ordered = sorted(accs, key=lambda a: (bool(a.held), not a.write,
                                          a.line))
    for a in ordered:
        sig = (a.role, bool(a.held), a.held)
        if sig in seen:
            continue
        seen.add(sig)
        picked.append(a)
        if len(picked) >= 4:
            break
    out = []
    for a in picked:
        locks = ",".join(sorted(a.held)) if a.held else "NO LOCK"
        kind = "write" if a.write else "read"
        out.append(f"[{a.role}] {kind} {a.path}:{a.line} "
                   f"holding {locks}")
    return out
