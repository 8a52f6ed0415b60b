"""Shared flow-sensitive dataflow substrate.

The syntactic passes chase a value through at most one local
assignment and resolve calls ad hoc; every precision gap of their
triage traced back to that. This module is the substrate the
flow-sensitive tier (``races``, ``exactness``, and the reworked
``compile_ladder``) is built on:

* :func:`build_call_graph` — one interprocedural call graph over the
  corpus: self-methods, attribute-typed calls (``self.index.insert``
  through the class/attribute type map), local + nested functions,
  and imported repo functions. The resolution logic generalizes the
  lock pass's resolver; confidently-resolved edges only, so clients
  under-approximate instead of spraying false positives.

* :class:`Engine` — a forward abstract interpreter parameterized by a
  :class:`Domain`. Per function it walks statements in order
  (branches join, loops iterate to a bounded fixpoint), maintaining a
  name -> abstract-value environment; across functions it computes
  memoized summaries (param values in, joined return value out) with
  cycle cut-off, chases class-attribute writes (``self.x = expr``
  joined over every write site), and tracks NamedTuple/dataclass
  constructor fields so ``plan.pos`` evaluates to what the
  constructor was given.

Domains stay SMALL: abstract values must be hashable and the lattice
finite-height — the engine bounds loop iterations and call depth, so
termination never depends on the domain being clever.
"""

from __future__ import annotations

import ast
import itertools
from typing import Any, Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    FunctionInfo, ModuleInfo, ModuleSet, call_name, dotted,
)

#: (path, class name or "", qualname) — the one function key every
#: layer of the tier shares
FuncKey = Tuple[str, str, str]

_MAX_CALL_DEPTH = 8      # interprocedural evaluation depth
_MAX_LOOP_PASSES = 2     # loop bodies re-evaluated until join stabilizes
_MAX_CALLSITE_JOIN = 12  # call sites joined into a parameter value


class Domain:
    """Abstract-value lattice + transfer functions.

    Subclasses override what they care about; everything defaults to
    ``top`` (= "unknown"), so a domain only models the expressions its
    pass judges. Values MUST be hashable (they key summary memos).
    """

    top: Any = None

    def join(self, a, b):
        if a == b:
            return a
        return self.top

    def const(self, value) -> Any:
        return self.top

    def call(self, cn: Optional[str], node: ast.Call,
             argvals: List[Any], kwvals: Dict[str, Any],
             recv: Any = None) -> Any:
        """Value of a call the engine could NOT resolve in-corpus (or
        a resolved one after summary evaluation returned top). ``cn``
        is the dotted callee name as written, possibly None; ``recv``
        is the receiver's abstract value for method calls
        (``less.sum()`` sees the value of ``less``)."""
        return self.top

    def attribute(self, base: Any, attr: str) -> Any:
        return self.top

    def subscript(self, base: Any, index: Any) -> Any:
        return self.top

    def binop(self, op: ast.AST, left: Any, right: Any) -> Any:
        return self.top

    def unaryop(self, op: ast.AST, operand: Any) -> Any:
        return operand if isinstance(op, ast.USub) else self.top

    def sequence(self, node: ast.AST, elts: List[Any]) -> Any:
        """Value of a Tuple/List/Set display."""
        return self.top


class Struct:
    """A constructor result with known fields (NamedTuple/dataclass):
    ``plan.pos`` evaluates to the value the constructor was given.
    Hashable on sorted items."""

    __slots__ = ("cls", "fields")

    def __init__(self, cls: str, fields: Dict[str, Any]):
        self.cls = cls
        self.fields = fields

    def __eq__(self, other):
        return (isinstance(other, Struct) and other.cls == self.cls
                and other.fields == self.fields)

    def __hash__(self):
        return hash((self.cls, tuple(sorted(
            (k, v) for k, v in self.fields.items()))))

    def __repr__(self):
        return f"Struct({self.cls}, {self.fields})"


class Seq:
    """A tuple/list display with known element values (supports
    unpacking assignment and iteration joins)."""

    __slots__ = ("elts",)

    def __init__(self, elts: Tuple[Any, ...]):
        self.elts = tuple(elts)

    def __eq__(self, other):
        return isinstance(other, Seq) and other.elts == self.elts

    def __hash__(self):
        return hash(self.elts)

    def __repr__(self):
        return f"Seq{self.elts}"


# --------------------------------------------------------------------- #
# class attribute typing (shared with the lock pass's model)             #
# --------------------------------------------------------------------- #

def attr_class_map(ms: ModuleSet, mi: ModuleInfo,
                   cname: str) -> Dict[str, str]:
    """{self-attr -> repo class name} for one class, chasing a
    one-level factory-method return the way the lock pass does."""
    out: Dict[str, str] = {}
    for attr, ctor in mi.attr_ctors.get(cname, {}).items():
        if ctor.startswith("self."):
            meth = mi.classes.get(cname, {}).get(ctor[len("self."):])
            if meth is not None:
                for st in ast.walk(meth):
                    if isinstance(st, ast.Return) \
                            and isinstance(st.value, ast.Call):
                        ctor = call_name(st.value) or ctor
                        break
        rc = ms.resolve_class(mi, ctor)
        if rc is not None:
            out[attr] = rc
    return out


def annotation_class(ms: ModuleSet, mi: ModuleInfo,
                     ann: Optional[ast.AST]) -> Optional[str]:
    """Resolve a parameter/variable annotation to a repo class name
    (string annotations and Optional[X] unwrapped)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):
        d = dotted(ann.value)
        if d in ("Optional", "typing.Optional"):
            return annotation_class(ms, mi, ann.slice)
        return None
    d = dotted(ann)
    if d is None:
        return None
    return ms.resolve_class(mi, d)


# --------------------------------------------------------------------- #
# call graph                                                             #
# --------------------------------------------------------------------- #

class CallGraph:
    """Resolved corpus call graph + the resolver every client shares."""

    def __init__(self, ms: ModuleSet):
        self.ms = ms
        self.functions: Dict[FuncKey, ast.AST] = {}
        self.infos: Dict[FuncKey, FunctionInfo] = {}
        self.edges: Dict[FuncKey, Set[FuncKey]] = {}
        self._attr_classes: Dict[Tuple[str, str], Dict[str, str]] = {}
        for path, mi in ms.modules.items():
            for fi in mi.iter_functions():
                key = (path, fi.cls or "", fi.qualname)
                self.functions[key] = fi.node
                self.infos[key] = fi
        for key in self.functions:
            self.edges[key] = set()
        for key, node in self.functions.items():
            path, cls, qual = key
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    r = self.resolve_call(path, cls or None, sub,
                                          prefix=qual)
                    if r is not None and r != key:
                        self.edges[key].add(r)

    # ------------------------------------------------------------------ #
    def attr_classes(self, path: str, cname: str) -> Dict[str, str]:
        key = (path, cname)
        if key not in self._attr_classes:
            self._attr_classes[key] = attr_class_map(
                self.ms, self.ms.modules[path], cname)
        return self._attr_classes[key]

    def resolve_call(self, path: str, cls: Optional[str],
                     call: ast.Call, prefix: str = ""
                     ) -> Optional[FuncKey]:
        """Map a call to a corpus function key: nested defs (via the
        enclosing qualname ``prefix``), self-methods, typed
        self-attributes, local defs, imported repo functions, and
        repo-class constructors (-> ``__init__``)."""
        ms = self.ms
        mi = ms.modules[path]
        cn = call_name(call)
        if cn is None:
            return None
        if "." not in cn and prefix:
            nested = (path, cls or "", f"{prefix}.{cn}")
            if nested in self.functions:
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
            tcls = self.attr_classes(path, cls).get(attr)
            if tcls is not None:
                tpath, methods = ms.class_defs[tcls]
                if meth in methods:
                    return (tpath, tcls, f"{tcls}.{meth}")
            return None
        if "." not in cn:
            if cn in mi.functions:
                return (path, "", cn)
            if cls is not None and cn in mi.classes.get(cls, {}):
                return (path, cls, f"{cls}.{cn}")
            resolved = ms.resolve_import(mi, cn)
            if resolved is not None:
                tpath, sym = resolved
                tmi = ms.modules.get(tpath)
                if tmi is not None and sym in tmi.functions:
                    return (tpath, "", sym)
        return None

    def resolve_constructor(self, path: str,
                            call: ast.Call) -> Optional[str]:
        """Repo class name when the call constructs one, else None."""
        cn = call_name(call)
        if cn is None:
            return None
        return self.ms.resolve_class(self.ms.modules[path], cn)

    def callers(self) -> Dict[FuncKey, Set[Tuple[FuncKey, ast.Call]]]:
        """{callee -> {(caller, call node)}} — parameter-value joins
        need the actual call expressions, not just the edge."""
        out: Dict[FuncKey, Set[Tuple[FuncKey, ast.Call]]] = {}
        for key, node in self.functions.items():
            path, cls, qual = key
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    r = self.resolve_call(path, cls or None, sub,
                                          prefix=qual)
                    if r is not None and r != key:
                        out.setdefault(r, set()).add((key, sub))
        return out


# --------------------------------------------------------------------- #
# the forward abstract interpreter                                       #
# --------------------------------------------------------------------- #

class Engine:
    """Interprocedural forward dataflow over a :class:`Domain`.

    * :meth:`eval_function` — flow-sensitive walk of one function with
      given parameter values; returns the joined return value and
      (optionally) a per-node value map for clients that inspect
      intermediate expressions.
    * :meth:`summary` — memoized interprocedural summary: evaluate the
      callee with the given argument values; recursion and depth are
      cut to ``domain.top``.
    * :meth:`param_values` — join a function's parameter values over
      every resolved call site (the chase that proves e.g. "every
      caller pads this query block to its bucket").
    * class-attribute values: ``self.x`` reads evaluate to the join of
      every ``self.x = ...`` write in the class (two rounds, so writes
      that read other attributes settle).
    """

    def __init__(self, ms: ModuleSet, domain: Domain,
                 graph: Optional[CallGraph] = None):
        self.ms = ms
        self.domain = domain
        self.graph = graph if graph is not None else CallGraph(ms)
        self._summaries: Dict[Tuple[FuncKey, Tuple], Any] = {}
        self._active: Set[FuncKey] = set()
        self._attr_values: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._attrs_ready: Set[Tuple[str, str]] = set()
        self._callers = None
        self._param_memo: Dict[FuncKey, Dict[str, Any]] = {}
        self._param_active: Set[FuncKey] = set()
        self._closure_memo: Dict[FuncKey, Dict[str, Any]] = {}
        self._closure_active: Set[FuncKey] = set()

    # ------------------------------------------------------------------ #
    # class attribute values                                             #
    # ------------------------------------------------------------------ #
    def attr_value(self, path: str, cname: str, attr: str) -> Any:
        key = (path, cname)
        if key not in self._attrs_ready:
            self._attrs_ready.add(key)     # cut self-recursion first
            self._attr_values[key] = self._compute_attrs(path, cname)
        return self._attr_values.get(key, {}).get(attr,
                                                  self.domain.top)

    def _compute_attrs(self, path: str, cname: str) -> Dict[str, Any]:
        mi = self.ms.modules.get(path)
        if mi is None or cname not in mi.classes:
            return {}
        out: Dict[str, Any] = {}
        for _round in range(2):
            for mname, mnode in mi.classes[cname].items():
                key = (path, cname, f"{cname}.{mname}")
                if key not in self.graph.functions:
                    continue
                env = self._entry_env(key, None)
                walker = _FunctionWalk(self, key, env)
                walker.run()
                for attr, val in walker.attr_writes.items():
                    if attr in out:
                        out[attr] = self.domain.join(out[attr], val)
                    else:
                        out[attr] = val
        return out

    # ------------------------------------------------------------------ #
    # parameter joins over call sites                                    #
    # ------------------------------------------------------------------ #
    def param_values(self, key: FuncKey) -> Dict[str, Any]:
        """{param name -> joined abstract value over every resolved
        call site}. Params no site binds (or functions with no known
        callers) default to ``top``."""
        if key in self._param_memo:
            return self._param_memo[key]
        if key in self._param_active or len(self._param_active) > 24:
            return {}
        self._param_active.add(key)
        try:
            if self._callers is None:
                self._callers = self.graph.callers()
            node = self.graph.functions.get(key)
            sites = list(self._callers.get(key, ()))[:_MAX_CALLSITE_JOIN]
            if node is None or not sites \
                    or not isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                self._param_memo[key] = {}
                return {}
            params = [a.arg for a in node.args.args]
            if params and params[0] in ("self", "cls"):
                params = params[1:]
            joined: Dict[str, Any] = {}
            for caller, call in sites:
                env = self._entry_env(caller, None)
                walker = _FunctionWalk(self, caller, env,
                                       stop_at=call)
                walker.run()
                argvals = [walker.eval(a) for a in call.args]
                kwvals = {k.arg: walker.eval(k.value)
                          for k in call.keywords if k.arg}
                bound = dict(zip(params, argvals))
                bound.update({k: v for k, v in kwvals.items()
                              if k in params})
                for p in params:
                    v = bound.get(p, self.domain.top)
                    if p in joined:
                        joined[p] = self.domain.join(joined[p], v)
                    else:
                        joined[p] = v
            self._param_memo[key] = joined
            return joined
        finally:
            self._param_active.discard(key)

    # ------------------------------------------------------------------ #
    # function evaluation + summaries                                    #
    # ------------------------------------------------------------------ #
    def _entry_env(self, key: FuncKey,
                   argvals: Optional[List[Any]],
                   kwvals: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        node = self.graph.functions[key]
        env: Dict[str, Any] = {}
        args = getattr(node, "args", None)
        if args is None:
            return env
        params = [a.arg for a in args.args]
        vals = list(argvals) if argvals is not None else []
        if params and params[0] in ("self", "cls"):
            env[params[0]] = self.domain.top
            params = params[1:]
        for i, p in enumerate(params):
            env[p] = vals[i] if i < len(vals) else self.domain.top
        if kwvals:
            for k, v in kwvals.items():
                if k in params:
                    env[k] = v
        return env

    def eval_function(self, key: FuncKey,
                      argvals: Optional[List[Any]] = None,
                      kwvals: Optional[Dict[str, Any]] = None) -> Any:
        """Joined return value of ``key`` under the given argument
        values (missing ones default to the call-site join, then
        top)."""
        env = self._entry_env(key, argvals, kwvals)
        if argvals is None and kwvals is None:
            for p, v in self.param_values(key).items():
                if env.get(p, self.domain.top) is self.domain.top:
                    env[p] = v
        walker = _FunctionWalk(self, key, env)
        walker.run()
        return walker.returns

    def closure_env(self, key: FuncKey) -> Dict[str, Any]:
        """Free-variable environment of a NESTED def: the enclosing
        function's final env (the healer's ``attempt`` closures read
        the padded query blocks their enclosing method built)."""
        path, cls, qual = key
        if "." not in qual:
            return {}
        parent = (path, cls, qual.rsplit(".", 1)[0])
        if parent not in self.graph.functions:
            return {}
        if parent in self._closure_memo:
            return self._closure_memo[parent]
        if parent in self._closure_active:
            return {}
        self._closure_active.add(parent)
        try:
            env = self._entry_env(parent, None)
            for p, v in self.param_values(parent).items():
                if env.get(p, self.domain.top) is self.domain.top:
                    env[p] = v
            walker = _FunctionWalk(self, parent, env)
            walker.run()
            self._closure_memo[parent] = dict(walker.env)
            return self._closure_memo[parent]
        finally:
            self._closure_active.discard(parent)

    def trace_function(self, key: FuncKey, hook) -> None:
        """Flow-sensitive walk of ``key`` calling ``hook(walker,
        stmt)`` before each statement — clients inspect assignments
        with the environment AT that program point (parameters default
        to their call-site join)."""
        env = self._entry_env(key, None)
        for p, v in self.param_values(key).items():
            if env.get(p, self.domain.top) is self.domain.top:
                env[p] = v
        walker = _FunctionWalk(self, key, env, stmt_hook=hook)
        walker.run()

    def summary(self, key: FuncKey, argvals: List[Any],
                kwvals: Dict[str, Any]) -> Any:
        if key in self._active or len(self._active) >= _MAX_CALL_DEPTH:
            return self.domain.top
        memo = (key, tuple(argvals),
                tuple(sorted(kwvals.items())) if kwvals else ())
        try:
            if memo in self._summaries:
                return self._summaries[memo]
        except TypeError:       # unhashable domain value: no memo
            memo = None
        self._active.add(key)
        try:
            val = self.eval_function(key, argvals, kwvals)
        finally:
            self._active.discard(key)
        if memo is not None:
            self._summaries[memo] = val
        return val


class _FunctionWalk:
    """Flow-sensitive walk of ONE function body.

    ``stop_at`` — an AST node; evaluation stops once the statement
    containing it has been processed (used to read the environment a
    call site sees). ``attr_writes`` — joined values of every
    ``self.x = ...`` in the body. ``returns`` — joined return value.
    """

    def __init__(self, engine: Engine, key: FuncKey,
                 env: Dict[str, Any], stop_at: Optional[ast.AST] = None,
                 stmt_hook=None):
        self.engine = engine
        self.domain = engine.domain
        self.key = key
        self.env = env
        self.stop_at = stop_at
        self.stmt_hook = stmt_hook
        self._stopped = False
        self.returns = self.domain.top
        self._saw_return = False
        self.attr_writes: Dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    def run(self) -> None:
        node = self.engine.graph.functions[self.key]
        body = getattr(node, "body", [])
        if isinstance(body, ast.AST):    # Lambda
            self.returns = self.eval(body)
            return
        self.exec_block(body)
        if not self._saw_return:
            self.returns = self.domain.top

    def exec_block(self, stmts) -> None:
        for st in stmts:
            if self._stopped:
                return
            self.exec_stmt(st)
            if self._stopped:
                return      # a nested block hit stop_at: the branch
                # env is preserved as-is (no join past this point)
            if self.stop_at is not None and self._contains(st):
                self._stopped = True
                return

    def _contains(self, st: ast.AST) -> bool:
        return any(n is self.stop_at for n in ast.walk(st))

    # ------------------------------------------------------------------ #
    def exec_stmt(self, st: ast.AST) -> None:
        d = self.domain
        if self.stmt_hook is not None:
            self.stmt_hook(self, st)
        if isinstance(st, ast.Assign):
            val = self.eval(st.value)
            for t in st.targets:
                self.assign(t, val)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.assign(st.target, self.eval(st.value))
        elif isinstance(st, ast.AugAssign):
            cur = self.eval(st.target)
            val = d.binop(st.op, cur, self.eval(st.value))
            self.assign(st.target, val)
        elif isinstance(st, ast.Return):
            val = self.eval(st.value) if st.value is not None else d.top
            self.returns = val if not self._saw_return \
                else d.join(self.returns, val)
            self._saw_return = True
        elif isinstance(st, (ast.If,)):
            self.eval(st.test)
            before = dict(self.env)
            self.exec_block(st.body)
            if self._stopped:
                return      # stop_at inside then-branch: keep its env
            then_env = self.env
            self.env = before
            self.exec_block(st.orelse)
            if self._stopped:
                return
            self.env = self._join_env(then_env, self.env)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            it = self.eval(st.iter)
            elem = d.top
            if isinstance(it, Seq):
                vals = list(it.elts)
                if vals:
                    elem = vals[0]
                    for v in vals[1:]:
                        elem = d.join(elem, v)
            self.assign(st.target, elem)
            for _ in range(_MAX_LOOP_PASSES):
                before = dict(self.env)
                self.exec_block(st.body)
                if self._stopped:
                    return
                joined = self._join_env(before, self.env)
                if joined == before:
                    self.env = joined
                    break
                self.env = joined
            self.exec_block(st.orelse)
        elif isinstance(st, ast.While):
            self.eval(st.test)
            for _ in range(_MAX_LOOP_PASSES):
                before = dict(self.env)
                self.exec_block(st.body)
                if self._stopped:
                    return
                joined = self._join_env(before, self.env)
                if joined == before:
                    self.env = joined
                    break
                self.env = joined
            self.exec_block(st.orelse)
        elif isinstance(st, ast.With) or isinstance(st, ast.AsyncWith):
            for item in st.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, v)
            self.exec_block(st.body)
        elif isinstance(st, ast.Try):
            self.exec_block(st.body)
            if self._stopped:
                return
            before = dict(self.env)
            for h in st.handlers:
                self.env = dict(before)
                self.exec_block(h.body)
                if self._stopped:
                    return
                before = self._join_env(before, self.env)
            self.env = before
            self.exec_block(st.orelse)
            self.exec_block(st.finalbody)
        elif isinstance(st, ast.Expr):
            self.eval(st.value)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            pass    # nested defs have their own keys
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        # Import/Global/Pass/Raise/Assert/...: no value flow modeled

    def _join_env(self, a: Dict[str, Any],
                  b: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k in set(a) | set(b):
            va = a.get(k, self.domain.top)
            vb = b.get(k, self.domain.top)
            out[k] = self.domain.join(va, vb)
        return out

    # ------------------------------------------------------------------ #
    def assign(self, target: ast.AST, val: Any) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
        elif isinstance(target, ast.Starred):
            self.assign(target.value, self.domain.top)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(val, Seq) \
                    and len(val.elts) == len(target.elts):
                for t, v in zip(target.elts, val.elts):
                    self.assign(t, v)
            else:
                for t in target.elts:
                    self.assign(t, self.domain.top)
        elif isinstance(target, ast.Attribute):
            d = dotted(target)
            if d is not None and d.startswith("self.") \
                    and "." not in d[len("self."):]:
                attr = d[len("self."):]
                if attr in self.attr_writes:
                    self.attr_writes[attr] = self.domain.join(
                        self.attr_writes[attr], val)
                else:
                    self.attr_writes[attr] = val
        # Subscript stores: no container content tracking

    # ------------------------------------------------------------------ #
    def eval(self, node: Optional[ast.AST]) -> Any:
        d = self.domain
        if node is None:
            return d.top
        if isinstance(node, ast.Constant):
            return d.const(node.value)
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            cenv = self.engine.closure_env(self.key)
            if node.id in cenv:
                return cenv[node.id]
            return self._module_const(node.id)
        if isinstance(node, ast.Attribute):
            dn = dotted(node)
            if dn is not None and dn.startswith("self.") \
                    and "." not in dn[len("self."):]:
                path, cls, _ = self.key
                if cls:
                    v = self.engine.attr_value(path, cls,
                                               dn[len("self."):])
                    if v is not d.top:
                        return v
            base = self.eval(node.value)
            if isinstance(base, Struct):
                if node.attr in base.fields:
                    return base.fields[node.attr]
                return d.top
            return d.attribute(base, node.attr)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            idx = self.eval(node.slice)
            if isinstance(base, Seq) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, int) \
                    and 0 <= node.slice.value < len(base.elts):
                return base.elts[node.slice.value]
            return d.subscript(base, idx)
        if isinstance(node, ast.BinOp):
            return d.binop(node.op, self.eval(node.left),
                           self.eval(node.right))
        if isinstance(node, ast.UnaryOp):
            return d.unaryop(node.op, self.eval(node.operand))
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = d.join(out, v)
            return out
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return d.join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            elts = [self.eval(e) for e in node.elts]
            if any(isinstance(e, ast.Starred) for e in node.elts):
                return d.sequence(node, elts)
            seq = Seq(tuple(elts))
            custom = d.sequence(node, elts)
            return custom if custom is not d.top else seq
        if isinstance(node, ast.Compare):
            for c in itertools.chain([node.left], node.comparators):
                self.eval(c)
            return d.top
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp, ast.DictComp)):
            return d.top
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.Lambda):
            return d.top
        if isinstance(node, ast.JoinedStr):
            return d.top
        return d.top

    def _module_const(self, name: str) -> Any:
        """Module-level scalar constants (``_MERGE_CHUNK = 32768``)."""
        path = self.key[0]
        mi = self.engine.ms.modules.get(path)
        if mi is None:
            return self.domain.top
        for st in mi.tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and st.targets[0].id == name \
                    and isinstance(st.value, ast.Constant):
                return self.domain.const(st.value.value)
        return self.domain.top

    def eval_call(self, node: ast.Call) -> Any:
        d = self.domain
        engine = self.engine
        path, cls, qual = self.key
        argvals = [self.eval(a) for a in node.args]
        kwvals = {k.arg: self.eval(k.value)
                  for k in node.keywords if k.arg}
        cn = call_name(node)
        recv = None
        if isinstance(node.func, ast.Attribute):
            recv = self.eval(node.func.value)
        # domain transfer first: it sees the raw call + arg values and
        # may fully decide (len, next_bucket, np.zeros, x.sum(), ...)
        val = d.call(cn, node, argvals, kwvals, recv=recv)
        if val is not d.top:
            return val
        # repo constructor -> Struct of its fields
        ctor = engine.graph.resolve_constructor(path, node) \
            if cn is not None else None
        if ctor is not None:
            fields = dict(kwvals)
            tpath, _ = engine.ms.class_defs[ctor]
            tmi = engine.ms.modules[tpath]
            names = _field_names(tmi, ctor)
            for i, v in enumerate(argvals):
                if i < len(names):
                    fields.setdefault(names[i], v)
            if fields:
                return Struct(ctor, fields)
            return d.top
        # interprocedural summary
        r = engine.graph.resolve_call(path, cls or None, node,
                                      prefix=qual)
        if r is not None:
            return engine.summary(r, argvals, kwvals)
        return d.top


def _field_names(mi: ModuleInfo, cname: str) -> List[str]:
    """Positional field names of a constructor: NamedTuple/dataclass
    annotations, else the ``__init__`` parameters (a plain class that
    stores its ctor args — ``self.x = x`` — chases the same way)."""
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.ClassDef) and node.name == cname:
            fields = [st.target.id for st in node.body
                      if isinstance(st, ast.AnnAssign)
                      and isinstance(st.target, ast.Name)]
            if fields:
                return fields
            init = mi.classes.get(cname, {}).get("__init__")
            if init is not None:
                return [a.arg for a in init.args.args
                        if a.arg not in ("self", "cls")]
    return []
