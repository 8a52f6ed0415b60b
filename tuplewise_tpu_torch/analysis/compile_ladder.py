"""Pass 4 — compile-ladder discipline: the bucket ladders bound the
shapes a device allocation or a launch is sized by.

The reference's chokepoints are its ``@functools.lru_cache`` jit
factories: their integer arguments key the compiled-program cache. The
port compiles nothing per shape, but the same integers size its device
allocations and launches, and on the card the caching allocator keeps
one block pool per distinct size: off the power-of-two ladders
((T_bucket, cap, q_bucket) — DESIGN §8/§15) every live size is a new
pack shape held by the allocator, and churn fragments it. Torch eager
has no factory marker, so the chokepoints are a declared table,
:data:`CHOKEPOINTS` (function name -> its shape-determining parameter
names): every public function of the count layer
(``parallel/sharded_counts.py``) that takes a size, confirmed from the
call sites in ``serving/index.py`` and ``serving/tenancy.py``.
``place_base`` is not one: it takes no size and buckets its own ``cap``
with ``next_bucket``.

Rule ``ladder-raw-shape``: at any call site of a chokepoint, a
shape-determining argument (positional or keyword) whose value derives
from ``len(...)`` / ``.shape`` / ``.size`` / ``.size()`` / ``.numel()``
of an arbitrary array allocates one pack shape per distinct live size.

The argument is evaluated on the shared dataflow substrate
(``analysis.dataflow``) with a ladder lattice:

* ``next_bucket`` / ``tenant_bucket`` / ``_t_bucket`` results are
  **bucketed**, as are integer constants and min/max/arithmetic over
  bucketed values;
* arrays and tensors allocated with bucketed dimensions
  (``np.full(bb, ...)``, ``torch.zeros((t_bucket, qb))``) are **ladder
  arrays**: their ``len()`` / ``.shape`` / ``.size`` reads are the
  ladder value itself, not a raw size;
* the chase is interprocedural: parameters take the JOIN of their
  resolved call-site values, results are the callee's summarized return
  (``dev, cap, _ = place_base(...)`` gives a bucketed ``cap``), and
  constructor fields flow through NamedTuples (``plan.cap_out``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name,
)
from tuplewise_tpu_torch.analysis import dataflow

_BUCKET_HELPERS = {"next_bucket", "_next_bucket", "_t_bucket",
                   "tenant_bucket", "self._t_bucket"}

# lattice values (hashable strings; dataflow.Domain contract)
BUCKETED = "bucketed"        # on the ladder (or a plain constant)
RAW = "raw"                  # derived from an arbitrary len/.shape
ARR_LADDER = "arr_ladder"    # array with ladder-derived dimensions
SHAPE_LADDER = "shape_ladder"  # .shape of a ladder array
SHAPE_RAW = "shape_raw"      # .shape of anything else

_ALLOC_LEAVES = {"zeros", "full", "empty", "ones"}


#: chokepoint -> its shape-determining parameters (names; positions
#: come from the corpus's def)
CHOKEPOINTS: Dict[str, Tuple[str, ...]] = {
    "place_run": ("cap",),
    "place_tenant_pack": ("t_bucket",),
    "sharded_counts": ("cap",),
    "tenant_pack_counts": ("cap_pos", "cap_neg", "t_bucket"),
    "delta_append": ("cap_old", "cap_chunk", "cap_new"),
    "sharded_major_merge": ("cap_base",),
}


class LadderDomain(dataflow.Domain):
    """raw dominates (a maybe-raw shape is a finding); bucketed and
    constants are interchangeable for cache-boundedness."""

    top = None

    def join(self, a, b):
        if a == b:
            return a
        if a is None or b is None:
            return None if RAW not in (a, b) else RAW
        if RAW in (a, b) or SHAPE_RAW in (a, b):
            return RAW
        if {a, b} <= {BUCKETED, ARR_LADDER, SHAPE_LADDER}:
            return BUCKETED if BUCKETED in (a, b) else a
        return None

    def const(self, value):
        if isinstance(value, bool):
            return None
        if isinstance(value, int):
            return BUCKETED     # a literal shape is one cache entry
        return None

    def call(self, cn, node, argvals, kwvals, recv=None):
        leaf = cn.split(".")[-1] if cn else None
        if cn in _BUCKET_HELPERS or leaf in _BUCKET_HELPERS:
            return BUCKETED
        if cn == "len":
            v = argvals[0] if argvals else None
            return BUCKETED if v == ARR_LADDER else RAW
        if cn is not None and "." in cn and leaf in ("size", "numel"):
            # torch's x.size(d) / x.numel(): the .shape/.size reads
            if leaf == "size" and not argvals:
                return SHAPE_LADDER if recv == ARR_LADDER else SHAPE_RAW
            return BUCKETED if recv == ARR_LADDER else RAW
        if cn == "int" or leaf in ("int32", "int64"):
            return argvals[0] if argvals else None
        if cn in ("min", "max"):
            out = BUCKETED
            for v in argvals:
                if v == RAW:
                    return RAW
                if v is None:
                    out = None
            return out
        if leaf in _ALLOC_LEAVES:
            shape = argvals[0] if argvals else None
            if isinstance(shape, dataflow.Seq):
                vals = set(shape.elts)
                if vals <= {BUCKETED}:
                    return ARR_LADDER
                if RAW in vals:
                    return None
                return None
            if shape == BUCKETED:
                return ARR_LADDER
            return None
        if leaf in ("concatenate", "cat", "stack", "hstack", "sort",
                    "ascontiguousarray"):
            v = argvals[0] if argvals else None
            if isinstance(v, dataflow.Seq):
                if set(v.elts) <= {ARR_LADDER}:
                    return ARR_LADDER
                return None
            return v if v in (ARR_LADDER,) else None
        if leaf in ("asarray", "copy", "ravel", "reshape",
                    "astype", "to", "contiguous", "clone", "from_numpy"):
            if recv in (ARR_LADDER,):
                return recv
            v = argvals[0] if argvals else None
            return v if v == ARR_LADDER else None
        return None

    def attribute(self, base, attr):
        if attr in ("shape",):
            return SHAPE_LADDER if base == ARR_LADDER else SHAPE_RAW
        if attr in ("size",):
            return BUCKETED if base == ARR_LADDER else RAW
        return None

    def subscript(self, base, index):
        if base == SHAPE_LADDER:
            return BUCKETED
        if base == SHAPE_RAW:
            return RAW
        if base == ARR_LADDER:
            return None
        return None

    def binop(self, op, left, right):
        if RAW in (left, right):
            return RAW
        if left is None or right is None:
            return None
        if BUCKETED in (left, right):
            return BUCKETED
        return None

    def sequence(self, node, elts):
        return self.top


def ladder_factories(ms: ModuleSet) -> Dict[str, Set[int]]:
    """{chokepoint name: shape-arg positions} for every
    :data:`CHOKEPOINTS` entry the corpus defines at module level."""
    out: Dict[str, Set[int]] = {}
    for path, mi in ms.modules.items():
        for name, params in CHOKEPOINTS.items():
            node = mi.functions.get(name)
            if node is None:
                continue
            out.setdefault(name, set()).update(
                i for i, a in enumerate(node.args.args)
                if a.arg in params)
    return out


def _raw_label(expr: ast.AST) -> str:
    """Human label of the offending derivation for the message."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and call_name(node) == "len":
            return "len(...)"
        if isinstance(node, ast.Attribute) and node.attr in ("shape",
                                                             "size"):
            return f".{node.attr}"
    return "len(...)/.shape"


def run(ms: ModuleSet) -> List[Finding]:
    factories = ladder_factories(ms)
    engine = dataflow.Engine(ms, LadderDomain())
    findings: List[Finding] = []

    for key, node in engine.graph.functions.items():
        path, cls, qual = key
        if not any(isinstance(sub, ast.Call)
                   and (lambda c: c and c.split(".")[-1]
                        in factories)(call_name(sub))
                   for sub in ast.walk(node)):
            continue
        calls: List[tuple] = []

        def hook(walker, st, _calls=calls):
            for sub in ast.walk(st):
                if not isinstance(sub, ast.Call):
                    continue
                cn = call_name(sub)
                leaf = cn.split(".")[-1] if cn else None
                if leaf not in factories:
                    continue
                for i, arg in enumerate(sub.args):
                    if i not in factories[leaf]:
                        continue
                    val = walker.eval(arg)
                    if val == RAW:
                        _calls.append((leaf, i, arg, sub.lineno))
                for kw in sub.keywords:
                    if kw.arg in CHOKEPOINTS[leaf] \
                            and walker.eval(kw.value) == RAW:
                        _calls.append((leaf, kw.arg, kw.value,
                                       sub.lineno))

        engine.trace_function(key, hook)
        for leaf, i, arg, lineno in calls:
            findings.append(Finding(
                "ladder-raw-shape", path, lineno,
                f"{qual}::{leaf}:{i}",
                f"{qual} passes a raw {_raw_label(arg)}-derived"
                f" size as shape arg {i} of {leaf}() — "
                "shape-determining values must come off "
                "the bucket ladder (next_bucket) or the device "
                "allocates one pack shape per live size"))

    # dedupe by fingerprint (a loop can hit the same site twice)
    seen: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
