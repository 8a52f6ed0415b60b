"""Shared substrate for the invariant passes: parsed
modules, import resolution, class/attribute typing, and the
:class:`Finding` record every pass emits.

Everything operates on a :class:`ModuleSet` — a mapping of repo-
relative paths to parsed ASTs — so the full-repo run
(``ModuleSet.from_repo``) and the fixture tests
(``ModuleSet.from_sources``) drive the identical code.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, Iterator, List, Optional, Tuple

#: modules scanned by default, relative to the repo root
DEFAULT_GLOBS = ("tuplewise_tpu_torch/**/*.py", "scripts_torch/*.py",
                 "bench_torch*.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``fingerprint`` is line-independent (rule + file + symbol) so a
    waiver survives unrelated line churn; ``symbol`` therefore has to
    name the violating construct stably (function qualname, metric
    name, config field) rather than a position.
    """

    rule: str
    file: str
    line: int
    symbol: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.file}:{self.symbol}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def dotted(node: ast.AST) -> Optional[str]:
    """Best-effort dotted name of an expression: ``self._q.put`` ->
    "self._q.put"; None for anything not a Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_glob(node: ast.AST) -> Optional[str]:
    """A JoinedStr (f-string) as a glob: f"requests_{k}_total" ->
    "requests_*_total" — the producer-pattern form the telemetry pass
    matches consumers against."""
    if not isinstance(node, ast.JoinedStr):
        return None
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def name_or_glob(node: ast.AST) -> Optional[str]:
    return literal_str(node) if literal_str(node) is not None \
        else fstring_glob(node)


@dataclasses.dataclass
class FunctionInfo:
    qualname: str            # "module-relative" e.g. Class.method or fn
    node: ast.AST            # FunctionDef / AsyncFunctionDef / Lambda
    cls: Optional[str]       # owning class name, if a method


class ModuleInfo:
    """One parsed module: AST + source lines + import table + classes."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # imported name -> fully qualified target ("pkg.mod" for module
        # imports, "pkg.mod:sym" for from-imports), including imports
        # nested inside functions (the repo lazy-imports heavily)
        self.imports: Dict[str, str] = {}
        self.toplevel_imports: Dict[str, str] = {}
        # class name -> {method name -> FunctionDef}
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        # class name -> {self-attr -> constructor name as written}
        self.attr_ctors: Dict[str, Dict[str, str]] = {}
        self.functions: Dict[str, ast.AST] = {}
        self._index()

    # ------------------------------------------------------------------ #
    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}:{a.name}"
        for node in self.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        self.toplevel_imports[
                            a.asname or a.name.split(".")[0]] = a.name
                elif node.module:
                    for a in node.names:
                        self.toplevel_imports[a.asname or a.name] = \
                            f"{node.module}:{a.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods: Dict[str, ast.AST] = {}
                ctors: Dict[str, str] = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        methods[sub.name] = sub
                        for st in ast.walk(sub):
                            if (isinstance(st, ast.Assign)
                                    and len(st.targets) == 1):
                                t = dotted(st.targets[0])
                                val = st.value
                                # x = C(...) if cond else None
                                if isinstance(val, ast.IfExp):
                                    val = (val.body
                                           if isinstance(val.body,
                                                         ast.Call)
                                           else val.orelse)
                                if (t and t.startswith("self.")
                                        and isinstance(val, ast.Call)):
                                    cn = call_name(val)
                                    if cn:
                                        ctors.setdefault(
                                            t[len("self."):], cn)
                self.classes[node.name] = methods
                self.attr_ctors[node.name] = ctors

    # ------------------------------------------------------------------ #
    def iter_functions(self) -> Iterator[FunctionInfo]:
        """Every def in the module (module-level, methods, nested),
        with a stable qualname."""
        stack: List[Tuple[ast.AST, str, Optional[str]]] = [
            (self.tree, "", None)]
        while stack:
            node, prefix, cls = stack.pop()
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    q = f"{prefix}{sub.name}"
                    yield FunctionInfo(q, sub, cls)
                    stack.append((sub, q + ".", cls))
                elif isinstance(sub, ast.ClassDef):
                    stack.append((sub, f"{prefix}{sub.name}.",
                                  sub.name))


class ModuleSet:
    """The analyzed corpus: repo-relative path -> :class:`ModuleInfo`,
    plus whatever non-Python text files the doc-facing passes need."""

    def __init__(self, modules: Dict[str, ModuleInfo],
                 texts: Optional[Dict[str, str]] = None,
                 root: Optional[str] = None):
        self.modules = modules
        self.texts = texts or {}
        self.root = root
        self.parse_errors: Dict[str, str] = {}
        # global class registry (name -> (path, methods)); ambiguous
        # names keep the first definition — good enough for call
        # resolution, and the repo keeps class names unique
        self.class_defs: Dict[str, Tuple[str, Dict[str, ast.AST]]] = {}
        for path, mi in modules.items():
            for cname, methods in mi.classes.items():
                self.class_defs.setdefault(cname, (path, methods))

    # ------------------------------------------------------------------ #
    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     texts: Optional[Dict[str, str]] = None
                     ) -> "ModuleSet":
        mods = {}
        errors = {}
        for path, src in sources.items():
            try:
                mods[path] = ModuleInfo(path, src)
            except SyntaxError as e:   # keep analyzing the rest
                errors[path] = repr(e)
        ms = cls(mods, texts=texts)
        ms.parse_errors = errors
        return ms

    @classmethod
    def from_repo(cls, root: str,
                  globs: Tuple[str, ...] = DEFAULT_GLOBS,
                  text_files: Tuple[str, ...] = (
                      "README.md", "docs/DESIGN.md"),
                  cache=None) -> "ModuleSet":
        sources: Dict[str, str] = {}
        for pat in globs:
            base = pat.split("*")[0].rstrip("/")
            start = os.path.join(root, base) if base else root
            if pat.endswith(".py") and "*" not in pat:
                p = os.path.join(root, pat)
                if os.path.exists(p):
                    sources[pat] = _read(p)
                continue
            if "/" not in pat:
                # a glob at the root (bench_torch*.py): its own
                # directory only, never a walk of the whole checkout
                for fn in sorted(os.listdir(root)):
                    if fnmatch.fnmatch(fn, pat) \
                            and os.path.isfile(os.path.join(root, fn)):
                        sources[fn] = _read(os.path.join(root, fn))
                continue
            for dirpath, dirnames, filenames in os.walk(start):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in filenames:
                    if not fn.endswith(".py"):
                        continue
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, root).replace(
                        os.sep, "/")
                    if fnmatch.fnmatch(rel, pat):
                        sources[rel] = _read(full)
        texts = {}
        for tf in text_files:
            p = os.path.join(root, tf)
            if os.path.exists(p):
                texts[tf] = _read(p)
        if cache is None:
            ms = cls.from_sources(sources, texts=texts)
        else:
            # incremental parse: content-sha hits
            # skip the parse+index entirely; misses are stored back
            mods: Dict[str, ModuleInfo] = {}
            errors: Dict[str, str] = {}
            for path, src in sources.items():
                mi = cache.get(path, src)
                if mi is None:
                    try:
                        mi = ModuleInfo(path, src)
                    except SyntaxError as e:
                        errors[path] = repr(e)
                        continue
                    cache.put(path, src, mi)
                mods[path] = mi
            ms = cls(mods, texts=texts)
            ms.parse_errors = errors
        ms.root = root
        return ms

    # ------------------------------------------------------------------ #
    def module_name(self, path: str) -> str:
        """"tuplewise_tpu_torch/serving/index.py" ->
        "tuplewise_tpu_torch.serving.index"."""
        p = path[:-3] if path.endswith(".py") else path
        p = p[:-len("/__init__")] if p.endswith("/__init__") else p
        return p.replace("/", ".")

    def path_of_module(self, mod: str) -> Optional[str]:
        cand = mod.replace(".", "/") + ".py"
        if cand in self.modules:
            return cand
        cand = mod.replace(".", "/") + "/__init__.py"
        if cand in self.modules:
            return cand
        return None

    def resolve_import(self, mi: ModuleInfo, name: str
                       ) -> Optional[Tuple[str, str]]:
        """Resolve a bare name used in ``mi`` through its import table
        to ``(module_path, symbol)`` inside this ModuleSet; None for
        stdlib / third-party / unresolved names."""
        tgt = mi.imports.get(name)
        if tgt is None:
            return None
        if ":" in tgt:
            mod, sym = tgt.split(":", 1)
        else:
            mod, sym = tgt, ""
        path = self.path_of_module(mod)
        if path is None:
            return None
        return path, sym

    def resolve_class(self, mi: ModuleInfo, ctor: str
                      ) -> Optional[str]:
        """Map a constructor name as written ("ExactAucIndex",
        "queue.Queue", "threading.Thread") to a repo class name when it
        is one, else None."""
        head = ctor.split(".")[0]
        if ctor in mi.classes:
            return ctor
        resolved = self.resolve_import(mi, head)
        if resolved is not None:
            _, sym = resolved
            name = sym or ctor.split(".")[-1]
            if name in self.class_defs:
                return name
        if ctor in self.class_defs:
            return ctor
        return None


def _read(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def glob_match(name: str, patterns) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in patterns)
