"""Pass 5 — config / CLI / doc drift.

``ServingConfig`` / ``TenancyConfig`` / ``ControllerConfig`` fields,
the ``harness.cli`` flags that set them, and the README/DESIGN prose
that teaches them must agree:

* ``config-field-unbound`` — a config field with neither a CLI flag
  (``--field-with-dashes``, or a declared alias like
  ``flush_timeout_s`` <-> ``--flush-timeout-ms``) nor a doc mention:
  a knob nobody can discover or set from the outside.
* ``doc-flag-unknown`` — a ``--flag`` mentioned in README/DESIGN that
  no argparse ``add_argument`` defines: the quickstart teaches a flag
  the CLI rejects.

Scope note: only the three serving-stack configs are checked — the
experiment configs (VarianceConfig etc.) generate their flags
mechanically from the dataclass and cannot drift.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted, literal_str,
)

_CHECKED_CONFIGS = ("ServingConfig", "TenancyConfig",
                    "ControllerConfig")

# field -> flag spelled differently than field.replace("_", "-")
_FLAG_ALIASES = {
    "flush_timeout_s": "flush-timeout-ms",
    "deadline_s": "deadline-ms",
    "weight": "tenant-weight",
    "flight_recorder_size": "flight-recorder-size",
}

_DOC_FLAG_RE = re.compile(r"--[a-z][a-z0-9-]+")
# flags documented but owned by other tools (XLA, pytest, pip, git)
_FOREIGN_FLAG_PREFIXES = ("--xla",)


def dataclass_fields(ms: ModuleSet) -> Dict[str, List[Tuple[str, int]]]:
    """{class name: [(field, line)]} for every dataclass in the
    corpus."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for path, mi in ms.modules.items():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            is_dc = False
            for deco in node.decorator_list:
                d = deco.func if isinstance(deco, ast.Call) else deco
                if dotted(d) in ("dataclasses.dataclass", "dataclass"):
                    is_dc = True
            if not is_dc:
                continue
            fields = []
            for sub in node.body:
                if isinstance(sub, ast.AnnAssign) \
                        and isinstance(sub.target, ast.Name):
                    fields.append((sub.target.id, sub.lineno))
            out.setdefault(node.name, fields)
    return out


def cli_flags(ms: ModuleSet) -> Set[str]:
    """Every literal ``--flag`` passed to an ``add_argument`` call in
    the corpus (harness CLI and the scripts' own parsers). When any
    parser generates flags mechanically from a dataclass
    (``add_argument`` with a computed first argument, the
    ``_add_variance_args`` pattern), every dataclass field's dashed
    form is admitted too — mechanical generation cannot drift."""
    flags: Set[str] = set()
    all_fields = dataclass_fields(ms)
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            dynamic = False
            generated: Set[str] = set()
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node)
                if cn and cn.endswith("add_argument"):
                    literal_seen = False
                    for a in node.args:
                        s = literal_str(a)
                        if s and s.startswith("--"):
                            flags.add(s.lstrip("-"))
                            literal_seen = True
                    if node.args and not literal_seen:
                        dynamic = True
                elif cn in ("dataclasses.fields", "fields") \
                        and node.args \
                        and isinstance(node.args[0], ast.Name):
                    generated.add(node.args[0].id)
            if dynamic:
                # flags generated mechanically from the dataclass the
                # same function iterates — those cannot drift
                for cname in generated:
                    for f, _ in all_fields.get(cname, ()):
                        flags.add(f.replace("_", "-"))
    return flags


def _config_paths(ms: ModuleSet) -> Dict[str, Tuple[str, int]]:
    locs: Dict[str, Tuple[str, int]] = {}
    for path, mi in ms.modules.items():
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.ClassDef) \
                    and node.name in _CHECKED_CONFIGS:
                locs.setdefault(node.name, (path, node.lineno))
    return locs


def run(ms: ModuleSet) -> List[Finding]:
    fields = dataclass_fields(ms)
    flags = cli_flags(ms)
    locs = _config_paths(ms)
    doc_text = "\n".join(ms.texts.values())
    findings: List[Finding] = []

    for cname in _CHECKED_CONFIGS:
        if cname not in fields or cname not in locs:
            continue
        path, _ = locs[cname]
        for field, line in fields[cname]:
            flag = _FLAG_ALIASES.get(field, field.replace("_", "-"))
            if flag in flags:
                continue
            # doc mention: the bare field name as a word (backticked
            # or prose) OR its dashed flag form in README/DESIGN — a
            # doc teaching `--flush-timeout-ms` documents the field
            # even before the parser defines it
            if re.search(rf"\b{re.escape(field)}\b", doc_text) \
                    or f"--{flag}" in doc_text:
                continue
            findings.append(Finding(
                "config-field-unbound", path, line,
                f"{cname}.{field}",
                f"{cname}.{field} has no CLI flag (--{flag}) and no "
                "README/DESIGN mention — an undiscoverable knob"))

    for doc_path, text in ms.texts.items():
        seen: Set[str] = set()
        for m in _DOC_FLAG_RE.finditer(text):
            tok = m.group(0)
            if tok in seen:
                continue
            seen.add(tok)
            if any(tok.startswith(p) for p in _FOREIGN_FLAG_PREFIXES) \
                    and tok.lstrip("-") not in flags:
                continue
            if tok.lstrip("-") not in flags:
                findings.append(Finding(
                    "doc-flag-unknown", doc_path, 0, tok,
                    f"{doc_path} mentions {tok} but no argparse "
                    "definition exists — the doc teaches a flag the "
                    "CLI rejects"))
    return findings
