"""The span pairing auditor for ``repro_torch.obs`` (the counterpart of
``repro/analysis/obs_check.py``).

``obs.spans.span_begin`` / ``span_end`` record marks that
``Telemetry`` pairs by name afterwards (``paired_marks``): a begin with
no end is dropped there, and its span vanishes from every trace and
audit without an error.  The invariant is kept at the source: every
``span_begin(name)`` is paired with a ``span_end(name)`` in the same
enclosing function (the round protocol's marks are always taken within
one function: ``core/loop.py``, ``obs/__init__.py``), and a span's
name is a string literal or one variable, the same in its begin and its
end (``core.loop``'s span wrappers take the name as a parameter); any
other expression cannot be paired statically.

* CHK-SPAN (error) — a ``span_begin`` without a same-function
  ``span_end`` of the same name (a literal, or the same variable), or
  vice versa, or a begin / end call whose name is another expression.
  Anchors to the offending call.

Purely syntactic (AST over ``src/repro_torch``): the begin / end calls
are module-level functions, so counting call sites is exact.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from .findings import ERROR, Finding

SRC_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BEGIN = "span_begin"
_END = "span_end"


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _span_calls(fn: ast.AST) -> List[Tuple[str, ast.Call]]:
    """Every span_begin/span_end call lexically inside ``fn`` but NOT
    inside a nested function (the nested def is its own pairing
    scope)."""
    out: List[Tuple[str, ast.Call]] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                kind = _call_name(child)
                if kind in (_BEGIN, _END):
                    out.append((kind, child))
            walk(child)

    walk(fn)
    return out


def _check_function(path: str, fn) -> List[Finding]:
    calls = _span_calls(fn)
    if not calls:
        return []
    findings: List[Finding] = []
    opens: Dict[str, int] = {}
    closes: Dict[str, int] = {}
    anchor: Dict[str, int] = {}
    for kind, call in calls:
        name_arg = call.args[0] if call.args else None
        if isinstance(name_arg, ast.Constant) \
                and isinstance(name_arg.value, str):
            name = name_arg.value
        elif isinstance(name_arg, ast.Name):
            name = f"<variable {name_arg.id}>"
        else:
            findings.append(Finding(
                check="CHK-SPAN", severity=ERROR, path=path,
                line=call.lineno,
                message=f"{kind} name must be a string literal or one "
                        f"variable (another expression cannot be paired "
                        f"statically)"))
            continue
        anchor.setdefault(name, call.lineno)
        tally = opens if kind == _BEGIN else closes
        tally[name] = tally.get(name, 0) + 1
    for name in sorted(set(opens) | set(closes)):
        nb, ne = opens.get(name, 0), closes.get(name, 0)
        if nb != ne:
            findings.append(Finding(
                check="CHK-SPAN", severity=ERROR, path=path,
                line=anchor[name],
                message=f"traced span {name!r} has {nb} span_begin vs "
                        f"{ne} span_end call sites in "
                        f"{getattr(fn, 'name', '<module>')!r} — an "
                        f"unmatched begin is silently dropped by "
                        f"paired_marks()"))
    return findings


def run(root: str = SRC_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.abspath(os.path.join(dirpath, fname))
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    findings.extend(_check_function(path, node))
    return findings
