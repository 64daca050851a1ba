"""Capture and tree hygiene over ``src/repro_torch/`` (the counterpart of
``repro/analysis/lint.py``).

* CHK-SYNC (error), the counterpart of CHK-TRACER: a host sync inside a
  round function.  ``core.loop`` captures the solvers' rounds into CUDA
  graphs (``RoundGraphs``), and a graph cannot hold a read of a device
  value on the host: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``bool()`` / ``float()`` / ``int()`` of a tensor, or an
  ``if`` / ``while`` / conditional expression on one.  On the CPU such a
  read runs silently; on the card it breaks the capture.  Checked in
  every function nested in a ``make_*round_fn`` factory (``core/dcd.py``,
  ``bdcd.py``, ``sstep_dcd.py``, ``sstep_bdcd.py``) and every function
  named ``round_fn``.  The reference's static tests are allowed: ``is``
  / ``is not``, comparisons whose subject is static metadata
  (``.shape``, ``.ndim``, ``.dtype``, ``.size``, ``.name``), ``len()``,
  ``isinstance()``, ``hasattr()`` and constants.
* CHK-TREE (error), the counterpart of CHK-PYTREE: a dataclass with
  tensor-annotated fields.  ``repro_torch.tree`` walks dicts, lists and
  tuples only, so such a dataclass is one opaque leaf wherever a tree
  carries it: its tensors escape ``map_tree`` (device moves, copies) and
  the guard's ``finite_health``.  Suppress where the record is meant to
  stay whole (a host-side result, a spec).

CHK-STATIC has no counterpart: it guards ``jax.jit``'s cache against
callables passed as static arguments, and the port compiles nothing in
Python (ROADMAP C39).
"""
from __future__ import annotations

import ast
import dataclasses as _dc
import importlib
import inspect
import os
import pkgutil
from typing import List

from .findings import ERROR, Finding

SRC_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "name"}
_HOST_COERCIONS = {"bool", "float", "int"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}


# --------------------------------------------------------- CHK-SYNC -----

def _is_static_expr(node: ast.expr) -> bool:
    """Conservatively: is this expression a host value even when the
    closure's variables are tensors on the card?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)          # x.shape[0]
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return True
        return _is_static_expr(node.left)
    if isinstance(node, ast.BoolOp):
        return all(_is_static_expr(v) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _is_static_expr(node.operand)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("len", "isinstance", "hasattr")
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    return False


def _round_fn_nodes(tree: ast.AST):
    """Every function that is a round function or lives inside a round
    function factory: the bodies ``core.loop`` captures."""
    factories = [n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("make_") and "round_fn" in n.name]
    seen = set()
    for fac in factories:
        for n in ast.walk(fac):
            if isinstance(n, ast.FunctionDef) and n is not fac:
                seen.add(id(n))
                yield n
    for n in ast.walk(tree):
        if isinstance(n, ast.FunctionDef) and n.name == "round_fn" \
                and id(n) not in seen:
            yield n


def _check_sync(path: str, tree: ast.AST) -> List[Finding]:
    out = []
    for fn in _round_fn_nodes(tree):
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if _is_static_expr(node.test):
                    continue
                what = type(node).__name__.lower()
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id in _HOST_COERCIONS and node.args):
                if _is_static_expr(node.args[0]):
                    continue
                what = f"{node.func.id}()"
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _HOST_READS):
                what = f".{node.func.attr}()"
            else:
                continue
            out.append(Finding(
                "CHK-SYNC", ERROR, path, node.lineno,
                f"host-side {what} on a possible device value inside round "
                f"function '{fn.name}' — core.loop captures rounds into "
                f"CUDA graphs, which cannot read the card on the host; use "
                f"torch.where or move the read out of the round"))
    return out


# --------------------------------------------------------- CHK-TREE -----

def _tensor_fields(cls) -> List[str]:
    names = []
    for f in _dc.fields(cls):
        ann = f.type if isinstance(f.type, str) else getattr(
            f.type, "__name__", str(f.type))
        if "Tensor" in ann:
            names.append(f.name)
    return names


def iter_port_dataclasses():
    """Every dataclass defined in a ``repro_torch`` module (each submodule
    imported; they are all import-safe)."""
    import repro_torch
    for info in pkgutil.walk_packages(repro_torch.__path__,
                                      "repro_torch."):
        if info.name.endswith("__main__"):
            continue
        try:
            mod = importlib.import_module(info.name)
        except Exception:
            continue
        for obj in vars(mod).values():
            if (inspect.isclass(obj) and obj.__module__ == info.name
                    and _dc.is_dataclass(obj)
                    and not issubclass(obj, tuple)):
                yield mod, obj


def _check_tree(classes=None) -> List[Finding]:
    """CHK-TREE over ``(module, class)`` pairs, by default every
    dataclass of the port."""
    out, seen = [], set()
    for mod, cls in (iter_port_dataclasses() if classes is None
                     else classes):
        if cls in seen:
            continue
        seen.add(cls)
        tensors = _tensor_fields(cls)
        if not tensors:
            continue
        try:
            path = inspect.getsourcefile(cls)
            line = inspect.getsourcelines(cls)[1]
        except (OSError, TypeError):
            path, line = getattr(mod, "__file__", "<unknown>"), 1
        out.append(Finding(
            "CHK-TREE", ERROR, os.path.abspath(path), line,
            f"dataclass {cls.__name__} carries tensor fields {tensors}, "
            f"which repro_torch.tree does not walk — they escape map_tree "
            f"and finite_health wherever a tree carries it (make it a "
            f"dict, or suppress if it is meant to stay whole)"))
    return out


# ------------------------------------------------------------- entry -----

def run(root: str = SRC_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.abspath(os.path.join(dirpath, fname))
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            findings.extend(_check_sync(path, tree))
    findings.extend(_check_tree())
    return findings
