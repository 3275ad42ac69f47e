"""Assertion-strength lint (AS001/AS002).

A heap ``check_invariants`` that compares the free-list walk against
itself is green forever and checks nothing.  These rules
target that class of tautology inside the functions whose *job* is
checking: ``check_invariants``, ``audit``, ``validate_*``.

* **AS001** — a comparison whose two sides are structurally identical
  ASTs (``x == x``, ``len(a.b) <= len(a.b)``).  Always true (NaN
  aside), so the check it anchors is vacuous.
* **AS002** — counting an iterable against its own length:
  ``sum(1 for _ in X)`` compared with ``len(X)`` for the same ``X``.
  Both sides enumerate the same container, so corruption shows up in
  both and cancels — the self-checking heap shape exactly.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .findings import Finding, normalize_path

_CHECK_NAMES = ("check_invariants", "audit")
_CHECK_PREFIXES = ("validate_",)


def _is_check_function(name: str) -> bool:
    return name in _CHECK_NAMES or name.startswith(_CHECK_PREFIXES)


def _snippet(node: ast.AST) -> str:
    try:
        s = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is py3.9+ stdlib
        s = "<expr>"
    return s if len(s) <= 48 else s[:45] + "..."


def _count_target(node: ast.AST) -> Optional[ast.AST]:
    """If ``node`` is ``sum(1 for _ in X)``, return X."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "sum" and len(node.args) == 1):
        return None
    gen = node.args[0]
    if not isinstance(gen, ast.GeneratorExp):
        return None
    if not (isinstance(gen.elt, ast.Constant) and gen.elt.value == 1):
        return None
    if len(gen.generators) != 1:
        return None
    return gen.generators[0].iter


def _len_target(node: ast.AST) -> Optional[ast.AST]:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "len" and len(node.args) == 1):
        return node.args[0]
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, qualprefix: str, funcname: str):
        self.relpath = relpath
        self.qualname = f"{qualprefix}{funcname}" if qualprefix \
            else funcname
        self.findings: List[Finding] = []

    def visit_Compare(self, node: ast.Compare):
        sides = [node.left] + list(node.comparators)
        for left, right in zip(sides, sides[1:]):
            if ast.dump(left) == ast.dump(right):
                self.findings.append(Finding(
                    rule="AS001", path=self.relpath, line=node.lineno,
                    qualname=self.qualname,
                    detail=f"self-compare:{_snippet(left)}",
                    message=f"both comparison sides are the same "
                            f"expression ({_snippet(left)}) — the check "
                            "is vacuously true"))
                continue
            for a, b in ((left, right), (right, left)):
                counted = _count_target(a)
                measured = _len_target(b)
                if counted is not None and measured is not None and \
                        ast.dump(counted) == ast.dump(measured):
                    self.findings.append(Finding(
                        rule="AS002", path=self.relpath, line=node.lineno,
                        qualname=self.qualname,
                        detail=f"count-vs-len:{_snippet(counted)}",
                        message=f"sum(1 for _ in {_snippet(counted)}) vs "
                                f"len(...) over the same iterable — both "
                                "walk the same container, corruption "
                                "cancels (the heap-tautology shape)"))
                    break
        self.generic_visit(node)


def check_assertions(tree: ast.Module, relpath: str) -> List[Finding]:
    findings: List[Finding] = []

    def scan(body, qualprefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                scan(node.body, f"{qualprefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_check_function(node.name):
                    v = _Visitor(relpath, qualprefix, node.name)
                    v.visit(node)
                    findings.extend(v.findings)
                scan(node.body, f"{qualprefix}{node.name}.")

    scan(tree.body, "")
    return findings


def analyze_source(text: str, relpath: str) -> List[Finding]:
    return check_assertions(ast.parse(text), normalize_path(relpath))
