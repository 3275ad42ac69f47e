"""Lock-discipline (LD00x) and lock-order (LO001) static analyses.

Guard-declaration convention (plain class attributes, readable by
``ast.literal_eval`` — no imports, no runtime cost):

``_GUARDED_BY = {"_lock": ("_map", "hits", ...)}``
    lock attribute -> fields every method must only touch while
    holding that lock.  Declaring *any* ``_GUARDED_BY`` opts the class
    into LD001/LD002 and into the lock-order graph.
``_LOCK_ALIASES = {"_cv": "_lock"}``
    attribute that *wraps* a lock (a ``Condition`` built over it):
    ``with self._cv`` counts as holding ``_lock``.
``_LOCK_HELD = ("_dequeue", ...)``
    methods only ever called with the lock already held; their bodies
    are analysed as locked regions.  A ``*_locked`` name suffix means
    the same thing without the declaration.
``_CALLBACKS = ("on_evict",)``
    attributes holding *user* callbacks; invoking one inside a locked
    region is LD002 (the inline-callback deadlock shape).

Rules:

* **LD001** — a declared guarded field is read/written in a method
  body outside any ``with self.<lock>`` region (and the method is not
  lock-held by convention).  ``__init__`` is exempt: no concurrent
  observer exists before ``__init__`` returns.
* **LD002** — a blocking call while a lock is held: ``time.sleep``,
  ``.wait(...)`` on anything that is not an alias of a lock already
  held, ``Future.result()``, ``Thread.join()`` (string receivers are
  exempt — ``", ".join``), ``Executor.shutdown()``,
  ``add_done_callback`` (may run the callback inline), invoking a
  declared ``_CALLBACKS`` attribute, and ``yield`` (a generator/
  contextmanager parks arbitrary caller code under the lock).
* **LD003** — a class assigns ``self.x = threading.Lock/RLock/
  Condition(...)`` but declares no ``_GUARDED_BY``: undeclared locks
  escape every other rule, so coverage itself is enforced.
* **LO001** — cycles in the static acquisition graph.  Inside each
  class's locked regions, calls ``recv.m(...)`` are resolved by *name*
  to every declared class whose method ``m`` acquires its own lock;
  each resolution adds an edge ``C -> D``.  ``x in y`` resolves to
  ``__contains__`` unless ``y`` is a plain ``self.<attr>`` (dict/set
  fields would drown the graph in noise).  Self-edges are dropped
  (RLock reentrancy; same-name false positives).  A strongly-connected
  component with >1 class is a potential deadlock and one finding.

The name-based call resolution is deliberately over-approximate: a
false edge is cheap (baseline it), a missed real cycle is not.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding, normalize_path

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
_BLOCKING_ATTRS = {"result", "join", "shutdown", "add_done_callback"}


class GuardSpec:
    """Parsed guard declarations for one class."""

    def __init__(self, cls: ast.ClassDef):
        self.name = cls.name
        self.guarded_by: Dict[str, Tuple[str, ...]] = {}
        self.aliases: Dict[str, str] = {}
        self.lock_held: Tuple[str, ...] = ()
        self.callbacks: Tuple[str, ...] = ()
        for stmt in cls.body:
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            tgt = stmt.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            try:
                val = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                continue
            if tgt.id == "_GUARDED_BY":
                self.guarded_by = {k: tuple(v) for k, v in dict(val).items()}
            elif tgt.id == "_LOCK_ALIASES":
                self.aliases = dict(val)
            elif tgt.id == "_LOCK_HELD":
                self.lock_held = tuple(val)
            elif tgt.id == "_CALLBACKS":
                self.callbacks = tuple(val)

    @property
    def declared(self) -> bool:
        return bool(self.guarded_by)

    @property
    def lock_names(self) -> Set[str]:
        return set(self.guarded_by) | set(self.aliases)

    def canonical(self, attr: str) -> Optional[str]:
        """Canonical lock name for an acquired attribute, or None."""
        if attr in self.guarded_by:
            return attr
        return self.aliases.get(attr)

    def field_lock(self, field: str) -> Optional[str]:
        for lock, fields in self.guarded_by.items():
            if field in fields:
                return lock
        return None

    def is_lock_held_method(self, name: str) -> bool:
        return name in self.lock_held or name.endswith("_locked")


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _acquired_lock(item: ast.withitem, spec: GuardSpec) -> Optional[str]:
    """Canonical lock name a ``with`` item acquires, or None."""
    expr = item.context_expr
    attr = _self_attr(expr)
    if attr is None and isinstance(expr, ast.Call):
        # with self._lock.acquire_timeout(...) style — not used here,
        # but resolve plain with self._lock() defensively
        attr = _self_attr(expr.func)
    return spec.canonical(attr) if attr else None


class _MethodChecker(ast.NodeVisitor):
    """LD001/LD002 over one method body, tracking the held-lock set.

    Lambdas inherit the held set (sort keys and the like run inline);
    nested ``def``s are skipped entirely — they may escape the region
    and analysing them either way guesses wrong.
    """

    def __init__(self, spec: GuardSpec, method: str, path: str,
                 findings: List[Finding], all_held: bool):
        self.spec = spec
        self.method = method
        self.path = path
        self.findings = findings
        self.held: Set[str] = set(spec.guarded_by) if all_held else set()
        self._depth = 0  # >0 once inside the method body proper

    # -- helpers -----------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, detail: str, message: str):
        self.findings.append(Finding(
            rule=rule, path=self.path, line=node.lineno,
            qualname=f"{self.spec.name}.{self.method}",
            detail=detail, message=message))

    # -- region tracking --------------------------------------------
    def visit_With(self, node: ast.With):
        acquired = []
        for item in node.items:
            lock = _acquired_lock(item, self.spec)
            if lock is not None and lock not in self.held:
                acquired.append(lock)
            # the context expression itself evaluates outside the region
            self.visit(item.context_expr)
        self.held.update(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(acquired)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if self._depth == 0:
            self._depth += 1
            for stmt in node.body:
                self.visit(stmt)
            self._depth -= 1
        # nested defs: skipped (see class docstring)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        self.visit(node.body)  # inherits held set

    # -- LD001: guarded field access --------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr is not None:
            lock = self.spec.field_lock(attr)
            if lock is not None and lock not in self.held:
                self._emit(
                    "LD001", node, attr,
                    f"field self.{attr} is guarded by self.{lock} "
                    f"(declared in _GUARDED_BY) but accessed without it")
        self.generic_visit(node)

    # -- LD002: blocking while holding ------------------------------
    def visit_Call(self, node: ast.Call):
        if self.held:
            self._check_blocking(node)
        self.generic_visit(node)

    def visit_Yield(self, node: ast.Yield):
        if self.held:
            self._emit(
                "LD002", node, "yield",
                f"yield while holding {sorted(self.held)}: the caller "
                "runs arbitrary code inside the locked region")
        self.generic_visit(node)

    visit_YieldFrom = visit_Yield

    def _check_blocking(self, node: ast.Call):
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        recv, meth = func.value, func.attr
        recv_attr = _self_attr(func)
        # user callback invoked under the lock (inline-callback deadlock)
        if recv_attr in self.spec.callbacks:
            self._emit(
                "LD002", node, recv_attr,
                f"user callback self.{recv_attr}() invoked while holding "
                f"{sorted(self.held)} — callback code can re-enter and "
                "deadlock (the inline-callback shape)")
            return
        if meth == "sleep" and isinstance(recv, ast.Name) \
                and recv.id == "time":
            self._emit("LD002", node, "time.sleep",
                       f"time.sleep while holding {sorted(self.held)}")
            return
        if meth in ("wait", "wait_for"):
            # waiting on an alias of a lock we hold releases it (a
            # Condition over that lock) — that is the one safe shape
            if isinstance(recv, ast.Attribute):
                wait_attr = _self_attr(recv)
                if wait_attr and self.spec.canonical(wait_attr) in self.held:
                    return
            self._emit(
                "LD002", node, f"{meth}",
                f".{meth}() on a foreign object while holding "
                f"{sorted(self.held)} — blocks with the lock held")
            return
        if meth in _BLOCKING_ATTRS:
            if meth == "join" and isinstance(recv, ast.Constant) \
                    and isinstance(recv.value, str):
                return  # ", ".join(...)
            why = ("may run the callback inline under the lock"
                   if meth == "add_done_callback"
                   else "blocks (or runs arbitrary code) with the lock held")
            self._emit(
                "LD002", node, meth,
                f".{meth}() while holding {sorted(self.held)} — {why}")


def _iter_classes(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            yield node


def _methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def check_lock_discipline(tree: ast.Module, relpath: str) -> List[Finding]:
    """LD001/LD002/LD003 over one parsed module."""
    findings: List[Finding] = []
    for cls in _iter_classes(tree):
        spec = GuardSpec(cls)
        if not spec.declared:
            _check_undeclared_lock(cls, relpath, findings)
            continue
        for meth in _methods(cls):
            if meth.name == "__init__":
                continue
            checker = _MethodChecker(
                spec, meth.name, relpath, findings,
                all_held=spec.is_lock_held_method(meth.name))
            checker.visit(meth)
    return findings


def _check_undeclared_lock(cls: ast.ClassDef, relpath: str,
                           findings: List[Finding]):
    """LD003: ``self.x = threading.Lock()`` without ``_GUARDED_BY``."""
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        func = node.value.func
        is_factory = (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "threading"
            and func.attr in _LOCK_FACTORIES
        ) or (isinstance(func, ast.Name) and func.id in _LOCK_FACTORIES)
        if not is_factory:
            continue
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is not None:
                findings.append(Finding(
                    rule="LD003", path=relpath, line=node.lineno,
                    qualname=cls.name, detail=attr,
                    message=f"self.{attr} is a threading lock but "
                            f"{cls.name} declares no _GUARDED_BY — "
                            "undeclared locks escape LD001/LD002/LO001"))


# ---------------------------------------------------------------------------
# LO001: static lock-order graph
# ---------------------------------------------------------------------------

class _ClassInfo:
    def __init__(self, spec: GuardSpec, relpath: str,
                 method_names: Set[str]):
        self.spec = spec
        self.relpath = relpath
        self.method_names = method_names
        # method name -> True if the method acquires this class's lock
        self.acquiring: Set[str] = set()
        # call sites inside locked regions: (callee name, line)
        self.locked_calls: List[Tuple[str, int]] = []


class _RegionCallCollector(ast.NodeVisitor):
    """Collect (callee-name, line) for calls made inside locked
    regions of one method, plus whether the method acquires at all."""

    def __init__(self, info: _ClassInfo, all_held: bool):
        self.info = info
        self.spec = info.spec
        self.held = bool(all_held)
        self.acquires = False
        self._depth = 0

    def visit_With(self, node: ast.With):
        acquired = any(
            _acquired_lock(item, self.spec) is not None
            for item in node.items)
        if acquired:
            self.acquires = True
        prev = self.held
        self.held = self.held or acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if self._depth == 0:
            self._depth += 1
            for stmt in node.body:
                self.visit(stmt)
            self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        self.visit(node.body)

    def visit_Call(self, node: ast.Call):
        if self.held and isinstance(node.func, ast.Attribute):
            recv_attr = _self_attr(node.func)
            # plain self.m() where m is a method of this class stays
            # in-class (reentrant RLock) — but self.cb() where cb is a
            # *callback attribute* escapes to whatever was wired in,
            # so it participates in the graph under the callee's name
            if recv_attr is None or recv_attr not in self.info.method_names:
                self.info.locked_calls.append(
                    (node.func.attr, node.lineno))
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        if self.held:
            for op, comparator in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)) \
                        and _self_attr(comparator) is None:
                    # `x in something-not-self-attr` -> __contains__
                    self.info.locked_calls.append(
                        ("__contains__", node.lineno))
        self.generic_visit(node)


def build_lock_graph(modules: Sequence[Tuple[ast.Module, str]]):
    """(classes, edges): edges is ``{(C, D): (relpath, line, callee)}``
    keyed on first-seen site."""
    classes: Dict[str, _ClassInfo] = {}
    for tree, relpath in modules:
        for cls in _iter_classes(tree):
            spec = GuardSpec(cls)
            if not spec.declared:
                continue
            info = _ClassInfo(spec, relpath,
                              {m.name for m in _methods(cls)})
            for meth in _methods(cls):
                if meth.name == "__init__":
                    continue
                col = _RegionCallCollector(
                    info, all_held=spec.is_lock_held_method(meth.name))
                col.visit(meth)
                if col.acquires or spec.is_lock_held_method(meth.name):
                    info.acquiring.add(meth.name)
            # a declared callback attribute is a lock-acquiring call
            # target for *whoever the runtime wires in*; the witness
            # covers that dynamically, the static graph covers the
            # one wiring the repo itself ships (directory.on_evict)
            classes[spec.name] = info

    # method name -> classes whose method of that name acquires
    acquiring_by_name: Dict[str, Set[str]] = {}
    for cname, info in classes.items():
        for m in info.acquiring:
            acquiring_by_name.setdefault(m, set()).add(cname)

    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for cname, info in classes.items():
        for callee, line in info.locked_calls:
            for target in acquiring_by_name.get(callee, ()):
                if target != cname and (cname, target) not in edges:
                    edges[(cname, target)] = (info.relpath, line, callee)
    return classes, edges


def _sccs(nodes: Set[str], edges) -> List[List[str]]:
    """Tarjan, iterative-enough for our graph sizes (recursive is fine
    for tens of classes)."""
    adj: Dict[str, List[str]] = {n: [] for n in nodes}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, adj.get(b, []))
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v: str):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for n in sorted(adj):
        if n not in index:
            strong(n)
    return out


def check_lock_order(modules: Sequence[Tuple[ast.Module, str]]
                     ) -> List[Finding]:
    """LO001 over the whole scanned module set."""
    classes, edges = build_lock_graph(modules)
    findings: List[Finding] = []
    for comp in _sccs(set(classes), edges):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        cyc_edges = sorted(
            (a, b, edges[(a, b)]) for (a, b) in edges
            if a in comp_set and b in comp_set)
        first = cyc_edges[0][2]
        detail = "cycle:" + "<->".join(sorted(comp))
        lines = "; ".join(
            f"{a}->{b} via .{site[2]}() at {site[0]}:{site[1]}"
            for a, b, site in cyc_edges)
        findings.append(Finding(
            rule="LO001", path=first[0], line=first[1],
            qualname="<lock-graph>", detail=detail,
            message=f"lock-order cycle {' <-> '.join(sorted(comp))}: "
                    f"{lines}"))
    return findings


def analyze_source(text: str, relpath: str) -> List[Finding]:
    """LD001/LD002/LD003 + single-module LO001 over source text —
    the fixture-test entry point."""
    tree = ast.parse(text)
    rel = normalize_path(relpath)
    findings = check_lock_discipline(tree, rel)
    findings.extend(check_lock_order([(tree, rel)]))
    return findings
