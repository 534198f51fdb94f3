"""GS: guarded-state lock discipline.

A class opts in by annotating field assignments in ``__init__`` with a
``# guarded by: <lock-attr>`` comment::

    self._queue = []      # guarded by: _lock
    self._stats = {...}   # guarded by: _lock

From then on, every read or write of ``self._queue`` anywhere in the
class must sit lexically inside ``with self._lock:`` (or a recognized
alias — see below), with three deliberate escape hatches:

  * ``__init__`` itself (construction happens before publication);
  * methods whose name ends in ``_locked`` — the project's standing
    convention for "caller holds the lock" (the checker still verifies
    their *callers* at the call site's own accesses; the runtime
    sanitizer's :func:`~llm_consensus_tpu_torch.analysis.sanitizer.assert_held`
    covers the dynamic half);
  * a line carrying ``# lint-ok: GS01 <reason>`` for accesses whose
    safety argument is local and deliberate.

Alias resolution: ``self._work = threading.Condition(self._lock)`` (or
the sanitizer factory form ``make_condition(name, self._lock)``) makes
holding ``_work`` equivalent to holding ``_lock`` — both names resolve
to one canonical rank, so ``with self._work:`` guards ``_lock``-guarded
fields. A bare ``Condition()`` is its own lock.

Findings:
  GS01 — guarded field read/written outside its lock
  GS02 — ``guarded by:`` names an attribute never assigned a lock
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from llm_consensus_tpu_torch.analysis.core import Finding, Project, checker

_GUARD_RE = re.compile(r"#\s*guarded by:\s*(\w+)")

_LOCK_FACTORIES = ("Lock", "RLock", "Condition")
_SAN_FACTORIES = ("make_lock", "make_rlock", "make_condition")


def _call_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _ClassInfo:
    def __init__(self):
        self.guarded: dict = {}  # field -> (canonical lock, decl lineno)
        self.locks: dict = {}  # lock attr -> canonical lock attr
        self.decl_order: list = []

    def canonical(self, name: str) -> str:
        seen = set()
        while name in self.locks and self.locks[name] != name:
            if name in seen:
                break
            seen.add(name)
            name = self.locks[name]
        return name


def _scan_init(pf, cls: ast.ClassDef) -> Optional[_ClassInfo]:
    init = next(
        (
            n
            for n in cls.body
            if isinstance(n, ast.FunctionDef) and n.name == "__init__"
        ),
        None,
    )
    if init is None:
        return None
    info = _ClassInfo()
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = _self_attr(node.targets[0])
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target = _self_attr(node.target)
        else:
            continue
        if target is None:
            continue
        # Lock/condition construction → lock attr (+ alias when the
        # condition wraps another self lock).
        if isinstance(node.value, ast.Call):
            cname = _call_name(node.value)
            if cname in _LOCK_FACTORIES + _SAN_FACTORIES:
                info.locks.setdefault(target, target)
                if cname in ("Condition", "make_condition"):
                    for arg in node.value.args:
                        wrapped = _self_attr(arg)
                        if wrapped is not None:
                            info.locks[target] = wrapped
                            info.locks.setdefault(wrapped, wrapped)
        m = _GUARD_RE.search(pf.line_at(node.lineno))
        if m:
            info.guarded[target] = (m.group(1), node.lineno)
            info.decl_order.append(target)
    return info if info.guarded else None


class _MethodVisitor(ast.NodeVisitor):
    """Walk one method tracking the lexically-held canonical lock set."""

    def __init__(self, pf, relpath, cls_name, method, info, findings):
        self.pf = pf
        self.relpath = relpath
        self.cls_name = cls_name
        self.method = method
        self.info = info
        self.findings = findings
        self.held: list = []

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.info.locks:
                acquired.append(self.info.canonical(attr))
        self.held.extend(acquired)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr in self.info.guarded:
            lock, _decl = self.info.guarded[attr]
            need = self.info.canonical(lock)
            if need not in self.held and not self.pf.suppressed(
                "GS01", node.lineno
            ):
                self.findings.append(
                    Finding(
                        code="GS01",
                        path=self.relpath,
                        line=node.lineno,
                        message=(
                            f"{self.cls_name}.{attr} is guarded by "
                            f"self.{lock} but accessed off-lock in "
                            f"{self.method}()"
                        ),
                        detail=f"{self.cls_name}.{self.method} :: {attr}",
                    )
                )
        self.generic_visit(node)


@checker(
    "guarded-state",
    ("GS01", "GS02"),
    "fields annotated '# guarded by: <lock>' only touched under the lock",
)
def check(project: Project) -> list:
    findings: list = []
    for pf in project.package_files():
        tree = pf.tree
        if tree is None:
            continue
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            info = _scan_init(pf, cls)
            if info is None:
                continue
            for fname in info.decl_order:
                lock, lineno = info.guarded[fname]
                if info.canonical(lock) not in info.locks:
                    findings.append(
                        Finding(
                            code="GS02",
                            path=pf.relpath,
                            line=lineno,
                            message=(
                                f"{cls.name}.{fname}: 'guarded by: {lock}' "
                                f"names an attribute never assigned a lock "
                                f"in __init__"
                            ),
                            detail=f"{cls.name} :: {fname} :: {lock}",
                        )
                    )
            for node in cls.body:
                if not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if node.name == "__init__" or node.name.endswith("_locked"):
                    continue
                _MethodVisitor(
                    pf, pf.relpath, cls.name, node.name, info, findings
                ).visit(node)
    return findings
