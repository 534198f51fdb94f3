"""SA: raw synchronization-primitive construction is forbidden.

The sanitizer factories (``analysis/sanitizer.py`` ``make_lock`` /
``make_rlock`` / ``make_condition`` / ``make_event``) are the seam that
gives every lock a ROLE name in the order graph, hands the runtime
sanitizer its instrumentation, and — inside a schedule-exploration
session (``analysis/schedule.py``) — swaps in cooperative primitives so
the model checker sees the whole process. A raw
``threading.Lock()`` / ``RLock()`` / ``Condition()`` / ``Event()``
anywhere else is a lock the deadlock detector cannot rank, the race
detector cannot order, and the scheduler cannot preempt: coverage that
silently regressed. Every construction in the package goes through a
factory; this checker keeps it so.

Findings:
  SA01 — raw ``threading.{Lock,RLock,Condition,Event}(...)`` constructed
         outside ``analysis/`` and the explicit allowlist

The allowlist is deliberately tiny and lives here, not in the baseline:
an entry means "this module IS the instrumentation substrate", not
"this violation is grandfathered". ``threading.local`` /
``Semaphore`` / ``Thread`` are not restricted — they carry no lock rank
(the scheduler intercepts ``Thread.start`` dynamically instead).
"""

from __future__ import annotations

import ast

from llm_consensus_tpu_torch.analysis.core import Finding, Project, checker

_PRIMITIVES = ("Lock", "RLock", "Condition", "Event")

# Paths (exact file or trailing-slash directory prefix) allowed to
# construct raw primitives: the instrumentation substrate itself must
# bottom out on real threading objects.
ALLOWLIST = (
    "llm_consensus_tpu_torch/analysis/",
)


def _allowed(relpath: str) -> bool:
    for entry in ALLOWLIST:
        if entry.endswith("/"):
            if relpath.startswith(entry):
                return True
        elif relpath == entry:
            return True
    return False


def _threading_aliases(tree: ast.AST) -> tuple:
    """(module aliases of ``threading``, {local name: primitive} from
    ``from threading import Lock as L``)."""
    mods: set = set()
    names: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "threading":
                    mods.add(a.asname or "threading")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "threading":
                for a in node.names:
                    if a.name in _PRIMITIVES:
                        names[a.asname or a.name] = a.name
    return mods, names


@checker(
    "raw-primitives",
    ("SA01",),
    "locks/conditions/events built via the sanitizer factories only",
)
def check(project: Project) -> list:
    findings: list = []
    for pf in project.package_files():
        if _allowed(pf.relpath):
            continue
        tree = pf.tree
        if tree is None:
            continue
        mods, names = _threading_aliases(tree)
        if not mods and not names:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            prim = ""
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _PRIMITIVES
                and isinstance(fn.value, ast.Name)
                and fn.value.id in mods
            ):
                prim = fn.attr
            elif isinstance(fn, ast.Name) and fn.id in names:
                prim = names[fn.id]
            if not prim or pf.suppressed("SA01", node.lineno):
                continue
            factory = {
                "Lock": "make_lock", "RLock": "make_rlock",
                "Condition": "make_condition", "Event": "make_event",
            }[prim]
            findings.append(
                Finding(
                    code="SA01",
                    path=pf.relpath,
                    line=node.lineno,
                    message=(
                        f"raw threading.{prim}() — construct it via "
                        f"sanitizer.{factory}(<role>) so the sanitizer, "
                        "race detector, and schedule explorer see it"
                    ),
                    detail=f"threading.{prim} :: line-site "
                           f"{_site_detail(pf, node.lineno)}",
                )
            )
    return findings


def _site_detail(pf, lineno: int) -> str:
    """Content-stable detail: the stripped source line (a raw
    construction is identified by what it assigns, not where)."""
    return pf.line_at(lineno).strip()[:80]
