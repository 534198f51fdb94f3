"""KR: knob routing through utils/knobs.py + doc-table cross-check.

utils/knobs.py is the single module of the port that may read an
``LLMC_*`` variable. The port has no declaration table: its declared set
is the ``LLMC_*`` names that module passes to a getter (``get_str``,
``get_bool``, ``get_int``, ``get_float``) or to ``_tristate``. This checker
closes the loop statically:

  KR01 — raw ``os.environ`` / ``os.getenv`` read of an ``LLMC_*`` name
         outside utils/knobs.py (reads must route through that module)
  KR02 — an ``LLMC_*`` name referenced in code (getter call, env write,
         ``setdefault``) that utils/knobs.py does not read
  KR03 — a knob the port reads that the operator docs (README.md or
         docs/*.md) never mention
  KR04 — an ``LLMC_*`` token in the docs that the port does not read
         and that :data:`JAX_ONLY` does not list (a typo'd or stale row)

The docs are shared with the JAX package, which reads a few knobs the
port has no use for; :data:`JAX_ONLY` names each with its reason, and a
test holds that list to the JAX registry. The declared set is read from
utils/knobs.py's AST — no import of the package, so the checker catches
even an import-broken tree.
"""

from __future__ import annotations

import ast
import re

from llm_consensus_tpu_torch.analysis.core import Finding, Project, checker

KNOBS_PATH = "llm_consensus_tpu_torch/utils/knobs.py"
_DOC_TOKEN_RE = re.compile(r"LLMC_[A-Z0-9_]*[A-Z0-9]")
_GETTERS = ("get_str", "get_bool", "get_int", "get_float")

# Knobs the JAX package reads and documents that the port does not read,
# by name without the shared prefix, each with its reason. KR04 does not
# fire on them; a doc token outside this list and the port's reads does.
JAX_ONLY = {
    "FLASH": "forces the Pallas flash-prefill kernel on or off; the port "
             "launches its CUDA flash kernel on every card prefill and has "
             "no XLA path to switch to",
    "PREFILL_SCAN": "the scan form of the XLA chunked-prefill program; the "
                    "port runs prefill chunks in a Python loop",
    "DECODE_BLOCKS": "the Pallas decode kernel's block-shape override; the "
                     "CUDA decode kernel sizes its own split",
    "DECODE_KV_MIN": "the width-bucket floor of the XLA decode program's "
                     "recompiles; the port's floor is the fixed "
                     "engine.DECODE_KV_MIN (128) and needs no recompile",
    "XLA_CACHE": "the persistent XLA compilation cache; the port compiles "
                 "its kernels with nvcc into its own build directory",
    "CANARY_WINDOWS": "the canary watcher's knob: no module of either "
                      "package builds a watcher yet (it waits for a caller)",
    "CANARY_LATENCY_TOL": "the canary watcher's knob: waits for a caller",
    "CANARY_MIN_SAMPLES": "the canary watcher's knob: waits for a caller",
}


def jax_only_names() -> set:
    """The full names of :data:`JAX_ONLY` (joined here, so that no string
    constant outside utils/knobs.py names a knob)."""
    return {"LLMC" + "_" + k for k in JAX_ONLY}


def declared_knobs(project: Project) -> dict:
    """{name: (getter, lineno)}: every ``LLMC_*`` literal utils/knobs.py
    passes as the first argument of a getter or ``_tristate``."""
    pf = project.file(KNOBS_PATH)
    out: dict = {}
    if pf is None or pf.tree is None:
        return out
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in _GETTERS + ("_tristate",)
            and node.args
        ):
            name = _llmc_literal(node.args[0])
            if name:
                out.setdefault(name, (node.func.id, node.lineno))
    return out


def _dotted(node: ast.AST) -> str:
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _llmc_literal(node: ast.AST) -> str:
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and _DOC_TOKEN_RE.fullmatch(node.value)
    ):
        return node.value
    return ""


@checker(
    "knob-registry",
    ("KR01", "KR02", "KR03", "KR04"),
    "knob reads route through utils/knobs.py and match the doc tables",
)
def check(project: Project) -> list:
    findings: list = []
    declared = declared_knobs(project)
    referenced: dict = {}  # name -> (path, lineno) first reference

    for pf in project.package_files():
        if pf.relpath == KNOBS_PATH or pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            # -- raw reads: os.environ.get / os.getenv / a subscript of os.environ
            if isinstance(node, ast.Call):
                fname = _dotted(node.func)
                name = ""
                if fname in ("os.environ.get", "os.getenv", "environ.get"):
                    name = _llmc_literal(node.args[0]) if node.args else ""
                    if name and not pf.suppressed("KR01", node.lineno):
                        findings.append(
                            Finding(
                                code="KR01",
                                path=pf.relpath,
                                line=node.lineno,
                                message=(
                                    f"raw env read of {name} — route it "
                                    "through utils/knobs.py getters"
                                ),
                                detail=f"{name} :: raw-read",
                            )
                        )
                elif fname in ("os.environ.setdefault", "environ.setdefault"):
                    name = _llmc_literal(node.args[0]) if node.args else ""
                elif fname.rsplit(".", 1)[-1] in _GETTERS and (
                    fname.split(".", 1)[0] == "knobs" or ".knobs." in fname
                ):
                    name = _llmc_literal(node.args[0]) if node.args else ""
                if name:
                    referenced.setdefault(name, (pf.relpath, node.lineno))
            # -- env writes / membership tests with an LLMC literal index
            elif isinstance(node, ast.Subscript):
                if _dotted(node.value) in ("os.environ", "environ"):
                    name = _llmc_literal(node.slice)
                    if name:
                        referenced.setdefault(
                            name, (pf.relpath, node.lineno)
                        )
                        if isinstance(
                            node.ctx, ast.Load
                        ) and not pf.suppressed("KR01", node.lineno):
                            findings.append(
                                Finding(
                                    code="KR01",
                                    path=pf.relpath,
                                    line=node.lineno,
                                    message=(
                                        f"raw env read of {name} — route "
                                        "it through utils/knobs.py getters"
                                    ),
                                    detail=f"{name} :: raw-read",
                                )
                            )
            elif isinstance(node, ast.Compare):
                if any(
                    isinstance(op, (ast.In, ast.NotIn))
                    for op in node.ops
                ) and any(
                    _dotted(c) in ("os.environ", "environ")
                    for c in node.comparators
                ):
                    name = _llmc_literal(node.left)
                    if name and not pf.suppressed("KR01", node.lineno):
                        referenced.setdefault(
                            name, (pf.relpath, node.lineno)
                        )
                        findings.append(
                            Finding(
                                code="KR01",
                                path=pf.relpath,
                                line=node.lineno,
                                message=(
                                    f"raw env read of {name} — route it "
                                    "through utils/knobs.py getters"
                                ),
                                detail=f"{name} :: raw-read",
                            )
                        )

    # -- KR02: referenced-but-undeclared
    for name, (path, lineno) in sorted(referenced.items()):
        if name not in declared:
            findings.append(
                Finding(
                    code="KR02",
                    path=path,
                    line=lineno,
                    message=(
                        f"{name} is referenced but utils/knobs.py does "
                        "not read it"
                    ),
                    detail=f"{name} :: undeclared",
                )
            )

    # -- docs cross-check
    docs = project.doc_texts()
    documented: dict = {}  # name -> first doc file
    for relpath, text in docs.items():
        for tok in _DOC_TOKEN_RE.findall(text):
            documented.setdefault(tok, relpath)
    for name, (_kind, lineno) in sorted(declared.items()):
        if name not in documented:
            findings.append(
                Finding(
                    code="KR03",
                    path=KNOBS_PATH,
                    line=lineno,
                    message=(
                        f"knob {name} is read but not documented in "
                        "README.md or docs/*.md"
                    ),
                    detail=f"{name} :: undocumented",
                )
            )
    jax_only = jax_only_names()
    for name, relpath in sorted(documented.items()):
        if name not in declared and name not in jax_only:
            findings.append(
                Finding(
                    code="KR04",
                    path=relpath,
                    line=1,
                    message=(
                        f"docs mention {name} but utils/knobs.py does not "
                        "read it (typo or stale doc row)"
                    ),
                    detail=f"{name} :: doc-only",
                )
            )
    return findings
