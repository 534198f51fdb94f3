"""MD: declared-vs-documented metric-family cross-check.

The static generalization of a runtime ``/metricsz`` lint (what one live
gateway *exports*): this checker asserts, at lint time and over the whole tree,
that the three representations of the metric plane agree:

  * **manifest** — ``FAMILIES`` in obs/prom.py, the declared name→type
    table every family must be registered in;
  * **code** — family names the source actually constructs: live
    histogram names (``.observe("<name>", ...)`` → ``llmc_<name>_seconds``)
    and the ``gauges``/``families`` tables assembled in
    ``ConsensusGateway.metricsz`` / ``ChipTimeLedger.prom_families``;
  * **docs** — the family tables in docs/observability.md.

Findings:
  MD01 — a family constructed in code that the manifest doesn't declare
  MD02 — a manifest family missing from docs/observability.md
  MD03 — a docs family the manifest doesn't declare (stale/typo'd row)
  MD04 — the ``FAMILIES`` manifest could not be parsed

Label-dict keys (``family``/``disposition``/...) and the families-entry
shape keys (``type``/``samples``) are excluded from code collection by
name — the collection walks only functions named ``metricsz`` /
``prom_families``, so the exclusion list stays small and local.
"""

from __future__ import annotations

import ast
import re

from llm_consensus_tpu_torch.analysis.core import Finding, Project, checker

PROM_PATH = "llm_consensus_tpu_torch/obs/prom.py"
DOC_PATH = "docs/observability.md"
_DOC_TOKEN_RE = re.compile(r"llmc_[a-z0-9_]*[a-z0-9]")
_FAMILY_FNS = ("metricsz", "prom_families")
_NON_FAMILY_KEYS = {
    "type", "samples", "family", "disposition", "kind", "phase", "block",
    "key", "class", "outcome", "version", "jax", "features", "le",
    "source", "url", "surface",
}
# Sample-line suffixes a doc may legitimately spell out for a histogram
# family; normalized back to the family name before the manifest check.
_SUFFIXES = ("_bucket", "_sum", "_count")


def manifest(project: Project) -> dict:
    """{family: (type, lineno)} parsed from obs/prom.py FAMILIES."""
    pf = project.file(PROM_PATH)
    if pf is None or pf.tree is None:
        return {}
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "FAMILIES"
            for t in node.targets
        ):
            try:
                raw = dict(ast.literal_eval(node.value))
            except (ValueError, SyntaxError):
                return {}
            return {k: (v, node.lineno) for k, v in raw.items()}
    return {}


def _code_families(project: Project) -> dict:
    """{family: (path, lineno)} constructed by the source."""
    out: dict = {}
    for pf in project.package_files():
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            # live histogram names: .observe("<name>", value, ...)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "observe"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                fam = f"llmc_{node.args[0].value}_seconds"
                out.setdefault(fam, (pf.relpath, node.lineno))
            # gauge/family tables in metricsz/prom_families
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node.name in _FAMILY_FNS:
                for sub in ast.walk(node):
                    key = None
                    if isinstance(sub, ast.Dict):
                        for k in sub.keys:
                            if (
                                isinstance(k, ast.Constant)
                                and isinstance(k.value, str)
                            ):
                                key = k.value
                                if key not in _NON_FAMILY_KEYS:
                                    out.setdefault(
                                        f"llmc_{key}",
                                        (pf.relpath, k.lineno),
                                    )
                    elif isinstance(sub, ast.Subscript) and isinstance(
                        sub.ctx, ast.Store
                    ):
                        if (
                            isinstance(sub.slice, ast.Constant)
                            and isinstance(sub.slice.value, str)
                            and sub.slice.value not in _NON_FAMILY_KEYS
                        ):
                            out.setdefault(
                                f"llmc_{sub.slice.value}",
                                (pf.relpath, sub.lineno),
                            )
    out.setdefault("llmc_stat", (PROM_PATH, 1))  # rendered unconditionally
    return out


@checker(
    "metrics-docs",
    ("MD01", "MD02", "MD03", "MD04"),
    "metric families agree across code, the FAMILIES manifest, and docs",
)
def check(project: Project) -> list:
    findings: list = []
    fams = manifest(project)
    if not fams:
        findings.append(
            Finding(
                code="MD04",
                path=PROM_PATH,
                line=1,
                message=(
                    "could not parse the FAMILIES manifest from obs/prom.py"
                    " — the metric cross-check is blind"
                ),
                detail="FAMILIES :: unparsable",
            )
        )
        return findings
    # code vs manifest
    for fam, (path, lineno) in sorted(_code_families(project).items()):
        if fam not in fams:
            findings.append(
                Finding(
                    code="MD01",
                    path=path,
                    line=lineno,
                    message=(
                        f"metric family {fam} is constructed here but not "
                        "declared in obs/prom.py FAMILIES"
                    ),
                    detail=f"{fam} :: undeclared",
                )
            )
    # manifest vs docs
    doc_text = project.doc_texts().get(DOC_PATH, "")
    documented: set = set()
    for tok in _DOC_TOKEN_RE.findall(doc_text):
        for sfx in _SUFFIXES:
            if tok.endswith(sfx) and tok[: -len(sfx)] in fams:
                tok = tok[: -len(sfx)]
                break
        documented.add(tok)
    for fam, (_type, lineno) in sorted(fams.items()):
        if fam not in documented:
            findings.append(
                Finding(
                    code="MD02",
                    path=PROM_PATH,
                    line=lineno,
                    message=(
                        f"declared family {fam} has no row in "
                        f"{DOC_PATH}"
                    ),
                    detail=f"{fam} :: undocumented",
                )
            )
    for tok in sorted(documented):
        if tok not in fams and tok != "llmc":
            findings.append(
                Finding(
                    code="MD03",
                    path=DOC_PATH,
                    line=1,
                    message=(
                        f"{DOC_PATH} documents {tok} but obs/prom.py "
                        "FAMILIES does not declare it (stale or typo'd row)"
                    ),
                    detail=f"{tok} :: doc-only",
                )
            )
    return findings
