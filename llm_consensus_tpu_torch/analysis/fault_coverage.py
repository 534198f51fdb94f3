"""FC: fault-site coverage.

faults/plan.py declares the injection matrix (``SITE_KINDS``: every
site and the fault kinds that can fire there). A declared kind nothing
ever injects is untested recovery code wearing a tested-looking label —
the matrix rots silently as sites are added. This checker reads
``SITE_KINDS`` from the AST (no package import) and requires every kind
to appear in at least one coverage text of the port: its tests
(``tests/test_torch_*.py``) or ``chip_smoke.py``, which drives it on the
card. Sites whose kinds are all covered are implicitly covered
themselves.

Findings:
  FC01 — declared fault kind never referenced by a port test or chip_smoke.py
  FC02 — ``SITE_KINDS`` could not be parsed (checker contract broken)
"""

from __future__ import annotations

import ast
import re

from llm_consensus_tpu_torch.analysis.core import Finding, Project, checker

PLAN_PATH = "llm_consensus_tpu_torch/faults/plan.py"


def declared_site_kinds(project: Project) -> dict:
    """{site: (kinds...)} parsed from the SITE_KINDS literal."""
    pf = project.file(PLAN_PATH)
    if pf is None or pf.tree is None:
        return {}
    for node in pf.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "SITE_KINDS":
                try:
                    return dict(ast.literal_eval(node.value))
                except (ValueError, SyntaxError):
                    return {}
    return {}


@checker(
    "fault-coverage",
    ("FC01", "FC02"),
    "every declared fault site/kind is fired by a port test or chip_smoke.py",
)
def check(project: Project) -> list:
    findings: list = []
    site_kinds = declared_site_kinds(project)
    if not site_kinds:
        findings.append(
            Finding(
                code="FC02",
                path=PLAN_PATH,
                line=1,
                message=(
                    "could not parse SITE_KINDS from faults/plan.py — the "
                    "fault-coverage checker is blind"
                ),
                detail="SITE_KINDS :: unparsable",
            )
        )
        return findings
    corpus = project.coverage_texts()
    for site, kinds in sorted(site_kinds.items()):
        for kind in kinds:
            pat = re.compile(rf"\b{re.escape(kind)}\b")
            if not any(pat.search(text) for text in corpus.values()):
                findings.append(
                    Finding(
                        code="FC01",
                        path=PLAN_PATH,
                        line=1,
                        message=(
                            f"fault kind {kind!r} (site {site!r}) is "
                            "declared but no port test and no chip_smoke.py "
                            "phase ever fires it"
                        ),
                        detail=f"{site} :: {kind}",
                    )
                )
    return findings
