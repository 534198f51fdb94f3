"""``python -m llm_consensus_tpu_torch.analysis`` — the port's lint gate.

Exit codes: 0 = no unsuppressed findings; 1 = new findings (or a
baseline write was needed and ``--update-baseline`` wasn't passed);
2 = usage/config error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from llm_consensus_tpu_torch.analysis import core


def _detect_root() -> Path:
    # analysis/__main__.py → analysis → llm_consensus_tpu_torch → repo root
    return Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llm_consensus_tpu_torch.analysis",
        description=(
            "Project-native static analysis of the port: lock discipline, "
            "raw primitives, knob/fault/metric registries vs docs."
        ),
    )
    ap.add_argument(
        "--root", type=Path, default=None,
        help="repo root (default: auto-detected from the package location)",
    )
    ap.add_argument(
        "--baseline", type=Path, default=core.BASELINE_DEFAULT,
        help="baseline suppression file (default: analysis/baseline.txt)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding as new",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to exactly the current findings",
    )
    ap.add_argument(
        "--checks", default="",
        help="comma-separated checker names to run (default: all)",
    )
    ap.add_argument(
        "--list", action="store_true", help="list checkers and exit"
    )
    ap.add_argument(
        "-v", "--verbose", action="store_true",
        help="also print grandfathered (baseline-suppressed) findings",
    )
    ns = ap.parse_args(argv)

    if ns.list:
        for c in core.checkers():
            print(f"{c.name:16s} {','.join(c.codes):30s} {c.doc}")
        return 0

    try:
        project = core.Project(ns.root or _detect_root())
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    only = {s.strip() for s in ns.checks.split(",") if s.strip()} or None
    if only:
        known = {c.name for c in core.checkers()}
        unknown = only - known
        if unknown:
            print(
                f"error: unknown checkers {sorted(unknown)} "
                f"(known: {sorted(known)})",
                file=sys.stderr,
            )
            return 2

    findings = core.run_checkers(project, only)

    # Syntax errors are findings too — a file the AST can't parse is a
    # file every checker silently skipped.
    for pf in project.package_files():
        pf.tree  # force parse
        if pf.parse_error is not None:
            findings.append(
                core.Finding(
                    code="XX01",
                    path=pf.relpath,
                    line=pf.parse_error.lineno or 1,
                    message=f"syntax error: {pf.parse_error.msg}",
                    detail="syntax-error",
                )
            )

    if ns.update_baseline:
        core.save_baseline(ns.baseline, findings)
        print(
            f"baseline: wrote {len(findings)} fingerprint(s) to {ns.baseline}"
        )
        return 0

    baseline = set() if ns.no_baseline else core.load_baseline(ns.baseline)
    rep = core.apply_baseline(findings, baseline)

    for f in rep.new:
        print(f.render())
    if ns.verbose:
        for f in rep.grandfathered:
            print(f"{f.render()}  [grandfathered]")
    for fp in rep.stale:
        print(f"stale baseline entry (no longer fires): {fp}")

    counts: dict = {}
    for f in rep.new:
        counts[f.code] = counts.get(f.code, 0) + 1
    summary = ", ".join(f"{c}={n}" for c, n in sorted(counts.items()))
    print(
        f"analysis: {len(rep.new)} new finding(s)"
        + (f" ({summary})" if summary else "")
        + f", {len(rep.grandfathered)} grandfathered,"
        f" {len(rep.stale)} stale baseline entr(y/ies)"
    )
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
