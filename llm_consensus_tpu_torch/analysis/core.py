"""Lint framework: file model, finding/fingerprint shape, baseline IO.

Design points, sized to this project rather than to a generic linter:

  * **Pure AST + text.** Checkers never import the code under analysis —
    ``python -m llm_consensus_tpu_torch.analysis`` runs without torch (or
    any heavy dependency) ever initializing, and a module with an
    import-time bug still gets linted.
  * **Content-based fingerprints.** A finding's identity is
    ``CODE path :: detail`` where ``detail`` names the violating
    *thing* (``Class.method :: field``, a knob name, a fault kind) —
    never a line number — so the checked-in baseline survives unrelated
    edits above the finding and goes stale exactly when the violation
    itself moves or dies.
  * **Baseline = grandfather file, not an off switch.** Suppressed
    findings still print (as ``grandfathered``) under ``-v``; new
    findings fail the run; baseline entries that no longer fire are
    reported so the file shrinks monotonically.
  * **Inline escape hatch.** A source line carrying ``lint-ok: CODE``
    (e.g. ``# lint-ok: GS01 scheduler-owned``) suppresses that code on
    that line — for the handful of accesses whose safety argument is
    local and deliberate, where a baseline entry would hide the
    reasoning from the reader.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

_LINT_OK_RE = re.compile(r"lint-ok:\s*([A-Z]{2}\d{2}(?:[ ,]+[A-Z]{2}\d{2})*)")


@dataclass
class Finding:
    """One checker hit. ``detail`` is the stable fingerprint payload."""

    code: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    detail: str

    @property
    def fingerprint(self) -> str:
        return f"{self.code} {self.path} :: {self.detail}"

    def render(self) -> str:
        return f"{self.code} {self.path}:{self.line}: {self.message}"


class PyFile:
    """One parsed source file (lazy AST, raw lines for comment checks)."""

    def __init__(self, abspath: Path, relpath: str):
        self.abspath = abspath
        self.relpath = relpath
        self.source = abspath.read_text(encoding="utf-8")
        self.lines = self.source.splitlines()
        self._tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None

    @property
    def tree(self) -> Optional[ast.AST]:
        if self._tree is None and self.parse_error is None:
            try:
                self._tree = ast.parse(self.source, filename=str(self.abspath))
            except SyntaxError as exc:
                self.parse_error = exc
        return self._tree

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, code: str, lineno: int) -> bool:
        m = _LINT_OK_RE.search(self.line_at(lineno))
        return bool(m) and code in m.group(1)


class Project:
    """The analyzed tree: package sources + test/doc corpora."""

    PACKAGE = "llm_consensus_tpu_torch"

    def __init__(self, root: Path):
        self.root = Path(root).resolve()
        self.package_dir = self.root / self.PACKAGE
        if not self.package_dir.is_dir():
            raise FileNotFoundError(
                f"{self.package_dir} not found — pass --root at the repo root"
            )
        self._files: Optional[list] = None

    def package_files(self) -> list:
        if self._files is None:
            self._files = [
                PyFile(p, p.relative_to(self.root).as_posix())
                for p in sorted(self.package_dir.rglob("*.py"))
            ]
        return self._files

    def file(self, relpath: str) -> Optional[PyFile]:
        for f in self.package_files():
            if f.relpath == relpath:
                return f
        return None

    def doc_texts(self) -> dict:
        """{relpath: text} for the operator-facing docs the doc-drift
        checkers cross-check (README + docs/*.md)."""
        out: dict = {}
        readme = self.root / "README.md"
        if readme.is_file():
            out["README.md"] = readme.read_text(encoding="utf-8")
        docs = self.root / "docs"
        if docs.is_dir():
            for p in sorted(docs.glob("*.md")):
                out[p.relative_to(self.root).as_posix()] = p.read_text(
                    encoding="utf-8"
                )
        return out

    def coverage_texts(self) -> dict:
        """{relpath: text} for everything that counts as exercising a
        fault site of the port: its tests (``tests/test_torch_*.py``) and
        ``chip_smoke.py``, which drives it on the card."""
        out: dict = {}
        tests = self.root / "tests"
        if tests.is_dir():
            for p in sorted(tests.rglob("test_torch_*.py")):
                out[p.relative_to(self.root).as_posix()] = p.read_text(
                    encoding="utf-8"
                )
        smoke = self.root / "chip_smoke.py"
        if smoke.is_file():
            out["chip_smoke.py"] = smoke.read_text(encoding="utf-8")
        return out


@dataclass
class Checker:
    name: str
    codes: tuple
    doc: str
    fn: Callable


_CHECKERS: list = []


def checker(name: str, codes: tuple, doc: str):
    """Register a checker: ``fn(project) -> Iterable[Finding]``."""

    def wrap(fn):
        _CHECKERS.append(Checker(name, codes, doc, fn))
        return fn

    return wrap


def checkers() -> list:
    # Import for side effect: each module registers itself. Local so
    # importing core (e.g. from tests) stays cheap and cycle-free.
    from llm_consensus_tpu_torch.analysis import (  # noqa: F401
        fault_coverage, guarded_state, knob_registry, metrics_docs,
        raw_primitives,
    )

    return list(_CHECKERS)


def run_checkers(
    project: Project, only: Optional[Iterable[str]] = None
) -> list:
    findings: list = []
    for c in checkers():
        if only and c.name not in only:
            continue
        findings.extend(c.fn(project))
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.detail))
    return findings


# -- baseline ----------------------------------------------------------------

BASELINE_DEFAULT = Path(__file__).with_name("baseline.txt")

_BASELINE_HEADER = """\
# Grandfathered static-analysis findings (python -m llm_consensus_tpu_torch.analysis).
# One fingerprint per line; entries suppress EXISTING findings only — new
# findings always fail. Regenerate with --update-baseline; entries that no
# longer fire are reported stale so this file only ever shrinks.
"""


def load_baseline(path: Path) -> set:
    if not Path(path).is_file():
        return set()
    out: set = set()
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    Path(path).write_text(
        _BASELINE_HEADER + "".join(fp + "\n" for fp in fps),
        encoding="utf-8",
    )


@dataclass
class Report:
    new: list = field(default_factory=list)
    grandfathered: list = field(default_factory=list)
    stale: list = field(default_factory=list)  # baseline entries that no longer fire

    @property
    def ok(self) -> bool:
        return not self.new


def apply_baseline(findings: list, baseline: set) -> Report:
    rep = Report()
    fired = set()
    for f in findings:
        fp = f.fingerprint
        if fp in baseline:
            fired.add(fp)
            rep.grandfathered.append(f)
        else:
            rep.new.append(f)
    rep.stale = sorted(baseline - fired)
    return rep
