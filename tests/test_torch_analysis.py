"""The port's static analysis framework, checkers and runtime sanitizer
(``llm_consensus_tpu_torch/analysis/``), held to ``tests/test_analysis.py``.

Every case of that file but the two tracer-hygiene ones (the ``TH``
checker has no port counterpart) runs here over the port: golden findings
on small fixture projects written to tmp_path, the baseline and the
``lint-ok`` suppression, the lock-order monitor, and the whole-tree gate
over ``llm_consensus_tpu_torch``. Beside them: the factory role names of
both packages agree, the same fixture trees give the same findings through
both packages' ``GS``, ``SA``, ``FC`` and ``MD`` checkers, and the ``KR``
checker's list of knobs only the JAX package reads stays inside the JAX
registry.
"""

from __future__ import annotations

import ast
import re
import textwrap
import threading
from pathlib import Path

import pytest

from llm_consensus_tpu.analysis import core as jax_core
from llm_consensus_tpu_torch.analysis import core, knob_registry, sanitizer
from llm_consensus_tpu_torch.analysis.core import (
    Project, apply_baseline, load_baseline, run_checkers, save_baseline,
)

REPO_ROOT = Path(__file__).resolve().parents[1]
PKG = "llm_consensus_tpu_torch"


def _mini_project(tmp_path: Path, files: dict, readme: str = "", obs_doc: str = "",
                  packages=(PKG,)) -> Project:
    """A throwaway project tree: ``files`` maps package-relative paths to
    source text, written under each of ``packages``; README/docs are
    optional."""
    for package in packages:
        pkg = tmp_path / package
        pkg.mkdir(parents=True, exist_ok=True)
        for rel, src in files.items():
            p = pkg / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(textwrap.dedent(src))
        # Package markers so rglob mirrors the real layout.
        for d in set(p.parent for p in pkg.rglob("*.py")) | {pkg}:
            init = d / "__init__.py"
            if not init.exists():
                init.write_text("")
    (tmp_path / "README.md").write_text(readme)
    docs = tmp_path / "docs"
    docs.mkdir(exist_ok=True)
    (docs / "observability.md").write_text(obs_doc)
    return Project(tmp_path)


def _codes(findings) -> list:
    return sorted(f.code for f in findings)


def _only(findings, code) -> list:
    return [f for f in findings if f.code == code]


# ---------------------------------------------------------------------------
# guarded-state (GS)

CLEAN_GUARDED = """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._work = threading.Condition(self._lock)
            self._free = []  # guarded by: _lock
            self._stats = {}  # guarded by: _lock

        def take(self):
            with self._lock:
                return self._free.pop()

        def via_alias(self):
            with self._work:
                self._stats["x"] = 1

        def _drain_locked(self):
            return list(self._free)
"""

DIRTY_GUARDED = """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._free = []  # guarded by: _lock
            self._stats = {}  # guarded by: _missing

        def bad_read(self):
            return len(self._free)

        def bad_write(self):
            self._free.append(1)

        def excused(self):
            return bool(self._free)  # lint-ok: GS01 watchdog read
"""

FACTORY_GUARDED = """
    from llm_consensus_tpu_torch.analysis import sanitizer

    class C:
        def __init__(self):
            self._cond = sanitizer.make_condition("c")
            self._n = 0  # guarded by: _cond

        def ok(self):
            with self._cond:
                self._n += 1

        def bad(self):
            return self._n
"""


def test_guarded_state_clean_and_dirty(tmp_path):
    proj = _mini_project(tmp_path, {"mod.py": CLEAN_GUARDED})
    assert run_checkers(proj, only={"guarded-state"}) == []
    proj = _mini_project(tmp_path / "d", {"mod.py": DIRTY_GUARDED})
    found = run_checkers(proj, only={"guarded-state"})
    gs01 = _only(found, "GS01")
    assert sorted(f.detail for f in gs01) == [
        "Pool.bad_read :: _free",
        "Pool.bad_write :: _free",
    ]
    # The annotation naming a nonexistent lock is its own finding.
    assert [f.detail for f in _only(found, "GS02")] == ["Pool :: _stats :: _missing"]


def test_guarded_state_sanitizer_factories_count_as_locks(tmp_path):
    proj = _mini_project(tmp_path, {"mod.py": FACTORY_GUARDED})
    found = run_checkers(proj, only={"guarded-state"})
    assert [f.detail for f in found] == ["C.bad :: _n"]


# ---------------------------------------------------------------------------
# knob registry (KR), the port's form: the declared set is what
# utils/knobs.py passes to its readers

KNOBS_FIXTURE = """
    import os

    def get_int(name, default):
        return int(os.environ.get(name) or default)

    def get_str(name, default=""):
        return os.environ.get(name) or default

    def alpha():
        return get_int("LLMC_ALPHA", 4)

    def orphan():
        return get_str("LLMC_ORPHAN")
"""


def test_knob_registry_drift_directions(tmp_path):
    proj = _mini_project(
        tmp_path,
        {
            "utils/knobs.py": KNOBS_FIXTURE,
            "mod.py": """
            import os
            from llm_consensus_tpu_torch.utils import knobs

            RAW = os.environ.get("LLMC_ALPHA", "")
            TYPO = knobs.get_int("LLMC_TPYO")
            OK = knobs.get_int("LLMC_ALPHA")
            """,
        },
        readme="Knobs: `LLMC_ALPHA` and the stale `LLMC_GHOST`.\n",
    )
    found = run_checkers(proj, only={"knob-registry"})
    assert [f.detail for f in _only(found, "KR01")] == ["LLMC_ALPHA :: raw-read"]
    assert [f.detail for f in _only(found, "KR02")] == ["LLMC_TPYO :: undeclared"]
    assert [f.detail for f in _only(found, "KR03")] == ["LLMC_ORPHAN :: undocumented"]
    # Doc-only names: the typo'd getter name never reaches docs, but the
    # stale README mention does.
    assert {f.detail for f in _only(found, "KR04")} == {"LLMC_GHOST :: doc-only"}


def test_knob_registry_env_writes_need_declaration_only(tmp_path):
    proj = _mini_project(
        tmp_path,
        {
            "utils/knobs.py": KNOBS_FIXTURE,
            "mod.py": """
            import os

            os.environ["LLMC_ALPHA"] = "1"       # write: legal
            os.environ["LLMC_UNKNOWN"] = "1"     # write of undeclared
            """,
        },
        readme="`LLMC_ALPHA` `LLMC_ORPHAN`\n",
    )
    found = run_checkers(proj, only={"knob-registry"})
    assert _codes(found) == ["KR02"]
    assert found[0].detail == "LLMC_UNKNOWN :: undeclared"


def test_knob_registry_skips_knobs_only_the_jax_package_reads(tmp_path):
    """The docs are shared: a knob on the JAX-only list raises no KR04, a
    token outside it and the port's reads still does."""
    proj = _mini_project(
        tmp_path, {"utils/knobs.py": KNOBS_FIXTURE},
        readme="`LLMC_ALPHA` `LLMC_ORPHAN` `LLMC_FLASH` `LLMC_XLA_CACHE` "
               "`LLMC_CANARY_WINDOWS` `LLMC_FLASHY`\n",
    )
    found = run_checkers(proj, only={"knob-registry"})
    assert [f.detail for f in found] == ["LLMC_FLASHY :: doc-only"]


def test_knob_registry_jax_only_list_is_held_to_the_jax_registry():
    """Every name on the JAX-only list is a knob the JAX registry declares
    and the port does not read, each with its reason, and together with the
    port's reads they cover the registry."""
    from llm_consensus_tpu.utils import knobs as jax_knobs

    names = knob_registry.jax_only_names()
    assert names <= set(jax_knobs.REGISTRY)
    assert all(reason.strip() for reason in knob_registry.JAX_ONLY.values())
    read = set(knob_registry.declared_knobs(Project(REPO_ROOT)))
    assert not names & read
    assert read | names == set(jax_knobs.REGISTRY)


# ---------------------------------------------------------------------------
# fault coverage (FC): the port's coverage texts are its tests and chip_smoke.py

PLAN_FIXTURE = """
    SITE_KINDS = {
        "prefill": ("prefill_oom",),
        "serve": ("queue_full", "slow_admit"),
    }
"""


def test_fault_coverage_gap_detection(tmp_path):
    proj = _mini_project(tmp_path, {"faults/plan.py": PLAN_FIXTURE})
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_x.py").write_text('PLAN = "prefill_oom@step=1,queue_full"\n')
    # A JAX test file does not cover the port's sites.
    (tests / "test_x.py").write_text('PLAN = "slow_admit@s=1"\n')
    found = run_checkers(proj, only={"fault-coverage"})
    assert [f.detail for f in found] == ["serve :: slow_admit"]
    # Cover it from the card smoke script instead of a test: also accepted.
    (tmp_path / "chip_smoke.py").write_text('X = "slow_admit@s=1"\n')
    proj = Project(tmp_path)
    assert run_checkers(proj, only={"fault-coverage"}) == []


def test_fault_coverage_unparsable_is_a_finding(tmp_path):
    proj = _mini_project(tmp_path, {"faults/plan.py": "SITE_KINDS = make()\n"})
    found = run_checkers(proj, only={"fault-coverage"})
    assert _codes(found) == ["FC02"]


# ---------------------------------------------------------------------------
# metrics docs (MD)

PROM_FIXTURE = """
    FAMILIES = {
        "llmc_ttft_seconds": "histogram",
        "llmc_declared_unused_total": "counter",
        "llmc_stat": "gauge",
    }
"""

GATEWAY_FIXTURE = """
    class GW:
        def metricsz(self):
            gauges = {"rogue_gauge": 1.0}
            self.live.observe("ttft", 0.1, outcome="ok")
            return gauges
"""

OBS_DOC = ("| `llmc_ttft_seconds` | ... |\n| `llmc_stat` | ... |\n"
           "| `llmc_phantom_total` | stale row |\n")


def test_metrics_docs_three_way_crosscheck(tmp_path):
    proj = _mini_project(
        tmp_path, {"obs/prom.py": PROM_FIXTURE, "serve/gateway.py": GATEWAY_FIXTURE},
        obs_doc=OBS_DOC,
    )
    found = run_checkers(proj, only={"metrics-docs"})
    assert [f.detail for f in _only(found, "MD01")] == ["llmc_rogue_gauge :: undeclared"]
    assert [f.detail for f in _only(found, "MD02")] == [
        "llmc_declared_unused_total :: undocumented"]
    assert [f.detail for f in _only(found, "MD03")] == ["llmc_phantom_total :: doc-only"]


# ---------------------------------------------------------------------------
# baseline + fingerprints

def test_baseline_grandfathers_and_reports_stale(tmp_path):
    proj = _mini_project(tmp_path, {"mod.py": DIRTY_GUARDED})
    found = run_checkers(proj, only={"guarded-state"})
    assert found
    bl = tmp_path / "baseline.txt"
    save_baseline(bl, found)
    # Every finding suppressed: the gate is green.
    rep = apply_baseline(found, load_baseline(bl))
    assert rep.ok and len(rep.grandfathered) == len(found)
    # A NEW finding still fails even with the old ones grandfathered.
    extra = core.Finding("GS01", f"{PKG}/mod.py", 1, "new", "Pool.newer :: _free")
    rep = apply_baseline(found + [extra], load_baseline(bl))
    assert not rep.ok and [f.detail for f in rep.new] == ["Pool.newer :: _free"]
    # Fixing a finding leaves its entry stale — reported for removal.
    rep = apply_baseline(found[1:], load_baseline(bl))
    assert rep.ok and len(rep.stale) == 1


def test_fingerprints_are_line_independent(tmp_path):
    proj = _mini_project(tmp_path, {"mod.py": DIRTY_GUARDED})
    fp1 = {f.fingerprint for f in run_checkers(proj, only={"guarded-state"})}
    shifted = "\n\n\n# shifted by a comment block\n" + textwrap.dedent(DIRTY_GUARDED)
    (tmp_path / PKG / "mod.py").write_text(shifted)
    proj = Project(tmp_path)
    fp2 = {f.fingerprint for f in run_checkers(proj, only={"guarded-state"})}
    assert fp1 == fp2


def test_cli_exit_codes(tmp_path):
    from llm_consensus_tpu_torch.analysis.__main__ import main

    _mini_project(tmp_path, {"mod.py": DIRTY_GUARDED})
    bl = tmp_path / "bl.txt"
    args = ["--root", str(tmp_path), "--baseline", str(bl), "--checks", "guarded-state"]
    assert main(args) == 1  # findings, no baseline
    assert main(args + ["--update-baseline"]) == 0
    assert main(args) == 0  # grandfathered
    assert main(args + ["--no-baseline"]) == 1
    assert main(["--root", str(tmp_path / "nope")]) == 2
    assert main(args[:2] + ["--checks", "bogus"]) == 2
    # The port's checker set: the JAX one without tracer hygiene.
    assert main(args[:2] + ["--checks", "tracer-hygiene"]) == 2


# ---------------------------------------------------------------------------
# runtime sanitizer

@pytest.fixture()
def monitor():
    m = sanitizer.LockMonitor()
    sanitizer.install(m)
    yield m
    sanitizer.reset()


def test_factories_plain_when_disabled(monkeypatch):
    monkeypatch.delenv("LLMC_SANITIZE", raising=False)
    sanitizer.reset()
    try:
        assert not sanitizer.enabled()
        assert isinstance(sanitizer.make_lock("x"), type(threading.Lock()))
        assert isinstance(sanitizer.make_event("x"), threading.Event)
        assert sanitizer.assert_held(threading.Lock())  # no-op, True
        assert sanitizer.report() is None
    finally:
        sanitizer.reset()


def test_sanitize_knob_resolves_once_at_the_first_factory_call(monkeypatch):
    """``LLMC_SANITIZE=1`` instruments the locks built after the first
    resolution; flipping the variable later changes nothing until a
    reset (a process never holds half-instrumented locks)."""
    monkeypatch.setenv("LLMC_SANITIZE", "1")
    sanitizer.reset()
    try:
        assert isinstance(sanitizer.make_lock("x"), sanitizer.SanLock)
        monkeypatch.setenv("LLMC_SANITIZE", "0")
        assert sanitizer.enabled()
        assert isinstance(sanitizer.make_rlock("y"), sanitizer.SanRLock)
    finally:
        sanitizer.reset()


def test_lock_order_cycle_detected(monitor):
    a = sanitizer.make_lock("A")
    b = sanitizer.make_lock("B")
    assert isinstance(a, sanitizer.SanLock)

    def ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=ab)
    t.start()
    t.join()
    # Sequentially (no real deadlock), the opposite order on this thread.
    with b:
        with a:
            pass
    cycles = monitor.cycles()
    assert cycles and set(cycles[0]) >= {"A", "B"}, cycles
    rep = monitor.report()
    assert ("A", "B") in rep["edges"] and ("B", "A") in rep["edges"]
    assert rep["cycles"]


def test_consistent_order_reports_no_cycle(monitor):
    a = sanitizer.make_lock("A")
    b = sanitizer.make_lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert monitor.cycles() == []
    assert monitor.violations == []


def test_assert_held_records_violation(monitor):
    lock = sanitizer.make_lock("guarded")
    with lock:
        assert sanitizer.assert_held(lock)
    assert not sanitizer.assert_held(lock)
    assert len(monitor.violations) == 1
    assert "guarded" in monitor.violations[0]["what"]


def test_condition_wait_keeps_bookkeeping_exact(monitor):
    cond = sanitizer.make_condition("C")
    inner = cond._lock
    assert isinstance(inner, sanitizer.SanLock)
    released_during_wait = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            released_during_wait.append(monitor.holds(inner))

    t = threading.Thread(target=waiter)
    t.start()
    # Let the waiter release the lock inside wait(), then notify.
    pause = threading.Event()
    for _ in range(200):
        if cond._lock.locked():
            pause.wait(0.01)
        else:
            break
    with cond:
        assert sanitizer.assert_held(cond)
        cond.notify_all()
    t.join(5)
    assert not t.is_alive()
    # Re-acquired through the instrumented path on wakeup.
    assert released_during_wait == [True]
    assert monitor.violations == []


def test_rlock_reentrancy_no_self_edges(monitor):
    r = sanitizer.make_rlock("R")
    with r:
        with r:
            pass
    rep = monitor.report()
    assert ("R", "R") not in rep["edges"]
    assert monitor.cycles() == []


def test_render_report_carries_cycle_edge_stacks(monitor):
    a = sanitizer.make_lock("A")
    b = sanitizer.make_lock("B")

    def ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=ab)
    t.start()
    t.join()
    with b:
        with a:
            pass
    text = sanitizer.render_report(monitor.report())
    assert "lock-order cycle" in text
    assert "edge A -> B first acquired at:" in text
    assert "edge B -> A first acquired at:" in text
    # The first-observed stacks point at THIS test, not wait internals.
    assert "test_torch_analysis" in text


# ---------------------------------------------------------------------------
# raw-primitives (SA)

RAW_DIRTY = """
    import threading
    import threading as _t
    from threading import Condition

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._rl = _t.RLock()
            self._cond = Condition()
            self._ev = threading.Event()
            self._tls = threading.local()   # not restricted
            self._sem = threading.Semaphore()  # not restricted
"""


def test_raw_primitives_flagged_across_import_forms(tmp_path):
    proj = _mini_project(tmp_path, {"mod.py": RAW_DIRTY})
    found = _only(run_checkers(proj, only={"raw-primitives"}), "SA01")
    assert len(found) == 4
    assert {f.detail.split(" :: ")[0] for f in found} == {
        "threading.Lock", "threading.RLock", "threading.Condition", "threading.Event",
    }
    for f in found:
        assert "sanitizer.make_" in f.message


def test_raw_primitives_factories_allowlist_and_suppression(tmp_path):
    clean = """
    from llm_consensus_tpu_torch.analysis import sanitizer

    class C:
        def __init__(self):
            self._lock = sanitizer.make_lock("c")
            self._cond = sanitizer.make_condition("c", self._lock)
            self._ev = sanitizer.make_event("c")
    """
    proj = _mini_project(tmp_path, {"mod.py": clean})
    assert run_checkers(proj, only={"raw-primitives"}) == []
    # The instrumentation substrate itself is allowlisted …
    proj = _mini_project(tmp_path / "a",
                         {"analysis/impl.py": "import threading\nL = threading.Lock()\n"})
    assert run_checkers(proj, only={"raw-primitives"}) == []
    # … and an inline lint-ok suppresses a deliberate site.
    proj = _mini_project(tmp_path / "s", {"mod.py": (
        "import threading\n"
        "L = threading.Lock()  # lint-ok: SA01 bootstrap\n"
    )})
    assert run_checkers(proj, only={"raw-primitives"}) == []


def test_raw_primitives_repo_grep_is_empty():
    """The acceptance grep, as a test: no raw primitive construction
    outside analysis/ anywhere in the port."""
    pat = re.compile(r"threading\.(Lock|RLock|Condition|Event)\(")
    offenders = []
    for p in (REPO_ROOT / PKG).rglob("*.py"):
        rel = p.relative_to(REPO_ROOT).as_posix()
        if rel.startswith(f"{PKG}/analysis/"):
            continue
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if pat.search(line) and "lint-ok: SA01" not in line:
                offenders.append(f"{rel}:{i}: {line.strip()}")
    assert offenders == []


# ---------------------------------------------------------------------------
# the port's tree, under its baseline

def test_repository_is_analysis_clean():
    proj = Project(REPO_ROOT)
    assert proj.package_dir.name == PKG
    findings = run_checkers(proj)
    rep = apply_baseline(findings, load_baseline(core.BASELINE_DEFAULT))
    assert rep.ok, "new analysis findings:\n" + "\n".join(f.render() for f in rep.new)
    # The baseline started empty and grandfathers nothing.
    assert load_baseline(core.BASELINE_DEFAULT) == set()


# ---------------------------------------------------------------------------
# parity with the JAX package

_FACTORIES = ("make_lock", "make_rlock", "make_condition", "make_event")
# Locks the port builds that have no JAX counterpart: the kernel build and
# launch counters, the decode kernel's split-ticket table, the roofline's
# process-wide capture count and the profiler's owning thread's two events.
PORT_ONLY_ROLES = {
    "ops.kernels.build", "ops.kernels.launches", "ops.kernels.decode_attention",
    "obs.roofline.capturing", "obs.profiler.armed", "obs.profiler.stop",
}
# The JAX package's process-wide journal registry: the port's journal is no
# singleton (providers and batchers take it as an argument).
JAX_ONLY_ROLES = {"recovery.registry"}


def _role_values(node) -> set:
    """The role names a factory's first argument can take: a string, or
    either arm of a conditional expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.IfExp):
        return _role_values(node.body) | _role_values(node.orelse)
    return set()


def _roles(package: str) -> set:
    out: set = set()
    root = REPO_ROOT / package
    for p in root.rglob("*.py"):
        if p.relative_to(root).parts[0] == "analysis":
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in _FACTORIES:
                out |= _role_values(node.args[0])
    return out


def test_factory_role_names_match_the_jax_package():
    jax_roles = {r.replace("providers.tpu", "providers.gpu", 1)
                 for r in _roles("llm_consensus_tpu")}
    port_roles = _roles(PKG)
    assert port_roles - PORT_ONLY_ROLES == jax_roles - JAX_ONLY_ROLES
    assert PORT_ONLY_ROLES <= port_roles and JAX_ONLY_ROLES <= jax_roles


PARITY_TREES = {
    "guarded-state": ({"mod.py": DIRTY_GUARDED, "fac.py": FACTORY_GUARDED}, ""),
    "raw-primitives": ({"mod.py": RAW_DIRTY,
                        "analysis/impl.py": "import threading\nL = threading.Lock()\n"}, ""),
    "fault-coverage": ({"faults/plan.py": PLAN_FIXTURE}, ""),
    "metrics-docs": ({"obs/prom.py": PROM_FIXTURE, "serve/gateway.py": GATEWAY_FIXTURE},
                     OBS_DOC),
}


@pytest.mark.parametrize("checker", sorted(PARITY_TREES))
def test_checkers_find_what_the_jax_checkers_find(tmp_path, checker):
    """One fixture tree, written under both package names: both packages'
    checker gives the same codes and details (the paths differ by the
    package directory only)."""
    files, obs_doc = PARITY_TREES[checker]
    _mini_project(tmp_path, files, obs_doc=obs_doc, packages=("llm_consensus_tpu", PKG))
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_cov.py").write_text('PLAN = "prefill_oom@step=1,queue_full"\n')
    port = run_checkers(Project(tmp_path), only={checker})
    ref = jax_core.run_checkers(jax_core.Project(tmp_path), only={checker})
    assert port, checker
    assert [(f.code, f.detail) for f in port] == [(f.code, f.detail) for f in ref]
    assert [f.path.split("/", 1)[-1] for f in port] == [f.path.split("/", 1)[-1] for f in ref]


# The six schedule-exploration seams: (module, function, tag).
SEAMS = [
    ("engine/batcher.py", "_loop", "batcher.schedule"),
    ("engine/handoff.py", "_run", "handoff.drain"),
    ("serve/admission.py", "admit", "admission.dequeue"),
    ("pressure/governor.py", "_loop", "governor.tick"),
    ("recovery/supervisor.py", "_watch", "supervisor.watchdog"),
    ("serve/elastic.py", "_run", "elastic.tick"),
]


@pytest.mark.parametrize("rel,fn,tag", SEAMS, ids=[s[2] for s in SEAMS])
def test_sched_point_seams_exist(rel, fn, tag):
    """Each JAX ``sched_point`` seam has its counterpart in the port, inside
    the function that runs the protocol step."""
    tree = ast.parse((REPO_ROOT / PKG / rel).read_text())
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == fn]
    tags = {c.args[0].value for f in funcs for c in ast.walk(f)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and c.func.attr == "sched_point" and c.args}
    assert tag in tags, (rel, fn, tags)
