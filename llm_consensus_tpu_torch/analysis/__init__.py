"""Project-native static analysis & concurrency sanitizer of the port.

Two halves, one correctness gate:

  * **Static** (``python -m llm_consensus_tpu_torch.analysis``): an
    AST-walking lint framework (analysis/core.py) with project-specific
    checkers over ``llm_consensus_tpu_torch`` — guarded-state lock
    discipline (``GS``), raw synchronization primitives (``SA``), the
    knob module + doc-table cross-check (``KR``), fault-site coverage
    (``FC``), and the declared-vs-documented metric-family cross-check
    (``MD``). Findings carry stable content-based fingerprints; the
    checked-in baseline (analysis/baseline.txt) suppresses grandfathered
    findings so new ones — and only new ones — fail the run.
  * **Runtime** (analysis/sanitizer.py): drop-in instrumented
    Lock/RLock/Condition/Event under ``LLMC_SANITIZE=1`` that record
    the per-thread lock acquisition graph, report lock-order cycles
    (potential deadlocks) and off-lock guarded-field access. The same
    factory seam powers **deterministic model checking**
    (analysis/schedule.py: cooperative schedule exploration under
    ``LLMC_SCHED``, with replay tokens and delta-debug minimization) and
    **happens-before race detection** (analysis/race.py: FastTrack-style
    vector clocks over the ``# guarded by:`` field inventory);
    analysis/protocols.py holds the protocol fixtures the schedule tests
    explore.

The JAX package's tracer-hygiene checker (``TH``: jit-reachable JAX
code) has no counterpart here: the port traces nothing.

This ``__init__`` stays import-light on purpose: the serving hot path
imports :mod:`~llm_consensus_tpu_torch.analysis.sanitizer` at
construction time, and must not drag the lint framework (or anything
heavier) in with it.
"""
