"""Runtime concurrency sanitizer: instrumented locks + lock-order graph.

The static guarded-state checker (analysis/guarded_state.py) proves
lock *placement*; this module proves lock *ordering* at runtime. Under
``LLMC_SANITIZE=1`` the project's lock factories hand out instrumented
``Lock``/``RLock``/``Condition`` objects that record, per thread, which
named locks were held at every acquisition. Each (held → acquired) pair
becomes an edge in a process-wide lock-order graph; a cycle in that
graph is a potential deadlock (two threads interleaving the two edge
directions wedge forever — exactly the batcher ↔ KV pool ↔ handoff
inversion class the recovery supervisor can only restart its way out
of, never prevent). :func:`assert_held` additionally catches off-lock
guarded-field access at runtime — the dynamic complement of the static
``GS`` findings.

Zero-cost when disabled: the factories return plain ``threading``
primitives and :func:`assert_held` is a single global-None check, so
the serving hot path pays nothing. ``chip_smoke.py``'s ``sanitize``
phase runs the chaos and disaggregated serving paths on the card with
``LLMC_SANITIZE=1`` and consults :func:`report` at the end, so the fault
plan doubles as a race harness: an injected crash drives the lock graph
through its recovery interleavings with the sanitizer watching.

Nothing here raises on a violation by default — a sanitizer that kills
the process mid-wave hides every later violation of the same run.
Violations and cycles accumulate in the monitor; harness code asserts
:func:`report`'s ``cycles`` / ``violations`` are empty at the end of a run.

The factories are also the seam for **deterministic schedule
exploration** (analysis/schedule.py): inside an active schedule
session they hand out cooperative primitives instead, and
:func:`sched_point` — a single global None-check when no session is
active — marks the explicit yield points at the protocol seams
(batcher scheduler loop, handoff wave drain, admission dequeue,
governor tick, supervisor watchdog). A race detector
(analysis/race.py) can attach here too: instrumented locks/conditions
feed it acquire/release and notify⇒wake happens-before edges in live
(``LLMC_SANITIZE=1``) runs, the cooperative primitives feed the same
edges under the model checker.
"""

from __future__ import annotations

import threading
import traceback
from typing import Optional

from llm_consensus_tpu_torch.utils import knobs


class LockMonitor:
    """Process-wide acquisition-order graph over instrumented locks."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_name, acquired_name) -> first-observed site string
        self._edges: dict = {}
        self._locks: set = set()
        self.violations: list = []  # assert_held failures

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def on_acquire(self, lock: "SanLock") -> None:
        held = self._held()
        for h in held:
            if h.name == lock.name:
                continue  # same-name siblings (per-preset pools) share a rank
            edge = (h.name, lock.name)
            if edge not in self._edges:
                site = "".join(traceback.format_stack(limit=6)[:-2])[-400:]
                with self._mu:
                    self._edges.setdefault(edge, site)
        with self._mu:
            self._locks.add(lock.name)
        held.append(lock)

    def on_release(self, lock: "SanLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def holds(self, lock: "SanLock") -> bool:
        return any(h is lock for h in self._held())

    # -- condition-wait reacquisition -----------------------------------------
    # A waiter's lock reacquisition is forced by the wait protocol, not
    # a code-chosen acquisition order: booking it through on_acquire
    # would mint (held → acquired) edges whose first-observed site is a
    # Condition.wait frame — useless for diagnosing the REAL ordering
    # decision — so the reacquire re-enters the held stack directly.

    def begin_reacquire(self, lock: "SanLock") -> None:
        self._tls.reacquire = lock

    def end_reacquire(self, lock: "SanLock") -> None:
        self._tls.reacquire = None

    def reacquiring(self, lock: "SanLock") -> bool:
        return getattr(self._tls, "reacquire", None) is lock

    def on_reacquire(self, lock) -> None:
        self._held().append(lock)
        with self._mu:
            self._locks.add(lock.name)

    # -- reporting -----------------------------------------------------------

    def record_violation(self, what: str) -> None:
        site = "".join(traceback.format_stack(limit=8)[:-3])[-600:]
        with self._mu:
            self.violations.append({"what": what, "site": site})

    def cycles(self) -> list:
        """Every elementary cycle in the lock-order graph (as name
        lists) — a non-empty result is a potential-deadlock report."""
        with self._mu:
            edges = list(self._edges)
        graph: dict = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
        out: list = []
        seen_cycles: set = set()

        def dfs(node, path, on_path):
            for nxt in graph.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    continue
                dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(graph):
            dfs(start, [start], {start})
        return out

    def report(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            return {
                "locks": sorted(self._locks),
                "edges": sorted(self._edges),
                "edge_sites": dict(self._edges),
                "cycles": cycles,
                "violations": list(self.violations),
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._locks.clear()
            self.violations.clear()


class SanLock:
    """Instrumented non-reentrant lock (drop-in for threading.Lock).

    Also satisfies the lock protocol ``threading.Condition`` expects
    (acquire/release + context manager), so ``make_condition`` can wrap
    one — Condition's default ``_release_save``/``_acquire_restore``
    route through these instrumented methods and the monitor's held
    stack stays exact across ``wait()``.
    """

    _llmc_instrumented = True
    _reentrant = False

    def __init__(self, name: str, monitor: LockMonitor):
        self._inner = self._make_inner()
        self.name = name
        self._monitor = monitor

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._monitor.reacquiring(self):
                self._monitor.on_reacquire(self)
            else:
                self._monitor.on_acquire(self)
            det = _race_detector
            if det is not None:
                det.on_acquire(threading.get_ident(), id(self))
        return ok

    def release(self) -> None:
        det = _race_detector
        if det is not None:
            det.on_release(threading.get_ident(), id(self))
        self._monitor.on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class SanRLock(SanLock):
    """Instrumented reentrant lock: only the outermost acquire/release
    pair touches the monitor, so reentry never fabricates self-edges."""

    _reentrant = True

    def __init__(self, name: str, monitor: LockMonitor):
        super().__init__(name, monitor)
        self._depth = threading.local()

    def _make_inner(self):
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            d = getattr(self._depth, "n", 0)
            if d == 0:
                # Mirror SanLock.acquire exactly: the wait-reacquire
                # path must not mint order edges, and an attached race
                # detector needs the lock-clock join or every HB edge
                # through an RLock is lost (false-positive races).
                if self._monitor.reacquiring(self):
                    self._monitor.on_reacquire(self)
                else:
                    self._monitor.on_acquire(self)
                det = _race_detector
                if det is not None:
                    det.on_acquire(threading.get_ident(), id(self))
            self._depth.n = d + 1
        return ok

    def release(self) -> None:
        d = getattr(self._depth, "n", 1) - 1
        self._depth.n = d
        if d == 0:
            det = _race_detector
            if det is not None:
                det.on_release(threading.get_ident(), id(self))
            self._monitor.on_release(self)
        self._inner.release()


class SanCondition(threading.Condition):
    """Instrumented Condition over a :class:`SanLock`, with sound
    wait/notify bookkeeping:

      * the ``wait`` reacquisition re-enters the monitor's held stack
        via :meth:`LockMonitor.on_reacquire` instead of
        ``on_acquire`` — the reacquire is protocol-forced, not a
        code-chosen lock ordering, so it must neither mint order-graph
        edges nor claim an edge's first-observed site (which would
        point diagnosis at Condition.wait internals instead of the real
        acquisition);
      * ``notify``/``notify_all`` and a notified waiter's return are an
        explicit happens-before edge (notify ⇒ wake) for an attached
        race detector — in addition to the lock-clock join the
        reacquire performs, so the edge survives even a zero-length
        critical section on the notifier side.
    """

    def __init__(self, lock: SanLock, name: Optional[str] = None):
        super().__init__(lock)
        self.name = name or lock.name

    def wait(self, timeout: Optional[float] = None) -> bool:
        lk = self._lock
        mon = lk._monitor
        mon.begin_reacquire(lk)
        try:
            got = super().wait(timeout)
        finally:
            mon.end_reacquire(lk)
        det = _race_detector
        if det is not None and got:
            det.on_wake(threading.get_ident(), id(self))
        return got

    def notify(self, n: int = 1) -> None:
        det = _race_detector
        if det is not None:
            det.on_notify(threading.get_ident(), id(self))
        super().notify(n)


_monitor: Optional[LockMonitor] = None
_resolve_lock = threading.Lock()
_resolved = False

# Active cooperative scheduler (analysis/schedule.py session) — checked
# FIRST by every factory and by sched_point; None outside sessions, so
# the serving hot path pays one module-global None-check.
_scheduler = None

# Attached happens-before race detector (analysis/race.py) — consulted
# by live instrumented primitives; the cooperative primitives carry
# their own reference.
_race_detector = None


def set_scheduler(s) -> None:
    global _scheduler
    _scheduler = s


def scheduler():
    return _scheduler


def set_race_detector(d) -> None:
    global _race_detector
    _race_detector = d


def sched_point(tag: str = "") -> None:
    """Explicit schedule-exploration yield at a protocol seam. No-op
    (one global None-check) outside a schedule session; inside one, a
    budget-charged preemption opportunity for the seeded walk."""
    s = _scheduler
    if s is not None and s.controls_current():
        s.sched_point(tag)


def enabled() -> bool:
    """True when the process runs with LLMC_SANITIZE=1 (resolved once —
    flipping the env mid-process cannot leave half-instrumented locks)."""
    return monitor() is not None


def monitor() -> Optional[LockMonitor]:
    """The process-wide monitor, or None when sanitizing is off."""
    global _monitor, _resolved
    if not _resolved:
        with _resolve_lock:
            if not _resolved:
                if knobs.sanitize_enabled():
                    _monitor = LockMonitor()
                _resolved = True
    return _monitor


def install(m: Optional[LockMonitor]) -> None:
    """Install ``m`` as the process monitor (tests/harness). Affects
    locks created AFTER the call — construction-time binding, same as
    every other subsystem's zero-cost pattern."""
    global _monitor, _resolved
    with _resolve_lock:
        _monitor = m
        _resolved = True


def reset() -> None:
    """Forget the override; next :func:`monitor` re-reads the env."""
    global _monitor, _resolved
    with _resolve_lock:
        _monitor = None
        _resolved = False


# -- factories (the drop-in seam the serving modules use) --------------------


def make_lock(name: str):
    """threading.Lock, instrumented under LLMC_SANITIZE=1 and
    cooperative inside a schedule session. ``name`` is the lock's rank
    identity in the order graph — use one name per lock ROLE
    (``engine.batcher``, ``kv.pool``), not per instance, so same-role
    locks across presets share a rank."""
    s = _scheduler
    if s is not None and s.controls_current():
        return s.make_lock(name)
    m = monitor()
    return SanLock(name, m) if m is not None else threading.Lock()


def make_rlock(name: str):
    s = _scheduler
    if s is not None and s.controls_current():
        return s.make_rlock(name)
    m = monitor()
    return SanRLock(name, m) if m is not None else threading.RLock()


def make_condition(name: str, lock=None):
    """threading.Condition over ``lock`` (or a fresh lock named
    ``name``). Pass the SAME object the module also uses bare so the
    condition and the ``with self._lock`` sites share one rank."""
    s = _scheduler
    if s is not None and s.controls_current() and (
        # Only a SchedLock of THIS session can back a SchedCondition: a
        # SanLock (live-instrumented) or a stale prior-session SchedLock
        # must fall through to the real-Condition path, or the first
        # wait() would park the token-holding thread on a primitive the
        # scheduler cannot see.
        lock is None or getattr(lock, "_sched", None) is s
    ):
        return s.make_condition(name, lock)
    if lock is None:
        lock = make_lock(name)
    if isinstance(lock, SanLock):
        return SanCondition(lock, name)
    return threading.Condition(lock)


def make_event(name: str):
    """threading.Event, cooperative inside a schedule session (timed
    waits become schedulable timeout paths instead of real sleeps).
    Plain otherwise — events carry no lock rank, so the live sanitizer
    has nothing to record."""
    s = _scheduler
    if s is not None and s.controls_current():
        return s.make_event(name)
    return threading.Event()


def assert_held(lock) -> bool:
    """Record a violation when the calling thread does not hold ``lock``
    — the runtime form of the ``GS`` off-lock-access finding, called
    from ``*_locked`` helpers. No-op (True) when sanitizing is off or
    ``lock`` is an uninstrumented primitive; never raises."""
    m = _monitor
    if m is None:
        return True
    inner = getattr(lock, "_lock", lock)  # Condition → its lock
    if not getattr(inner, "_llmc_instrumented", False):
        return True
    if m.holds(inner):
        return True
    m.record_violation(f"off-lock access: {inner.name} not held")
    return False


def report() -> Optional[dict]:
    """The monitor's lock/edge/cycle/violation report (None when off)."""
    m = monitor()
    return m.report() if m is not None else None


def render_report(rep: dict) -> str:
    """Human-readable failure rendering: every cycle with the
    first-observed acquisition stack of EACH participating edge, so a
    inversion seen once on the card is diagnosable from the log alone."""
    lines: list = []
    sites = rep.get("edge_sites", {})
    for cyc in rep.get("cycles", []):
        lines.append("lock-order cycle: " + " -> ".join(cyc))
        for a, b in zip(cyc, cyc[1:]):
            site = sites.get((a, b)) or ""
            lines.append(f"  edge {a} -> {b} first acquired at:")
            lines.extend(
                "    " + ln for ln in site.rstrip().splitlines()[-6:]
            )
    for v in rep.get("violations", []):
        lines.append(f"violation: {v['what']}")
        lines.extend(
            "    " + ln for ln in v.get("site", "").rstrip().splitlines()[-6:]
        )
    return "\n".join(lines)


__all__ = [
    "LockMonitor", "SanLock", "SanRLock", "SanCondition", "enabled",
    "monitor", "install", "reset", "make_lock", "make_rlock",
    "make_condition", "make_event", "assert_held", "report",
    "render_report", "set_scheduler", "scheduler", "set_race_detector",
    "sched_point",
]
