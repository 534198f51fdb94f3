"""The port's deterministic schedule exploration and happens-before race
detection (``llm_consensus_tpu_torch/analysis/schedule.py``, ``race.py``),
held to ``tests/test_schedule.py`` case by case.

The explorer's contract, tested end to end over the port's sanitizer
factories: both planted-bug fixtures are FOUND within a bounded schedule
budget; the same seed gives the identical trace and finding; replay tokens
round-trip and minimize; the race detector flags an off-lock read, stays
silent under the lock and across notify⇒wake, and honors inline
suppressions; and the six protocol fixtures over the port's REAL classes
(admission, handoff, supervisor, scale-down, swap, quarantine) model-check
clean at the JAX test's schedule counts. The conftest's
``@pytest.mark.schedules`` hook drives the JAX explorer, whose cooperative
primitives reach only the JAX factories, so these tests call the port's
``schedule.check(fn, schedules=n)`` themselves. Last, the planted fixtures
fail at the same schedule index with the same replay token through both
packages' explorers.
"""

from __future__ import annotations

import threading

import pytest

from llm_consensus_tpu_torch.analysis import race, sanitizer, schedule
from llm_consensus_tpu_torch.analysis.protocols import (
    admission_preempt_vs_drain, handoff_crash_fallback, planted_atomicity,
    planted_deadlock, quarantine_vs_resident_stream,
    scale_down_vs_resident_stream, supervisor_restart_vs_submit,
    swap_vs_resident_stream,
)

BUDGET = 512  # the acceptance ceiling; findings land far under it


# ---------------------------------------------------------------------------
# planted bugs: detection within budget

def test_atomicity_violation_found_within_budget():
    res = schedule.explore(planted_atomicity, schedules=BUDGET, seed=0,
                           race=False)
    assert res.failed, "explorer missed the planted atomicity violation"
    assert res.schedules_run <= 64, (
        f"took {res.schedules_run} schedules — budget regression"
    )
    assert isinstance(res.failure.exc, AssertionError)
    assert "lost update" in str(res.failure.exc)


def test_deadlock_found_within_budget():
    res = schedule.explore(planted_deadlock, schedules=BUDGET, seed=0,
                           race=False)
    assert res.failed, "explorer missed the planted deadlock"
    assert res.schedules_run <= 64
    assert isinstance(res.failure.exc, schedule.DeadlockError)
    # The report names each blocked thread's resource.
    assert res.failure.exc.threads
    for _name, (status, what, _stack) in res.failure.exc.threads.items():
        assert status in ("blocked", "timed", "runnable")
        assert what is None or what[0] in ("lock", "cond", "event", "join")


# ---------------------------------------------------------------------------
# determinism + replay + minimization

def test_same_seed_same_trace_same_finding():
    a = schedule.explore(planted_atomicity, schedules=BUDGET, seed=0,
                         race=False)
    b = schedule.explore(planted_atomicity, schedules=BUDGET, seed=0,
                         race=False)
    assert a.failed and b.failed
    assert a.failure.token == b.failure.token
    assert a.failure.index == b.failure.index
    assert a.failure.seed == b.failure.seed
    # Different seed base explores a different prefix (usually a
    # different token) but still finds the bug within budget.
    c = schedule.explore(planted_atomicity, schedules=BUDGET, seed=1000,
                         race=False)
    assert c.failed


def test_passing_body_traces_are_deterministic():
    def body():
        lock = sanitizer.make_lock("fixture.t")
        out = []

        def worker():
            with lock:
                out.append(1)

        t = threading.Thread(target=worker)
        t.start()
        with lock:
            out.append(2)
        t.join()
        assert sorted(out) == [1, 2]

    a = schedule.explore(body, schedules=8, seed=3, race=False,
                         keep_traces=True)
    b = schedule.explore(body, schedules=8, seed=3, race=False,
                         keep_traces=True)
    assert not a.failed and not b.failed
    assert a.traces == b.traces
    assert len(a.traces) == 8


def test_replay_token_reproduces_failure():
    res = schedule.explore(planted_deadlock, schedules=BUDGET, seed=0,
                           race=False)
    assert res.failed
    with pytest.raises(schedule.DeadlockError):
        schedule.replay(planted_deadlock, res.failure.token, race=False)
    res2 = schedule.explore(planted_atomicity, schedules=BUDGET, seed=0,
                            race=False)
    with pytest.raises(AssertionError, match="lost update"):
        schedule.replay(planted_atomicity, res2.failure.token, race=False)


def test_token_encode_decode_round_trip():
    for trace in ([], [0, 1, 2, 15], [0] * 40, [3, 17, 0, 255], [16]):
        tok = schedule.encode_token(trace)
        assert schedule.decode_token(tok) == trace
    with pytest.raises(ValueError):
        schedule.decode_token("notatoken!")
    with pytest.raises(ValueError):
        schedule.decode_token("")


def test_minimize_reduces_preemptions_and_still_fails():
    res = schedule.explore(planted_atomicity, schedules=BUDGET, seed=0,
                           race=False)
    assert res.failed
    tok = schedule.minimize(planted_atomicity, res.failure.token,
                            race=False)
    orig_nz = sum(1 for c in schedule.decode_token(res.failure.token) if c)
    min_nz = sum(1 for c in schedule.decode_token(tok) if c)
    assert min_nz <= orig_nz
    assert len(tok) <= len(res.failure.token)
    with pytest.raises(AssertionError, match="lost update"):
        schedule.replay(planted_atomicity, tok, race=False)


def test_from_env_parsing(monkeypatch):
    monkeypatch.setenv("LLMC_SCHED", "")
    assert schedule.from_env() is None
    monkeypatch.setenv("LLMC_SCHED", "7")
    assert schedule.from_env() == ("seed", 7)
    monkeypatch.setenv("LLMC_SCHED", "replay:x012")
    assert schedule.from_env() == ("replay", [0, 1, 2])
    monkeypatch.setenv("LLMC_SCHED", "bogus")
    with pytest.raises(ValueError):
        schedule.from_env()


def test_check_raises_assertion_with_replay_token():
    with pytest.raises(AssertionError) as ei:
        schedule.check(planted_atomicity, schedules=BUDGET)
    assert "LLMC_SCHED=replay:" in str(ei.value)


def test_check_honors_replay_env(monkeypatch):
    res = schedule.explore(planted_deadlock, schedules=BUDGET, seed=0,
                           race=False)
    monkeypatch.setenv("LLMC_SCHED", f"replay:{res.failure.token}")
    with pytest.raises(schedule.DeadlockError):
        schedule.check(planted_deadlock, schedules=1)


# ---------------------------------------------------------------------------
# race detector

class _Gauge:
    """Planted race: write under lock, read without."""

    def __init__(self):
        self._lock = sanitizer.make_lock("fixture.gauge")
        self._v = 0  # guarded by: _lock

    def set(self, v):
        with self._lock:
            self._v = v

    def peek(self):
        return self._v  # off-lock read — the planted bug

    def peek_locked_properly(self):
        with self._lock:
            return self._v


def _gauge_writer_body(reader):
    def body():
        g = _Gauge()

        def w():
            g.set(7)

        t = threading.Thread(target=w)
        t.start()
        reader(g)
        t.join()

    return body


def test_race_detector_flags_off_lock_read():
    res = schedule.explore(
        _gauge_writer_body(lambda g: g.peek()), schedules=16, seed=0,
        race=True, instrument=[(_Gauge, {"_v"})],
    )
    assert res.failed
    assert isinstance(res.failure.exc, race.RaceError)
    r = res.failure.exc.races[0]
    assert r["label"] == "_Gauge._v"
    assert r["kind"] in ("write-read", "read-write", "write-write")
    # Both access sites land in THIS file.
    assert "test_torch_schedule" in r["site"][0]
    assert "test_torch_schedule" in r["prev_site"][0]


def test_minimize_and_replay_accept_instrument():
    """A failure found with ``explore(..., instrument=...)`` must carry
    the instrumentation through minimize/replay, or the ddmin oracle
    never reproduces and minimization silently no-ops."""
    body = _gauge_writer_body(lambda g: g.peek())
    inst = [(_Gauge, {"_v"})]
    res = schedule.explore(body, schedules=16, seed=0, race=True,
                           instrument=inst)
    assert res.failed
    mint = schedule.minimize(body, res.failure.token, race=True,
                             instrument=inst)
    with pytest.raises(race.RaceError):
        schedule.replay(body, mint, race=True, instrument=inst)


def test_race_detector_forgets_collected_objects():
    """``id()`` recycles: a collected object's stale write epoch must
    not alias onto a new object allocated at the same address (the
    new object's first access would false-positive)."""
    import gc

    tids = {"cur": 1}
    det = race.RaceDetector(tid_fn=lambda: tids["cur"])

    class Obj:
        pass

    o = Obj()
    oid = id(o)
    tids["cur"] = 2  # a second thread writes with no later HB edge
    det.on_write(o, "_v", ("f.py", 10), "Obj._v")
    assert (oid, "_v") in det._vars
    del o
    gc.collect()
    o2 = None
    hold = []  # keep misses alive so the allocator must reach o's slot
    for _ in range(10000):
        cand = Obj()
        if id(cand) == oid:
            o2 = cand
            break
        hold.append(cand)
    if o2 is None:
        pytest.skip("allocator did not recycle the id")
    tids["cur"] = 1
    det.on_read(o2, "_v", ("f.py", 20), "Obj._v")
    assert det.races == [], det.races


def test_race_detector_lock_protected_access_is_clean():
    res = schedule.explore(
        _gauge_writer_body(lambda g: g.peek_locked_properly()),
        schedules=32, seed=0, race=True, instrument=[(_Gauge, {"_v"})],
    )
    assert not res.failed, repr(res.failure)


def test_race_detector_notify_wake_edge_is_sound():
    """Condition handoff: consumer reads fields the producer wrote,
    ordered only by notify⇒wake + lock edges — must NOT be a race."""

    class Box:
        def __init__(self):
            self._lock = sanitizer.make_lock("fixture.box")
            self._cond = sanitizer.make_condition("fixture.box", self._lock)
            self._full = False  # guarded by: _lock
            self._item = None   # guarded by: _lock

        def put(self, v):
            with self._cond:
                self._item = v
                self._full = True
                self._cond.notify()

        def take(self):
            with self._cond:
                while not self._full:
                    self._cond.wait()
                v = self._item
                self._full = False
            return v

    def body():
        b = Box()
        out = []

        def consumer():
            out.append(b.take())

        t = threading.Thread(target=consumer)
        t.start()
        b.put(42)
        t.join()
        assert out == [42], out

    res = schedule.explore(body, schedules=64, seed=0, race=True,
                           instrument=[(Box, {"_full", "_item"})])
    assert not res.failed, repr(res.failure)


def test_race_detector_inline_suppression():
    class Suppressed:
        def __init__(self):
            self._lock = sanitizer.make_lock("fixture.sup")
            self._v = 0  # guarded by: _lock

        def set(self, v):
            with self._lock:
                self._v = v

        def peek(self):
            return self._v  # race-ok deliberate monotone read

    def body():
        s = Suppressed()

        def w():
            s.set(1)

        t = threading.Thread(target=w)
        t.start()
        s.peek()
        t.join()

    res = schedule.explore(body, schedules=16, seed=0, race=True,
                           instrument=[(Suppressed, {"_v"})])
    assert not res.failed, repr(res.failure)


def test_race_inventory_covers_guarded_classes():
    inv = race.inventory()
    fields = inv[
        ("llm_consensus_tpu_torch.serve.admission", "AdmissionController")
    ]
    assert "_queue" in fields and "_draining" in fields
    assert ("llm_consensus_tpu_torch.engine.handoff", "KVHandoff") in inv


def test_live_race_detector_on_sanitizer_locks():
    """Live (non-scheduler) mode: SanLock acquire/release feed the
    detector, so an off-lock read after a real thread join (no HB edge
    in live mode) is flagged deterministically, while a lock-protected
    read is not."""
    prev = sanitizer.monitor()
    sanitizer.install(sanitizer.LockMonitor())
    det = race.RaceDetector()
    try:
        race.attach(det, extra=[(_Gauge, {"_v"})])
        # Live mode has no fork/join edges (no Thread interception), so
        # publish the __init__ writes through the lock before spawning.
        g = _Gauge()
        with g._lock:
            pass
        t = threading.Thread(target=lambda: g.set(5))
        t.start()
        t.join()
        g.peek()  # off-lock, never joined the worker's clock — racy
        assert len(det.races) == 1
        assert det.races[0]["label"] == "_Gauge._v"
        g2 = _Gauge()
        with g2._lock:
            pass
        t2 = threading.Thread(target=lambda: g2.set(6))
        t2.start()
        t2.join()
        g2.peek_locked_properly()  # joins the lock clock — ordered
        assert len(det.races) == 1  # no new race
    finally:
        race.detach()
        sanitizer.install(prev)


# ---------------------------------------------------------------------------
# cooperative primitives: modeled timeouts, events, budget

def test_event_polling_loop_explores_without_sleeping():
    def body():
        stop = sanitizer.make_event("fixture.stop")
        ticks = [0]

        def looper():
            while not stop.wait(0.25):
                ticks[0] += 1
                if ticks[0] > 100:
                    raise AssertionError("stop never observed")

        t = threading.Thread(target=looper)
        t.start()
        stop.set()
        t.join()

    res = schedule.explore(body, schedules=16, seed=0, race=False)
    assert not res.failed, repr(res.failure)


def test_timed_lock_acquire_models_both_outcomes():
    def body():
        lock = sanitizer.make_lock("fixture.timed")
        got = []

        def contender():
            got.append(lock.acquire(timeout=0.5))
            if got[-1]:
                lock.release()

        with lock:
            t = threading.Thread(target=contender)
            t.start()
            # hold while the contender races its timed acquire
        t.join()
        assert got[0] in (True, False)

    res = schedule.explore(body, schedules=24, seed=0, race=False)
    assert not res.failed, repr(res.failure)


def test_step_budget_catches_unbounded_loops():
    def body():
        stop = sanitizer.make_event("fixture.never")

        def looper():
            while not stop.wait(0.1):
                pass  # never stopped — livelock by construction

        t = threading.Thread(target=looper)
        t.start()
        t.join()  # untimed: the looper spins forever on modeled timeouts

    res = schedule.explore(body, schedules=1, seed=0, race=False,
                           max_steps=500)
    assert res.failed
    assert isinstance(res.failure.exc, schedule.ScheduleBudget)


def test_non_reentrant_self_acquire_is_a_deadlock():
    """Re-acquiring a non-reentrant lock you own is a guaranteed wedge
    on the real threading.Lock — the model checker must report it, not
    silently grant the lock."""

    def body():
        lock = sanitizer.make_lock("fixture.self")
        with lock:
            with lock:  # self-deadlock on a non-reentrant lock
                pass

    res = schedule.explore(body, schedules=4, seed=0, race=False)
    assert res.failed
    assert isinstance(res.failure.exc, schedule.DeadlockError)
    # Non-blocking and timed forms model the real semantics instead.
    def body2():
        lock = sanitizer.make_lock("fixture.self2")
        with lock:
            assert lock.acquire(blocking=False) is False
            assert lock.acquire(timeout=0.1) is False

    res2 = schedule.explore(body2, schedules=4, seed=0, race=False)
    assert not res2.failed, repr(res2.failure)


def test_live_rlock_feeds_race_detector_hb_edges():
    """SanRLock acquire/release must carry the lock-clock join, or
    every happens-before edge through an RLock is lost and correctly
    locked accesses false-positive."""
    prev = sanitizer.monitor()
    sanitizer.install(sanitizer.LockMonitor())
    det = race.RaceDetector()
    sanitizer.set_race_detector(det)
    try:
        class RGauge:
            def __init__(self):
                self._lock = sanitizer.make_rlock("fixture.rgauge")
                self._v = 0  # guarded by: _lock

        race.attach(det, extra=[(RGauge, {"_v"})])
        g = RGauge()
        with g._lock:
            pass  # publish init writes through the rlock clock
        def w():
            with g._lock:
                with g._lock:  # reentrant: outermost pair only
                    g._v = 5
        t = threading.Thread(target=w)
        t.start()
        t.join()
        with g._lock:
            _ = g._v  # joins the rlock clock — ordered, no race
        assert det.races == [], det.races
    finally:
        race.detach()
        sanitizer.set_race_detector(None)
        sanitizer.install(prev)


def test_rlock_reentrancy_under_scheduler():
    def body():
        rl = sanitizer.make_rlock("fixture.rl")
        out = []

        def worker():
            with rl:
                with rl:  # reentrant
                    out.append(1)

        t = threading.Thread(target=worker)
        t.start()
        with rl:
            out.append(2)
        t.join()
        assert sorted(out) == [1, 2]

    res = schedule.explore(body, schedules=16, seed=0, race=False)
    assert not res.failed, repr(res.failure)


def test_scheduler_mode_assert_held_still_works():
    """assert_held integrates with the session's monitor: *_locked
    helpers keep their runtime guard under the model checker."""
    violations = []

    def body():
        lock = sanitizer.make_lock("fixture.ah")
        with lock:
            assert sanitizer.assert_held(lock)
        sanitizer.assert_held(lock)  # off-lock: records a violation
        mon = sanitizer.monitor()
        violations.append(len(mon.report()["violations"]))

    res = schedule.explore(body, schedules=1, seed=0, race=False)
    assert not res.failed, repr(res.failure)
    assert violations == [1]


# ---------------------------------------------------------------------------
# live SanCondition bookkeeping (the wait/notify fix)

def test_san_condition_wait_mints_no_fresh_edges():
    """The wait-reacquire re-enters the held stack without recording
    (held → acquired) edges: across a notify/wake cycle under an outer
    lock, the edge set is exactly what the FIRST acquisition recorded,
    and the held stack stays exact (release after wait works)."""
    prev = sanitizer.monitor()
    mon = sanitizer.LockMonitor()
    sanitizer.install(mon)
    try:
        outer = sanitizer.make_lock("test.outer")
        inner = sanitizer.make_lock("test.inner")
        cond = sanitizer.make_condition("test.inner", inner)
        assert isinstance(cond, sanitizer.SanCondition)
        state = {"go": False}

        def waiter():
            with outer:
                with cond:
                    edges_before = len(mon.report()["edges"])
                    while not state["go"]:
                        cond.wait(timeout=5)
                    # Reacquire happened; no new ordering edges minted.
                    assert len(mon.report()["edges"]) == edges_before
                    assert mon.holds(inner)
                assert mon.holds(outer)

        t = threading.Thread(target=waiter)
        t.start()
        import time

        time.sleep(0.05)
        with cond:
            state["go"] = True
            cond.notify()
        t.join(timeout=5)
        assert not t.is_alive()
        rep = mon.report()
        # Exactly the one programmer-chosen ordering: outer → inner.
        assert ("test.outer", "test.inner") in [tuple(e) for e in rep["edges"]]
        assert not rep["cycles"]
        assert not rep["violations"]
    finally:
        sanitizer.install(prev)


def test_san_condition_notify_wake_feeds_live_detector():
    prev = sanitizer.monitor()
    sanitizer.install(sanitizer.LockMonitor())
    det = race.RaceDetector()
    sanitizer.set_race_detector(det)
    try:
        lock = sanitizer.make_lock("test.pc")
        cond = sanitizer.make_condition("test.pc", lock)
        ready = []

        def waiter():
            with cond:
                got = cond.wait(timeout=5)
                ready.append(got)

        t = threading.Thread(target=waiter)
        t.start()
        import time

        time.sleep(0.05)
        with cond:
            cond.notify()
        t.join(timeout=5)
        assert ready == [True]
        # The notify recorded a sync clock for this condition; the wake
        # joined it (observable: the sync entry exists).
        assert id(cond) in det._sync
    finally:
        sanitizer.set_race_detector(None)
        sanitizer.install(prev)


# ---------------------------------------------------------------------------
# real protocol fixtures, through the port's schedule.check

def test_admission_protocol_model_checked():
    schedule.check(admission_preempt_vs_drain, schedules=20)


def test_handoff_protocol_model_checked():
    schedule.check(handoff_crash_fallback, schedules=20)


def test_supervisor_protocol_model_checked():
    schedule.check(supervisor_restart_vs_submit, schedules=10)


def test_scale_down_protocol_model_checked():
    schedule.check(scale_down_vs_resident_stream, schedules=20)


def test_swap_protocol_model_checked():
    schedule.check(swap_vs_resident_stream, schedules=20)


def test_quarantine_protocol_model_checked():
    schedule.check(quarantine_vs_resident_stream, schedules=20)


# ---------------------------------------------------------------------------
# parity with the JAX explorer on the planted fixtures

@pytest.mark.parametrize("name", ["planted-atomicity", "planted-deadlock"])
@pytest.mark.parametrize("seed", [0, 7])
def test_planted_failures_match_the_jax_explorer(name, seed):
    """One seed, one planted fixture: both packages' explorers fail at the
    same schedule index with the same replay token (the walk and the token
    format are the JAX ones)."""
    from llm_consensus_tpu.analysis import protocols as jax_protocols
    from llm_consensus_tpu.analysis import schedule as jax_schedule
    from llm_consensus_tpu_torch.analysis.protocols import PLANTED

    port = schedule.explore(PLANTED[name], schedules=BUDGET, seed=seed, race=False)
    ref = jax_schedule.explore(jax_protocols.PLANTED[name], schedules=BUDGET, seed=seed,
                               race=False)
    assert port.failed and ref.failed
    assert (port.failure.index, port.failure.token) == (ref.failure.index, ref.failure.token)
    assert type(port.failure.exc).__name__ == type(ref.failure.exc).__name__
