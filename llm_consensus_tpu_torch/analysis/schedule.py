"""Deterministic cooperative schedule exploration (model checking).

The stack's thread protocols — batcher scheduler, handoff worker,
admission dequeue, governor tick, supervisor watchdog — are only ever
exercised by CI under whatever interleavings the OS scheduler happens to
produce; the chaos lanes widen the space by injecting faults, but the
*schedule* itself stays an uncontrolled input. This module makes it a
seeded, replayable one, the same contract ``LLMC_FAULTS`` gives fault
sequences:

  * Under an active :class:`session`, the sanitizer factories
    (``make_lock``/``make_rlock``/``make_condition``/``make_event``)
    hand out **cooperative** primitives, and ``threading.Thread.start``
    / ``join`` are intercepted for threads spawned by controlled
    threads. The process serializes onto ONE runnable thread at a time;
    every synchronization operation (plus explicit
    :func:`~llm_consensus_tpu_torch.analysis.sanitizer.sched_point` yields at
    the protocol seams) is a scheduling decision taken by a seeded
    random walk with **preemption bounding**: switches at blocking
    points (lock contention, condition/event waits, joins, spawns) are
    free, switches at non-blocking points spend one unit of the
    ``LLMC_SCHED_PREEMPTS`` budget — the CHESS observation that most
    concurrency bugs need only a handful of preemptions.
  * Timed waits are modeled, not slept: a thread in
    ``cond.wait(0.25)`` / ``event.wait(t)`` / ``lock.acquire(timeout=)``
    is *runnable via the timeout path* — scheduling it wakes it
    immediately — so the stack's pervasive bounded-wait polling loops
    explore both the notified and the timed-out arm without real time
    passing, and the schedule trace depends on nothing but the seed.
  * A failing schedule serializes to a compact **replay token**
    (:func:`encode_token`); ``LLMC_SCHED=replay:<token>`` (or
    :func:`replay`) reproduces the exact interleaving, and
    :func:`minimize` delta-debugs the token down to the fewest
    preemptions that still fail.
  * When every live thread is blocked the explored schedule IS a
    deadlock — :class:`DeadlockError` reports each thread's blocked
    resource and stack, no 120 s CI hang required. With
    ``LLMC_SCHED_RACE`` (default on) a
    :class:`~llm_consensus_tpu_torch.analysis.race.RaceDetector` rides the
    same hooks and checks happens-before over the ``# guarded by:``
    field inventory.

Scope rule: a session controls the thread that opened it plus every
thread transitively spawned by controlled threads; primitives built
through the factories *while a controlled thread runs* are cooperative.
Pre-session (module-level) factory locks stay plain — that is safe
because they are leaf locks: their critical sections contain no
scheduling point, so a controlled thread is never descheduled while
holding one and a plain acquire can never block on a descheduled owner.

Zero cost when inactive: the factories check one module global; the
``sched_point`` seams are a single global None-check.
"""

from __future__ import annotations

import random
import sys
import threading
import traceback
from typing import Callable, Iterable, Optional

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.utils import knobs

_RUNNABLE = "runnable"
_BLOCKED = "blocked"   # untimed: only an unblock makes it schedulable
_TIMED = "timed"       # timed wait: schedulable via the timeout path
_DONE = "done"


class SchedError(Exception):
    """Base for scheduler-detected failures."""


class DeadlockError(SchedError):
    """Every live thread is blocked — the explored schedule deadlocks.

    ``threads`` maps thread name -> (status, blocked_on, stack) for the
    report; the message carries a compact rendering."""

    def __init__(self, threads: dict):
        self.threads = threads
        lines = [
            f"  {name}: {status} on {what}"
            for name, (status, what, _stack) in sorted(threads.items())
        ]
        super().__init__(
            "deadlock: every live thread is blocked\n" + "\n".join(lines)
        )


class ScheduleBudget(SchedError):
    """The schedule exceeded LLMC_SCHED_STEPS scheduling decisions —
    either an unbounded fixture loop or a genuine livelock."""


class SchedulerKilled(BaseException):
    """Session-teardown poison injected into straggler threads; derives
    BaseException so fixture ``except Exception`` blocks can't eat it."""


class _TState:
    """One controlled thread's scheduling state. Mutated only by the
    token-holding thread (plus the gate handshake)."""

    __slots__ = (
        "tid", "name", "gate", "status", "blocked_on", "notified", "exc",
        "thread",
    )

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.gate = threading.Semaphore(0)
        self.status = _RUNNABLE
        self.blocked_on = None  # ("lock"|"cond"|"event"|"join"|"point", key)
        self.notified = False
        self.exc: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class Scheduler:
    """The cooperative scheduler for ONE explored schedule.

    Exactly one controlled thread runs at a time (it "holds the token");
    every scheduling decision appends one choice to ``trace``:
    ``0`` = stay on the current thread when it is runnable (else the
    first runnable, deterministically), ``k > 0`` = switch to the k-th
    *other* runnable thread. An all-zero / empty trace is therefore the
    maximally sequential schedule, and the number of nonzero entries at
    non-blocking points is the schedule's preemption count — exactly
    what :func:`minimize` shrinks."""

    def __init__(
        self,
        seed: int = 0,
        preempt_bound: Optional[int] = None,
        max_steps: Optional[int] = None,
        replay: Optional[list] = None,
        race=None,
        monitor=None,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        if preempt_bound is None:
            preempt_bound = knobs.sched_settings()["preempts"]
        if max_steps is None:
            max_steps = knobs.sched_settings()["steps"]
        self.preempts_left = preempt_bound
        self.max_steps = max_steps
        self.steps = 0
        self.trace: list = []
        self._replay = list(replay) if replay is not None else None
        self._rpos = 0
        self.race = race
        self.monitor = monitor
        self.errors: list = []
        self.poisoned = False
        self._order: list = []          # tids in registration order
        self._threads: dict = {}        # tid -> _TState
        self._by_ident: dict = {}       # threading ident -> _TState
        self._ident_mu = threading.Lock()  # _by_ident: child prologue writes
        self.current = 0
        self._next_tid = 0

    # -- registration ---------------------------------------------------------

    def adopt_current(self, name: str = "main") -> _TState:
        """Register the calling thread (the session opener) as tid 0."""
        st = self._new_state(name)
        st.thread = threading.current_thread()
        with self._ident_mu:
            self._by_ident[threading.get_ident()] = st
        self.current = st.tid
        return st

    def _new_state(self, name: str) -> _TState:
        tid = self._next_tid
        self._next_tid += 1
        st = _TState(tid, name)
        self._threads[tid] = st
        self._order.append(tid)
        return st

    def _state(self) -> _TState:
        with self._ident_mu:
            st = self._by_ident.get(threading.get_ident())
        if st is None:
            raise SchedError(
                "an uncontrolled thread touched a scheduler-mode primitive "
                "— spawn every toucher from a controlled thread"
            )
        return st

    def controls_current(self) -> bool:
        with self._ident_mu:
            return threading.get_ident() in self._by_ident

    def current_tid(self) -> Optional[int]:
        with self._ident_mu:
            st = self._by_ident.get(threading.get_ident())
        return st.tid if st is not None else None

    # -- the scheduling decision ----------------------------------------------

    def _runnable(self) -> list:
        return [
            self._threads[t]
            for t in self._order
            if self._threads[t].status in (_RUNNABLE, _TIMED)
        ]

    def _blocked_snapshot(self) -> dict:
        frames = sys._current_frames()
        out = {}
        for tid in self._order:
            st = self._threads[tid]
            if st.status == _DONE:
                continue
            ident = None
            if st.thread is not None:
                ident = st.thread.ident
            stack = ""
            if ident in frames:
                stack = "".join(traceback.format_stack(frames[ident], 8))
            out[f"{st.name}#{st.tid}"] = (st.status, st.blocked_on, stack)
        return out

    def _pick(self, st: _TState, runnable: list, free: bool) -> _TState:
        cur_ok = st in runnable
        if self._replay is not None:
            c = (
                self._replay[self._rpos]
                if self._rpos < len(self._replay)
                else 0
            )
            self._rpos += 1
            if cur_ok:
                if c == 0:
                    return st
                others = [t for t in runnable if t is not st]
                return others[(c - 1) % len(others)] if others else st
            return runnable[c % len(runnable)]
        if cur_ok:
            others = [t for t in runnable if t is not st]
            if not others:
                return st
            if not free and self.preempts_left <= 0:
                return st
            pick = self.rng.choice(runnable)
            if pick is not st and not free:
                self.preempts_left -= 1
            return pick
        return self.rng.choice(runnable) if len(runnable) > 1 else runnable[0]

    def _encode(self, pick: _TState, st: _TState, runnable: list) -> int:
        if st in runnable:
            if pick is st:
                return 0
            others = [t for t in runnable if t is not st]
            return others.index(pick) + 1
        return runnable.index(pick)

    def _switch(self, st: _TState, free: bool = True) -> None:
        """One scheduling decision, taken by the token-holding thread.
        ``st.status`` must already reflect why it yields (RUNNABLE for a
        voluntary point, BLOCKED/TIMED when it cannot proceed)."""
        self.steps += 1
        if self.steps > self.max_steps:
            raise ScheduleBudget(
                f"schedule exceeded {self.max_steps} scheduling decisions "
                f"(seed={self.seed}) — unbounded fixture loop or livelock"
            )
        runnable = self._runnable()
        if not runnable:
            raise DeadlockError(self._blocked_snapshot())
        pick = self._pick(st, runnable, free)
        self.trace.append(self._encode(pick, st, runnable))
        pick.status = _RUNNABLE
        if pick is st:
            return
        self.current = pick.tid
        pick.gate.release()
        st.gate.acquire()
        if self.poisoned:
            raise SchedulerKilled()

    def sched_point(self, tag: str = "") -> None:
        """A voluntary, budget-charged preemption opportunity — the
        explicit seam hook the protocol loops call."""
        st = self._state()
        st.status = _RUNNABLE
        self._switch(st, free=False)

    def _unblock(self, key) -> None:
        for tid in self._order:
            st = self._threads[tid]
            if st.status == _BLOCKED and st.blocked_on == key:
                st.status = _RUNNABLE

    # -- thread lifecycle -----------------------------------------------------

    def spawn(self, thread: threading.Thread, orig_start: Callable) -> None:
        parent = self._state()
        st = self._new_state(thread.name or f"t{self._next_tid}")
        st.thread = thread
        orig_run = thread.run

        def run():
            with self._ident_mu:
                self._by_ident[threading.get_ident()] = st
            st.gate.acquire()
            if self.poisoned:
                self._finish(st)
                return
            try:
                orig_run()
            except SchedulerKilled:
                pass
            except BaseException as exc:  # noqa: BLE001 — surfaced at exit
                st.exc = exc
                self.errors.append(exc)
            finally:
                self._finish(st)

        thread.run = run
        orig_start(thread)
        if self.race is not None:
            self.race.on_fork(parent.tid, st.tid)
        # Spawn is a free scheduling point: the child may run first,
        # exactly as a real scheduler might start it immediately.
        parent.status = _RUNNABLE
        self._switch(parent, free=True)

    def _finish(self, st: _TState) -> None:
        if self.poisoned:
            st.status = _DONE
            return
        st.status = _DONE
        if self.race is not None:
            self.race.on_thread_end(st.tid)
        self._unblock(("join", st.tid))
        runnable = self._runnable()
        if runnable:
            pick = self._pick(st, runnable, True)
            self.trace.append(self._encode(pick, st, runnable))
            pick.status = _RUNNABLE
            self.current = pick.tid
            pick.gate.release()
            return
        live = [
            t for t in self._order if self._threads[t].status != _DONE
        ]
        if live and not self.poisoned:
            self.errors.append(DeadlockError(self._blocked_snapshot()))
            self.poison()

    def join(self, thread: threading.Thread, timeout, orig_join) -> None:
        target = None
        for tid in self._order:
            if self._threads[tid].thread is thread:
                target = self._threads[tid]
                break
        st = self._state()
        if target is None or target is st:
            return orig_join(thread, timeout)
        while target.status != _DONE:
            if timeout is not None:
                st.status = _TIMED
                st.blocked_on = ("join", target.tid)
                self._switch(st, free=True)
                st.blocked_on = None
                if target.status != _DONE:
                    return  # modeled timeout: target still alive
                break
            st.status = _BLOCKED
            st.blocked_on = ("join", target.tid)
            self._switch(st, free=True)
            st.blocked_on = None
        # The OS thread is past _finish's token handoff; the real join
        # only reaps bootstrap epilogue and returns immediately.
        orig_join(thread, None)
        if self.race is not None:
            self.race.on_join(st.tid, target.tid)

    def poison(self) -> None:
        """Force-release every non-done thread; they raise
        :class:`SchedulerKilled` at their next scheduling point."""
        self.poisoned = True
        for tid in self._order:
            st = self._threads[tid]
            if st.status != _DONE:
                st.gate.release()

    # -- factory products -----------------------------------------------------

    def make_lock(self, name: str) -> "SchedLock":
        return SchedLock(name, self)

    def make_rlock(self, name: str) -> "SchedRLock":
        return SchedRLock(name, self)

    def make_condition(self, name: str, lock=None) -> "SchedCondition":
        if lock is None:
            lock = SchedLock(name, self)
        return SchedCondition(lock)

    def make_event(self, name: str) -> "SchedEvent":
        return SchedEvent(name, self)


def _effective_scheduler(prim) -> Optional[Scheduler]:
    """The scheduler ``prim`` should cooperate with, or None to use its
    real-threading fallback (no session, or uncontrolled thread).

    A primitive built in a PREVIOUS session (a lazily-created module
    singleton reused across schedules) is **rebound** to the active
    session at first touch: sessions join all their threads on exit, so
    no cooperative state survives an era change and adoption is sound —
    without it, a controlled thread polling a stale primitive would spin
    on real waits while holding the token and hang the explorer. The
    one case that stays degraded is a fallback half that is actually
    held (an uncontrolled thread mid-critical-section)."""
    s = prim._sched
    cur = sanitizer.scheduler()
    if cur is s:
        if s.poisoned:
            return None
        return s if s.controls_current() else None
    if cur is not None and not cur.poisoned and cur.controls_current():
        if prim._rebind(cur):
            return cur
    return None


def _poison_check(sched: Scheduler) -> None:
    """Mid-session poison (deadlock teardown): a CONTROLLED thread of
    the poisoned session must die at its next sync op — raising
    :class:`SchedulerKilled` to unwind — never proceed into a
    real-threading fallback it could block on."""
    if (
        sched.poisoned
        and sanitizer.scheduler() is sched
        and sched.controls_current()
    ):
        raise SchedulerKilled()


def _stale_era_yield(sched: Scheduler) -> None:
    """A controlled thread of the ACTIVE session operating a stale-era
    primitive (built in a previous schedule, e.g. a lazily-created
    module singleton) is about to block/poll on a REAL primitive while
    holding the token. Yield first (free — it is a blocking point) so
    the schedule keeps circulating and a genuinely stuck degraded loop
    dies at ScheduleBudget instead of hanging the process — the CI-hang
    class this module exists to eliminate."""
    cur = sanitizer.scheduler()
    if cur is None or cur is sched or not cur.controls_current():
        return
    st = cur._state()
    st.status = _RUNNABLE
    cur._switch(st, free=True)


class SchedLock:
    """Cooperative non-reentrant lock: state is plain fields — only the
    token holder ever touches them — and contention is modeled through
    the scheduler, so a timed acquire explores both outcomes without
    sleeping. Feeds the installed :class:`~.sanitizer.LockMonitor` and
    race detector exactly like the live SanLock.

    Era degradation: a primitive can outlive its session (a module
    first imported inside a session binds factory locks into module
    globals). Every operation resolves the *effective* scheduler: when
    this lock's session is no longer the active one — or the calling
    thread is not controlled — the operation degrades to a real
    ``threading`` fallback primitive, so post-session use keeps real
    mutual exclusion instead of dead cooperative state."""

    _llmc_instrumented = True
    _reentrant = False

    def __init__(self, name: str, sched: Scheduler):
        self.name = name
        self._sched = sched
        self._owner: Optional[int] = None
        self._fallback = self._make_fallback()

    def _make_fallback(self):
        return threading.Lock()

    def _live(self) -> Optional[Scheduler]:
        return _effective_scheduler(self)

    def _rebind(self, cur: Scheduler) -> bool:
        probe = getattr(self._fallback, "locked", None)
        if probe is not None and probe():
            return False  # the real half is mid-critical-section
        self._sched = cur
        self._owner = None
        return True

    def _fallback_acquire(self, blocking: bool, timeout) -> bool:
        _stale_era_yield(self._sched)
        if timeout is not None and timeout >= 0:
            return self._fallback.acquire(blocking, timeout)
        return self._fallback.acquire(blocking)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _poison_check(self._sched)
        if self._live() is None:
            return self._fallback_acquire(blocking, timeout)
        sched = self._sched  # _live() may have rebound a stale era
        st = sched._state()
        # Pre-acquire preemption opportunity: the window where
        # check-then-act atomicity violations live.
        st.status = _RUNNABLE
        sched._switch(st, free=False)
        # NOTE: owner == self blocks too — a non-reentrant lock
        # re-acquired by its owner is a self-deadlock on the real
        # threading.Lock, and the model checker must see it, not mask
        # it (SchedRLock handles reentrancy before reaching here).
        while self._owner is not None:
            if not blocking:
                return False
            if timeout is not None and timeout >= 0:
                st.status = _TIMED
                st.blocked_on = ("lock", id(self))
                sched._switch(st, free=True)
                st.blocked_on = None
                if self._owner is not None:
                    return False  # modeled timeout
                continue
            st.status = _BLOCKED
            st.blocked_on = ("lock", id(self))
            sched._switch(st, free=True)
            st.blocked_on = None
        self._owner = st.tid
        self._on_acquired(st, reacquire=False)
        return True

    def _on_acquired(self, st: _TState, reacquire: bool) -> None:
        mon = self._sched.monitor
        if mon is not None:
            if reacquire:
                mon.on_reacquire(self)
            else:
                mon.on_acquire(self)
        det = self._sched.race
        if det is not None:
            det.on_acquire(st.tid, id(self))

    def release(self) -> None:
        if self._live() is None:
            # Degraded era, or a poisoned thread unwinding through its
            # ``with`` blocks from wherever it was parked: release
            # whichever half is actually held; nothing cooperative left
            # to keep consistent.
            try:
                self._fallback.release()
            except RuntimeError:
                self._owner = None
            return
        sched = self._sched  # _live() may have rebound a stale era
        st = sched._state()
        if self._owner != st.tid:
            raise RuntimeError(f"release of un-owned lock {self.name}")
        det = sched.race
        if det is not None:
            det.on_release(st.tid, id(self))
        mon = sched.monitor
        if mon is not None:
            mon.on_release(self)
        self._owner = None
        sched._unblock(("lock", id(self)))

    def locked(self) -> bool:
        if self._owner is not None:
            return True
        probe = getattr(self._fallback, "locked", None)
        return bool(probe()) if probe is not None else False

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition-protocol internals (wait-side release/reacquire): no
    # pre-acquire yield, no fresh order edges — the reacquire is forced
    # by the wait protocol, not a code-chosen lock ordering.

    def _release_for_wait(self, st: _TState) -> None:
        det = self._sched.race
        if det is not None:
            det.on_release(st.tid, id(self))
        mon = self._sched.monitor
        if mon is not None:
            mon.on_release(self)
        self._owner = None
        self._sched._unblock(("lock", id(self)))

    def _reacquire_after_wait(self, st: _TState) -> None:
        sched = self._sched
        while self._owner is not None and self._owner != st.tid:
            st.status = _BLOCKED
            st.blocked_on = ("lock", id(self))
            sched._switch(st, free=True)
            st.blocked_on = None
        self._owner = st.tid
        self._on_acquired(st, reacquire=True)


class SchedRLock(SchedLock):
    """Cooperative reentrant lock; only the outermost pair touches the
    monitor/detector, mirroring SanRLock."""

    _reentrant = True

    def __init__(self, name: str, sched: Scheduler):
        super().__init__(name, sched)
        self._depth = 0

    def _make_fallback(self):
        return threading.RLock()

    def _rebind(self, cur: Scheduler) -> bool:
        # RLock fallbacks expose no held-probe: stay degraded (safe,
        # just unmodeled) rather than risk adopting a held lock.
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._live() is None:
            return super().acquire(blocking, timeout)  # fallback RLock
        st = self._sched._state()
        if self._owner == st.tid:
            self._depth += 1
            return True
        ok = super().acquire(blocking, timeout)
        if ok:
            self._depth = 1
        return ok

    def release(self) -> None:
        if self._live() is None:
            return super().release()
        st = self._sched._state()
        if self._owner != st.tid:
            raise RuntimeError(f"release of un-owned rlock {self.name}")
        self._depth -= 1
        if self._depth == 0:
            super().release()


class SchedCondition:
    """Cooperative condition over a :class:`SchedLock`. Wait parks the
    thread (untimed: until notify; timed: schedulable via the timeout
    path), releases/reacquires the lock with wait-protocol bookkeeping,
    and notify⇒wake is an explicit happens-before edge for the race
    detector — the sound form of the contract the live
    :class:`~.sanitizer.SanCondition` implements."""

    _llmc_instrumented = True

    def __init__(self, lock: SchedLock):
        self._lock = lock
        self.name = lock.name
        self._waiters: list = []  # tids, FIFO — valid for self._era only
        self._era: Optional[Scheduler] = lock._sched
        self._fallback_cond: Optional[threading.Condition] = None

    def _fallback(self) -> threading.Condition:
        # Degraded era: a real Condition over the lock's fallback
        # primitive (cooperative waiters and real waiters can never
        # coexist — eras change only between schedules).
        if self._fallback_cond is None:
            self._fallback_cond = threading.Condition(self._lock._fallback)
        return self._fallback_cond

    # lock protocol delegation -------------------------------------------------

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def __enter__(self):
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)

    # condition protocol -------------------------------------------------------

    def _era_check(self, sched: Scheduler) -> None:
        # Waiter tids are meaningless across sessions (small ints
        # recycle): clear them when the backing lock changed era.
        if self._era is not sched:
            self._waiters.clear()
            self._era = sched

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._lock._live() is None:
            sched = self._lock._sched
            _poison_check(sched)
            _stale_era_yield(sched)
            return self._fallback().wait(timeout)
        sched = self._lock._sched
        if sched.poisoned:
            raise SchedulerKilled()
        self._era_check(sched)
        st = sched._state()
        if self._lock._owner != st.tid:
            raise RuntimeError("cannot wait on un-acquired condition")
        st.notified = False
        self._waiters.append(st.tid)
        self._lock._release_for_wait(st)
        st.status = _BLOCKED if timeout is None else _TIMED
        st.blocked_on = ("cond", id(self))
        sched._switch(st, free=True)
        st.blocked_on = None
        got = st.notified
        if st.tid in self._waiters:
            self._waiters.remove(st.tid)
        if got and sched.race is not None:
            sched.race.on_wake(st.tid, id(self))
        self._lock._reacquire_after_wait(st)
        return got or timeout is None

    def notify(self, n: int = 1) -> None:
        if self._lock._live() is None:
            try:
                self._fallback().notify(n)
            except RuntimeError:
                pass  # degraded notifier without the fallback lock held
            return
        sched = self._lock._sched
        if sched.poisoned:
            return
        self._era_check(sched)
        st = sched._state()
        if self._lock._owner != st.tid:
            raise RuntimeError("cannot notify on un-acquired condition")
        if sched.race is not None and self._waiters:
            sched.race.on_notify(st.tid, id(self))
        for tid in self._waiters[:n]:
            w = sched._threads[tid]
            w.notified = True
            if w.status in (_BLOCKED, _TIMED) and w.blocked_on == (
                "cond", id(self)
            ):
                w.status = _RUNNABLE
        del self._waiters[:n]

    def notify_all(self) -> None:
        if self._lock._live() is None:
            try:
                self._fallback().notify_all()
            except RuntimeError:
                pass
            return
        self.notify(len(self._waiters))


class SchedEvent:
    """Cooperative event: ``set`` unblocks waiters and is a
    happens-before source; timed waits are schedulable via the timeout
    path so stop-event polling loops (`while not stop.wait(s)`) explore
    without sleeping."""

    _llmc_instrumented = True

    def __init__(self, name: str, sched: Scheduler):
        self.name = name
        self._sched = sched
        # The real Event IS the flag (single source of truth across
        # eras); the cooperative layer adds unblocking + HB edges.
        self._flag = threading.Event()

    def _live(self) -> Optional[Scheduler]:
        return _effective_scheduler(self)

    def _rebind(self, cur: Scheduler) -> bool:
        self._sched = cur  # the flag lives in the real Event — safe
        return True

    def is_set(self) -> bool:
        return self._flag.is_set()

    def set(self) -> None:
        sched = self._live()
        self._flag.set()
        if sched is None:
            return
        st = sched._state()
        if sched.race is not None:
            sched.race.on_notify(st.tid, id(self))
        sched._unblock(("event", id(self)))

    def clear(self) -> None:
        self._flag.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._live()
        if sched is None:
            s = self._sched
            _poison_check(s)
            _stale_era_yield(s)
            return self._flag.wait(timeout)
        st = sched._state()
        st.status = _RUNNABLE
        sched._switch(st, free=True)
        while not self._flag.is_set():
            if timeout is not None:
                st.status = _TIMED
                st.blocked_on = ("event", id(self))
                sched._switch(st, free=True)
                st.blocked_on = None
                if not self._flag.is_set():
                    return False  # modeled timeout
                break
            st.status = _BLOCKED
            st.blocked_on = ("event", id(self))
            sched._switch(st, free=True)
            st.blocked_on = None
        if sched.race is not None:
            sched.race.on_wake(st.tid, id(self))
        return True


# -- session ------------------------------------------------------------------


class session:
    """Context manager arming one cooperative schedule.

    Installs the scheduler into the sanitizer factories, intercepts
    ``Thread.start``/``join``, installs a fresh
    :class:`~.sanitizer.LockMonitor` (so lock-order cycles are reported
    per schedule too) and — with ``race=True`` — attaches a
    :class:`~.race.RaceDetector` over the guarded-field inventory. On
    exit, straggler threads are poisoned and any error a child thread
    recorded (assertion, deadlock, race) is re-raised in the opener."""

    def __init__(
        self,
        seed: int = 0,
        preempt_bound: Optional[int] = None,
        max_steps: Optional[int] = None,
        replay: Optional[list] = None,
        race: bool = False,
        instrument: Iterable = (),
    ):
        from llm_consensus_tpu_torch.analysis.sanitizer import LockMonitor

        self._race_on = race
        self._instrument = tuple(instrument)
        self.detector = None
        if race:
            from llm_consensus_tpu_torch.analysis import race as race_mod

            self.detector = race_mod.RaceDetector()
        self.sched = Scheduler(
            seed=seed,
            preempt_bound=preempt_bound,
            max_steps=max_steps,
            replay=replay,
            race=self.detector,
            monitor=LockMonitor(),
        )
        self._orig_start = None
        self._orig_join = None
        self._prev_monitor = None

    def __enter__(self) -> Scheduler:
        if sanitizer.scheduler() is not None:
            raise SchedError("schedule sessions do not nest")
        sched = self.sched
        sched.adopt_current()
        if self.detector is not None:
            from llm_consensus_tpu_torch.analysis import race as race_mod

            self.detector.tid_fn = sched.current_tid
            race_mod.attach(self.detector, extra=self._instrument)
        self._prev_monitor = sanitizer.monitor()
        sanitizer.install(sched.monitor)
        self._orig_start = threading.Thread.start
        self._orig_join = threading.Thread.join
        orig_start, orig_join = self._orig_start, self._orig_join

        def patched_start(thread):
            if sanitizer.scheduler() is sched and sched.controls_current():
                return sched.spawn(thread, orig_start)
            return orig_start(thread)

        def patched_join(thread, timeout=None):
            if sanitizer.scheduler() is sched and sched.controls_current():
                return sched.join(thread, timeout, orig_join)
            return orig_join(thread, timeout)

        threading.Thread.start = patched_start
        threading.Thread.join = patched_join
        sanitizer.set_scheduler(sched)
        return sched

    def __exit__(self, exc_type, exc, tb):
        sched = self.sched
        sanitizer.set_scheduler(None)
        threading.Thread.start = self._orig_start
        threading.Thread.join = self._orig_join
        sanitizer.install(self._prev_monitor)
        sched.poison()
        for tid in sched._order:
            t = sched._threads[tid].thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5)
        if self.detector is not None:
            from llm_consensus_tpu_torch.analysis import race as race_mod

            race_mod.detach()
        # Error precedence: a recorded child/deadlock error explains a
        # SchedulerKilled unwinding through the opener; body exceptions
        # otherwise win; detector races fail an otherwise-clean run.
        if exc is not None and isinstance(exc, SchedulerKilled):
            if sched.errors:
                raise sched.errors[0] from None
            return False
        if exc is not None:
            return False
        if sched.errors:
            raise sched.errors[0]
        if self.detector is not None and self.detector.races:
            from llm_consensus_tpu_torch.analysis import race as race_mod

            raise race_mod.RaceError(self.detector.races)
        return False


# -- replay tokens ------------------------------------------------------------


def encode_token(trace: list) -> str:
    """Compact, printable form of one schedule's choice list. Hex chars
    while every choice fits a nibble (the overwhelming case: choices are
    indices into the runnable set), dot-separated decimals otherwise."""
    if all(0 <= c < 16 for c in trace):
        return "x" + "".join(format(c, "x") for c in trace)
    return "d" + ".".join(str(c) for c in trace)


def decode_token(token: str) -> list:
    if not token or token[0] not in "xd":
        raise ValueError(f"bad schedule replay token {token!r}")
    if token[0] == "x":
        return [int(ch, 16) for ch in token[1:]]
    return [int(p) for p in token[1:].split(".") if p]


# -- exploration --------------------------------------------------------------


class ScheduleFailure:
    """One failing explored schedule: the error, its replay token, and
    where in the matrix it was found."""

    def __init__(self, exc: BaseException, token: str, seed: int,
                 index: int):
        self.exc = exc
        self.token = token
        self.seed = seed
        self.index = index

    def __repr__(self):
        return (
            f"ScheduleFailure({type(self.exc).__name__}: {self.exc}; "
            f"seed={self.seed} schedule={self.index} "
            f"replay=LLMC_SCHED=replay:{self.token})"
        )


class ExploreResult:
    def __init__(self, schedules_run: int, failure: Optional[ScheduleFailure],
                 traces: Optional[list] = None):
        self.schedules_run = schedules_run
        self.failure = failure
        self.traces = traces or []

    @property
    def failed(self) -> bool:
        return self.failure is not None


def _run_one(
    body: Callable, *, seed: int = 0, replay=None, race: bool = True,
    preempt_bound=None, max_steps=None, instrument=(),
) -> list:
    """One schedule; returns the trace, raising the schedule's failure
    (with the trace-so-far attached as ``exc._llmc_trace`` so explorers
    can mint the replay token)."""
    sess = session(
        seed=seed, replay=replay, race=race, preempt_bound=preempt_bound,
        max_steps=max_steps, instrument=instrument,
    )
    try:
        with sess:
            body()
    except Exception as exc:
        try:
            exc._llmc_trace = list(sess.sched.trace)
        except Exception:  # noqa: BLE001 — slots/frozen exceptions
            pass
        raise
    return list(sess.sched.trace)


def explore(
    body: Callable,
    schedules: int = 64,
    seed: int = 0,
    race: Optional[bool] = None,
    preempt_bound: Optional[int] = None,
    max_steps: Optional[int] = None,
    instrument: Iterable = (),
    keep_traces: bool = False,
    deadline: Optional[float] = None,
) -> ExploreResult:
    """Run ``body`` under up to ``schedules`` seeded schedules
    (``seed``, ``seed+1``, …), stopping at the first failure (any
    exception out of the body, a detected deadlock, a race, a child
    thread's assertion). Deterministic: the same arguments produce the
    same traces and the same finding. ``deadline`` (``time.monotonic``
    value) bounds wall clock for CI matrices."""
    import time

    if race is None:
        race = knobs.sched_settings()["race"]
    traces: list = []
    for i in range(schedules):
        if deadline is not None and time.monotonic() >= deadline:
            return ExploreResult(i, None, traces)
        s = seed + i
        trace: list = []
        try:
            trace = _run_one(
                body, seed=s, race=race, preempt_bound=preempt_bound,
                max_steps=max_steps, instrument=instrument,
            )
            if keep_traces:
                traces.append(trace)
        except Exception as exc:  # noqa: BLE001 — the finding
            token = encode_token(getattr(exc, "_llmc_trace", None) or trace)
            return ExploreResult(
                i + 1, ScheduleFailure(exc, token, s, i), traces
            )
    return ExploreResult(schedules, None, traces)


def replay(body: Callable, token: str, race: bool = True, **kw):
    """Re-run ``body`` under the exact interleaving ``token`` encodes.
    Returns normally when the schedule passes; raises its failure."""
    _run_one(body, replay=decode_token(token), race=race, **kw)


def minimize(
    body: Callable,
    token: str,
    max_trials: int = 64,
    race: bool = True,
    **kw,
) -> str:
    """Delta-debug a failing schedule down to fewer preemption points.

    A choice of 0 means "stay on the current thread" and replay pads an
    exhausted token with zeros, so minimization = zeroing nonzero
    choices (ddmin over their positions) + dropping the all-zero tail.
    Every trial re-executes ``body``; the oracle is "still raises".
    Returns the smallest failing token found (possibly the input).
    ``**kw`` forwards to each trial run like :func:`replay` — a failure
    found with ``explore(..., instrument=...)`` needs the same
    ``instrument=`` here or no trial reproduces and minimization
    silently returns the input token."""

    def fails(choices: list) -> bool:
        try:
            _run_one(body, replay=choices, race=race, **kw)
        except Exception:  # noqa: BLE001 — any failure reproduces
            return True
        return False

    choices = decode_token(token)
    while choices and choices[-1] == 0:
        choices.pop()
    if not fails(choices):
        return token  # not reproducible under padding — keep verbatim
    trials = 0
    nz = [i for i, c in enumerate(choices) if c]
    gran = 2
    while nz and trials < max_trials:
        chunk = max(1, len(nz) // gran)
        progressed = False
        i = 0
        while i < len(nz) and trials < max_trials:
            drop = nz[i:i + chunk]
            trial = list(choices)
            for p in drop:
                trial[p] = 0
            while trial and trial[-1] == 0:
                trial.pop()
            trials += 1
            if fails(trial):
                choices = trial
                nz = [j for j, c in enumerate(choices) if c]
                progressed = True
                i = 0
                continue
            i += chunk
        if not progressed:
            if chunk == 1:
                break
            gran *= 2
    while choices and choices[-1] == 0:
        choices.pop()
    return encode_token(choices)


# -- harness entry points ------------------------------------------------------


def from_env():
    """Parse ``LLMC_SCHED``: ``None`` when unset, ``("replay", choices)``
    for ``replay:<token>``, else ``("seed", n)``."""
    spec = knobs.sched_settings()["spec"]
    if not spec:
        return None
    if spec.startswith("replay:"):
        return ("replay", decode_token(spec[len("replay:"):]))
    try:
        return ("seed", int(spec))
    except ValueError:
        raise ValueError(
            f"LLMC_SCHED={spec!r}: expected an integer seed or "
            "replay:<token>"
        ) from None


def check(body: Callable, schedules: int, instrument: Iterable = ()) -> None:
    """The ``@pytest.mark.schedules(n)`` engine: run ``body`` under n
    explored schedules (honoring ``LLMC_SCHED`` — a seed rebases the
    matrix, ``replay:<token>`` runs exactly one interleaving) and raise
    an AssertionError carrying the replay token on the first failure."""
    env = from_env()
    if env is not None and env[0] == "replay":
        _run_one(body, replay=env[1], instrument=instrument)
        return
    base = env[1] if env is not None else 0
    res = explore(body, schedules=schedules, seed=base,
                  instrument=instrument)
    if res.failed:
        f = res.failure
        raise AssertionError(
            f"schedule {f.index} (seed {f.seed}) failed: "
            f"{type(f.exc).__name__}: {f.exc}\n"
            f"reproduce with LLMC_SCHED=replay:{f.token}"
        ) from f.exc


__all__ = [
    "Scheduler", "SchedLock", "SchedRLock", "SchedCondition", "SchedEvent",
    "SchedError", "DeadlockError", "ScheduleBudget", "SchedulerKilled",
    "session", "explore", "replay", "minimize", "check",
    "encode_token", "decode_token", "from_env",
    "ScheduleFailure", "ExploreResult",
]
