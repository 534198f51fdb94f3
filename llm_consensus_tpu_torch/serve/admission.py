"""Admission control: a bounded PRIORITY queue in front of the engines (a
copy of ``llm_consensus_tpu/serve/admission.py``; its settings are
arguments, read from the environment by ``cli/serve.py``).

The gateway serves from a fixed pool of engine capacity (one continuous
batcher of ``max_batch`` slots per tpu preset), so concurrency must be
capped *before* requests reach the batcher — an unbounded fan-in would
queue inside the submit path where nothing can shed load, report depth,
or honor deadlines. :class:`AdmissionController` is that cap:

  * at most ``max_concurrency`` runs execute at once;
  * at most ``max_queue`` more may wait for a slot. Dequeue is
    **priority-ordered** (pressure/priority.py classes), not FIFO: a
    freed slot goes to the best-class waiter, with FIFO order inside a
    class, and a waiter's effective class improves by one step per
    ``age_s`` (``LLMC_PRESSURE_AGE_S``) waited — the aging bound that keeps the
    lowest class from starving under a sustained higher-class stream
    (a LOW waiter reaches HIGH effective class after 2×AGE_S).
  * beyond the queue bound the request is rejected immediately
    (:class:`QueueFull` → HTTP 429 + ``Retry-After``) — unless a
    strictly lower-class waiter is queued, in which case THAT waiter is
    bumped (shed with its own class's Retry-After) and the higher-class
    arrival takes its place: under a low-priority flood the high class
    keeps admitting instead of 429ing alongside it;
  * ``Retry-After`` is jittered AND class-scaled
    (:meth:`retry_after`): a shed wave re-admits high-priority clients
    first because they were told to come back sooner;
  * waiting is cooperative with the request's own deadline: a client
    whose budget expires while queued gets its context error, not a slot
    it can no longer use;
  * :meth:`begin_drain` flips the controller into drain mode — every new
    or queued request is rejected (:class:`Draining` → HTTP 503) while
    in-flight runs finish; :meth:`drain` blocks until the last slot
    releases. This is the SIGTERM path: stop admitting, finish what's
    running, then the process can exit with every run's data flushed.

Telemetry (obs/): every admitted request records a ``queue_wait`` span
(time from arrival to slot grant — ~0 when a slot was free) and an
``admit`` span covering the slot hold; rejected requests count into
``serve.rejected``. Fault injection (faults/, site ``serve``):
``queue_full`` forces a rejection, ``slow_admit@s=<secs>`` delays the
grant — both deterministic under a seeded plan.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from llm_consensus_tpu_torch.pressure.priority import PRIORITY_NORMAL
from llm_consensus_tpu_torch.utils.context import Context


class RetryLater(Exception):
    """Base for load-shed rejections; carries the HTTP shape."""

    status = 503

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QueueFull(RetryLater):
    """Queue at capacity — shed load now, retry later (HTTP 429)."""

    status = 429


class Draining(RetryLater):
    """The server is draining for shutdown (HTTP 503)."""

    status = 503


class ClientGone(Exception):
    """The queued request's client disconnected before a slot was granted.

    Not a :class:`RetryLater`: there is nobody left to send a status to.
    The gateway drops the request at dequeue time instead of spending an
    execution slot on an answer no one will read."""


class Ticket:
    """One granted admission slot; release exactly once."""

    def __init__(self, controller: "AdmissionController", t0_ns: int):
        self._controller = controller
        self._t0_ns = t0_ns
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._controller._release(self._t0_ns)

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _Waiter:
    """One queued admission request: its class, arrival order, and the
    bump flag a higher-class queue-full arrival may set."""

    __slots__ = ("priority", "seq", "t_enq", "bumped")

    def __init__(self, priority: int, seq: int, t_enq: float):
        self.priority = priority
        self.seq = seq
        self.t_enq = t_enq
        self.bumped = False


class AdmissionController:
    """Bounded-concurrency, priority-dequeued admission with drain."""

    def __init__(
        self,
        max_concurrency: int,
        max_queue: int = 16,
        retry_after_s: float = 1.0,
        age_s: float = 30.0,
        retry_spread: float = 0.5,
    ):
        if max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_concurrency = max_concurrency
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        # Aging: one effective class step per age_s waited — the
        # starvation bound for the lowest class (it reaches the top
        # class after (classes-1)×age_s in queue).
        self.age_s = max(1e-3, age_s)
        # Retry-After class spread: scale = 1 + (class − NORMAL)×spread,
        # floored — HIGH retries sooner than the flood that shed it.
        self.retry_spread = retry_spread
        # Jitter source for Retry-After: a 429/503 wave otherwise tells
        # every shed client the SAME retry instant, and they thundering-
        # herd the gateway in lockstep (whole wave sheds again, repeat).
        self._jitter = random.Random()
        # Controller state below is guarded by the condition; the
        # *_locked helpers run with it held.
        self._cond = threading.Condition()
        self._active = 0  # guarded by: _cond
        self._waiting = 0  # guarded by: _cond
        self._queue: list[_Waiter] = []  # guarded by: _cond
        self._seq = 0  # guarded by: _cond
        self._draining = False  # guarded by: _cond
        self.admitted = 0  # guarded by: _cond
        self.rejected = 0  # guarded by: _cond
        self.bumped = 0  # guarded by: _cond
        self.dropped_disconnected = 0  # guarded by: _cond
        # Zero-cost pattern (faults/, obs/): bound once at construction.
        from llm_consensus_tpu_torch import faults, obs

        self._faults = faults.plan()
        self._obs = obs.recorder()

    # -- admission -----------------------------------------------------------

    def retry_after(self, priority: Optional[int] = None) -> float:
        """One jittered Retry-After in [scale×base, 2×scale×base), where
        ``scale`` grows with the shed CLASS: the uniform spread
        de-synchronizes the wave, the class spread re-admits
        high-priority clients first. ``priority=None`` keeps the
        class-neutral scale (drain paths, non-request sheds)."""
        scale = 1.0
        if priority is not None:
            scale = max(
                0.25, 1.0 + (priority - PRIORITY_NORMAL) * self.retry_spread
            )
        return self.retry_after_s * scale * (1.0 + self._jitter.random())

    def _key(self, w: _Waiter, now: float):
        """Effective dequeue key: class minus one step per age_s waited,
        then arrival order — FIFO within a class, aged promotion across
        classes."""
        return (w.priority - int((now - w.t_enq) / self.age_s), w.seq)

    def _next_locked(self) -> Optional[_Waiter]:
        """The waiter the next free slot belongs to (bumped waiters are
        already shed — they only still sit in the list until their
        thread wakes)."""
        now = time.monotonic()
        best = None
        best_key = None
        for w in self._queue:
            if w.bumped:
                continue
            k = self._key(w, now)
            if best_key is None or k < best_key:
                best, best_key = w, k
        return best

    def _bump_victim_locked(self, priority: int) -> Optional[_Waiter]:
        """Queue-full arbitration: the WORST queued waiter of a strictly
        lower class than ``priority`` (max effective key), or None when
        the whole queue is at/above the arrival's class."""
        now = time.monotonic()
        victim = None
        victim_key = None
        for w in self._queue:
            if w.bumped or w.priority <= priority:
                continue
            k = self._key(w, now)
            if victim_key is None or k > victim_key:
                victim, victim_key = w, k
        return victim

    def admit(self, ctx: Optional[Context] = None, probe=None,
              priority: int = PRIORITY_NORMAL) -> Ticket:
        """Block until an execution slot is granted; returns its Ticket.

        Raises :class:`QueueFull` / :class:`Draining` for shed load, or
        the context's own error if the caller's deadline expires while
        queued. ``probe`` (when given) is polled while waiting and
        checked once more before the slot is taken: returning True means
        the request is dead on the client side (socket closed, no
        coalesced followers riding it) and :class:`ClientGone` is raised
        instead of granting a slot the answer can never reach.
        ``priority`` orders the dequeue (see the module docstring).
        """
        t0 = time.monotonic_ns()
        if self._faults is not None:
            fs = self._faults.fire("serve", phase="admit")
            if fs is not None and fs.kind == "queue_full":
                self._reject()
                raise QueueFull(
                    "injected queue_full: admission queue at capacity",
                    self.retry_after(priority),
                )
            if fs is not None and fs.kind == "slow_admit":
                time.sleep(float(fs.param("s", 0.5)))
        with self._cond:
            if self._draining:
                self._reject_locked()
                raise Draining("server is draining", self.retry_after())
            if self._active >= self.max_concurrency and (
                self._waiting >= self.max_queue
            ):
                # Priority-aware shed: a strictly lower-class waiter
                # yields its queue spot (bumped — it sheds with its OWN
                # class's Retry-After when its thread wakes) so the
                # higher class keeps admitting through a flood; with no
                # such waiter, shed the arrival.
                victim = self._bump_victim_locked(priority)
                if victim is None:
                    self._reject_locked()
                    raise QueueFull(
                        f"admission queue full "
                        f"({self._active} active, {self._waiting} queued)",
                        self.retry_after(priority),
                    )
                victim.bumped = True
                self.bumped += 1
                if self._obs is not None:
                    self._obs.count("serve.bumped")
                self._cond.notify_all()
            self._seq += 1
            w = _Waiter(priority, self._seq, time.monotonic())
            self._queue.append(w)
            self._waiting += 1
            try:
                while True:
                    if self._draining:
                        self._reject_locked()
                        raise Draining(
                            "server is draining", self.retry_after()
                        )
                    if w.bumped:
                        self._reject_locked()
                        raise QueueFull(
                            "bumped from the admission queue by a "
                            "higher-priority arrival",
                            self.retry_after(priority),
                        )
                    if probe is not None and probe():
                        self._drop_locked()
                        raise ClientGone(
                            "client disconnected while queued for a slot"
                        )
                    if (
                        self._active < self.max_concurrency
                        and self._next_locked() is w
                    ):
                        break
                    # Bounded waits even without a deadline: aging
                    # promotions only become visible on a wakeup.
                    if ctx is not None:
                        ctx.raise_if_done()  # deadline expired while queued
                        rem = ctx.remaining()
                        self._cond.wait(
                            0.25 if rem is None else min(0.25, rem)
                        )
                    else:
                        self._cond.wait(0.25)
                # Dequeue-time check: a slot is free, but a client that
                # vanished while this request waited must not consume it
                # — the run would execute for nobody.
                if probe is not None and probe():
                    self._drop_locked()
                    raise ClientGone(
                        "client disconnected while queued for a slot"
                    )
            finally:
                self._waiting -= 1
                self._queue.remove(w)
                # The departing waiter may have been masking the next
                # grant (it WAS the head, or its removal frees a bump).
                self._cond.notify_all()
            self._active += 1
            self.admitted += 1
        if self._obs is not None:
            self._obs.complete("queue_wait", t0, tid="serve")
            self._obs.count("serve.admitted")
        return Ticket(self, time.monotonic_ns())

    def _release(self, admit_t0_ns: int) -> None:
        if self._obs is not None:
            # The slot-hold interval: concurrent occupancy on the timeline.
            self._obs.complete("admit", admit_t0_ns, tid="serve")
        with self._cond:
            self._active -= 1
            self._cond.notify_all()

    def _reject_locked(self) -> None:
        self.rejected += 1
        if self._obs is not None:
            self._obs.count("serve.rejected")

    def _drop_locked(self) -> None:
        self.dropped_disconnected += 1
        if self._obs is not None:
            self._obs.count("serve.dropped_disconnected")

    def _reject(self) -> None:
        with self._cond:
            self._reject_locked()

    # -- drain ---------------------------------------------------------------

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def begin_drain(self) -> None:
        """Stop admitting; queued waiters are rejected, in-flight runs
        keep their slots."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """begin_drain + block until the last in-flight run releases.

        Returns True when fully drained, False on timeout (callers decide
        whether to abandon the stragglers)."""
        self.begin_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._active > 0:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(0.25 if rem is None else min(0.25, rem))
        return True

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._cond:
            waiting_by_class: dict[int, int] = {}
            for w in self._queue:
                if not w.bumped:
                    waiting_by_class[w.priority] = (
                        waiting_by_class.get(w.priority, 0) + 1
                    )
            return {
                "active": self._active,
                "waiting": self._waiting,
                "waiting_by_class": waiting_by_class,
                "max_concurrency": self.max_concurrency,
                "max_queue": self.max_queue,
                "draining": self._draining,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "bumped": self.bumped,
                "dropped_disconnected": self.dropped_disconnected,
            }
