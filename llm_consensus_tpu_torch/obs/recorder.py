"""Run-wide telemetry: spans, counters and instant events on one timeline
(a copy of ``llm_consensus_tpu/obs/recorder.py``).

A :class:`Recorder` collects three event kinds from the engine, the
batcher, the runner and the provider onto one ``time.monotonic_ns``
timeline:

  * **spans**: an interval with a duration (a prefill, a decode-chunk
    dispatch, a fetch), recorded after the fact with ``complete(name, t0)``
    (one clock read before the work, one append after) or with the
    ``span(...)`` context manager on cool paths;
  * **instants**: a point on the timeline (a watchdog abandon, a retrace);
  * **counters**: run aggregates (decode tokens, decode seconds) exported
    into ``metrics.json``; no timestamp, one dict update.

Events carry a ``tid``, a subsystem label ("engine", "batcher", "runner"),
not a thread id; the Chrome exporter (obs/export.py) maps labels to
stable integer tids with ``thread_name`` metadata.

Memory is bounded: past ``max_events`` new events are counted as dropped,
never appended; the first drop appends a one-time ``events_dropped``
instant so a truncated timeline says so. Nothing here reads the
environment: the CLI resolves ``LLMC_EVENTS_MAX`` (utils/knobs.py).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

DEFAULT_MAX_EVENTS = 200_000


@dataclass(frozen=True)
class Event:
    """One timeline event. ``ph`` is the Chrome trace phase it exports as:
    "X" (complete span, ``dur_ns`` set) or "i" (instant)."""

    name: str
    ph: str
    ts_ns: int
    tid: str
    dur_ns: int = 0
    args: dict = field(default_factory=dict)


class Recorder:
    """Thread-safe span/counter/instant recorder for one run; readers get
    copies, so exporters see consistent state while workers append."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._events: list[Event] = []
        self._counters: dict[str, float] = {}
        self._max_events = max_events
        self.dropped = 0
        self._drop_warned = False

    @staticmethod
    def now() -> int:
        """Timeline clock: monotonic nanoseconds."""
        return time.monotonic_ns()

    def _append(self, ev: Event) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
                self._counters["obs.dropped_events"] = (
                    self._counters.get("obs.dropped_events", 0.0) + 1.0)
                if not self._drop_warned:
                    self._drop_warned = True
                    self._events.append(Event(
                        name="events_dropped", ph="i", ts_ns=time.monotonic_ns(),
                        tid="obs", args={"max_events": self._max_events}))
                return
            self._events.append(ev)

    def complete(self, name: str, t0_ns: int, tid: str = "main", **args) -> None:
        """Record a span that started at ``t0_ns`` (from :meth:`now`) and
        ends now."""
        t1 = time.monotonic_ns()
        self._append(Event(name=name, ph="X", ts_ns=t0_ns, tid=tid,
                           dur_ns=max(t1 - t0_ns, 0), args=args))

    @contextmanager
    def span(self, name: str, tid: str = "main", **args):
        """Span context manager for cool paths (a body that raises still
        records its span)."""
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.complete(name, t0, tid=tid, **args)

    def instant(self, name: str, tid: str = "main", **args) -> None:
        self._append(Event(name=name, ph="i", ts_ns=time.monotonic_ns(), tid=tid, args=args))

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulate a run-aggregate counter (no timestamp)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def depth(self) -> int:
        """Events recorded so far (the gateway's ``obs`` block)."""
        with self._lock:
            return len(self._events)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def span_names(self) -> set[str]:
        with self._lock:
            return {e.name for e in self._events if e.ph == "X"}

    def clear(self) -> None:
        """Drop events and counters in place (the CLI's per-run reset:
        warm engines keep their bound reference)."""
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self.dropped = 0
            self._drop_warned = False


__all__ = ["DEFAULT_MAX_EVENTS", "Event", "Recorder"]
