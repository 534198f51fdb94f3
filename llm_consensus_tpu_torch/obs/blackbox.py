"""The always-on flight recorder: a bounded ring of recent spans (a copy of
``llm_consensus_tpu/obs/blackbox.py``).

The per-run recorder is opt-in (``--events``); when a batcher dies with
events off, the timeline that explains it was never recorded. The
:class:`FlightRecorder` keeps the most recent spans and instants of the
engine, batcher and runner in a fixed ring (``LLMC_BLACKBOX_EVENTS``,
default 4096), always (``LLMC_BLACKBOX=0`` opts out), at one deque append
per event.

On an anomaly the ring **dumps** a Perfetto-loadable Chrome trace,
atomically, into ``LLMC_BLACKBOX_DIR`` (default
``data/_artifacts/blackbox/``), rate-limited by
``LLMC_BLACKBOX_MIN_INTERVAL_S``. The port's triggers: the batcher loop's
fatal path (``engine_crash``) and the kernel-build sentinel after warm-up
(``retrace``, obs/attrib.py). The pressure and SLO triggers arrive with
the port's ``pressure/`` and ``serve/``.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.obs.recorder import Event

DEFAULT_CAPACITY = 4096
DEFAULT_MIN_INTERVAL_S = 30.0
DEFAULT_DIR = os.path.join("data", "_artifacts", "blackbox")


class FlightRecorder:
    """Bounded ring of recent Events + anomaly-triggered trace dumps.

    Recording is ``deque.append`` with a maxlen (atomic under the GIL);
    only ``dump`` takes the lock, for its rate-limit state."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, out_dir: str = DEFAULT_DIR,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S):
        self._ring: deque = deque(maxlen=max(16, capacity))
        self.out_dir = out_dir
        self.min_interval_s = min_interval_s
        self._lock = sanitizer.make_lock("obs.blackbox")
        self._last_dump = 0.0
        self.dumps = 0
        self.suppressed = 0
        self.last_reason: Optional[str] = None
        self.last_path: Optional[str] = None

    @staticmethod
    def now() -> int:
        return time.monotonic_ns()

    def complete(self, name: str, t0_ns: int, tid: str = "main", **args) -> None:
        t1 = time.monotonic_ns()
        self._ring.append(Event(name=name, ph="X", ts_ns=t0_ns, tid=tid,
                                dur_ns=max(t1 - t0_ns, 0), args=args))

    def instant(self, name: str, tid: str = "main", **args) -> None:
        self._ring.append(Event(name=name, ph="i", ts_ns=time.monotonic_ns(), tid=tid,
                                args=args))

    def depth(self) -> int:
        return len(self._ring)

    def dump(self, reason: str, extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring as a trace document; returns its path, or None when
        empty, rate-limited or the write failed (a blackbox never fails the
        system it records: the write goes through ``save_file``, which
        reports and returns None)."""
        events = list(self._ring)
        if not events:
            return None
        with self._lock:
            now = time.monotonic()
            if not force and self.dumps > 0 and now - self._last_dump < self.min_interval_s:
                self.suppressed += 1
                return None
            prev_last, self._last_dump = self._last_dump, now
        from llm_consensus_tpu_torch.obs.export import chrome_events, trace_document
        from llm_consensus_tpu_torch.output.persist import save_file

        doc = trace_document(chrome_events(events, pid=0, process_name="blackbox"))
        doc["blackbox"] = {"reason": reason, "events": len(events),
                           "dumped_unix": time.time(), **(extra or {})}
        name = f"blackbox-{_safe(reason)}-{time.time_ns()}.json"
        path = save_file(self.out_dir, name, json.dumps(doc, indent=2) + "\n")
        with self._lock:
            if path is None:
                self._last_dump = prev_last  # nothing landed: the next anomaly retries
                return None
            self.dumps += 1
            self.last_reason = reason
            self.last_path = path
        return path

    def stats(self) -> dict:
        with self._lock:
            return {"depth": len(self._ring), "capacity": self._ring.maxlen,
                    "dumps": self.dumps, "suppressed": self.suppressed,
                    "last_reason": self.last_reason, "last_path": self.last_path}


def _safe(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in str(reason))[:48] or "anomaly"


_lock = sanitizer.make_lock("obs.blackbox.registry")
_ring: Optional[FlightRecorder] = None
_resolved = False


def ring() -> Optional[FlightRecorder]:
    """The installed flight recorder, or None."""
    return _ring


def resolved() -> bool:
    return _resolved


def install(r: Optional[FlightRecorder]) -> None:
    global _ring, _resolved
    with _lock:
        _ring = r
        _resolved = True


def reset() -> None:
    global _ring, _resolved
    with _lock:
        _ring = None
        _resolved = False


__all__ = ["DEFAULT_CAPACITY", "DEFAULT_DIR", "DEFAULT_MIN_INTERVAL_S", "FlightRecorder",
           "install", "reset", "resolved", "ring"]
