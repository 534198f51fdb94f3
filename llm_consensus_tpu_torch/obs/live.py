"""The live metrics plane: windowed, mergeable histograms (a copy of
``llm_consensus_tpu/obs/live.py``).

  * **Fixed log-bucket histograms** (:class:`Histogram`): one bucket ladder
    (powers of two from 100 µs) for every histogram, so histograms merge
    bucket-wise. One observation is a bisect into the edge table and three
    integer adds under the metrics lock.
  * **Windowed** (:class:`WindowedHistogram`): a cumulative total and a
    ring of closed windows, so recent quantiles come from bounded state.
  * **Labels**: each label combination owns its histogram, made on first
    observation.

Metric names on the port's paths: ``device_time`` (seconds of one
dispatch, by ``family``; obs/attrib.py observes it), ``token_latency``
(seconds per generated token, by ``class``, the priority class, and
``outcome``; the provider observes it), and the gateway's ``ttft``,
``queue_wait``, ``e2e`` and ``judge_synthesis`` (serve/), and
``swap_vacate`` (the engine's weight flip). All values are seconds.

The plane is installed by the CLI (``LLMC_LIVE``, default on;
``LLMC_LIVE_WINDOW_S``, ``LLMC_LIVE_WINDOWS``) and bound by its consumers
at construction; :func:`metrics` returns None when nothing is installed.
``LiveMetrics.start`` runs the window rotator (the ``serve`` gateway starts
it); rotation callbacks feed the :class:`SLOWatcher`, whose burn dumps
the flight recorder. obs/prom.py renders the plane for ``/metricsz``.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from collections import deque
from typing import Callable, Optional

from llm_consensus_tpu_torch.analysis import sanitizer

# Upper edges BUCKET_MIN * 2^i: 100 µs .. ~14 min; past the top edge the
# value lands in the +Inf bucket.
BUCKET_MIN = 1e-4
BUCKET_GROWTH = 2.0
N_BUCKETS = 23
BUCKET_EDGES: tuple = tuple(BUCKET_MIN * (BUCKET_GROWTH ** i) for i in range(N_BUCKETS))

DEFAULT_WINDOW_S = 10.0
DEFAULT_WINDOWS = 30

OUTCOMES = ("ok", "degraded", "shed", "preempted", "failover", "error")
CLASS_NAMES = {0: "high", 1: "normal", 2: "low"}


def class_label(priority) -> str:
    """Priority class → label (an unknown class keeps its number)."""
    try:
        return CLASS_NAMES.get(int(priority), str(int(priority)))
    except (TypeError, ValueError):
        return "normal"


def bucket_index(value: float) -> int:
    """The first edge >= value (Prometheus ``le``); ``N_BUCKETS`` is +Inf."""
    if value <= BUCKET_MIN:
        return 0
    return bisect_left(BUCKET_EDGES, value)


def new_trace_id() -> str:
    """A fresh 16-hex-character request trace id."""
    return os.urandom(8).hex()


class Histogram:
    """Counts per bucket + count + sum; not locked (the owner serializes).
    Merge is elementwise, so associative and commutative."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts = [0] * (N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bucket_index(value)] += 1
        self.count += 1
        self.sum += value

    def merge_from(self, other: "Histogram") -> "Histogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def copy(self) -> "Histogram":
        out = Histogram()
        out.counts = list(self.counts)
        out.count = self.count
        out.sum = self.sum
        return out

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile by linear interpolation inside the bucket the
        rank falls in (within one growth factor of exact); None when empty;
        ranks in the overflow bucket report the top finite edge."""
        if self.count <= 0:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c > 0:
                if i >= N_BUCKETS:
                    return BUCKET_EDGES[-1]
                lo = 0.0 if i == 0 else BUCKET_EDGES[i - 1]
                hi = BUCKET_EDGES[i]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
        return BUCKET_EDGES[-1]

    def cumulative(self) -> list:
        """Cumulative bucket counts in edge order, then the +Inf total: the
        Prometheus ``_bucket`` series (obs/prom.py renders them)."""
        out = []
        cum = 0
        for c in self.counts:
            cum += c
            out.append(cum)
        return out


class WindowedHistogram:
    """Cumulative total + the open window + a bounded ring of closed ones."""

    __slots__ = ("total", "window", "ring")

    def __init__(self, windows: int = DEFAULT_WINDOWS):
        self.total = Histogram()
        self.window = Histogram()
        self.ring: deque = deque(maxlen=max(1, windows))

    def observe(self, value: float) -> None:
        self.total.observe(value)
        self.window.observe(value)

    def rotate(self) -> None:
        """Close the current window into the ring and open a new one."""
        self.ring.append(self.window)
        self.window = Histogram()

    def recent(self, n: int = 1) -> Histogram:
        """The merge of the last ``n`` closed windows (the open one is
        excluded: half a window under-counts)."""
        out = Histogram()
        for h in list(self.ring)[-max(1, n):]:
            out.merge_from(h)
        return out


class LiveMetrics:
    """The process's histogram families keyed by (name, labels); one lock
    serializes observation, rotation and snapshots."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S, windows: int = DEFAULT_WINDOWS):
        self.window_s = max(0.05, window_s)
        self._windows = max(1, windows)
        self._lock = sanitizer.make_lock("obs.live")
        self._hists: dict = {}  # (name, ((k, v), ...)) -> WindowedHistogram
        self._callbacks: list = []
        self._stop = sanitizer.make_event("obs.live.stop")
        self._thread: Optional[threading.Thread] = None

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one observation (seconds; negatives clamp to 0) into the
        labeled histogram, made on first use."""
        value = max(0.0, float(value))
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            wh = self._hists.get(key)
            if wh is None:
                wh = self._hists[key] = WindowedHistogram(self._windows)
            wh.observe(value)

    def rotate(self) -> None:
        """Close every histogram's current window, then run the rotation
        callbacks (outside the lock: a callback may observe or dump)."""
        with self._lock:
            for wh in self._hists.values():
                wh.rotate()
            callbacks = list(self._callbacks)
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a callback must not stop rotation
                pass

    def on_rotate(self, fn: Callable[["LiveMetrics"], None]) -> None:
        with self._lock:
            self._callbacks.append(fn)

    def remove_rotate(self, fn: Callable[["LiveMetrics"], None]) -> None:
        """Detach a rotation callback (a closed gateway must not stay
        reachable through the process plane)."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def families(self) -> dict:
        """{name: [(labels dict, cumulative Histogram copy)]}."""
        with self._lock:
            items = [(name, dict(labels), wh.total.copy())
                     for (name, labels), wh in self._hists.items()]
        out: dict = {}
        for name, labels, hist in items:
            out.setdefault(name, []).append((labels, hist))
        return out

    def quantile_recent(self, name: str, q: float, windows: int = 1,
                        **label_filter) -> Optional[float]:
        """The ``q``-quantile of ``name`` over the last ``windows`` closed
        windows, merged across the label sets matching ``label_filter``."""
        with self._lock:
            merged = Histogram()
            for (n, labels), wh in self._hists.items():
                if n == name and all(dict(labels).get(k) == v for k, v in label_filter.items()):
                    merged.merge_from(wh.recent(windows))
        return merged.quantile(q)

    def counts(self, name: Optional[str] = None) -> int:
        """Total observations (optionally of one family)."""
        with self._lock:
            return sum(wh.total.count for (n, _), wh in self._hists.items()
                       if name is None or n == name)

    def start(self) -> None:
        """Start the window rotator thread (idempotent: in-process gateways
        share one)."""
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._loop, name="llmc-live-rotate",
                                            daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.window_s):
            try:
                self.rotate()
            except Exception:  # noqa: BLE001 — the rotator must not die
                continue

    def close(self) -> None:
        self._stop.set()


class SLOWatcher:
    """The SLO-burn trigger: the ``quantile`` of a live metric over
    ``threshold_s`` for ``windows`` consecutive closed windows fires
    ``on_burn`` (the flight-recorder dump). Registered as a rotation
    callback, so it samples once a window; ``threshold_s`` 0 disables it
    (``LLMC_SLO_TTFT_P99_S`` and ``LLMC_SLO_WINDOWS``, read by the CLI)."""

    def __init__(self, metric: str = "ttft", quantile: float = 0.99,
                 threshold_s: float = 0.0, windows: int = 3,
                 on_burn: Optional[Callable[[dict], None]] = None):
        self.metric = metric
        self.quantile = quantile
        self.threshold_s = threshold_s
        self.windows = max(1, windows)
        self.on_burn = on_burn
        self.burns = 0
        self._streak = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_s > 0

    def check(self, live: LiveMetrics) -> bool:
        """One post-rotation sample; True when a burn fired. A quiet window
        resets the streak: an idle server is not burning its SLO."""
        if not self.enabled:
            return False
        q = live.quantile_recent(self.metric, self.quantile, windows=1)
        if q is not None and q > self.threshold_s:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak < self.windows:
            return False
        self._streak = 0  # the next burn needs N fresh windows
        self.burns += 1
        if self.on_burn is not None:
            try:
                self.on_burn({
                    "metric": self.metric, "quantile": self.quantile, "value_s": q,
                    "threshold_s": self.threshold_s, "windows": self.windows,
                })
            except Exception:  # noqa: BLE001
                pass
        return True


_lock = sanitizer.make_lock("obs.live.registry")
_metrics: Optional[LiveMetrics] = None
_resolved = False


def metrics() -> Optional[LiveMetrics]:
    """The installed live plane, or None."""
    return _metrics


def resolved() -> bool:
    """Whether the CLI (or a test) decided this plane yet."""
    return _resolved


def install(m: Optional[LiveMetrics]) -> None:
    """Install ``m`` as the process plane; a replaced plane's rotator
    stops."""
    global _metrics, _resolved
    with _lock:
        old = _metrics
        _metrics = m
        _resolved = True
    if old is not None and old is not m:
        old.close()


def reset() -> None:
    global _resolved
    install(None)
    with _lock:
        _resolved = False


__all__ = [
    "BUCKET_EDGES", "BUCKET_GROWTH", "BUCKET_MIN", "CLASS_NAMES", "DEFAULT_WINDOWS",
    "DEFAULT_WINDOW_S", "Histogram", "LiveMetrics", "N_BUCKETS", "OUTCOMES",
    "SLOWatcher", "WindowedHistogram", "bucket_index", "class_label", "install",
    "metrics", "new_trace_id", "reset", "resolved",
]
