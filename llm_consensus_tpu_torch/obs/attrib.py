"""Chip-time attribution: where did this second of device time go? (a copy
of ``llm_consensus_tpu/obs/attrib.py`` for the port's paths).

  * **Device time per program family** (:data:`FAMILIES`): every dispatch
    the engine and the batcher make is booked against its family. A
    family's ``device_s`` is the stream interval of its dispatches: on a
    card, a pair of CUDA events recorded around each dispatch (a prefill, a
    chunk of decode steps, an admission wave, a compaction) and read at the
    sync point the path already has (the chunk's token fetch), so the
    interval covers the device work and, inside a host-paced chunk, the
    idle gaps between its launches: never less than the kernel time. On
    the CPU, where a dispatch runs synchronously, the host wall around it.
  * **Goodput ledger**: tokens by disposition (:data:`DISPOSITIONS`);
    ``useful`` is one bump per token appended to a stream, nowhere else.
  * **Host gaps**: device idle between a drained dispatch pipeline and the
    next dispatch on a batcher that still has work, by the scheduler phase
    that ran in between.

Two sentinels feed the flight recorder (obs/blackbox.py):

  * **Build sentinel**: eager PyTorch has no XLA compile; the one compile
    on the port's path is the kernel library's ``nvcc`` build or load
    (``ops/kernels/build.py`` ``ensure_built``). It is booked as a compile
    of the family the building thread was tagged with (:func:`tag`), and a
    build after warm-up (``warmup_s``, or :meth:`ChipTimeLedger.mark_warm`)
    lands a ``retrace`` instant in the recorder and the ring and dumps it.
  * **HBM watermark**: modeled resident bytes (the engines' weights, the
    batchers' pool caches, the KV pools' arenas) and, on a card, the
    allocator's own numbers (``torch.cuda.memory_stats``: allocated bytes
    now and at peak, against the card's total memory). A pressure event
    (:meth:`ChipTimeLedger.hbm_pressure`: the KV pool about to truncate a
    publish) counts in the ``hbm`` block and lands an ``hbm_high_water``
    instant in the recorder and the flight recorder, then a dump.

The ledger is installed by the CLI (``LLMC_ATTRIB``: "0" off, unset follows
``LLMC_LIVE``; ``LLMC_ATTRIB_WARMUP_S``, ``LLMC_ATTRIB_HBM_HIGH``) and
bound by its consumers at construction; :func:`ledger` is None when nothing
is installed.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

from llm_consensus_tpu_torch.obs import roofline

FAMILIES = (
    "prefill", "decode", "spec_verify", "draft",
    "kv_gather", "kv_publish", "kv_handoff", "allgather", "compact",
    "elastic", "swap", "train_step",
    "other",
)

DISPOSITIONS = (
    "useful", "preempt_replay", "crash_replay", "spec_rejected",
    "overshoot", "abandoned", "evicted_kv",
)

GAP_PHASES = ("admit", "establish", "compact", "absorb", "preempt", "resize", "schedule")

DEFAULT_WARMUP_S = 120.0
DEFAULT_HBM_HIGH = 0.92

_tls = threading.local()


@contextmanager
def tag(family: str):
    """Tag this thread's dispatches with a program family for the duration
    (the build sentinel's attribution source; two attribute writes)."""
    prev = getattr(_tls, "family", None)
    _tls.family = family
    try:
        yield
    finally:
        _tls.family = prev


def current_family() -> Optional[str]:
    return getattr(_tls, "family", None)


class ChipTimeLedger:
    """Device-time / goodput / gap / sentinel accounting for the process;
    one lock serializes every write, snapshots read under it. Per-dispatch
    device times also go to the live plane's ``device_time`` histogram."""

    def __init__(self, warmup_s: float = DEFAULT_WARMUP_S, hbm_high: float = DEFAULT_HBM_HIGH):
        self.warmup_s = max(0.0, warmup_s)
        self.hbm_high = min(1.0, max(0.0, hbm_high))
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._device_s: dict = {}
        self._dispatches: dict = {}
        self._tokens: dict = {}
        self._gap_s: dict = {}
        self._gaps = 0
        self._compiles: dict = {}
        self._compile_s: dict = {}
        self._retraces = 0
        self._warm_marked = False
        self._components: dict = {}
        self._peak_modeled = 0
        self._hbm_events = 0

    def observe_device(self, family: str, seconds: float, dispatches: int = 1) -> None:
        """Book ``seconds`` of device interval against ``family``."""
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._device_s[family] = self._device_s.get(family, 0.0) + seconds
            self._dispatches[family] = self._dispatches.get(family, 0) + dispatches
        live = _live()
        if live is not None:
            live.observe("device_time", seconds, family=family)

    def token_event(self, disposition: str, n: int = 1) -> None:
        """Book ``n`` tokens under ``disposition``."""
        if n <= 0:
            return
        with self._lock:
            self._tokens[disposition] = self._tokens.get(disposition, 0) + n

    def gap(self, seconds: float, phase: str = "schedule") -> None:
        """Book one device-idle bubble of a busy batcher against the
        scheduler phase that preceded the dispatch that ended it."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            self._gap_s[phase] = self._gap_s.get(phase, 0.0) + seconds
            self._gaps += 1
        live = _live()
        if live is not None:
            live.observe("host_gap", seconds, phase=phase)

    @property
    def warmed(self) -> bool:
        """Past warm-up: a kernel build from here on is a retrace."""
        return self._warm_marked or time.monotonic() - self._t0 > self.warmup_s

    def mark_warm(self) -> None:
        self._warm_marked = True

    def note_build(self, duration_s: float) -> None:
        """A kernel build or load of ``duration_s`` ran on this thread: book
        it as a compile of the thread's family; past warm-up, fire the
        retrace sentinel."""
        family = current_family() or "other"
        warmed = self.warmed
        with self._lock:
            self._compiles[family] = self._compiles.get(family, 0) + 1
            self._compile_s[family] = self._compile_s.get(family, 0.0) + float(duration_s)
            if warmed:
                self._retraces += 1
            retraces = self._retraces
        if not warmed:
            return
        info = {"family": family, "compile_s": round(float(duration_s), 4),
                "retraces": retraces}
        from llm_consensus_tpu_torch import obs

        rec = obs.recorder()
        if rec is not None:
            rec.instant("retrace", tid="attrib", **info)
            rec.count("attrib.retraces")
        bb = obs.blackbox.ring()
        if bb is not None:
            bb.instant("retrace", tid="attrib", **info)
            bb.dump("retrace", extra=info)

    def update_component(self, name: str, nbytes: int) -> None:
        """Register or refresh one modeled resident component (weights, a
        batcher's pool cache)."""
        with self._lock:
            self._components[name] = int(nbytes)
            self._peak_modeled = max(self._peak_modeled, sum(self._components.values()))

    def hbm_pressure(self, source: str, **info) -> None:
        """An HBM-pressure event (the KV pool about to truncate a publish):
        counted, then an ``hbm_high_water`` instant into the recorder and
        the flight recorder and a (rate-limited) flight-recorder dump,
        before the degradation it precedes is reported. On a card the
        payload carries ``hbm_frac``, the device memory in use
        (``torch.cuda.mem_get_info``)."""
        with self._lock:
            self._hbm_events += 1
        payload = {"source": source, **info}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            free, total = torch.cuda.mem_get_info()
            payload["hbm_frac"] = round(1.0 - free / total, 4) if total else 0.0
        from llm_consensus_tpu_torch import obs

        rec = obs.recorder()
        if rec is not None:
            rec.instant("hbm_high_water", tid="attrib", **payload)
            rec.count("attrib.hbm_events")
        bb = obs.blackbox.ring()
        if bb is not None:
            bb.instant("hbm_high_water", tid="attrib", **payload)
            bb.dump("hbm_high_water", extra=payload)

    @staticmethod
    def hbm_device_stats() -> Optional[dict]:
        """The card's allocator numbers (allocated bytes now and at peak,
        against its total memory), the fullest device's; None on the CPU or
        before CUDA is initialized (reading them must not start it)."""
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        worst = None
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
            in_use = int(st.get("allocated_bytes.all.current", 0))
            frac = in_use / limit if limit else 0.0
            if worst is None or frac > worst["frac"]:
                worst = {
                    "bytes_in_use": in_use,
                    "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(limit),
                    "frac": round(frac, 4),
                }
        return worst

    def activity(self) -> int:
        """Dispatches + token events + gaps: the CLI's did-this-run-move-it
        watermark."""
        with self._lock:
            return sum(self._dispatches.values()) + sum(self._tokens.values()) + self._gaps

    def prom_families(self) -> dict:
        """The labeled counter and gauge families ``/metricsz`` renders
        (obs/prom.py ``render(families=...)``), the JAX ledger's names and
        labels. No goodput-fraction gauge: a fleet merge sums gauges."""
        with self._lock:
            device = list(self._device_s.items())
            tokens = list(self._tokens.items())
            gaps = list(self._gap_s.items())
            compiles = list(self._compiles.items())
            retraces = self._retraces
            modeled = sum(self._components.values())
            peak = self._peak_modeled
        out: dict = {
            "device_time_seconds_total": {
                "type": "counter", "samples": [({"family": f}, s) for f, s in device]},
            "tokens_total": {
                "type": "counter", "samples": [({"disposition": d}, n) for d, n in tokens]},
            "host_gap_seconds_total": {
                "type": "counter", "samples": [({"phase": p}, s) for p, s in gaps]},
            "compiles_total": {
                "type": "counter", "samples": [({"family": f}, n) for f, n in compiles]},
            "retraces_total": {"type": "counter", "samples": [({}, retraces)]},
            "hbm_modeled_bytes": {
                "type": "gauge", "samples": [({"kind": "live"}, modeled), ({"kind": "peak"}, peak)]},
        }
        dev = self.hbm_device_stats()
        if dev is not None:
            out["hbm_device_bytes"] = {
                "type": "gauge",
                "samples": [({"kind": "in_use"}, dev["bytes_in_use"]),
                            ({"kind": "peak"}, dev["peak_bytes_in_use"]),
                            ({"kind": "limit"}, dev["bytes_limit"])],
            }
        return out

    def snapshot(self) -> dict:
        """The ``attrib`` block of ``metrics.json``."""
        with self._lock:
            device_s = {k: round(v, 4) for k, v in sorted(self._device_s.items())}
            dispatches = dict(sorted(self._dispatches.items()))
            tokens = dict(sorted(self._tokens.items()))
            gap_s = {k: round(v, 4) for k, v in sorted(self._gap_s.items())}
            gaps = self._gaps
            compiles = dict(sorted(self._compiles.items()))
            compile_s = {k: round(v, 3) for k, v in sorted(self._compile_s.items())}
            retraces = self._retraces
            components = dict(sorted(self._components.items()))
            peak_modeled = self._peak_modeled
            hbm_events = self._hbm_events
        useful = tokens.get("useful", 0)
        wasted = sum(v for k, v in tokens.items() if k != "useful")
        hbm: dict = {
            "modeled_bytes": sum(components.values()),
            "peak_modeled_bytes": peak_modeled,
            "components": components,
            "events": hbm_events,
            "high_water_frac": self.hbm_high,
        }
        dev = self.hbm_device_stats()
        if dev is not None:
            hbm["device"] = dev
        return {
            "device_s": device_s,
            "busy_s": round(sum(device_s.values()), 4),
            "dispatches": dispatches,
            "tokens": tokens,
            "goodput": {
                "useful": useful,
                "wasted": wasted,
                "fraction": round(useful / (useful + wasted), 4) if useful + wasted else None,
            },
            "gap_s": gap_s,
            "gaps": gaps,
            "compiles": compiles,
            "compile_s": compile_s,
            "retraces": retraces,
            "warm": self.warmed,
            "hbm": hbm,
        }


def _live():
    from llm_consensus_tpu_torch.obs import live

    return live.metrics()


_lock = threading.Lock()
_ledger: Optional[ChipTimeLedger] = None
_resolved = False


def ledger() -> Optional[ChipTimeLedger]:
    """The installed attribution ledger, or None."""
    return _ledger


def resolved() -> bool:
    return _resolved


def install(led: Optional[ChipTimeLedger]) -> None:
    global _ledger, _resolved
    with _lock:
        _ledger = led
        _resolved = True


def reset() -> None:
    global _ledger, _resolved
    with _lock:
        _ledger = None
        _resolved = False


class DeviceWall:
    """The stream interval of one dispatch, for the attribution ledger: a
    start event on a card, closed by a later event of the path and read
    after a later sync point (the fetch of a chunk enqueued after it) with
    no sync of its own; the host clock around it on the CPU, where a
    dispatch runs synchronously. The host time a roofline capture spent
    counting inside the interval (obs/roofline.py ``held_s``) is taken out
    of it: the device waited for the host meanwhile."""

    __slots__ = ("_start", "_end", "_t0", "_t1", "_held")

    def __init__(self, device: torch.device) -> None:
        self._end = None
        self._t1 = 0.0
        self._held = roofline.held_s()
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = None
            self._t0 = time.monotonic()

    def stop(self, end: Optional[torch.cuda.Event] = None) -> "DeviceWall":
        """Close the interval here, or at ``end``, a timing event the
        caller has just recorded."""
        self._held = roofline.held_s() - self._held
        if self._start is not None:
            if end is None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            self._end = end
        else:
            self._t1 = time.monotonic()
        return self

    def done(self) -> bool:
        """Whether :meth:`seconds` can be read without waiting."""
        return self._start is None or self._end.query()

    def seconds(self) -> float:
        if self._start is not None:
            wall = self._start.elapsed_time(self._end) / 1e3
        else:
            wall = self._t1 - self._t0
        return max(0.0, wall - self._held)


__all__ = [
    "DISPOSITIONS", "FAMILIES", "GAP_PHASES", "ChipTimeLedger", "DeviceWall", "current_family",
    "install", "ledger", "reset", "resolved", "tag",
]

