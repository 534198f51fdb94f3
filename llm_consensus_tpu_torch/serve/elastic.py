"""Elastic fleet control: replica lifecycle, scale hysteresis, migration (a
copy of ``llm_consensus_tpu/serve/elastic.py``).

The fleet tier (serve/fleet.py, serve/router.py) is robust to replicas
*dying* — health hysteresis demotes them, failover + StreamLedger replay
splice the seam — but membership itself was static: the only way to
shrink a gateway was to drain it, shedding or stalling resident streams.
This module makes membership changes first-class:

  * **Lifecycle** — every gateway is in exactly one of
    ``joining → serving → draining → retiring`` (plus the reversible
    ``quarantined`` detour the integrity plane drives — see ``_NEXT``).
    The state rides the
    heartbeat/health-poll path to the router, which places new work only
    on ``serving`` replicas; a ``joining`` replica advertises
    ``load_score=1.0`` until warm, so the ring never routes to a cold
    one, and ``draining``/``retiring`` are just membership transitions
    the consistent-hash ring already handles with bounded key movement.

  * **ElasticController** — the scale decision loop, a two-sided
    hysteresis state machine copied from the pressure governor's: the
    fleet-load signal must sit at/above the high-water mark for
    ``up_patience`` consecutive ticks before a scale-up, at/below the
    low-water mark for ``down_patience`` ticks before a scale-down, and
    any mid-band sample resets BOTH streaks — so join/leave oscillation
    (the ``replica_flap`` fault) never flaps the pool size. Decisions
    clamp to ``[min_replicas, max_replicas]`` and go through injectable
    ``scale_up`` / ``scale_down`` hooks (the dryrun lane and tests embed
    in-process gateways; a production embedding points them at its
    process manager). ``POST /v1/scale`` on the router reaches
    :meth:`ElasticController.request` for operator-forced transitions.

  * **Migration plumbing** — :class:`MigrationRecord` is the unit a
    retiring source gateway ships per resident stream over
    ``POST /v1/migrate``: the coalescing key, per-model journal payloads
    (sealed ``prompt_ids`` + ``sampling`` + emitted token snapshot —
    the crash-recovery seal→close→reopen contract stretched across
    replicas), the emitted text prefix, priority/trace and
    weight/spec/kv flags.
    The destination parks records in its :class:`MigrationTable`; when
    the router's failover re-submission arrives (the source closed the
    SSE leg without a terminal event — the crash path, fired on
    purpose), the destination claims the record by key exactly once and
    resumes via ``submit_ids(replay_ids=...)``. The router's
    StreamLedger burns the already-delivered prefix, so the client sees
    one byte-identical stream across the seam.

Everything here is control-plane: no decode hot path runs through this
module. It reads no environment: the controller's hysteresis, clamps and
cadence and ``ship_record``'s bounded wait are arguments with the JAX
defaults (``LLMC_ELASTIC_*``, read by ``cli/route.py`` and ``cli/serve.py``
through ``utils/knobs.py``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

from llm_consensus_tpu_torch import faults, integrity, obs

# -- lifecycle ----------------------------------------------------------------

JOINING = "joining"
SERVING = "serving"
DRAINING = "draining"
RETIRING = "retiring"
QUARANTINED = "quarantined"

LIFECYCLES = (JOINING, SERVING, DRAINING, RETIRING, QUARANTINED)

# Legal transitions: lifecycle only moves forward (a retired gateway that
# comes back announces as a fresh joining replica — the router treats the
# re-registration as a new member). ``quarantined`` is the one loop: a
# serving replica whose integrity failures cross the quarantine threshold
# steps aside (the router stops placing on it, residents migrate away),
# and earns its way back to serving via consecutive clean probe windows
# (integrity.QuarantineTracker) — or drains out if the operator gives up
# on it.
_NEXT = {
    JOINING: (SERVING,),
    SERVING: (DRAINING, QUARANTINED),
    DRAINING: (RETIRING, SERVING),  # drain can be cancelled
    RETIRING: (),
    QUARANTINED: (SERVING, DRAINING),
}


def placeable(lifecycle: str) -> bool:
    """Only ``serving`` replicas take NEW work; every other state is a
    membership transition the router must route around."""
    return lifecycle == SERVING


def can_transition(cur: str, nxt: str) -> bool:
    return nxt in _NEXT.get(cur, ())


class StreamMigrated(RuntimeError):
    """This request's stream was shipped to another replica: the source
    closes the SSE leg WITHOUT a terminal event — deliberately the same
    wire shape as a crashed replica — so the router's failover path
    re-submits it and the destination resumes. Never reaches a client as
    an error."""


# -- migration records --------------------------------------------------------


@dataclass
class MigrationRecord:
    """Everything the destination needs to resume one migrated stream.

    ``resume`` maps model name → journal payload: ``{"prompt_ids": [...],
    "sampling": {...}, "tokens": [...]}`` when the source sealed a real
    journal entry, or ``{"text": "..."}`` when only the emitted text
    prefix is known (deterministic providers re-derive it). ``emitted``
    maps ``"<kind>:<model>"`` → the text already flushed to the client —
    the destination never needs it for correctness (the router ledger
    burns the prefix), but it makes the record self-describing for
    post-mortems and the stall-fallback decision auditable."""

    key: str
    resume: dict = field(default_factory=dict)
    emitted: dict = field(default_factory=dict)
    priority: int = 1
    trace_id: Optional[str] = None
    flags: dict = field(default_factory=dict)  # weight/spec/kv capability flags
    source: str = ""  # source gateway url (debugging)
    created_s: float = 0.0
    # Content digest over the resume state (integrity plane): stamped by
    # the source before the record crosses the wire, verified by the
    # destination before the record can park — a corrupted resume
    # payload is refused and the source finishes the stream locally.
    digest: Optional[str] = None

    def content_digest(self) -> str:
        """Canonical digest of the fields a resume actually consumes —
        the wire-integrity unit (JSON round-trip stable: canonical
        encoding sorts keys and ints survive the trip verbatim)."""
        return integrity.canonical_digest({
            "key": self.key,
            "resume": self.resume,
            "priority": self.priority,
        })

    def stamp_digest(self) -> None:
        self.digest = self.content_digest()

    def verify_digest(self) -> bool:
        """True when the record carries no digest (pre-plane source) or
        the resume state reproduces it."""
        return self.digest is None or self.digest == self.content_digest()

    def to_doc(self) -> dict:
        return {
            "key": self.key,
            "resume": self.resume,
            "emitted": self.emitted,
            "priority": self.priority,
            "trace_id": self.trace_id,
            "flags": self.flags,
            "source": self.source,
            "digest": self.digest,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "MigrationRecord":
        key = doc.get("key")
        if not isinstance(key, str) or not key:
            raise ValueError("migration record requires a string 'key'")
        return cls(
            key=key,
            resume=dict(doc.get("resume") or {}),
            emitted=dict(doc.get("emitted") or {}),
            priority=int(doc.get("priority", 1)),
            trace_id=doc.get("trace_id"),
            flags=dict(doc.get("flags") or {}),
            source=str(doc.get("source") or ""),
            digest=doc.get("digest"),
        )


class MigrationTable:
    """Destination-side parking lot for in-flight migration records.

    ``offer`` parks a record under its coalescing key; ``claim`` pops it
    exactly once — the resumed leader consumes it, replays and duplicate
    re-submissions find nothing and just run from scratch (correct,
    merely slower). Records expire after ``ttl_s`` so a migration whose
    re-submission never arrives (client gone mid-seam) cannot leak."""

    def __init__(self, ttl_s: float = 60.0, clock=time.monotonic):
        self._ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._records: dict[str, MigrationRecord] = {}
        self.offered = 0
        self.claimed = 0
        self.expired = 0

    def offer(self, record: MigrationRecord) -> None:
        now = self._clock()
        record.created_s = now
        with self._lock:
            self._sweep_locked(now)
            self._records[record.key] = record
            self.offered += 1

    def claim(self, key: str) -> Optional[MigrationRecord]:
        with self._lock:
            self._sweep_locked(self._clock())
            rec = self._records.pop(key, None)
            if rec is not None:
                self.claimed += 1
            return rec

    def _sweep_locked(self, now: float) -> None:
        dead = [
            k for k, r in self._records.items()
            if now - r.created_s > self._ttl_s
        ]
        for k in dead:
            del self._records[k]
            self.expired += 1

    def depth(self) -> int:
        with self._lock:
            return len(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._records),
                "offered": self.offered,
                "claimed": self.claimed,
                "expired": self.expired,
            }


# -- scale controller ---------------------------------------------------------


class ElasticController:
    """Two-sided hysteretic scale loop over a fleet-load signal.

    ``signal`` returns the current fleet load in ``[0, 1]`` (default:
    mean ``load_score`` over serving replicas plus an SLO-burn override
    when a ``burning`` callable reports sustained TTFT burn — the
    goodput ledger and live histograms are the control signal, not raw
    CPU). ``scale_up()`` / ``scale_down()`` perform the transition and
    return True when they actually changed membership; the controller
    only books a decision when the hook succeeded, so a denied hook
    (e.g. no victim with every stream pinned) retries next tick instead
    of silently losing the decision.
    """

    def __init__(
        self,
        *,
        signal: Optional[Callable[[], float]] = None,
        fleet=None,
        burning: Optional[Callable[[], bool]] = None,
        scale_up: Optional[Callable[[], bool]] = None,
        scale_down: Optional[Callable[[], bool]] = None,
        replica_count: Optional[Callable[[], int]] = None,
        min_replicas: int = 1,
        max_replicas: int = 8,
        high_water: float = 0.8,
        low_water: float = 0.2,
        up_patience: int = 3,
        down_patience: int = 6,
        tick_s: float = 2.0,
        clock=time.monotonic,
    ):
        self._fleet = fleet
        self._signal = signal
        self._burning = burning
        self._scale_up = scale_up
        self._scale_down = scale_down
        self._replica_count = replica_count
        self.min_replicas = max(1, min_replicas)
        self.max_replicas = max(self.min_replicas, max_replicas)
        self.high_water = high_water
        self.low_water = low_water
        self.up_patience = max(1, up_patience)
        self.down_patience = max(1, down_patience)
        self.tick_s = tick_s
        self._clock = clock
        self._lock = threading.Lock()
        self._above = 0
        self._below = 0
        self._flap_until = 0.0
        self._flap_phase = 0
        self._faults = faults.plan()
        self._obs = obs.recorder()
        # Lifetime counters (statsz / the dryrun lane's assertions).
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.denied = 0  # clamped at min/max or hook refused
        self.flaps = 0
        self.last_signal = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal ---------------------------------------------------------------

    def _count(self) -> int:
        if self._replica_count is not None:
            return self._replica_count()
        if self._fleet is not None:
            return sum(
                1 for r in self._fleet.replicas()
                if getattr(r, "lifecycle", SERVING) == SERVING
            )
        return self.min_replicas

    def _read_signal(self) -> float:
        if self._signal is not None:
            load = float(self._signal())
        elif self._fleet is not None:
            scores = [
                r.load_score for r in self._fleet.replicas()
                if getattr(r, "lifecycle", SERVING) == SERVING
            ]
            load = sum(scores) / len(scores) if scores else 0.0
        else:
            load = 0.0
        # Sustained SLO burn (obs/live SLOWatcher) is a scale-up signal
        # even when queue-derived load looks moderate: burning clients
        # are the goodput the fleet exists to protect.
        if self._burning is not None and self._burning():
            load = max(load, 1.0)
        return min(1.0, max(0.0, load))

    # -- decision loop --------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One hysteresis sample; returns ``"up"``/``"down"`` on a booked
        scale decision, else None."""
        fs = (
            self._faults.fire("router", phase="elastic")
            if self._faults is not None else None
        )
        now = self._clock()
        if fs is not None and fs.kind == "replica_flap":
            # A replica is join/leave oscillating: for @s= seconds the
            # observed load alternates between the extremes every tick.
            # Two-sided patience must absorb it — each flip resets the
            # opposing streak, so no decision can accumulate.
            self._flap_until = now + float(fs.param("s", 3.0) or 3.0)
            self.flaps += 1
            if self._obs is not None:
                self._obs.count("elastic.flaps")
        load = self._read_signal()
        if now < self._flap_until:
            self._flap_phase += 1
            load = 1.0 if self._flap_phase % 2 else 0.0
        decision: Optional[str] = None
        with self._lock:
            self.ticks += 1
            self.last_signal = load
            if load >= self.high_water:
                self._above += 1
                self._below = 0
            elif load <= self.low_water:
                self._below += 1
                self._above = 0
            else:
                # Mid-band resets BOTH streaks — patience means
                # *consecutive* evidence, exactly the governor's rule.
                self._above = 0
                self._below = 0
            count = self._count()
            if self._above >= self.up_patience:
                self._above = 0
                decision = "up" if count < self.max_replicas else None
                if decision is None:
                    self.denied += 1
            elif self._below >= self.down_patience:
                self._below = 0
                decision = "down" if count > self.min_replicas else None
                if decision is None:
                    self.denied += 1
        if decision is not None:
            return self._book(decision)
        return None

    def _book(self, decision: str) -> Optional[str]:
        hook = self._scale_up if decision == "up" else self._scale_down
        ok = True
        if hook is not None:
            try:
                ok = bool(hook())
            except Exception:  # noqa: BLE001 — a failed hook retries next tick
                ok = False
        if not ok:
            with self._lock:
                self.denied += 1
            return None
        with self._lock:
            if decision == "up":
                self.scale_ups += 1
            else:
                self.scale_downs += 1
        if self._obs is not None:
            self._obs.count(
                "elastic.scale_ups" if decision == "up"
                else "elastic.scale_downs"
            )
        return decision

    def request(self, direction: str) -> dict:
        """Operator-forced transition (``POST /v1/scale``): bypasses
        patience but NOT the min/max clamp."""
        if direction not in ("up", "down"):
            raise ValueError(f"scale direction must be up|down, got {direction!r}")
        count = self._count()
        if direction == "up" and count >= self.max_replicas:
            with self._lock:
                self.denied += 1
            return {"scaled": None, "replicas": count, "reason": "at max_replicas"}
        if direction == "down" and count <= self.min_replicas:
            with self._lock:
                self.denied += 1
            return {"scaled": None, "replicas": count, "reason": "at min_replicas"}
        booked = self._book(direction)
        return {"scaled": booked, "replicas": self._count()}

    # -- thread ---------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="elastic-controller", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive a bad tick
                pass

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "signal": round(self.last_signal, 4),
                "above": self._above,
                "below": self._below,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "denied": self.denied,
                "flaps": self.flaps,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "high_water": self.high_water,
                "low_water": self.low_water,
            }


# -- source-side shipping -----------------------------------------------------


def ship_record(
    dest_url: str, record: MigrationRecord, timeout_s: float = 10.0
) -> bool:
    """POST one migration record to the destination's ``/v1/migrate``.

    Returns True when the destination accepted (HTTP 200). Any error —
    connect refused, stall past the bounded timeout, non-200 — returns
    False and the caller finishes the stream locally: migration degrades
    to drain-and-wait, never a dropped stream."""
    p = integrity.plane()
    if p is not None and record.digest is None:
        # Stamp at the wire boundary: everything past this POST is
        # host-visible bytes the destination re-digests before parking.
        record.stamp_digest()
        p.check("migration")
    doc = record.to_doc()
    fplan = faults.plan()
    if fplan is not None:
        fs = fplan.fire("corrupt", surface="migration")
        if fs is not None and fs.kind == "bit_flip":
            # Flip one bit in the resume token stream AFTER the digest
            # stamp — valid JSON, wrong bytes: exactly what a corrupt
            # wire or buffer produces, and what the destination's
            # verify must catch.
            doc = json.loads(json.dumps(doc))
            for payload in doc.get("resume", {}).values():
                toks = payload.get("tokens") if isinstance(payload, dict) \
                    else None
                if toks:
                    toks[0] ^= 1
                    break
    body = json.dumps(doc).encode("utf-8")
    req = urllib.request.Request(
        dest_url.rstrip("/") + "/v1/migrate",
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            if resp.status != 200:
                return False
            doc = json.loads(resp.read().decode("utf-8"))
            return bool(doc.get("accepted"))
    except Exception:  # noqa: BLE001 — shipping is best-effort by contract
        return False


__all__ = [
    "DRAINING",
    "JOINING",
    "LIFECYCLES",
    "QUARANTINED",
    "RETIRING",
    "SERVING",
    "ElasticController",
    "MigrationRecord",
    "MigrationTable",
    "StreamMigrated",
    "can_transition",
    "placeable",
    "ship_record",
]
