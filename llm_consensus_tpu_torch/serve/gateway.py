"""The consensus serving gateway: a long-lived, stdlib-only HTTP front (a
copy of the single-replica parts of ``llm_consensus_tpu/serve/gateway.py``).

Converts the one-shot CLI pipeline into a resident service: a
``ThreadingHTTPServer`` multiplexes many concurrent consensus runs over
the shared warm engines behind the registry. Endpoints:

  * ``POST /v1/consensus`` — body ``{"prompt": ..., "models": [...],
    "judge": ..., "system": ..., "max_tokens": ..., "timeout": ...,
    "priority": ..., "stream": bool}`` (everything but ``prompt`` defaults
    from the server config). JSON response, or — with ``"stream": true``
    or an ``Accept: text/event-stream`` header — an SSE stream of
    per-model chunks and judge synthesis, ending in a ``done`` event
    carrying the full result envelope.
  * ``GET /healthz`` — liveness + drain state (503 while draining or
    quarantined, so load balancers pull the replica) + the membership
    lifecycle (serve/elastic.py).
  * ``GET /statsz`` — admission snapshot, cache stats, live-flight depth,
    runs executed, and every registered subsystem block (serve/stats.py).
  * ``GET /metricsz`` — Prometheus text format: the live histogram plane
    plus the /statsz blocks flattened into ``llmc_stat`` gauges
    (obs/prom.py).
  * ``POST /debugz/blackbox`` and ``POST /debugz/profile`` — an on-demand
    flight-recorder dump and one bounded ``torch.profiler`` window.
  * ``POST /v1/swap`` — hot-swap a model's weights onto a checkpoint (or
    roll back) without dropping streams; ``POST /v1/quarantine`` — the
    integrity quarantine walk (with ``{"to": url}`` its residents migrate).
  * ``POST /v1/migrate`` — a retiring peer ships one resident stream's
    sealed journal state here; the record parks in the migration table
    until the router's failover re-submission claims it by coalescing key
    and resumes the stream (``POST /v1/retire {"to": url}`` is the admin
    trigger on the source side, serve/elastic.py).

``announce(router_url)`` registers the gateway with a fleet router
(serve/router.py) by periodic heartbeat: its URL, ``load_score``, drain
state, lifecycle and weight version; each beat is also one quarantine probe
window.

Request flow: drain check → shed check (the pressure governor) → cache
lookup (a hit costs no slot and no model run) → single-flight join (an
identical in-flight request makes this one a *follower*: it streams the
leader's chunks and result, no slot, no run) → admission (slot or 429/503
+ ``Retry-After``) → scheduler execution. So a thundering herd of M
identical prompts costs exactly one panel+judge execution, one admission
slot, and M streamed responses with M distinct run ids.

Client disconnects (real or injected via the ``serve`` fault site's
``disconnect``) only stop that connection's writes: a leader whose
client vanishes mid-stream still finishes the run — followers and the
cache get the result.

The gateway reads no environment: warm-up, quarantine, SLO, migration and
feature settings are constructor arguments, the heartbeat's cadence an
argument of ``announce`` (``cli/serve.py`` reads them through
``utils/knobs.py``).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from llm_consensus_tpu_torch.providers import Registry
from llm_consensus_tpu_torch.serve.admission import (
    AdmissionController,
    ClientGone,
    Draining,
    QueueFull,
    RetryLater,
)
from llm_consensus_tpu_torch.serve.cache import ConsensusCache, FlightTable, cache_key
from llm_consensus_tpu_torch.serve.scheduler import Scheduler, ServeRequest
from llm_consensus_tpu_torch.serve import elastic as elastic_mod
from llm_consensus_tpu_torch.utils.context import Cancelled, DeadlineExceeded

DEFAULT_TIMEOUT_S = 120.0
# Decode-heartbeat normalization for load_score: a busy pool whose last
# decode chunk is this old reads as fully loaded on that component.
HEARTBEAT_REF_S = 5.0


def client_disconnected(sock) -> bool:
    """True when the request's client already hung up.

    A non-blocking ``MSG_PEEK`` distinguishes the three cases without
    consuming bytes: EOF (``b""``) means the peer closed, pending data
    means a live (pipelined) client, and would-block means a live client
    waiting for our response."""
    try:
        flag = getattr(socket, "MSG_DONTWAIT", 0)
        if flag:
            return sock.recv(1, socket.MSG_PEEK | flag) == b""
        prev = sock.gettimeout()
        sock.settimeout(0.0)
        try:
            return sock.recv(1, socket.MSG_PEEK) == b""
        finally:
            sock.settimeout(prev)
    except (BlockingIOError, InterruptedError):
        return False
    except OSError:
        return True  # reset/invalid socket: the client is gone either way


class BadRequest(ValueError):
    """Client error → HTTP 400 with the message."""


class _SSEWriter:
    """Writes SSE frames, absorbing client disconnects.

    Once a write fails (client gone, or an injected ``disconnect``), all
    later writes are no-ops — the serving side keeps running."""

    def __init__(self, wfile):
        self._wfile = wfile
        self.broken = False

    def event(self, name: str, data: dict) -> None:
        if self.broken:
            return
        frame = f"event: {name}\ndata: {json.dumps(data, ensure_ascii=False)}\n\n"
        try:
            self._wfile.write(frame.encode("utf-8"))
            self._wfile.flush()
        except OSError:
            self.broken = True


class _Resident:
    """One leader run currently decoding on this gateway — the unit a
    retire ships out. Tracks the per-(kind, model) emitted text so the
    migration record is self-describing, and the ``migrated`` flag the
    leader checks when its context is cancelled out from under it."""

    def __init__(self, key: str, req: ServeRequest, ctx):
        self.key = key
        self.req = req
        self.ctx = ctx
        self._lock = threading.Lock()
        self._emitted: dict[tuple[str, str], list[str]] = {}
        self._migrated = False

    def note(self, kind: str, model: str, text: str) -> None:
        with self._lock:
            self._emitted.setdefault((kind, model), []).append(text)

    def emitted(self) -> dict:
        with self._lock:
            return {
                f"{kind}:{model}": "".join(parts)
                for (kind, model), parts in self._emitted.items()
            }

    def mark_migrated(self) -> None:
        with self._lock:
            self._migrated = True

    @property
    def migrated(self) -> bool:
        with self._lock:
            return self._migrated


class ConsensusGateway:
    """Wires scheduler + admission + cache behind the HTTP server."""

    def __init__(
        self,
        scheduler: Scheduler,
        admission: AdmissionController,
        cache: ConsensusCache,
        *,
        registry: Registry,
        models: list[str],
        judge: str,
        system: Optional[str] = None,
        max_tokens: Optional[int] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
        host: str = "127.0.0.1",
        port: int = 0,
        log: Optional[Callable[[str], None]] = None,
        governor=None,
        live=None,
        lifecycle: Optional[str] = None,
        warm_s: float = 0.0,
        quarantine_after: int = 3,
        probe_n: int = 3,
        slo_ttft_p99_s: float = 0.0,
        slo_windows: int = 3,
        migrate_timeout_s: float = 10.0,
        features: Optional[dict] = None,
    ):
        self.scheduler = scheduler
        self.admission = admission
        self.cache = cache
        # Pressure governor (pressure/governor.py): None = the
        # pre-governor overload behavior. Its sampling thread starts
        # with the gateway and stops on close.
        self.governor = governor
        self.registry = registry
        self.default_models = list(models)
        self.default_judge = judge
        self.default_system = system
        self.default_max_tokens = max_tokens
        self.default_timeout = timeout
        self._host = host
        self._port = port
        self._log = log
        self._flights = FlightTable()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = time.monotonic()
        # Set at close: an open /debugz/profile window closes with it, and
        # so does the announce heartbeat.
        self._closing = threading.Event()
        # Configuration the build_info gauge reports (kv_pool, spec).
        self._features = dict(features or {})
        # Open consensus requests, counted from after the drain check to
        # after the response write. Admission slots cover only the
        # leader's execute window; drain must ALSO wait for followers,
        # cache-hit replays, and the post-release response/cache writes —
        # otherwise a SIGTERM landing as execute() returns reports a
        # clean drain while handler threads (daemons) still hold
        # unwritten responses and unflushed follower run dirs.
        self._open_cond = threading.Condition()
        self._open_requests = 0
        from llm_consensus_tpu_torch import faults, obs

        self._faults = faults.plan()
        self._obs = obs.recorder()
        # Live metrics plane (obs/live): TTFT/queue-wait/e2e histograms
        # behind GET /metricsz, labeled by priority class and outcome.
        # ``live`` override keeps multi-gateway tests per-replica; the
        # process singleton is the production binding.
        self._live = live if live is not None else obs.live.metrics()
        # Flight recorder (obs/blackbox): request spans in the always-on
        # ring; the SLO-burn watcher dumps it.
        self._bb = obs.blackbox.ring()
        # Chip-time attribution (obs/attrib): the /statsz ``attrib``
        # block + the labeled device-time/goodput/compile counters on
        # /metricsz come from this ledger.
        self._attrib = obs.attrib.ledger()
        # Roofline plane (obs/roofline): per-family static costs joined
        # with the attrib walls — the /statsz ``roofline`` block + the
        # roofline counter families on /metricsz.
        self._roofline = obs.roofline.ledger()
        # Deep profiler (obs/profiler): POST /debugz/profile arms one
        # bounded torch.profiler window on a thread of its own.
        self._profiler = obs.profiler.profiler()
        from llm_consensus_tpu_torch.obs.live import SLOWatcher

        self._slo = SLOWatcher(threshold_s=slo_ttft_p99_s, windows=slo_windows,
                               on_burn=self._on_slo_burn)
        if self._live is not None and self._slo.enabled:
            self._live.on_rotate(self._slo.check)
        # Membership lifecycle (serve/elastic.py): joining → serving →
        # draining → retiring. With ``warm_s`` > 0 (LLMC_ELASTIC_WARM_S)
        # the gateway starts as ``joining`` (advertised not-placeable —
        # load_score 1.0) and flips to ``serving`` once warm; an explicit
        # ``lifecycle`` argument overrides.
        self._elastic_mod = elastic_mod
        if lifecycle is None:
            lifecycle = (
                elastic_mod.JOINING if warm_s and warm_s > 0
                else elastic_mod.SERVING
            )
        self._warm_s = warm_s
        self._lifecycle_lock = threading.Lock()
        self._lifecycle = lifecycle
        # Resident-shipping serialization: retire() and quarantine() can
        # race (admin POST vs a request thread crossing the strike
        # threshold), and two concurrent walks over the same residents
        # would double-ship and double-cancel a stream. Ship under ONE
        # lock; the later walk sees ``resident.migrated`` and falls back.
        # (Ordered before _lifecycle_lock.)
        self._ship_lock = threading.Lock()
        # The source's bounded wait for a destination to take one stream
        # (LLMC_ELASTIC_MIGRATE_TIMEOUT_S).
        self._migrate_timeout_s = migrate_timeout_s
        # Resident leader runs (key → record) + the destination-side
        # migration table: the two halves of live stream migration.
        self._residents: dict[str, _Resident] = {}
        self._migrations = elastic_mod.MigrationTable()
        self._elastic_counts = {
            "migrations_out": 0, "migrations_in": 0, "migrations_resumed": 0,
            "migrate_fallbacks": 0, "retires": 0,
            "quarantines": 0, "unquarantines": 0,
        }
        # Integrity plane (integrity/): corruption-detection counters +
        # the replica-level quarantine tracker. Repeated integrity fires
        # walk this replica into the ``quarantined`` lifecycle state
        # (placeable() is serving-only); probe_quarantine() brings it back
        # to serving after consecutive clean windows. quarantine_after=0
        # (LLMC_INTEGRITY_QUARANTINE_AFTER) keeps detection without the
        # lifecycle walk.
        from llm_consensus_tpu_torch import integrity as integrity_mod

        self._integrity_mod = integrity_mod
        self._integrity = integrity_mod.plane()
        self._quarantine = (
            integrity_mod.QuarantineTracker(quarantine_after, probe_n)
            if self._integrity is not None and quarantine_after > 0 else None
        )
        # Failure-count watermark for probe windows: a window is clean
        # iff no integrity failure landed since the last probe.
        self._probe_mark = 0  # guarded by: _lifecycle_lock
        # Stats-provider registry: every introspection block /statsz and
        # /metricsz serve registers HERE once — both surfaces iterate it.
        from llm_consensus_tpu_torch.serve.stats import StatsRegistry

        self.stats_registry = StatsRegistry()
        self._register_stats()

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        assert self._httpd is not None, "gateway not started"
        return self._httpd.server_address[0], self._httpd.server_address[1]

    def start(self) -> tuple[str, int]:
        """Bind and serve in a background thread; returns (host, port) —
        with ``port=0`` the OS picks one (tests, parallel dryruns)."""
        gateway = self

        class Handler(_Handler):
            _gateway = gateway

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="serve-gateway",
            daemon=True,
        )
        self._thread.start()
        if self.lifecycle == self._elastic_mod.JOINING and self._warm_s:
            # Warmup window: the replica is up but not placeable until
            # the engines are warm; the timer flips it to serving.
            timer = threading.Timer(self._warm_s, self.mark_serving)
            timer.daemon = True
            timer.start()
        if self.governor is not None:
            self.governor.start()
        if self._live is not None:
            # Window rotation (and through it the SLO watcher) runs for
            # the life of the process; start() is idempotent, so many
            # in-process gateways share one rotator.
            self._live.start()
        return self.address

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, finish in-flight runs (their
        ``data/<run-id>/`` flushes inside execute), wait for every open
        request — followers and cache replays included — to finish
        writing its response, then stop the server.

        With ``drain=False`` — or when the drain times out — in-flight
        runs are hard-cancelled through their contexts instead. Returns
        True when every request finished cleanly."""
        self._closing.set()
        if self.governor is not None:
            self.governor.close()
        if self._live is not None:
            # Detach the SLO watcher from the (possibly process-wide)
            # live plane: a closed gateway must not keep firing dumps or
            # stay reachable through the rotation callback list.
            self._live.remove_rotate(self._slo.check)
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            drained = self.admission.drain(timeout)
            drained = self._await_quiesce(deadline) and drained
        else:
            self.admission.begin_drain()
            drained = False
        if not drained:
            self.scheduler.cancel_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return drained

    def announce(self, router_url: str, interval_s: float = 2.0) -> None:
        """Register with a fleet router by periodic heartbeat POST.

        Every ``interval_s`` (``LLMC_FLEET_HEARTBEAT_S``) the gateway POSTs
        ``/v1/register`` on the router with its own URL, current
        ``load_score``, drain state, lifecycle and weight version —
        push-based membership, so a fleet can grow without router-side
        discovery config. A missed heartbeat ages the registration out on
        the router side; the loop itself is best-effort (an unreachable
        router must never hurt serving). Each beat is also one quarantine
        probe window. Call after :meth:`start` (the advertised URL needs
        the bound port); the beat stops at :meth:`close`."""
        host, port = self.address
        self_url = f"http://{host}:{port}"
        register_url = router_url.rstrip("/") + "/v1/register"

        def beat() -> None:
            import http.client
            import urllib.parse

            parsed = urllib.parse.urlsplit(register_url)
            first = True
            while not self._closing.wait(0.0 if first else interval_s):
                first = False
                try:
                    self.probe_quarantine()
                except Exception:  # noqa: BLE001 — heartbeat must not die
                    pass
                lifecycle = self.lifecycle
                body = json.dumps({
                    "url": self_url,
                    "load_score": self.load_score(),
                    # Drain is advertised consistently: the admission
                    # controller's flag OR a draining/retiring lifecycle —
                    # the router must never place new work on a replica
                    # that is shipping its residents out.
                    "draining": self.admission.draining or lifecycle in (
                        self._elastic_mod.DRAINING,
                        self._elastic_mod.RETIRING,
                    ),
                    "lifecycle": lifecycle,
                    "weight_version": self.weight_version(),
                    "interval_s": interval_s,
                }).encode("utf-8")
                try:
                    conn = http.client.HTTPConnection(
                        parsed.netloc, timeout=max(1.0, interval_s)
                    )
                    try:
                        conn.request(
                            "POST", parsed.path, body,
                            {"Content-Type": "application/json"},
                        )
                        conn.getresponse().read()
                    finally:
                        conn.close()
                except (OSError, http.client.HTTPException):
                    pass  # router down/unreachable: keep serving, retry

        threading.Thread(target=beat, name="serve-announce", daemon=True).start()

    def _await_quiesce(self, deadline: Optional[float]) -> bool:
        with self._open_cond:
            while self._open_requests > 0:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._open_cond.wait(0.25 if rem is None else min(0.25, rem))
        return True

    # -- lifecycle state (serve/elastic.py) ----------------------------------

    @property
    def lifecycle(self) -> str:
        with self._lifecycle_lock:
            return self._lifecycle

    def set_lifecycle(self, state: str) -> None:
        """One forward membership transition (joining → serving →
        draining → retiring; draining may also cancel back to serving).
        Illegal transitions raise — lifecycle is a state machine, not a
        label."""
        with self._lifecycle_lock:
            cur = self._lifecycle
            if state == cur:
                return
            if not self._elastic_mod.can_transition(cur, state):
                raise ValueError(
                    f"illegal lifecycle transition {cur!r} -> {state!r}"
                )
            self._lifecycle = state
        if self._obs is not None:
            self._obs.instant(f"lifecycle_{state}", tid="serve")
            self._obs.count(f"elastic.lifecycle.{state}")
        self.log(f"lifecycle: {cur} -> {state}")

    def mark_serving(self) -> None:
        """Warmup finished (or a drain was cancelled): start placing."""
        try:
            self.set_lifecycle(self._elastic_mod.SERVING)
        except ValueError:
            pass  # already past serving (a retire raced the warm timer)

    # -- live stream migration (serve/elastic.py) ----------------------------

    def _resident_register(self, key: str, req: ServeRequest,
                           ctx) -> _Resident:
        resident = _Resident(key, req, ctx)
        with self._lifecycle_lock:
            self._residents[key] = resident
        return resident

    def _resident_unregister(self, key: str) -> None:
        with self._lifecycle_lock:
            self._residents.pop(key, None)

    def _migration_record(self, resident: _Resident):
        """Build one stream's shippable state: per-panel-model journal
        payloads via the provider's ``seal_stream`` hook (the sealed token
        snapshot is authoritative, late decode appends are dropped and
        regenerated by the resume), with the emitted-text prefix as the
        provider-agnostic fallback."""
        req = resident.req
        emitted = resident.emitted()
        resume: dict = {}
        for model in dict.fromkeys(req.models):
            payload = None
            provider = self.registry.get(model)
            seal = getattr(provider, "seal_stream", None)
            if seal is not None and req.trace_id:
                try:
                    payload = seal(req.trace_id, model)
                except Exception:  # noqa: BLE001 — fallback below
                    payload = None
            if payload is None:
                payload = {
                    "text": emitted.get(f"model_chunk:{model}", ""),
                }
            resume[model] = payload
        flags = {
            "kv_pool": bool(self._features.get("kv_pool")),
            "spec": bool(self._features.get("spec")),
            "disagg": bool(self._features.get("disagg")),
        }
        host, port = self.address
        return self._elastic_mod.MigrationRecord(
            key=resident.key,
            resume=resume,
            emitted=emitted,
            priority=req.priority,
            trace_id=req.trace_id,
            flags=flags,
            source=f"http://{host}:{port}",
        )

    def retire(self, to: Optional[str] = None,
               timeout_s: Optional[float] = None) -> dict:
        """Policy-proactive scale-down: stop admitting, ship every
        resident leader stream to ``to`` via ``POST /v1/migrate``, and
        finish locally whatever the destination would not take (the
        ``migrate_stall`` fault, a refused offer, or no destination at
        all — drain-and-wait, never a dropped stream).

        A shipped stream's context is cancelled; the leader converts the
        cancel into :class:`~llm_consensus_tpu_torch.serve.elastic
        .StreamMigrated` and closes its SSE leg without a terminal event
        — the exact wire shape of a crashed replica — so the router's
        failover re-submission lands on the destination (this replica is
        draining, hence out of candidates), claims the shipped record,
        and resumes byte-identically behind the StreamLedger."""
        try:
            self.set_lifecycle(self._elastic_mod.DRAINING)
        except ValueError:
            pass  # already draining/retiring: idempotent
        self.admission.begin_drain()
        with self._lifecycle_lock:
            self._elastic_counts["retires"] += 1
        residents, migrated, fallback = self._ship_residents(
            to, timeout_s=timeout_s
        )
        try:
            self.set_lifecycle(self._elastic_mod.RETIRING)
        except ValueError:
            pass
        if self._obs is not None:
            self._obs.count("elastic.retires")
        return {
            "residents": residents,
            "migrated": migrated,
            "fallback": fallback,
            "lifecycle": self.lifecycle,
        }

    def _ship_residents(self, to: Optional[str],
                        timeout_s: Optional[float] = None
                        ) -> "tuple[int, int, int]":
        """Ship every resident leader stream to ``to`` (the loop retire
        and quarantine share); returns ``(residents, migrated,
        fallback)``. A refused/stalled/destination-less stream counts as
        fallback and finishes locally — never dropped. Serialized on
        ``_ship_lock``: concurrent walks (a retire racing a quarantine)
        must never ship-and-cancel the same resident twice."""
        if timeout_s is None:
            timeout_s = self._migrate_timeout_s
        with self._ship_lock:
            with self._lifecycle_lock:
                residents = list(self._residents.values())
            migrated = 0
            fallback = 0
            for i, resident in enumerate(residents, start=1):
                stalled = False
                if self._faults is not None:
                    fs = self._faults.fire("serve", phase="migrate", stream=i)
                    stalled = fs is not None and fs.kind == "migrate_stall"
                shipped = False
                if to is not None and not stalled and not resident.migrated:
                    record = self._migration_record(resident)
                    shipped = self._elastic_mod.ship_record(
                        to, record, timeout_s=timeout_s
                    )
                if shipped:
                    # Order matters: the destination holds the record BEFORE
                    # the leader's cancel closes the client leg, so the
                    # failover re-submission can never miss it.
                    resident.mark_migrated()
                    resident.ctx.cancel()
                    migrated += 1
                    with self._lifecycle_lock:
                        self._elastic_counts["migrations_out"] += 1
                    if self._obs is not None:
                        self._obs.count("elastic.migrations")
                else:
                    fallback += 1
                    with self._lifecycle_lock:
                        self._elastic_counts["migrate_fallbacks"] += 1
                    if self._obs is not None:
                        self._obs.count("elastic.migrate_fallbacks")
            return len(residents), migrated, fallback

    def accept_migration(self, body: bytes) -> "tuple[int, dict]":
        """Destination half of ``POST /v1/migrate``: park the record
        until the router's re-submission claims it by key."""
        try:
            doc = json.loads(body.decode("utf-8"))
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            record = self._elastic_mod.MigrationRecord.from_doc(doc)
        except (ValueError, UnicodeDecodeError) as err:
            return 400, {"accepted": False, "error": f"bad record: {err}"}
        if self._integrity is not None:
            self._integrity.check("migration")
        if not record.verify_digest():
            # A record whose content digest does not reproduce was
            # corrupted in transit: refuse it — the source falls back to
            # finishing the stream locally (reuse lost, never a resume
            # from poisoned state).
            if self._integrity is not None:
                self._integrity.failure(
                    "migration",
                    f"record digest mismatch for {record.key[:12]}",
                )
                self.record_integrity_strike("migration")
            return 200, {
                "accepted": False, "error": "record digest mismatch",
            }
        if self.admission.draining or not self._elastic_mod.placeable(
            self.lifecycle
        ):
            # A draining/joining destination must refuse: the source
            # falls back to finishing the stream locally.
            return 200, {
                "accepted": False,
                "error": f"not placeable (lifecycle {self.lifecycle})",
            }
        self._migrations.offer(record)
        with self._lifecycle_lock:
            self._elastic_counts["migrations_in"] += 1
        if self._obs is not None:
            self._obs.count("elastic.migrations_in")
        return 200, {"accepted": True, "key": record.key}

    # -- integrity containment (integrity/) ----------------------------------

    def record_integrity_strike(self, surface: str) -> None:
        """One integrity failure observed on a request path. With the
        quarantine tracker armed (LLMC_INTEGRITY_QUARANTINE_AFTER > 0),
        repeated fires walk this replica into ``quarantined``; the
        threshold crossing fires :meth:`quarantine` exactly once."""
        if self._obs is not None:
            self._obs.count(f"integrity.strikes.{surface}")
        if self._quarantine is not None and self._quarantine.strike():
            self.quarantine()

    def quarantine(self, to: Optional[str] = None,
                   timeout_s: Optional[float] = None) -> dict:
        """Integrity containment: walk this replica to ``quarantined`` and
        (when a destination is known) migrate resident streams away.

        Unlike :meth:`retire`, admission is NOT drained — quarantine is
        reversible (:meth:`probe_quarantine`, one window per announce
        heartbeat, lifts it after ``probe_n`` consecutive clean windows),
        and the router stops placing the moment the heartbeat carries the
        new lifecycle (``placeable()`` is serving-only)."""
        try:
            self.set_lifecycle(self._elastic_mod.QUARANTINED)
        except ValueError:
            # Already draining/retiring/quarantined: those states are at
            # least as contained as quarantine; nothing to walk.
            return {"lifecycle": self.lifecycle}
        with self._lifecycle_lock:
            self._elastic_counts["quarantines"] += 1
            if self._integrity is not None:
                # Arm the probe watermark at the CURRENT failure count:
                # only failures after this point dirty a probe window.
                self._probe_mark = sum(
                    self._integrity.counters.snapshot()["failures"].values()
                )
        if self._obs is not None:
            self._obs.count("integrity.quarantines")
        residents, migrated, fallback = self._ship_residents(
            to, timeout_s=timeout_s
        )
        self.log(
            f"replica quarantined ({migrated}/{residents} residents "
            f"migrated, {fallback} finishing locally)"
        )
        return {
            "residents": residents,
            "migrated": migrated,
            "fallback": fallback,
            "lifecycle": self.lifecycle,
        }

    def probe_quarantine(self) -> bool:
        """One quarantine probe window (rides the announce heartbeat): a
        window with no new integrity failures counts clean, and
        ``probe_n`` consecutive clean windows lift the quarantine back
        to serving. Returns True when the quarantine lifted."""
        if self._quarantine is None or (
            self.lifecycle != self._elastic_mod.QUARANTINED
        ):
            return False
        total = 0
        if self._integrity is not None:
            total = sum(
                self._integrity.counters.snapshot()["failures"].values()
            )
        with self._lifecycle_lock:
            clean = total <= self._probe_mark
            self._probe_mark = total
        if not clean:
            # A dirty window resets the consecutive-clean run the same
            # way a strike would.
            self._quarantine.strike()
            return False
        if not self._quarantine.clean_probe():
            return False
        try:
            self.set_lifecycle(self._elastic_mod.SERVING)
        except ValueError:
            return False  # a retire raced the probe; stay contained
        with self._lifecycle_lock:
            self._elastic_counts["unquarantines"] += 1
        if self._obs is not None:
            self._obs.count("integrity.unquarantines")
        self.log("quarantine lifted: probe windows clean")
        return True

    # -- weight hot-swap ------------------------------------------------------

    def weight_version(self) -> int:
        """Max resident weight version across this replica's providers
        — 0 until a checkpoint has been swapped in; /statsz and /metricsz
        (``llmc_weight_version``) report it."""
        best = 0
        seen: set = set()
        for model in self.registry.models():
            provider = self.registry.get(model)
            if id(provider) in seen:
                continue
            seen.add(id(provider))
            fn = getattr(provider, "weight_version", None)
            if fn is None:
                continue
            try:
                best = max(best, int(fn()))
            except Exception:  # noqa: BLE001 — heartbeat must not throw
                pass
        return best

    def swap_checkpoint(self, doc: dict) -> "tuple[int, dict]":
        """POST /v1/swap: hot-swap a model onto a checkpoint without
        dropping streams.

        Body: ``{"model", "out_dir": distill output root}`` resolves the
        newest complete version through
        ``flywheel.distill.latest_checkpoint`` (its ``version.json`` gives
        the version and the meta, ``params_digest`` included; 404 when
        there is none), or ``{"model", "checkpoint": path, "version"}``
        names the checkpoint: for the gpu provider a directory of HF
        safetensors (engine/checkpoint.py). ``wait`` blocks the response
        until the flip (bounded by LLMC_SWAP_WAIT_S).
        ``{"action": "rollback"}`` restores the previous resident buffer
        under a new monotone version. Returns the provider's swap stats;
        409 when the swap was rejected (stale version, a params-digest
        mismatch) or there is nothing to roll back to."""
        model = doc.get("model")
        if not isinstance(model, str) or model not in self.registry:
            return 400, {
                "error": f"unknown model {model!r}; this server hosts "
                f"{self.registry.models()}"
            }
        provider = self.registry.get(model)
        action = doc.get("action", "swap")
        if action == "rollback":
            fn = getattr(provider, "rollback_weights", None)
            if fn is None:
                return 501, {"error": "provider does not support swaps"}
            version = fn(
                model, meta={"reason": str(doc.get("reason", "manual"))}
            )
            if version is None:
                return 409, {"error": "nothing to roll back to"}
            if self._obs is not None:
                self._obs.count("flywheel.rollbacks")
            self.log(f"weights rolled back -> v{version} ({model})")
            return 200, {
                "model": model, "action": "rollback",
                "weight_version": version,
            }
        if action != "swap":
            return 400, {"error": f"unknown swap action {action!r}"}
        path = doc.get("checkpoint")
        version = doc.get("version")
        meta: dict = {}
        if path is None:
            out_dir = doc.get("out_dir")
            if not isinstance(out_dir, str):
                return 400, {
                    "error": "swap needs 'checkpoint' (params path) or "
                    "'out_dir' (distill output root)"
                }
            from llm_consensus_tpu_torch.flywheel.distill import latest_checkpoint

            latest = latest_checkpoint(out_dir)
            if latest is None:
                return 404, {"error": f"no checkpoint under {out_dir!r}"}
            path = latest["params_path"]
            if version is None:
                version = latest.get("version")
            meta = {k: v for k, v in latest.items() if k != "params_path"}
        if not isinstance(path, str):
            return 400, {"error": "'checkpoint' must be a path"}
        if version is not None and (
            isinstance(version, bool) or not isinstance(version, int)
        ):
            return 400, {"error": "'version' must be an integer"}
        fn = getattr(provider, "swap_weights", None)
        if fn is None:
            return 501, {"error": "provider does not support swaps"}
        try:
            stats = fn(
                model, path, version,
                wait=bool(doc.get("wait", False)), meta=meta,
            )
        except Exception as err:  # noqa: BLE001 — admin surface, one error
            return 500, {"error": f"swap failed: {err}"}
        accepted = bool(stats.get("accepted"))
        if self._obs is not None:
            self._obs.count(
                "flywheel.swaps" if accepted else "flywheel.swap_rejects"
            )
        if stats.get("rejected") == "params_digest_mismatch":
            # The provider's integrity plane refused the checkpoint: it
            # never became latest; a replica fed repeated rotten
            # checkpoints still walks to quarantine.
            self.record_integrity_strike("ckpt")
        self.log(
            f"weight swap {'accepted' if accepted else 'REJECTED'} "
            f"-> v{stats.get('weight_version')} ({model})"
        )
        return (200 if accepted else 409), {
            "model": model, "action": "swap", **stats,
        }

    def parse_request(self, body: bytes) -> ServeRequest:
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as err:
            raise BadRequest(f"invalid JSON body: {err}") from err
        if not isinstance(doc, dict):
            raise BadRequest("body must be a JSON object")
        prompt = doc.get("prompt")
        if not isinstance(prompt, str) or not prompt.strip():
            raise BadRequest('"prompt" (non-empty string) is required')
        models = doc.get("models", self.default_models)
        if not isinstance(models, list) or not all(
            isinstance(m, str) for m in models
        ) or not models:
            raise BadRequest('"models" must be a non-empty list of strings')
        judge = doc.get("judge", self.default_judge)
        if not isinstance(judge, str) or not judge:
            raise BadRequest('"judge" must be a model name')
        for m in dict.fromkeys(models + [judge]):
            if m not in self.registry:
                raise BadRequest(
                    f"unknown model {m!r}; this server hosts "
                    f"{self.registry.models()}"
                )
        system = doc.get("system", self.default_system)
        if system is not None and not isinstance(system, str):
            raise BadRequest('"system" must be a string')
        max_tokens = doc.get("max_tokens", self.default_max_tokens)
        if max_tokens is not None and (
            isinstance(max_tokens, bool) or not isinstance(max_tokens, int)
            or max_tokens < 1
        ):
            raise BadRequest('"max_tokens" must be a positive integer')
        timeout = doc.get("timeout", self.default_timeout)
        if isinstance(timeout, bool) or not isinstance(timeout, (int, float)) \
                or timeout <= 0:
            raise BadRequest('"timeout" must be a positive number')
        stream = doc.get("stream", False)
        if not isinstance(stream, bool):
            raise BadRequest('"stream" must be a boolean')
        from llm_consensus_tpu_torch.pressure import resolve_priority

        try:
            # Explicit "priority" ("high"/"normal"/"low" or 0-2) wins;
            # otherwise the request DEADLINE classifies it (a tight
            # budget reads as interactive, a huge one as batch).
            priority = resolve_priority(
                doc.get("priority"), timeout_s=float(timeout)
            )
        except ValueError as err:
            raise BadRequest(str(err)) from err
        return ServeRequest(
            prompt=prompt,
            models=list(models),
            judge=judge,
            system=system or None,
            max_tokens=max_tokens,
            timeout=float(timeout),
            stream=stream,
            priority=priority,
        )

    def key_for(self, req: ServeRequest) -> str:
        return cache_key(
            req.models, req.judge, req.prompt,
            system=req.system, max_tokens=req.max_tokens,
        )

    def load_score(self) -> float:
        """One scalar in [0, 1] summarizing how loaded this replica is —
        the router's placement signal, so placement policy lives HERE
        (next to the knobs that define capacity) and the router never
        re-derives it from raw counters. Composition: execution-slot
        occupancy (the hard capacity), queue depth (latency already
        committed), and the busy decode-heartbeat age (a struggling or
        recovering engine reads as loaded even with free slots). A
        ``joining`` replica reads fully loaded until warm — cold engines
        have no capacity worth advertising."""
        if self.lifecycle == self._elastic_mod.JOINING:
            return 1.0
        adm = self.admission.snapshot()
        occupancy = adm["active"] / max(1, adm["max_concurrency"])
        if adm["max_queue"] > 0:
            queued = adm["waiting"] / adm["max_queue"]
        else:
            queued = 1.0 if adm["waiting"] else 0.0
        # Disaggregation backpressure: a saturated handoff queue is
        # admission latency already committed upstream of the batcher, so
        # it folds into the queued component.
        try:
            for block in self.disagg_stats().values():
                frac = block.get("queued", 0) / max(1, block.get("depth", 1))
                queued = max(queued, min(1.0, frac))
        except Exception:  # noqa: BLE001 — load_score must not throw
            pass
        heartbeat = 0.0
        recovery = self.recovery_stats()
        if recovery is not None:
            if recovery["state"] != "ok":
                heartbeat = 1.0
            else:
                age = recovery.get("decode_heartbeat_age_s")
                if age is not None:  # worst BUSY pool; idle pools excluded
                    heartbeat = min(1.0, age / HEARTBEAT_REF_S)
        score = 0.5 * occupancy + 0.35 * queued + 0.15 * heartbeat
        return round(min(1.0, score), 4)

    def _register_stats(self) -> None:
        """Wire every introspection block into the stats registry ONCE;
        /statsz nests the blocks, /metricsz flattens them into gauges —
        a new subsystem registers here and appears on both surfaces."""
        reg = self.stats_registry
        reg.register("admission", self.admission.snapshot)
        reg.register("cache", self.cache.stats)

        def batchers() -> dict:
            from llm_consensus_tpu_torch.obs.export import collect_batcher_stats

            return collect_batcher_stats(self.registry)

        reg.register("batchers", batchers)

        def recovery_block() -> Optional[dict]:
            recovery = self.recovery_stats()
            if recovery is None:
                return None
            return {
                "state": recovery["state"],
                "restarts": recovery["restarts"],
                "replayed_streams": recovery["replayed_streams"],
                "journal_depth": recovery["journal_depth"],
            }

        reg.register("recovery", recovery_block)

        def kv_block() -> Optional[dict]:
            kv = self.kv_stats()
            if not kv:
                return None
            # Aggregate exhaustion across presets at the top of the
            # block: the one number an operator alarms on — reuse is
            # silently degrading RIGHT NOW when it moves.
            out = dict(kv)
            out["exhausted_total"] = sum(
                snap.get("exhausted", 0) for snap in kv.values()
                if isinstance(snap, dict)
            )
            return out

        reg.register("kv", kv_block)
        reg.register("spec", self.spec_stats)

        def pressure_block() -> Optional[dict]:
            if self.governor is None:
                return None
            pressure = self.governor.snapshot()
            pools = {}
            for model in dict.fromkeys(self.registry.models()):
                provider = self.registry.get(model)
                fn = getattr(provider, "pressure_stats", None)
                if fn is None:
                    continue
                try:
                    pools.update(fn())
                except Exception:  # noqa: BLE001 — stats must not 500
                    continue
            if pools:
                pressure["pools"] = pools
            return pressure

        reg.register("pressure", pressure_block)

        def obs_block() -> Optional[dict]:
            if self._obs is None:
                return None
            # Recorder drop accounting: a truncated trace must say so
            # everywhere telemetry is read, not just in the trace.
            return {
                "recorded_events": self._obs.depth(),
                "dropped_events": self._obs.dropped,
            }

        reg.register("obs", obs_block)

        def blackbox_block() -> Optional[dict]:
            if self._bb is None:
                return None
            out = self._bb.stats()
            out["slo_burns"] = self._slo.burns
            return out

        reg.register("blackbox", blackbox_block)

        def attrib_block() -> Optional[dict]:
            if self._attrib is None:
                return None
            return self._attrib.snapshot()

        reg.register("attrib", attrib_block)

        def roofline_block() -> Optional[dict]:
            if self._roofline is None or self._roofline.activity() == 0:
                return None
            return self._roofline.snapshot()

        reg.register("roofline", roofline_block)

        def profiler_block() -> Optional[dict]:
            if self._profiler is None:
                return None
            stats = self._profiler.stats()
            if stats["windows"] == 0 and not stats["active"]:
                return None
            return stats

        reg.register("profiler", profiler_block)

        def utilization_block() -> dict:
            # Live per-pool decode rate + MFU/MBU gauges (scrape-to-
            # scrape batcher deltas — TPUProvider.utilization_stats);
            # flattened by /metricsz into llmc_stat{block="utilization"}.
            # Under disaggregation it carries one entry per ROLE
            # (``<preset>`` decode, ``<preset>:prefill`` the worker
            # mesh), so per-role MFU is a live gauge.
            from llm_consensus_tpu_torch.obs.export import _collect_provider_stats

            return _collect_provider_stats(self.registry, "utilization_stats")

        reg.register("utilization", utilization_block)

        def disagg_block() -> Optional[dict]:
            # Disaggregated prefill → decode (engine/handoff.py): per preset
            # the handoff queue and its bound, waves, bytes/s, fallbacks.
            # Falsy (omitted) unless a handoff is live.
            return self.disagg_stats() or None

        reg.register("disagg", disagg_block)

        def elastic_block() -> dict:
            # Membership state (serve/elastic.py): lifecycle, resident
            # leader runs, and the migration counters both directions —
            # flattened by /metricsz into llmc_stat{block="elastic"}.
            with self._lifecycle_lock:
                out = dict(self._elastic_counts)
                out["lifecycle"] = self._lifecycle
                out["residents"] = len(self._residents)
            out["table"] = self._migrations.stats()
            return out

        reg.register("elastic", elastic_block)

        def integrity_block() -> Optional[dict]:
            # Integrity plane (integrity/): per-surface check/failure
            # counters + the quarantine tracker's hysteresis state —
            # flattened by /metricsz into llmc_stat{block="integrity"}.
            # Falsy (omitted) while the plane is off — the default
            # serving shape is unchanged.
            if self._integrity is None:
                return None
            out = self._integrity.stats()
            if self._quarantine is not None:
                out["quarantine"] = self._quarantine.snapshot()
            return out

        reg.register("integrity", integrity_block)

        def flywheel_block() -> Optional[dict]:
            # Weight hot-swap state (flywheel/ + Engine.swap_stats):
            # per-preset resident weight version, pins, and the
            # swap/reject/queued/rollback counters — flattened by
            # /metricsz into llmc_stat{block="flywheel"}. Falsy
            # (omitted) until an engine exists.
            from llm_consensus_tpu_torch.obs.export import _collect_provider_stats

            return _collect_provider_stats(self.registry, "swap_stats") or None

        reg.register("flywheel", flywheel_block)

    def _on_slo_burn(self, info: dict) -> None:
        """SLO-burn anomaly (p99 TTFT over threshold for N windows):
        snapshot the flight recorder — the tail regression's timeline is
        in the ring RIGHT NOW and gone in a minute."""
        if self._obs is not None:
            self._obs.instant("slo_burn", tid="serve", **info)
            self._obs.count("obs.slo_burns")
        if self._bb is not None:
            self._bb.instant("slo_burn", tid="serve", **info)
            self._bb.dump("slo_burn", extra=info)
        self.log(f"SLO burn: {info}")

    def stats(self) -> dict:
        out = {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "load_score": self.load_score(),
            "live_flights": self._flights.depth(),
            "runs_executed": self.scheduler.runs_executed,
            # Top-level (not just the flywheel block): the fleet health
            # poller reads THIS field off /statsz to version-tag the
            # replica for the router's canary lane.
            "weight_version": self.weight_version(),
        }
        out.update(self.stats_registry.collect())
        return out

    def build_info_labels(self) -> dict:
        """The ``llmc_build_info`` gauge's labels: version, the torch
        version (where the JAX gateway reports jax's), and the enabled
        feature set — so fleet scrapes can correlate behavior with config
        skew across replicas."""
        import torch

        from llm_consensus_tpu_torch.version import __version__

        features = []
        if self._features.get("kv_pool"):
            features.append("kv_pool")
        if self._features.get("disagg"):
            features.append("disagg")
        if self._features.get("spec"):
            features.append("spec")
        if self.governor is not None:
            features.append("pressure")
        if self._live is not None:
            features.append("live")
        if self._attrib is not None:
            features.append("attrib")
        if self._roofline is not None:
            features.append("roofline")
        if self._profiler is not None:
            features.append("profile")
        return {
            "version": __version__,
            "torch": torch.__version__,
            "features": ",".join(features) or "none",
        }

    def metricsz(self) -> str:
        """The Prometheus text body behind GET /metricsz: the live
        histogram families, every /statsz block flattened into
        ``llmc_stat`` gauges, the chip-time attribution counter families,
        and the ``build_info`` gauge (obs/prom.py) — one registry, two
        surfaces."""
        from llm_consensus_tpu_torch.obs import prom

        gauges = {
            "uptime_seconds": round(time.monotonic() - self._started, 3),
            "load_score": self.load_score(),
            "live_flights": self._flights.depth(),
            "runs_executed": self.scheduler.runs_executed,
            "weight_version": self.weight_version(),
            "obs_dropped_events": (
                self._obs.dropped if self._obs is not None else 0
            ),
            "blackbox_dumps": self._bb.dumps if self._bb is not None else 0,
        }
        families: dict = {
            "build_info": {
                "type": "gauge",
                "samples": [(self.build_info_labels(), 1)],
            },
        }
        if self._attrib is not None:
            families.update(self._attrib.prom_families())
        if self._roofline is not None:
            families.update(self._roofline.prom_families())
        if self._integrity is not None:
            families.update(self._integrity.counters.prom_families())
        return prom.render(
            self._live,
            stats_blocks=self.stats_registry.collect(),
            gauges=gauges,
            families=families,
        )

    def debug_blackbox(self, reason: str = "manual") -> "tuple[int, dict]":
        """On-demand flight-recorder dump (POST /debugz/blackbox, the
        serve SIGQUIT handler): snapshot the ring NOW without waiting
        for a crash/SLO trigger. Rate-limited by the recorder's own
        interval so a curl loop cannot fill the disk; returns the HTTP
        status + body."""
        if self._bb is None:
            return 404, {"error": "flight recorder disabled (LLMC_BLACKBOX=0)"}
        path = self._bb.dump(reason)
        stats = self._bb.stats()
        if path is None:
            return 429, {
                "error": "dump suppressed (rate-limited or empty ring)",
                **stats,
            }
        self.log(f"blackbox dump ({reason}): {path}")
        return 200, {"path": path, **stats}

    def debug_profile(self, duration_s: Optional[float] = None,
                      tag: str = "ondemand") -> "tuple[int, dict]":
        """Arm one bounded deep-profiling window (POST /debugz/profile).
        Mirrors the /debugz/blackbox contract: 404 when the profiler is
        disabled, 429 when a window is in flight or inside the rate-
        limit interval, 200 + the artifact path on success (the
        directory appears atomically when the window closes)."""
        if self._profiler is None:
            return 404, {"error": "profiler disabled (LLMC_PROFILE=0)"}
        # torch.profiler stops on the thread that started it, and this
        # handler thread ends once it answers: the window gets an owning
        # thread that closes it at its bound (or at close()).
        path, status = self._profiler.arm_owned(duration_s, tag=tag, stop=self._closing)
        stats = self._profiler.stats()
        if status in ("busy", "rate_limited"):
            return 429, {
                "error": f"profile window suppressed ({status})",
                "status": status, **stats,
            }
        if status != "armed" or path is None:
            return 429, {"error": "profiler failed to arm", **stats}
        self.log(f"profile window armed ({tag}): {path}")
        return 200, {"path": path, "status": status, **stats}

    def spec_stats(self) -> dict:
        """Speculative-decoding state aggregated over the distinct
        providers behind the registry: per-preset rounds, accepted
        tokens, acceptance EMA, and governor state (single-stream
        SpeculativeEngine and/or the pool's batched spec mode). Empty
        when no draft is configured — the ``spec`` block is opt-in like
        the feature. Same aggregation metrics.json uses, so the two
        surfaces can't drift."""
        from llm_consensus_tpu_torch.obs.export import collect_spec_stats

        return collect_spec_stats(self.registry)

    def kv_stats(self) -> dict:
        """Paged-KV-pool state aggregated over the distinct providers
        behind the registry: per-preset hit tokens, block occupancy, and
        evictions — the serve layer caches KV, not just results, so
        /statsz reports the cache layer it sits on. Empty when no pool
        is live. Same aggregation metrics.json uses, so the two surfaces
        can't drift."""
        from llm_consensus_tpu_torch.obs.export import collect_kv_stats

        return collect_kv_stats(self.registry)

    def disagg_stats(self) -> dict:
        """Disaggregated prefill → decode handoff state over the distinct
        providers behind the registry (per preset: queue depth and bound,
        waves, handoff bytes/s, fallbacks). Empty when disaggregation is
        off."""
        from llm_consensus_tpu_torch.obs.export import collect_disagg_stats

        return collect_disagg_stats(self.registry)

    def recovery_stats(self) -> Optional[dict]:
        """Engine liveness + recovery state aggregated over the distinct
        providers behind the registry (providers repeat across models;
        dedup by identity). None when no provider reports any — the
        HTTP-only gateway shape stays unchanged."""
        merged: Optional[dict] = None
        seen: set = set()
        for model in self.registry.models():
            provider = self.registry.get(model)
            if id(provider) in seen:
                continue
            seen.add(id(provider))
            fn = getattr(provider, "recovery_stats", None)
            if fn is None:
                continue
            try:
                stats = fn()
            except Exception:  # noqa: BLE001 — liveness must not 500
                continue
            if merged is None:
                merged = {
                    "state": "ok", "restarts": 0, "replayed_streams": 0,
                    "journal_depth": 0, "heartbeats": {},
                    "decode_heartbeat_age_s": None,
                }
            if stats.get("state") == "recovering":
                merged["state"] = "recovering"
            merged["restarts"] += stats.get("restarts", 0)
            merged["replayed_streams"] += stats.get("replayed_streams", 0)
            merged["journal_depth"] += stats.get("journal_depth", 0)
            merged["heartbeats"].update(stats.get("heartbeats", {}))
            age = stats.get("decode_heartbeat_age_s")
            if age is not None and (
                merged["decode_heartbeat_age_s"] is None
                or age > merged["decode_heartbeat_age_s"]
            ):
                merged["decode_heartbeat_age_s"] = age
        return merged

    def log(self, msg: str) -> None:
        if self._log is not None:
            try:
                self._log(msg)
            except Exception:
                pass

    # -- the serving core ----------------------------------------------------

    def _observe(self, name: str, req: ServeRequest, seconds: float,
                 outcome: str) -> None:
        """One live-histogram observation, labeled by the request's
        priority class and its outcome (obs/live.py label scheme)."""
        if self._live is None:
            return
        from llm_consensus_tpu_torch.obs.live import class_label

        self._live.observe(
            name, seconds, outcome=outcome,
            **{"class": class_label(req.priority)},
        )

    def serve_consensus(self, req: ServeRequest, respond: "_Responder",
                        probe=None) -> None:
        """Full per-request flow: drain check → cache → coalesce → admit →
        execute. ``respond`` owns the HTTP shape (JSON vs SSE); ``probe``
        (when given) reports whether the request's client already hung
        up, so a queued request whose client vanished is dropped at
        dequeue time instead of burning a slot."""
        t0 = time.monotonic()
        t0_ns = time.monotonic_ns()
        outcome = "error"
        try:
            if self.admission.draining:
                outcome = "shed"
                raise Draining(
                    "server is draining", self.admission.retry_after()
                )
            if self.governor is not None and self.governor.should_shed(
                req.priority
            ):
                # The ladder's top rung: the shed classes are rejected
                # before they can queue, with a class-scaled Retry-After —
                # the flood is told to back off harder than the traffic
                # it is flooding.
                outcome = "shed"
                raise QueueFull(
                    "shedding under pressure "
                    f"(governor state {self.governor.state})",
                    self.admission.retry_after(req.priority),
                )
            with self._open_cond:
                self._open_requests += 1
            try:
                outcome = self._serve_consensus(req, respond, t0, probe)
            except RetryLater:
                outcome = "shed"
                raise
            except ClientGone:
                outcome = "gone"
                raise
            except self._elastic_mod.StreamMigrated:
                # The stream moved to another replica mid-decode: not an
                # error, not a completion — the destination's histogram
                # owns the e2e; this label marks the seam.
                outcome = "migrated"
                raise
            finally:
                with self._open_cond:
                    self._open_requests -= 1
                    self._open_cond.notify_all()
        finally:
            if outcome != "gone":
                # End-to-end wall, whatever the outcome — shed requests
                # are cheap and fast, which is exactly what their
                # histogram should show. (A vanished client has no
                # latency anyone experienced; skip it.)
                self._observe("e2e", req, time.monotonic() - t0, outcome)
            if self._bb is not None:
                self._bb.complete(
                    "request", t0_ns, tid="serve", trace=req.trace_id,
                    outcome=outcome, priority=req.priority,
                )

    @staticmethod
    def _result_outcome(out, degraded: Optional[str]) -> str:
        """The request's histogram outcome label: a brownout/remote tag
        wins, then engine-tier preemption, else ok."""
        if degraded is not None:
            return "degraded"
        if any(
            getattr(r, "preempted", False)
            for r in getattr(out, "responses", [])
        ):
            return "preempted"
        return "ok"

    def _serve_consensus(self, req: ServeRequest, respond: "_Responder",
                         t0: float, probe=None) -> str:
        """The per-request core; returns the outcome label for the e2e
        histogram (``ok`` / ``degraded`` / ``preempted``)."""
        degraded: Optional[str] = None
        if self.governor is not None and self.governor.brownout:
            # Brownout transform BEFORE the cache key: the clamped/
            # downgraded request is a different computation, so degraded
            # results cache and coalesce among themselves, never
            # poisoning the full-quality entries.
            req, degraded = self._apply_brownout(req)
        ctx = self.scheduler.request_ctx(req)
        try:
            key = self.key_for(req)
            cached = self.cache.get(key)
            if cached is not None:
                if self._obs is not None:
                    self._obs.instant("cache_hit", tid="serve")
                    self._obs.count("serve.cache_hit")
                self._observe(
                    "ttft", req, time.monotonic() - t0,
                    "degraded" if degraded else "ok",
                )
                session = self.scheduler.persist_copy(req, cached)
                respond.replay(
                    cached, session.run_id, cached=True, degraded=degraded
                )
                return self._result_outcome(cached, degraded)
            flight, leader = self._flights.begin(key)
            if not leader:
                if self._obs is not None:
                    self._obs.instant("coalesced", tid="serve")
                    self._obs.count("serve.coalesced")
                return self._follow(
                    req, ctx, flight, respond, t0, degraded=degraded
                )
            # Migrated-stream resume (serve/elastic.py): a failover
            # re-submission whose key a retiring peer shipped here claims
            # the record exactly once — the journal payloads ride the
            # request into the engine tier (submit_ids replay_ids), and
            # the router's ledger burns the delivered prefix, so the
            # client's stream is byte-identical across the seam.
            migration = self._migrations.claim(key)
            if migration is not None:
                from dataclasses import replace as _dc_replace

                req = _dc_replace(req, resume=dict(migration.resume))
                with self._lifecycle_lock:
                    self._elastic_counts["migrations_resumed"] += 1
                if self._obs is not None:
                    self._obs.instant("migration_resumed", tid="serve")
                    self._obs.count("elastic.migrations_resumed")
            # A dead-client leader is droppable ONLY while nobody rides
            # its flight: coalesced followers joined for the result, so
            # their presence keeps the run worth executing.
            leader_probe = None
            if probe is not None:
                leader_probe = lambda: flight.followers == 0 and probe()  # noqa: E731
            t_q = time.monotonic()
            try:
                ticket = self.admission.admit(
                    ctx, probe=leader_probe, priority=req.priority
                )
            except ClientGone:
                # Dropped at dequeue. A follower racing in between the
                # probe and this handler sees a retryable failure (the
                # same 503 shape a drain would give), never a hang.
                self._flights.end(flight)
                flight.fail(RetryLater(
                    "coalesced leader's client disconnected while queued",
                    self.admission.retry_after(),
                ))
                raise
            except RetryLater as err:
                # The would-be leader was shed: retire the flight so a
                # retry doesn't join a flight nobody is executing, and
                # fail it with the RetryLater itself so followers are
                # shed with the same retryable status, not a 500.
                self._observe(
                    "queue_wait", req, time.monotonic() - t_q, "shed"
                )
                self._flights.end(flight)
                flight.fail(err)
                raise
            self._observe("queue_wait", req, time.monotonic() - t_q, "ok")
            resident: Optional[_Resident] = None
            try:
                with ticket:
                    session = self.scheduler.open_session(req, ctx=ctx)
                    # Register as a resident leader run: the unit a
                    # retire() ships out. Followers are not residents —
                    # they ride this flight and fail over with it.
                    resident = self._resident_register(key, req, ctx)
                    respond.begin_stream(session.run_id)
                    first = [True]
                    ttft_outcome = "degraded" if degraded else "ok"

                    def emit(kind: str, model: str, text: str) -> None:
                        if first[0]:
                            # First streamed chunk of the run: TTFT.
                            first[0] = False
                            self._observe(
                                "ttft", req, time.monotonic() - t0,
                                ttft_outcome,
                            )
                        resident.note(kind, model, text)
                        flight.publish(kind, model, text)
                        respond.chunk(kind, model, text)

                    out = self.scheduler.execute(session, req, emit=emit)
            except BaseException as err:
                if resident is not None and resident.migrated:
                    # The failure is retire() shipping this stream out —
                    # the ctx cancel surfaces as Cancelled from the judge,
                    # or as AllModelsFailed when every cancelled panel
                    # worker was swallowed into a warning. Either way the
                    # destination already holds the record: convert to the
                    # migration marker so the leader AND every follower
                    # close their SSE legs without a terminal event — the
                    # router fails each over to the destination.
                    err = self._elastic_mod.StreamMigrated(
                        f"stream {key[:12]} migrated"
                    )
                flight.fail(err)
                raise err
            finally:
                # Retire BEFORE caching: a request arriving between the
                # two sees either the live flight or the cached result,
                # never a dead flight.
                self._flights.end(flight)
                if resident is not None:
                    self._resident_unregister(key)
            flight.finish(out)
            self.cache.put(key, out)
            respond.done(out, session.run_id, coalesced=False,
                         degraded=degraded)
            return self._result_outcome(out, degraded)
        finally:
            ctx.close()

    def _apply_brownout(self, req: ServeRequest):
        """The brownout transform: clamp the output budget and downgrade
        the judge tier (``LLMC_PRESSURE_JUDGE_FALLBACK``) — responses
        carry ``degraded: brownout`` so clients can tell a cheap answer
        from a full one. Returns ``(transformed request, tag)``."""
        from dataclasses import replace

        gov = self.governor
        judge = gov.brownout_judge(req.judge, available=self.registry)
        req = replace(
            req,
            judge=judge,
            max_tokens=gov.clamp_max_tokens(req.max_tokens),
        )
        if self._obs is not None:
            self._obs.count("pressure.brownout_requests")
        return req, "brownout"

    def _follow(self, req, ctx, flight, respond, t0, degraded=None) -> str:
        """Follower path: stream the leader's chunks, share its result,
        keep a private run id + run dir. Returns the outcome label."""
        from llm_consensus_tpu_torch.serve.cache import FlightFailed

        respond.begin_stream(None)
        first = True
        for kind, model, text in flight.stream(ctx):
            if first:
                first = False
                self._observe(
                    "ttft", req, time.monotonic() - t0,
                    "degraded" if degraded else "ok",
                )
            respond.chunk(kind, model, text)
        try:
            out = flight.result(ctx)
        except FlightFailed as err:
            cause = err.__cause__
            if isinstance(cause, RetryLater):
                # The leader was load-shed, so this follower is too —
                # same retryable shape (429/503 + Retry-After).
                raise type(cause)(str(cause), cause.retry_after_s) from err
            if isinstance(cause, self._elastic_mod.StreamMigrated):
                # The leader migrated: this follower's SSE leg closes
                # without a terminal event too, so the router fails it
                # over and it re-coalesces on the destination.
                raise cause from err
            raise
        session = self.scheduler.persist_copy(req, out)
        respond.done(out, session.run_id, coalesced=True, degraded=degraded)
        return self._result_outcome(out, degraded)


class _Responder:
    """One request's output shape — JSON body or SSE stream."""

    def __init__(self, handler: "_Handler", sse: bool,
                 trace_id: Optional[str] = None):
        self._handler = handler
        self._sse = sse
        self._writer: Optional[_SSEWriter] = None
        self._gateway = handler._gateway
        self._trace = trace_id

    def begin_stream(self, run_id: Optional[str]) -> None:
        if not self._sse or self._writer is not None:
            return
        h = self._handler
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-store")
        # No Content-Length on a live stream: the connection closing is
        # the end-of-body marker, so opt out of HTTP/1.1 keep-alive.
        h.send_header("Connection", "close")
        h.close_connection = True
        h.end_headers()
        self._writer = _SSEWriter(h.wfile)

    def chunk(self, kind: str, model: str, text: str) -> None:
        if self._writer is None:
            return
        faults = self._gateway._faults
        if faults is not None and not self._writer.broken:
            fs = faults.fire("serve", phase="stream")
            if fs is not None and fs.kind == "disconnect":
                # The client vanished mid-stream: stop writing to this
                # connection; the run itself keeps going.
                self._writer.broken = True
                return
        self._writer.event(
            "chunk", {"kind": kind, "model": model, "text": text}
        )

    def _envelope(self, out, run_id: str, cached: bool, coalesced: bool,
                  degraded=None) -> dict:
        doc = out.to_dict()
        doc["run_id"] = run_id
        doc["cached"] = cached
        doc["coalesced"] = coalesced
        if self._trace:
            # The cross-hop trace id, returned to the client: one id
            # links this request's router/gateway/engine spans (and its
            # flight-recorder entries) across failover hops.
            doc["trace_id"] = self._trace
        if degraded is not None:
            # Pressure brownout (or any future degradation lane): the
            # client can tell a clamped/downgraded answer from a full
            # one — the same tagging contract the fleet's remote
            # spillover uses ("degraded: remote").
            doc["degraded"] = degraded
        return doc

    def done(self, out, run_id: str, *, cached: bool = False,
             coalesced: bool = False, degraded=None) -> None:
        doc = self._envelope(out, run_id, cached, coalesced, degraded)
        if self._sse:
            self.begin_stream(run_id)
            if self._writer is not None:
                self._writer.event("done", doc)
        else:
            self._handler.respond_json(200, doc)

    def replay(self, out, run_id: str, *, cached: bool,
               degraded=None) -> None:
        """A cache hit 'streams' its stored result as one chunk per
        response plus the synthesis — same event shape as a live run."""
        if self._sse:
            self.begin_stream(run_id)
            for resp in out.responses:
                self.chunk("model_chunk", resp.model, resp.content)
            self.chunk("judge_chunk", out.judge, out.consensus)
        self.done(out, run_id, cached=cached, degraded=degraded)


class _Handler(BaseHTTPRequestHandler):
    _gateway: ConsensusGateway  # overridden per-server in start()
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        self._gateway.log(f"{self.address_string()} {fmt % args}")

    def respond_json(self, status: int, doc: dict, headers: dict = {}) -> None:
        body = (json.dumps(doc, ensure_ascii=False) + "\n").encode("utf-8")
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass  # client gone; nothing to salvage

    # -- GET -----------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        gw = self._gateway
        if self.path == "/healthz":
            lifecycle = gw.lifecycle
            draining = gw.admission.draining or lifecycle in (
                gw._elastic_mod.DRAINING,
                gw._elastic_mod.RETIRING,
            )
            quarantined = lifecycle == gw._elastic_mod.QUARANTINED
            doc = {
                "status": (
                    "draining" if draining
                    else "quarantined" if quarantined else "ok"
                ),
                "draining": draining,
                "lifecycle": lifecycle,
                "placeable": gw._elastic_mod.placeable(lifecycle)
                and not draining,
            }
            if quarantined and gw._quarantine is not None:
                # The probe hysteresis state: how close this replica is
                # to earning its way back to serving.
                doc["quarantine"] = gw._quarantine.snapshot()
            recovery = gw.recovery_stats()
            if recovery is not None:
                # Engine liveness: the worst busy pool's decode-heartbeat
                # age plus supervisor state. Recovering stays 200 — the
                # gateway is still serving (streams replay); only drain
                # pulls the replica from rotation.
                doc["engines"] = {
                    "state": recovery["state"],
                    "decode_heartbeat_age_s":
                        recovery["decode_heartbeat_age_s"],
                    "heartbeats": recovery["heartbeats"],
                }
                if recovery["state"] != "ok" and not draining:
                    # Draining wins the top-level status — it is what the
                    # 503 encodes and what balancers key on; the engine
                    # state stays visible under "engines".
                    doc["status"] = recovery["state"]
            # Quarantined answers 503 like draining: naive balancers
            # pull the replica too, not just the fleet router (which
            # already stopped placing on the lifecycle).
            self.respond_json(503 if (draining or quarantined) else 200, doc)
        elif self.path == "/statsz":
            self.respond_json(200, gw.stats())
        elif self.path == "/metricsz":
            from llm_consensus_tpu_torch.obs.prom import CONTENT_TYPE

            body = gw.metricsz().encode("utf-8")
            try:
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                pass  # scraper gone
        else:
            self.respond_json(404, {"error": f"no such path {self.path!r}"})

    # -- POST ----------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        gw = self._gateway
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            length = 0
        # Drain the body for EVERY POST path before responding: on an
        # HTTP/1.1 keep-alive connection, unread body bytes would parse
        # as the next request line and desync the connection.
        body = self.rfile.read(length) if length else b""
        if self.path == "/debugz/blackbox":
            # On-demand flight-recorder snapshot — no crash/SLO trigger
            # needed; rate-limited inside the recorder.
            status, doc = gw.debug_blackbox()
            self.respond_json(status, doc)
            return
        if self.path == "/debugz/profile":
            # Arm one bounded torch.profiler window — single-flight and
            # rate-limited inside the profiler (429), 404 when disabled.
            try:
                parsed = json.loads(body.decode("utf-8")) if body else {}
            except (ValueError, UnicodeDecodeError):
                parsed = {}
            dur = parsed.get("duration_s") if isinstance(parsed, dict) else None
            if dur is not None and not isinstance(dur, (int, float)):
                self.respond_json(
                    400, {"error": "profile 'duration_s' must be a number"}
                )
                return
            tag = (parsed.get("tag") if isinstance(parsed, dict) else None)
            status, doc = gw.debug_profile(
                dur, tag=str(tag) if tag else "ondemand"
            )
            self.respond_json(status, doc)
            return
        if self.path == "/v1/migrate":
            # A retiring peer ships a resident stream here; park it until
            # the re-submitted request claims it by coalescing key.
            status, doc = gw.accept_migration(body)
            self.respond_json(status, doc)
            return
        if self.path == "/v1/retire":
            try:
                parsed = json.loads(body.decode("utf-8")) if body else {}
            except (ValueError, UnicodeDecodeError) as err:
                self.respond_json(400, {"error": f"bad retire body: {err}"})
                return
            to = parsed.get("to") if isinstance(parsed, dict) else None
            if to is not None and not isinstance(to, str):
                self.respond_json(400, {"error": "retire 'to' must be a url"})
                return
            self.respond_json(200, gw.retire(to=to))
            return
        if self.path == "/v1/swap":
            # Flywheel admin surface: hot-swap a model onto a distilled
            # checkpoint (or roll back) without dropping streams.
            try:
                parsed = json.loads(body.decode("utf-8")) if body else {}
            except (ValueError, UnicodeDecodeError) as err:
                self.respond_json(400, {"error": f"bad swap body: {err}"})
                return
            if not isinstance(parsed, dict):
                self.respond_json(400, {"error": "swap body must be object"})
                return
            status, doc = gw.swap_checkpoint(parsed)
            self.respond_json(status, doc)
            return
        if self.path == "/v1/quarantine":
            # Admin/scaler surface: force the integrity quarantine walk
            # (ship residents to 'to' when given); the announce-beat
            # probes lift it once windows run clean.
            try:
                parsed = json.loads(body.decode("utf-8")) if body else {}
            except (ValueError, UnicodeDecodeError) as err:
                self.respond_json(
                    400, {"error": f"bad quarantine body: {err}"}
                )
                return
            to = parsed.get("to") if isinstance(parsed, dict) else None
            if to is not None and not isinstance(to, str):
                self.respond_json(
                    400, {"error": "quarantine 'to' must be a url"}
                )
                return
            self.respond_json(200, gw.quarantine(to=to))
            return
        if self.path != "/v1/consensus":
            self.respond_json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            req = gw.parse_request(body)
        except BadRequest as err:
            self.respond_json(400, {"error": str(err)})
            return
        from llm_consensus_tpu_torch.obs.live import new_trace_id

        # Trace id: honor the caller's X-LLMC-Trace (a router's, which
        # survives failover re-submissions); mint one for direct hits.
        # Returned in the done envelope.
        req.trace_id = (
            self.headers.get("X-LLMC-Trace", "").strip() or new_trace_id()
        )
        sse = req.stream or "text/event-stream" in (
            self.headers.get("Accept", "")
        )
        responder = _Responder(self, sse, trace_id=req.trace_id)
        probe = lambda: client_disconnected(self.connection)  # noqa: E731
        try:
            gw.serve_consensus(req, responder, probe=probe)
        except ClientGone:
            # Dropped at dequeue: the client hung up while queued, so
            # there is no response to write — just release the handler.
            self.close_connection = True
        except RetryLater as err:
            self.respond_json(
                err.status,
                {"error": str(err), "retry_after_s": err.retry_after_s},
                headers={"Retry-After": str(max(1, int(err.retry_after_s)))},
            )
        except gw._elastic_mod.StreamMigrated:
            # The stream was shipped to another replica mid-flight. Close
            # the SSE leg with NO terminal event: the router reads the
            # silent EOF as a replica failure, fails over to the
            # destination, and splices the seam byte-identically.
            self.close_connection = True
        except gw._integrity_mod.IntegrityError as err:
            # Corruption detected on THIS stream's path (non-finite
            # logits, a corrupt cross-mesh block, ...): a typed terminal
            # so the client can tell a contained poisoned stream from an
            # ordinary failure — and only this stream fails; batch
            # neighbors keep decoding untouched. Repeated fires walk the
            # replica to quarantine.
            gw.record_integrity_strike(err.surface)
            gw.log(f"integrity failure ({err.surface}): {err}")
            self._fail_integrity(responder, err)
        except (Cancelled, DeadlineExceeded) as err:
            self._fail(responder, 503, f"request deadline exceeded: {err}")
        except BrokenPipeError:
            pass  # client disconnected; the run (if leading) completed
        except Exception as err:  # noqa: BLE001 — one request, one error
            gw.log(f"request failed: {err!r}")
            self._fail(responder, 500, f"consensus run failed: {err}")

    def _fail(self, responder: _Responder, status: int, msg: str) -> None:
        """Error shape depends on how far the response got: a plain status
        before any bytes, a terminal SSE ``error`` event after."""
        if responder._writer is not None:
            if not responder._writer.broken:
                responder._writer.event("error", {"error": msg})
        else:
            self.respond_json(status, {"error": msg})

    def _fail_integrity(self, responder: _Responder, err) -> None:
        """The typed integrity terminal: same before/after-bytes split
        as :meth:`_fail`, but the payload carries ``type: integrity`` +
        the failing surface so clients never mistake a contained
        corruption for a transient server error."""
        doc = {
            "error": str(err), "type": "integrity",
            "surface": getattr(err, "surface", "unknown"),
        }
        if responder._writer is not None:
            if not responder._writer.broken:
                responder._writer.event("error", doc)
        else:
            self.respond_json(500, doc)
