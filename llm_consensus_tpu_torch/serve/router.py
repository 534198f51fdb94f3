"""The fleet router: health-aware placement, failover, remote spillover (a
copy of ``llm_consensus_tpu/serve/router.py``).

A stdlib-only HTTP tier in front of N consensus gateways (serve/gateway).
Endpoints mirror the gateway's where they overlap:

  * ``POST /v1/consensus`` — place the request on its home replica by
    consistent hash of the gateway's coalescing cache key (identical
    concurrent requests land on the same gateway and collapse to one
    execution fleet-wide), overflow to the next ring replica when the
    home is saturated (``load_score`` ≥ the saturation threshold) or
    sheds with 429/503, and fail over mid-stream when a replica dies:
    the request is re-submitted to the next live replica and the
    :class:`~llm_consensus_tpu_torch.serve.fleet.StreamLedger` suppresses the
    already-delivered prefix, so the client's SSE stream is
    character-identical to an undisturbed run — the supervisor's
    restart-and-replay contract (recovery/), extended across process
    boundaries.
  * ``POST /v1/register`` — gateway heartbeat registration
    (push-based membership; see serve/fleet.py). The beat carries the
    gateway's lifecycle (serve/elastic.py): only ``serving`` replicas
    place new work — ``joining``/``draining``/``retiring`` are ordinary
    ring membership changes with bounded key movement.
  * ``POST /v1/scale`` — operator/controller scale requests
    (``{"direction": "up"|"down"}``), forwarded to the attached
    :class:`~llm_consensus_tpu_torch.serve.elastic.ElasticController`; the
    controller's own tick loop makes the same decision from the fleet
    load signal with two-sided hysteresis.
  * ``GET /healthz`` / ``GET /statsz`` — router liveness + the fleet
    picture (per-replica state/load, placement + failover counters).
  * ``GET /metricsz`` — the FLEET-WIDE Prometheus view: every placeable
    replica's ``/metricsz`` parsed and merged bucket-wise (exact — one
    shared bucket ladder, obs/prom.py), plus the router's own
    ``route_e2e`` family and fleet counters as gauges.

When every device replica is dead or saturated, the **spillover lane**
degrades eligible requests to the remote-API providers
(providers/http_sse.py — OpenAI/Anthropic/Google, as in the reference Go
CLI) instead of shedding: the panel+judge run executes in the router
process over a remote registry and the response is tagged
``degraded: "remote"``. Eligibility is deadline-classed — only requests
whose budget can absorb a remote round trip (``timeout ≥
LLMC_FLEET_SPILLOVER_MIN_TIMEOUT_S``) spill; tight-deadline requests
still get a fast, honest 503. A request that already streamed chunks
from a device replica never spills (different models ⇒ different bytes —
the continuity contract would break); it fails over within the fleet or
errors.

Fault site ``router``: ``partition`` (connect fails before any byte),
``replica_down`` (the Nth proxied SSE frame dies mid-stream — the
failover trigger the fleet dryrun lane injects), ``slow_healthz``
(fires in the health monitor; hysteresis must absorb it),
``replica_flap`` (fires in the elastic controller's tick; the scale
hysteresis must absorb the oscillation without a pool-size change).

The router reads no environment: saturation, the canary fraction, the
spillover gates and whether the elastic controller's tick thread starts
are arguments with the JAX defaults (``LLMC_FLEET_SATURATION``,
``LLMC_CANARY_FRACTION``, ``LLMC_FLEET_SPILLOVER_MIN_TIMEOUT_S``,
``LLMC_FLEET_SPILLOVER_MAX_PRIORITY``, ``LLMC_ELASTIC``; ``cli/route.py``
reads them through ``utils/knobs.py``).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.pressure import PRIORITY_NORMAL, resolve_priority
from llm_consensus_tpu_torch.serve import elastic as elastic_mod
from llm_consensus_tpu_torch.serve.cache import cache_key
from llm_consensus_tpu_torch.serve.fleet import (
    DEAD,
    HEALTHY,
    FleetState,
    HealthMonitor,
    StreamLedger,
    _point,
    ring_order,
)
from llm_consensus_tpu_torch.serve.gateway import _SSEWriter
from llm_consensus_tpu_torch.serve.scheduler import Scheduler, ServeRequest

DEFAULT_TIMEOUT_S = 120.0
# Proxy socket slack over the request's own deadline: the replica
# enforces the deadline; the socket timeout only catches a dead peer.
PROXY_SLACK_S = 10.0


class RouterBadRequest(ValueError):
    """Client error the router can reject without a replica (HTTP 400)."""


class NoReplica(RuntimeError):
    """No live replica could take the request (and spillover declined)."""


class _ReplicaFailed(RuntimeError):
    """This replica's connection/stream died — try the next candidate."""


class _ReplicaShed(RuntimeError):
    """This replica answered 429/503 — overflow to the next candidate."""

    def __init__(self, status: int, body: bytes, retry_after: Optional[str]):
        super().__init__(f"replica shed with {status}")
        self.status = status
        self.body = body
        self.retry_after = retry_after


class RouteRequest:
    """One parsed routing request: raw body + the fields the router
    itself needs (placement key, deadline class, stream shape). All
    semantic validation stays on the replicas — they own the defaults."""

    def __init__(self, raw: bytes, doc: dict, sse: bool,
                 trace_id: Optional[str] = None):
        self.raw = raw
        self.doc = doc
        self.sse = sse
        # Cross-hop trace id (obs/live.py): minted here at the fleet
        # edge (or honored from an upstream hop), forwarded to every
        # replica attempt via the X-LLMC-Trace header — the SAME id
        # across failover/spillover hops, so one id stitches the whole
        # request path. Returned in the done envelope.
        self.trace_id = trace_id
        prompt = doc.get("prompt")
        if not isinstance(prompt, str) or not prompt.strip():
            raise RouterBadRequest('"prompt" (non-empty string) is required')
        self.prompt = prompt
        models = doc.get("models")
        if models is not None and (
            not isinstance(models, list)
            or not all(isinstance(m, str) for m in models)
        ):
            raise RouterBadRequest('"models" must be a list of strings')
        self.models = models
        judge = doc.get("judge")
        if judge is not None and not isinstance(judge, str):
            raise RouterBadRequest('"judge" must be a model name')
        self.judge = judge
        system = doc.get("system")
        self.system = system if isinstance(system, str) else None
        max_tokens = doc.get("max_tokens")
        self.max_tokens = (
            max_tokens
            if isinstance(max_tokens, int) and not isinstance(max_tokens, bool)
            else None
        )
        timeout = doc.get("timeout", DEFAULT_TIMEOUT_S)
        if isinstance(timeout, bool) or not isinstance(timeout, (int, float)) \
                or timeout <= 0:
            raise RouterBadRequest('"timeout" must be a positive number')
        self.timeout = float(timeout)
        try:
            # Same derivation the gateway applies (explicit field, else
            # deadline class): the router only needs it for spillover
            # policy — the body passes through raw, so the home replica
            # re-derives the identical class for admission ordering.
            self.priority = resolve_priority(
                doc.get("priority"), timeout_s=self.timeout
            )
        except ValueError as err:
            raise RouterBadRequest(str(err)) from err

    def key(self) -> str:
        """The placement key — the SAME digest the home gateway's
        coalescing cache uses, so one key ⇒ one home ⇒ one execution.
        Unset fields hash as-is: two requests that both rely on replica
        defaults still share a key."""
        return cache_key(
            self.models or [], self.judge, self.prompt,
            system=self.system, max_tokens=self.max_tokens,
        )


class SpilloverPolicy:
    """Deadline- and priority-class gating for the remote-API lane."""

    def __init__(self, mode: str = "saturated",
                 min_timeout_s: float = 10.0,
                 max_priority: int = 1):
        if mode not in ("off", "saturated"):
            raise ValueError(
                f"spillover policy must be 'off' or 'saturated', got {mode!r}"
            )
        self.mode = mode
        self.min_timeout_s = min_timeout_s
        # Priority gate (pressure/priority.py): remote API calls cost
        # real money per token — when the fleet saturates, that budget
        # goes to the classes worth it. Default: NORMAL and above spill,
        # LOW sheds with Retry-After (it is the traffic most likely to
        # BE the saturation).
        self.max_priority = max_priority

    def eligible(self, req: RouteRequest) -> bool:
        """Spill only requests whose deadline can absorb a remote round
        trip AND whose class clears the priority gate; a tight-deadline
        or shed-class request is better served by a fast 503 it can
        retry against the fleet."""
        return (
            self.mode != "off"
            and req.timeout >= self.min_timeout_s
            and getattr(req, "priority", PRIORITY_NORMAL)
            <= self.max_priority
        )


class ConsensusRouter:
    """Routes consensus requests over a fleet of gateway replicas."""

    def __init__(
        self,
        fleet: FleetState,
        monitor: Optional[HealthMonitor] = None,
        *,
        spillover_registry=None,
        spillover_models: Optional[list[str]] = None,
        spillover_judge: Optional[str] = None,
        spillover_policy: Optional[SpilloverPolicy] = None,
        saturation: float = 0.85,
        vnodes: int = 32,
        elastic=None,
        start_elastic: bool = False,
        canary_fraction: float = 0.0,
        data_dir: str = "data",
        save: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
        log: Optional[Callable[[str], None]] = None,
    ):
        self.fleet = fleet
        self.monitor = monitor
        # Elastic controller (serve/elastic.py): owns the scale decision
        # loop; POST /v1/scale forwards to it. Its tick thread starts
        # with the router only with ``start_elastic`` (LLMC_ELASTIC=1) —
        # tests and lanes drive tick() by hand.
        self.elastic = elastic
        self._start_elastic = start_elastic
        self.saturation = saturation
        self.vnodes = vnodes
        self._host = host
        self._port = port
        self._log = log
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = time.monotonic()
        self._lock = threading.Lock()
        self.counters = {
            "requests": 0, "failovers": 0, "overflow": 0,
            "spillover": 0, "rejected": 0, "registered": 0,
            "canary_requests": 0,
        }
        # Canary lane (flywheel hot-swap): when > 0 and the fleet is
        # weight-version-skewed, this fraction of the keyspace prefers
        # the newest-version replicas; everyone else prefers baseline.
        self.canary_fraction = canary_fraction
        # Per-replica scrape health (url -> monotonic time of the last
        # SUCCESSFUL /metricsz scrape): behind llmc_replica_up and the
        # scrape-staleness gauge, so a fleet dashboard can tell "replica
        # down" from "replica up but its numbers are N seconds old".
        self._scrape_ok_at: dict = {}
        # Spillover lane: a local Scheduler over remote-API providers.
        self._spill_sched: Optional[Scheduler] = None
        self._spill_models = list(spillover_models or [])
        self._spill_judge = spillover_judge
        if spillover_registry is not None:
            if not self._spill_models or not self._spill_judge:
                raise ValueError(
                    "spillover needs models and a judge for the remote panel"
                )
            self._spill_sched = Scheduler(
                spillover_registry, data_dir=data_dir, save=save
            )
        self.spillover_policy = (
            spillover_policy if spillover_policy is not None
            else SpilloverPolicy(
                "saturated" if spillover_registry is not None else "off"
            )
        )
        self._faults = faults.plan()
        self._obs = obs.recorder()
        # Live plane: the router's own e2e histogram (outcome "failover"
        # when a request crossed a replica seam) + route spans in the
        # always-on flight recorder ring. Fleet-wide /metricsz is the
        # bucket-wise merge of the replicas' histograms (obs/prom.py) —
        # the router's own observations stay out of the merged body so
        # the router-equals-merge property holds exactly.
        self._live = obs.live.metrics()
        self._bb = obs.blackbox.ring()

    # -- lifecycle ------------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        assert self._httpd is not None, "router not started"
        return self._httpd.server_address[0], self._httpd.server_address[1]

    def start(self) -> tuple[str, int]:
        router = self

        class Handler(_RouterHandler):
            _router = router

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router", daemon=True
        )
        self._thread.start()
        if self.monitor is not None:
            self.monitor.start()
        if self.elastic is not None and self._start_elastic:
            self.elastic.start()
        return self.address

    def close(self) -> None:
        if self.elastic is not None:
            self.elastic.close()
        if self.monitor is not None:
            self.monitor.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def log(self, msg: str) -> None:
        if self._log is not None:
            try:
                self._log(msg)
            except Exception:
                pass

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if self._obs is not None:
            self._obs.count(f"fleet.{name}", n)

    # -- placement ------------------------------------------------------------

    def candidates(self, key: str) -> list[str]:
        """Replica URLs to try, in order: unsaturated healthy replicas in
        ring order from the key's home, then saturated healthy ones
        (better a queue than a corpse), then suspects. Dead, draining,
        expired, and non-``serving``-lifecycle replicas never place — a
        joining replica is cold and a retiring one is shipping its
        residents out; routing new work at either defeats the
        transition."""
        state: dict[str, str] = {}
        load: dict[str, float] = {}
        version: dict[str, int] = {}
        placeable: list[str] = []
        for replica in self.fleet.replicas():
            if replica.state == DEAD or replica.draining:
                continue
            if not elastic_mod.placeable(replica.lifecycle):
                continue
            if self.fleet.expired(replica):
                continue
            placeable.append(replica.url)
            state[replica.url] = replica.state
            load[replica.url] = replica.load_score
            version[replica.url] = replica.weight_version
        order = ring_order(key, placeable, vnodes=self.vnodes)
        fresh = [
            u for u in order
            if state[u] == HEALTHY and load[u] < self.saturation
        ]
        saturated = [
            u for u in order
            if state[u] == HEALTHY and load[u] >= self.saturation
        ]
        suspect = [u for u in order if state[u] != HEALTHY]
        if self.canary_fraction > 0:
            fresh, saturated = self._canary_lanes(
                key, fresh, saturated, version
            )
        return fresh + saturated + suspect

    def _canary_lanes(
        self,
        key: str,
        fresh: list[str],
        saturated: list[str],
        version: dict[str, int],
    ) -> "tuple[list[str], list[str]]":
        """The canary lane (flywheel hot-swap): while the fleet is
        weight-version-skewed, an ``LLMC_CANARY_FRACTION`` slice of the
        keyspace PREFERS the newest-version replicas and the rest
        prefers baseline — reordering within each health tier, never
        exclusion, so failover across cohorts still works when a whole
        cohort dies. Deterministic by placement key: a retried request
        re-lands in its lane, and the watcher (flywheel/canary.py)
        compares stable cohorts. A version-uniform fleet has no lanes —
        ordering is untouched and nothing is counted."""
        versions = {version.get(u, 0) for u in fresh + saturated}
        if len(versions) < 2:
            return fresh, saturated
        top = max(versions)
        canary = (
            (_point("canary|" + key) % 10_000) / 10_000.0
            < self.canary_fraction
        )
        if canary:
            self._count("canary_requests")

        def lane(urls: list[str]) -> list[str]:
            pref = [u for u in urls if (version.get(u, 0) == top) == canary]
            rest = [u for u in urls if (version.get(u, 0) == top) != canary]
            return pref + rest

        return lane(fresh), lane(saturated)

    # -- the routing core -----------------------------------------------------

    def route(self, rreq: RouteRequest, handler: "_RouterHandler") -> None:
        self._count("requests")
        t0 = (
            time.monotonic_ns()
            if self._obs is not None or self._bb is not None else 0
        )
        t0_wall = time.monotonic()
        key = rreq.key()
        candidates = self.candidates(key)
        ledger = StreamLedger()
        out = _ClientStream(handler, rreq.sse, trace_id=rreq.trace_id)
        last_shed: Optional[_ReplicaShed] = None
        prev_failed = False
        failovers = 0  # THIS request's failovers (the done envelope's)
        outcome = "error"
        try:
            for url in candidates:
                if prev_failed:
                    # Re-placing after a replica failure: book the
                    # failover, and when chunks already reached the
                    # client, arm the ledger so the fresh replica's
                    # replay burns the delivered prefix.
                    prev_failed = False
                    failovers += 1
                    self._count("failovers")
                    if self._obs is not None:
                        self._obs.instant(
                            "failover", tid="fleet", to=url, key=key[:12]
                        )
                    if ledger.delivered_any:
                        ledger.arm_replay()
                try:
                    self._proxy_once(url, rreq, out, ledger, failovers)
                    outcome = "failover" if failovers else "ok"
                    return
                except _ReplicaShed as err:
                    last_shed = err
                    self._count("overflow")
                    continue
                except _ReplicaFailed as err:
                    prev_failed = True
                    self.fleet.note_proxy_failure(url)
                    self.log(f"replica {url} failed: {err}")
                    continue
            # No replica completed the stream.
            if ledger.delivered_any:
                # Chunks already reached the client from the device panel;
                # a remote re-run would splice DIFFERENT bytes. Honest
                # terminal error beats silent corruption.
                out.error("every fleet replica died mid-stream")
                return
            if self._spill_sched is not None and (
                self.spillover_policy.eligible(rreq)
            ):
                self._spillover(rreq, out)
                outcome = "degraded"
                return
            if last_shed is not None:
                out.shed(last_shed)
                outcome = "shed"
                return
            self._count("rejected")
            raise NoReplica(
                "no live replica for this request and spillover is "
                f"{self.spillover_policy.mode!r}"
            )
        except Exception as err:  # noqa: BLE001
            if out.begun:
                # The SSE stream is already open (spillover execution
                # died, writer tripped, ...): the only legal frame left
                # is a terminal error event — a fresh HTTP status line
                # from do_POST's handler would corrupt the stream.
                self.log(f"terminal stream failure: {err!r}")
                out.error(f"routing failed: {err}")
                return
            raise
        finally:
            if self._obs is not None:
                self._obs.complete(
                    "route", t0, tid="fleet", candidates=len(candidates),
                    trace=rreq.trace_id, outcome=outcome,
                )
            if self._bb is not None:
                self._bb.complete(
                    "route", t0, tid="fleet", candidates=len(candidates),
                    trace=rreq.trace_id, outcome=outcome,
                )
            if self._live is not None:
                from llm_consensus_tpu_torch.obs.live import class_label

                # The router's OWN latency family (route_e2e — a name
                # the replicas never emit, so the fleet-merge property
                # of the request families stays exact): "failover" here
                # marks requests that crossed a replica seam.
                self._live.observe(
                    "route_e2e", time.monotonic() - t0_wall,
                    outcome=outcome,
                    **{"class": class_label(rreq.priority)},
                )

    # -- proxying -------------------------------------------------------------

    def _proxy_once(self, url: str, rreq: RouteRequest, out: "_ClientStream",
                    ledger: StreamLedger, failovers: int = 0) -> None:
        import http.client
        import urllib.parse

        if self._faults is not None:
            fs = self._faults.fire("router", phase="connect", url=url)
            if fs is not None and fs.kind == "partition":
                raise _ReplicaFailed(f"injected partition to {url}")
        parsed = urllib.parse.urlsplit(url)
        headers = {"Content-Type": "application/json"}
        if rreq.trace_id:
            # The SAME id on every attempt: a failover re-submission
            # carries the original trace, so the fresh replica's spans
            # stitch onto the path the dead replica started.
            headers["X-LLMC-Trace"] = rreq.trace_id
        if rreq.sse:
            headers["Accept"] = "text/event-stream"
        try:
            conn = http.client.HTTPConnection(
                parsed.netloc, timeout=rreq.timeout + PROXY_SLACK_S
            )
        except Exception as err:  # noqa: BLE001 — bad netloc etc.
            raise _ReplicaFailed(f"connect failed: {err}") from None
        try:
            try:
                conn.request("POST", "/v1/consensus", rreq.raw, headers)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as err:
                raise _ReplicaFailed(f"request failed: {err}") from None
            if resp.status in (429, 503):
                try:
                    shed_body = resp.read()
                except (OSError, http.client.HTTPException):
                    shed_body = b""
                raise _ReplicaShed(
                    resp.status, shed_body, resp.getheader("Retry-After")
                )
            ctype = resp.getheader("Content-Type", "")
            if resp.status == 200 and "text/event-stream" in ctype:
                self._proxy_sse(url, resp, out, ledger, failovers)
                return
            # JSON (or a replica-side 4xx/5xx): forward verbatim — the
            # replica owns request semantics. A read failure with
            # nothing delivered is failover-safe.
            try:
                body = resp.read()
            except (OSError, http.client.HTTPException) as err:
                raise _ReplicaFailed(f"read failed: {err}") from None
            out.forward_json(resp.status, body, url)
        finally:
            conn.close()

    def _proxy_sse(self, url: str, resp, out: "_ClientStream",
                   ledger: StreamLedger, failovers: int) -> None:
        """Relay one replica's SSE stream, chunk-accounted. Raises
        :class:`_ReplicaFailed` on a mid-stream connection death or an
        EOF with no terminal event — the failover triggers."""
        import http.client

        event: Optional[str] = None
        data_lines: list[str] = []
        terminal = False
        frame = 0
        try:
            for raw in resp:
                line = raw.decode("utf-8", "replace").rstrip("\n").rstrip("\r")
                if line.startswith("event: "):
                    event = line[len("event: "):]
                    continue
                if line.startswith("data: "):
                    data_lines.append(line[len("data: "):])
                    continue
                if line:
                    continue  # comment or unknown field
                if event is None and not data_lines:
                    continue  # stray blank
                frame += 1
                terminal = self._relay_frame(
                    url, event or "message", "\n".join(data_lines), out,
                    ledger, frame, failovers,
                )
                event, data_lines = None, []
                if terminal:
                    return
        except (OSError, ValueError, http.client.HTTPException) as err:
            raise _ReplicaFailed(f"stream failed: {err}") from None
        if not terminal:
            # The connection closed with no done/error event: the
            # replica (or its writer) died mid-stream.
            raise _ReplicaFailed("stream ended without a terminal event")

    def _relay_frame(self, url: str, event: str, data: str,
                     out: "_ClientStream", ledger: StreamLedger,
                     frame: int, failovers: int) -> bool:
        """Process one replica SSE frame; returns True when terminal.

        ``frame`` is THIS replica attempt's 1-indexed frame counter —
        the ``replica_down@frame=N`` matcher keys on it (an attr, not
        the site counter, so concurrent polls/requests advancing the
        shared ``router`` counter cannot shift the injection point)."""
        if self._faults is not None:
            fs = self._faults.fire(
                "router", phase="proxy", url=url, frame=frame
            )
            if fs is not None and fs.kind == "replica_down":
                raise _ReplicaFailed(
                    f"injected replica_down on frame {frame} from {url}"
                )
        try:
            doc = json.loads(data) if data else {}
        except ValueError:
            return False  # malformed frame: skip, same as gateway clients
        if event == "chunk":
            text = ledger.record(
                str(doc.get("kind", "")), str(doc.get("model", "")),
                str(doc.get("text", "")),
            )
            if text:
                out.chunk(doc.get("kind", ""), doc.get("model", ""), text)
            return False
        if event == "done":
            doc["replica"] = url
            doc["failovers"] = failovers  # THIS request's seams, not the
            out.done(doc)                 # router-global counter
            return True
        if event == "error":
            # The replica itself reported a run failure — that is a
            # request outcome, not replica death; forward, don't retry.
            out.error(str(doc.get("error", "consensus run failed")))
            return True
        return False

    # -- spillover ------------------------------------------------------------

    def _spillover(self, rreq: RouteRequest, out: "_ClientStream") -> None:
        """Degrade to the remote-API panel+judge in-process."""
        self._count("spillover")
        if self._obs is not None:
            self._obs.instant("spillover", tid="fleet")
        sched = self._spill_sched
        assert sched is not None
        sreq = ServeRequest(
            prompt=rreq.prompt,
            models=list(self._spill_models),
            judge=self._spill_judge,
            system=rreq.system,
            max_tokens=rreq.max_tokens,
            timeout=rreq.timeout,
            stream=rreq.sse,
            priority=rreq.priority,
            trace_id=rreq.trace_id,
        )
        session = sched.open_session(sreq)
        emit = None
        if rreq.sse:
            out.begin()
            emit = out.chunk
        result = sched.execute(session, sreq, emit=emit)
        doc = result.to_dict()
        doc["run_id"] = session.run_id
        doc["cached"] = False
        doc["coalesced"] = False
        doc["degraded"] = "remote"
        out.done(doc)

    # -- introspection --------------------------------------------------------

    def _fetch_metricsz(self, url: str, timeout_s: float = 5.0) -> str:
        import http.client
        import urllib.parse

        parsed = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(parsed.netloc, timeout=timeout_s)
        try:
            conn.request("GET", "/metricsz")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise OSError(f"/metricsz returned {resp.status}")
            return body.decode("utf-8", "replace")
        finally:
            conn.close()

    def metricsz(self) -> str:
        """Fleet-wide Prometheus body: every placeable replica's
        ``/metricsz`` parsed and merged BUCKET-WISE (obs/prom.py — exact,
        because every histogram in the fleet shares one bucket ladder),
        plus the router's own families (``route_e2e`` — a name replicas
        never emit, keeping the merge property assertable) and the fleet
        counters as ``llmc_stat{block="fleet",...}`` gauges. A replica
        that fails the scrape is skipped — the fleet view degrades to
        the replicas that answered, it never 500s."""
        from llm_consensus_tpu_torch.obs import prom

        urls = [
            replica.url for replica in self.fleet.replicas()
            if replica.state != DEAD and not self.fleet.expired(replica)
        ]
        # Concurrent scrapes: one wedged replica (accepting TCP, never
        # answering) must cost its own timeout once, not once PER
        # replica serially — the fleet view matters most mid-incident.
        results: list = [None] * len(urls)

        def scrape(i: int, url: str) -> None:
            try:
                results[i] = prom.parse_text(self._fetch_metricsz(url))
            except Exception:  # noqa: BLE001 — skip the dead scrape
                results[i] = None

        threads = [
            threading.Thread(
                target=scrape, args=(i, url), daemon=True,
                name=f"metricsz-scrape-{i}",
            )
            for i, url in enumerate(urls)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        parsed = [doc for doc in results if doc is not None]
        scraped = len(parsed)
        # Router-local samples join the MERGED document (not appended as
        # raw lines): render_parsed groups each family contiguously, so
        # the router's llmc_stat gauges and the replicas' stay one
        # family — strict text-format parsers reject split families.
        if self._live is not None:
            parsed.append(prom.parse_text(prom.render(self._live)))
        merged = prom.merge(parsed)
        gauges = merged["gauges"]
        gauges[("fleet_replicas_scraped", ())] = scraped
        # Per-replica scrape health: router-only family names (replicas
        # never emit them), so the bucket-wise merge property stays
        # assertable. Staleness is seconds since the last scrape that
        # ANSWERED; a replica that has never answered reports -1.
        now = time.monotonic()
        with self._lock:
            for url, doc in zip(urls, results):
                if doc is not None:
                    self._scrape_ok_at[url] = now
            ok_at = dict(self._scrape_ok_at)
        wv = {
            replica.url: replica.weight_version
            for replica in self.fleet.replicas()
        }
        for url, doc in zip(urls, results):
            lbl = (("url", url),)
            gauges[("replica_up", lbl)] = 1.0 if doc is not None else 0.0
            last = ok_at.get(url)
            gauges[("replica_scrape_staleness_seconds", lbl)] = (
                round(now - last, 3) if last is not None else -1.0
            )
            # Version-labeled fleet view (flywheel hot-swap): which
            # replica serves which weight version — the dashboard's
            # canary-cohort axis. Router-only family name, so the
            # bucket-wise merge property stays assertable.
            gauges[("replica_weight_version", lbl)] = float(wv.get(url, 0))
        for path, value in prom.flatten_numeric(self.stats()):
            key = ("stat", (("block", "fleet"), ("key", path)))
            gauges[key] = gauges.get(key, 0.0) + value
        return prom.render_parsed(merged)

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        elastic = (
            self.elastic.snapshot() if self.elastic is not None else None
        )
        return {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "fleet": self.fleet.snapshot(),
            "counters": counters,
            "saturation": self.saturation,
            "elastic": elastic,
            "spillover": {
                "policy": self.spillover_policy.mode,
                "min_timeout_s": self.spillover_policy.min_timeout_s,
                "models": list(self._spill_models),
                "judge": self._spill_judge,
            },
        }


class _ClientStream:
    """The router's half of the client connection (JSON or SSE)."""

    def __init__(self, handler: "_RouterHandler", sse: bool,
                 trace_id: Optional[str] = None):
        self._handler = handler
        self._sse = sse
        self._writer: Optional[_SSEWriter] = None
        self._trace = trace_id

    def begin(self) -> None:
        if not self._sse or self._writer is not None:
            return
        h = self._handler
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-store")
            h.send_header("Connection", "close")
            h.close_connection = True
            h.end_headers()
        except OSError:
            pass
        self._writer = _SSEWriter(h.wfile)

    def chunk(self, kind: str, model: str, text: str) -> None:
        self.begin()
        if self._writer is not None:
            self._writer.event(
                "chunk", {"kind": kind, "model": model, "text": text}
            )

    def done(self, doc: dict) -> None:
        if self._trace:
            # The replica already stamped the id it received in the
            # header; setdefault covers spillover and older replicas.
            doc.setdefault("trace_id", self._trace)
        if self._sse:
            self.begin()
            if self._writer is not None:
                self._writer.event("done", doc)
        else:
            self._handler.respond_json(200, doc)

    def error(self, msg: str) -> None:
        """Terminal failure: an SSE ``error`` event once the stream has
        begun, a plain 502 before any bytes moved."""
        if self._writer is not None:
            if not self._writer.broken:
                self._writer.event("error", {"error": msg})
        else:
            self._handler.respond_json(502, {"error": msg})

    def forward_json(self, status: int, body: bytes, url: str) -> None:
        """Relay a replica's non-SSE response; successful envelopes gain
        the serving replica's URL for observability."""
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            doc = None
        if self._writer is not None:
            # A non-SSE reply after the stream already began (a failover
            # candidate answering a replayed request with a plain error
            # envelope): a fresh HTTP status line would corrupt the open
            # event stream — the only legal frame left is terminal error.
            msg = doc.get("error") if isinstance(doc, dict) else None
            self.error(str(msg or f"replica returned HTTP {status} mid-stream"))
            return
        if isinstance(doc, dict):
            if status == 200:
                doc["replica"] = url
                if self._trace:
                    doc.setdefault("trace_id", self._trace)
            self._handler.respond_json(status, doc)
            return
        h = self._handler
        try:
            h.send_response(status)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except OSError:
            pass

    def shed(self, err: _ReplicaShed) -> None:
        """Every replica shed this request: forward the last shed
        response (status, body, Retry-After) so the client's retry
        machinery sees the same backpressure shape a single gateway
        gives."""
        headers = {}
        if err.retry_after:
            headers["Retry-After"] = err.retry_after
        try:
            doc = json.loads(err.body.decode("utf-8"))
        except ValueError:
            doc = {"error": "fleet saturated"}
        self._handler.respond_json(err.status, doc, headers)

    @property
    def begun(self) -> bool:
        return self._writer is not None


class _RouterHandler(BaseHTTPRequestHandler):
    _router: ConsensusRouter  # overridden per-server in start()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        self._router.log(f"{self.address_string()} {fmt % args}")

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
            pass

    def do_GET(self) -> None:  # noqa: N802
        router = self._router
        if self.path == "/healthz":
            snap = router.fleet.snapshot()
            self.respond_json(200, {
                "status": "ok",
                "replicas": snap["by_state"],
            })
        elif self.path == "/statsz":
            self.respond_json(200, router.stats())
        elif self.path == "/metricsz":
            from llm_consensus_tpu_torch.obs.prom import CONTENT_TYPE

            body = router.metricsz().encode("utf-8")
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

    def do_POST(self) -> None:  # noqa: N802
        router = self._router
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            length = 0
        body = self.rfile.read(length) if length else b""
        if self.path == "/v1/register":
            self._register(body)
            return
        if self.path == "/v1/scale":
            self._scale(body)
            return
        if self.path == "/debugz/profile":
            self._profile(body)
            return
        if self.path != "/v1/consensus":
            self.respond_json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            doc = json.loads(body.decode("utf-8"))
            if not isinstance(doc, dict):
                raise RouterBadRequest("body must be a JSON object")
            sse = bool(doc.get("stream", False)) or (
                "text/event-stream" in (self.headers.get("Accept", ""))
            )
            from llm_consensus_tpu_torch.obs.live import new_trace_id

            # Trace id minted at the FLEET edge (or honored from an
            # upstream tier), so every hop of this request logs one id.
            trace = (
                self.headers.get("X-LLMC-Trace", "").strip()
                or new_trace_id()
            )
            rreq = RouteRequest(body, doc, sse, trace_id=trace)
        except RouterBadRequest as err:
            self.respond_json(400, {"error": str(err)})
            return
        except (ValueError, UnicodeDecodeError) as err:
            self.respond_json(400, {"error": f"invalid JSON body: {err}"})
            return
        try:
            router.route(rreq, self)
        except NoReplica as err:
            self.respond_json(
                503, {"error": str(err)}, {"Retry-After": "2"}
            )
        except BrokenPipeError:
            pass  # client vanished mid-relay
        except Exception as err:  # noqa: BLE001 — one request, one error
            router.log(f"routing failed: {err!r}")
            self.respond_json(502, {"error": f"routing failed: {err}"})

    def _register(self, body: bytes) -> None:
        router = self._router
        try:
            doc = json.loads(body.decode("utf-8"))
            url = doc["url"]
            if not isinstance(url, str) or not url.startswith("http"):
                raise ValueError("'url' must be an http(s) URL")
            load_score = float(doc.get("load_score", 0.0) or 0.0)
            draining = bool(doc.get("draining", False))
            interval_s = float(doc.get("interval_s", 2.0) or 2.0)
            lifecycle = doc.get("lifecycle")
            if lifecycle is not None and not isinstance(lifecycle, str):
                raise ValueError("'lifecycle' must be a string")
            weight_version = doc.get("weight_version")
            if weight_version is not None:
                weight_version = int(weight_version)
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as err:
            self.respond_json(400, {"error": f"bad registration: {err}"})
            return
        router.fleet.heartbeat(
            url, load_score=load_score, draining=draining,
            interval_s=interval_s, lifecycle=lifecycle,
            weight_version=weight_version,
        )
        router._count("registered")
        self.respond_json(200, {"ok": True})

    def _profile(self, body: bytes) -> None:
        """POST /debugz/profile at the fleet edge: fan the arm request
        out to ONE named replica (``{"replica": url}``) or, absent a
        name, the first placeable replica that answers. The replica's
        own 404/429/200 contract passes through verbatim — the router
        adds addressing, not policy."""
        router = self._router
        try:
            doc = json.loads(body.decode("utf-8")) if body else {}
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            target = doc.get("replica")
            if target is not None and not isinstance(target, str):
                raise ValueError("'replica' must be a url string")
        except (ValueError, UnicodeDecodeError) as err:
            self.respond_json(400, {"error": f"bad profile request: {err}"})
            return
        candidates = [
            replica.url for replica in router.fleet.replicas()
            if replica.state != DEAD and not router.fleet.expired(replica)
        ]
        if target is not None:
            if target not in candidates:
                self.respond_json(
                    404, {"error": f"no live replica {target!r}",
                          "replicas": candidates}
                )
                return
            candidates = [target]
        if not candidates:
            self.respond_json(503, {"error": "no live replicas"})
            return
        import http.client
        import urllib.parse

        last_err = None
        for url in candidates:
            parsed = urllib.parse.urlsplit(url)
            conn = http.client.HTTPConnection(parsed.netloc, timeout=10.0)
            try:
                conn.request(
                    "POST", "/debugz/profile", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                rbody = resp.read()
                try:
                    rdoc = json.loads(rbody.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    rdoc = {"raw": rbody.decode("utf-8", "replace")[:500]}
                rdoc["replica"] = url
                self.respond_json(resp.status, rdoc)
                return
            except OSError as err:
                last_err = err
                continue
            finally:
                conn.close()
        self.respond_json(
            502, {"error": f"profile fan-out failed: {last_err}"}
        )

    def _scale(self, body: bytes) -> None:
        """POST /v1/scale — operator-forced scale transition. Bypasses
        the controller's patience, never its min/max clamp."""
        router = self._router
        if router.elastic is None:
            self.respond_json(
                503, {"error": "no elastic controller attached"}
            )
            return
        try:
            doc = json.loads(body.decode("utf-8"))
            direction = doc["direction"]
            if direction not in ("up", "down"):
                raise ValueError("'direction' must be 'up' or 'down'")
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as err:
            self.respond_json(400, {"error": f"bad scale request: {err}"})
            return
        self.respond_json(200, router.elastic.request(direction))
