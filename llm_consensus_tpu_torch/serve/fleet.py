"""Fleet state: replica membership, health hysteresis, placement ring (a
copy of ``llm_consensus_tpu/serve/fleet.py``).

The router tier (serve/router.py) fronts N gateway/engine replicas; this
module owns everything it knows *about* them:

  * :class:`Replica` / :class:`FleetState` — thread-safe membership.
    Replicas arrive statically (``--replica`` config) or by heartbeat
    (gateways POST ``/v1/register`` periodically — push-based membership,
    so the fleet grows without router-side config; a registration that
    misses ~3 heartbeats ages out of placement).
  * the **healthy → suspect → dead** state machine, driven by the
    :class:`HealthMonitor`'s polls of each replica's ``/healthz`` +
    ``/statsz`` (drain state, ``load_score``, recovery state). The
    transitions carry hysteresis in both directions: one slow or failed
    poll demotes only to *suspect* (still placeable, deprioritized) —
    never straight to dead — and a dead replica must produce
    ``revive_after`` consecutive good polls before placement trusts it
    again. A mid-stream proxy failure counts as a failed poll
    (:meth:`FleetState.note_proxy_failure`), so the router's own
    evidence accelerates detection between polls without ever bypassing
    the hysteresis.
  * :func:`ring_order` — consistent-hash placement. Keys are the gateway's
    coalescing cache key, so identical concurrent requests share a home
    replica and collapse to one execution *fleet-wide* through that
    gateway's single-flight table; vnodes keep the load split stable as
    replicas come and go.
  * :class:`StreamLedger` — per-(kind, model) delivered-character
    accounting for cross-replica failover: after a replica dies
    mid-stream, the re-submitted run's chunks burn the already-delivered
    prefix before anything reaches the client (the cross-process
    analogue of recovery/supervisor.py's ``_StreamShim``), so the SSE
    consumer sees a pause, never a dropped or duplicated chunk.

The module reads no environment: the monitor's cadence and the
hysteresis counts are arguments with the JAX defaults
(``LLMC_FLEET_POLL_S``, ``LLMC_FLEET_SUSPECT_AFTER``,
``LLMC_FLEET_DEAD_AFTER``, ``LLMC_FLEET_REVIVE_AFTER``; ``cli/route.py``
reads them through ``utils/knobs.py``).
"""

from __future__ import annotations

import bisect
import functools
import hashlib
import threading
import time
from typing import Callable, Optional

from llm_consensus_tpu_torch import faults, obs

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

# A heartbeat registration survives this many missed beats before it
# ages out of placement (the gateway may just be GC-pausing; the health
# poller keeps refining the state meanwhile).
HEARTBEAT_GRACE = 3


class Replica:
    """One gateway replica as the router sees it (guarded by FleetState)."""

    __slots__ = (
        "url", "source", "state", "fails", "oks", "load_score", "draining",
        "lifecycle", "weight_version", "last_error", "last_poll_s",
        "expires_at", "stats",
    )

    def __init__(self, url: str, source: str = "static"):
        self.url = url.rstrip("/")
        self.source = source  # "static" | "heartbeat"
        self.state = HEALTHY  # optimistic: the first poll refines it
        self.fails = 0        # consecutive bad polls
        self.oks = 0          # consecutive good polls (revival progress)
        self.load_score = 0.0
        self.draining = False
        # Membership lifecycle (serve/elastic.py): joining → serving →
        # draining → retiring, as the gateway last advertised it. Health
        # (healthy/suspect/dead) is the router's *evidence*; lifecycle is
        # the gateway's *intent* — placement needs both.
        self.lifecycle = "serving"
        # Resident weight version as last advertised (flywheel hot-swap;
        # 0 = baseline). The canary lane splits placement by comparing
        # this across the fleet — a freshly swapped replica is the
        # canary cohort until the watcher promotes or rolls it back.
        self.weight_version = 0
        self.last_error: Optional[str] = None
        self.last_poll_s: Optional[float] = None
        self.expires_at: Optional[float] = None  # heartbeat replicas only
        self.stats: dict = {}

    def snapshot(self) -> dict:
        return {
            "url": self.url,
            "source": self.source,
            "state": self.state,
            "load_score": self.load_score,
            "draining": self.draining,
            "lifecycle": self.lifecycle,
            "weight_version": self.weight_version,
            "fails": self.fails,
            "last_error": self.last_error,
        }


class FleetState:
    """Thread-safe replica registry + the health state machine."""

    def __init__(
        self,
        suspect_after: int = 1,
        dead_after: int = 3,
        revive_after: int = 2,
        clock: Callable[[], float] = time.monotonic,
    ):
        # Hysteresis: one bad poll ⇒ suspect (placeable, deprioritized);
        # dead needs suspect_after + dead_after CONSECUTIVE bad polls;
        # revival from dead needs revive_after consecutive good polls.
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.revive_after = revive_after
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self.deaths = 0
        self.revivals = 0
        self._obs = obs.recorder()

    # -- membership -----------------------------------------------------------

    def add_static(self, url: str) -> Replica:
        """Configured replica: always a member, never expires."""
        with self._lock:
            replica = self._replicas.get(url.rstrip("/"))
            if replica is None:
                replica = Replica(url, source="static")
                self._replicas[replica.url] = replica
            return replica

    def heartbeat(self, url: str, load_score: float = 0.0,
                  draining: bool = False,
                  interval_s: float = 2.0,
                  lifecycle: Optional[str] = None,
                  weight_version: Optional[int] = None) -> Replica:
        """A gateway announced itself: register/refresh its membership.

        The heartbeat itself is liveness evidence — it counts as a good
        poll, so a registered-and-beating replica becomes placeable
        without waiting for the monitor's next cycle. ``lifecycle`` is
        the gateway's advertised membership state (serve/elastic.py);
        a heartbeat that omits it keeps the last known value."""
        with self._lock:
            replica = self._replicas.get(url.rstrip("/"))
            if replica is None:
                replica = Replica(url, source="heartbeat")
                self._replicas[replica.url] = replica
            if replica.source == "heartbeat":
                replica.expires_at = (
                    self._clock() + HEARTBEAT_GRACE * max(0.1, interval_s)
                )
            self._good_locked(replica, load_score, draining,
                              lifecycle=lifecycle,
                              weight_version=weight_version)
            return replica

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def expired(self, replica: Replica) -> bool:
        """A heartbeat replica that stopped beating is out of placement
        (but stays a member — a late heartbeat re-admits it)."""
        return (
            replica.expires_at is not None
            and self._clock() > replica.expires_at
        )

    # -- the state machine ----------------------------------------------------

    def record_poll(self, replica: Replica, ok: bool,
                    load_score: float = 0.0, draining: bool = False,
                    error: Optional[str] = None,
                    lifecycle: Optional[str] = None,
                    weight_version: Optional[int] = None) -> None:
        with self._lock:
            replica.last_poll_s = self._clock()
            if ok:
                self._good_locked(replica, load_score, draining,
                                  lifecycle=lifecycle,
                                  weight_version=weight_version)
            else:
                self._bad_locked(replica, error)

    def note_proxy_failure(self, url: str) -> None:
        """The router watched this replica's connection die mid-request:
        the strongest liveness evidence there is, booked as one failed
        poll — detection accelerates, hysteresis still gates dead."""
        with self._lock:
            replica = self._replicas.get(url.rstrip("/"))
            if replica is not None:
                replica.last_poll_s = self._clock()
                self._bad_locked(replica, "proxy connection failed")

    def _good_locked(self, replica: Replica, load_score: float,
                     draining: bool,
                     lifecycle: Optional[str] = None,
                     weight_version: Optional[int] = None) -> None:
        replica.load_score = float(load_score)
        replica.draining = bool(draining)
        if lifecycle is not None and lifecycle != replica.lifecycle:
            replica.lifecycle = lifecycle
            self._transition(replica, f"replica_{lifecycle}")
        if weight_version is not None and (
            weight_version != replica.weight_version
        ):
            replica.weight_version = int(weight_version)
            self._transition(replica, "replica_swapped")
        replica.last_error = None
        replica.fails = 0
        if replica.state == DEAD:
            replica.oks += 1
            if replica.oks >= self.revive_after:
                replica.state = HEALTHY
                replica.oks = 0
                self.revivals += 1
                self._transition(replica, "replica_revived")
        else:
            if replica.state == SUSPECT:
                self._transition(replica, "replica_recovered")
            replica.state = HEALTHY
            replica.oks = 0

    def _bad_locked(self, replica: Replica, error: Optional[str]) -> None:
        replica.last_error = error
        replica.oks = 0
        replica.fails += 1
        if replica.state == HEALTHY and replica.fails >= self.suspect_after:
            replica.state = SUSPECT
            self._transition(replica, "replica_suspect")
        elif replica.state == SUSPECT and (
            replica.fails >= self.suspect_after + self.dead_after
        ):
            replica.state = DEAD
            self.deaths += 1
            self._transition(replica, "replica_dead")

    def _transition(self, replica: Replica, name: str) -> None:
        if self._obs is not None:
            self._obs.instant(
                name, tid="fleet", url=replica.url, fails=replica.fails
            )
            self._obs.count(f"fleet.{name}")

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            replicas = [r.snapshot() for r in self._replicas.values()]
        for doc in replicas:
            # expired() takes the lock-free path; annotate outside it.
            replica = self._replicas.get(doc["url"])
            doc["expired"] = replica is not None and self.expired(replica)
        by_state: dict[str, int] = {HEALTHY: 0, SUSPECT: 0, DEAD: 0}
        by_lifecycle: dict[str, int] = {}
        by_weight_version: dict[str, int] = {}
        for doc in replicas:
            by_state[doc["state"]] = by_state.get(doc["state"], 0) + 1
            lc = doc.get("lifecycle", "serving")
            by_lifecycle[lc] = by_lifecycle.get(lc, 0) + 1
            wv = str(doc.get("weight_version", 0))
            by_weight_version[wv] = by_weight_version.get(wv, 0) + 1
        return {
            "replicas": replicas,
            "by_state": by_state,
            "by_lifecycle": by_lifecycle,
            "by_weight_version": by_weight_version,
            "deaths": self.deaths,
            "revivals": self.revivals,
        }


class HealthMonitor:
    """Polls every replica's /healthz + /statsz on a fixed cadence.

    ``probe`` is injectable (tests drive the state machine without HTTP):
    it takes a replica URL and returns ``(ok, load_score, draining,
    error)`` — or a 5-tuple with the gateway's advertised ``lifecycle``
    appended (serve/elastic.py; 4-tuple probes keep the last known
    state). The ``slow_healthz`` fault (site ``router``) fires *here*,
    turning one poll into a slow failure — the hysteresis must absorb it
    (suspect at most), which the fleet tests assert.
    """

    def __init__(
        self,
        fleet: FleetState,
        poll_s: float = 2.0,
        timeout_s: Optional[float] = None,
        probe: Optional[Callable] = None,
    ):
        self.fleet = fleet
        self.poll_s = poll_s
        self.timeout_s = (
            max(0.5, self.poll_s) if timeout_s is None else timeout_s
        )
        self._probe = probe if probe is not None else self._http_probe
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._faults = faults.plan()
        self._obs = obs.recorder()

    # -- probing --------------------------------------------------------------

    def _http_probe(self, url: str):
        """(ok, load_score, draining, error, lifecycle) from one /healthz
        + /statsz round trip. Any connect/read/parse failure is one bad
        poll."""
        import http.client
        import json
        import urllib.parse

        parsed = urllib.parse.urlsplit(url)
        try:
            conn = http.client.HTTPConnection(
                parsed.netloc, timeout=self.timeout_s
            )
            try:
                conn.request("GET", "/healthz")
                health = conn.getresponse()
                hdoc = json.loads(health.read().decode("utf-8"))
                draining = health.status == 503 or hdoc.get("draining", False)
                conn.request("GET", "/statsz")
                stats = conn.getresponse()
                sdoc = json.loads(stats.read().decode("utf-8"))
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException) as err:
            return False, 0.0, False, f"poll failed: {err}", None
        return (True, float(sdoc.get("load_score", 0.0)), draining, None,
                hdoc.get("lifecycle"), sdoc.get("weight_version"))

    def poll_once(self) -> None:
        for replica in self.fleet.replicas():
            if self.fleet.expired(replica):
                continue  # aged-out heartbeat: nothing to poll yet
            t0 = self._obs.now() if self._obs is not None else 0
            if self._faults is not None:
                fs = self._faults.fire(
                    "router", phase="poll", url=replica.url
                )
                if fs is not None and fs.kind == "slow_healthz":
                    # One slow poll: burn the delay, book one failure —
                    # the hysteresis, not this poll, decides the state.
                    time.sleep(float(fs.param("s", 0.0)))
                    self.fleet.record_poll(
                        replica, False, error="injected slow_healthz"
                    )
                    continue
            probed = self._probe(replica.url)
            # 4-tuple probes (tests, older embeddings) carry no
            # lifecycle; the replica keeps its last advertised state.
            ok, load, draining, error = probed[:4]
            lifecycle = probed[4] if len(probed) > 4 else None
            weight_version = probed[5] if len(probed) > 5 else None
            self.fleet.record_poll(
                replica, ok, load_score=load, draining=draining, error=error,
                lifecycle=lifecycle, weight_version=weight_version,
            )
            if self._obs is not None:
                self._obs.complete(
                    "poll", t0, tid="fleet", url=replica.url, ok=ok
                )

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="fleet-health", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the monitor must not die
                continue

    def close(self) -> None:
        self._stop.set()


# -- placement ----------------------------------------------------------------


def _point(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode("utf-8")).digest()[:8],
                          "big")


@functools.lru_cache(maxsize=32)
def _ring_points(urls: tuple[str, ...], vnodes: int) -> list[tuple[int, str]]:
    """The sorted vnode point list for one membership set — it only
    changes when placeable membership does, so the per-request cost is a
    bisect, not |urls|·vnodes SHA-256 digests plus a sort."""
    return sorted(
        (_point(f"{u}#{i}"), u) for u in urls for i in range(vnodes)
    )


def ring_order(key: str, urls: list[str], vnodes: int = 32) -> list[str]:
    """Replica URLs in consistent-hash ring order starting at ``key``.

    The first element is the key's *home* replica; the rest are the
    failover/overflow sequence. Each URL contributes ``vnodes`` ring
    points, so removing one replica only remaps its own arc — identical
    requests keep hashing to the same home while the membership holds,
    which is what lets per-gateway single-flight coalescing work
    fleet-wide."""
    if not urls:
        return []
    points = _ring_points(tuple(sorted(urls)), vnodes)
    start = bisect.bisect_left(points, (_point(key), ""))
    order: list[str] = []
    seen: set[str] = set()
    for i in range(len(points)):
        _, url = points[(start + i) % len(points)]
        if url not in seen:
            seen.add(url)
            order.append(url)
            if len(order) == len(urls):
                break
    return order


# -- cross-replica stream continuity ------------------------------------------


class StreamLedger:
    """Per-(kind, model) delivered-character accounting for one request.

    The router records every chunk character it forwards. When a replica
    dies mid-stream and the request is re-submitted elsewhere, the fresh
    run re-produces the stream from chunk zero (greedy decode is
    deterministic — the same byte-identical-replay contract the in-
    process supervisor relies on); :meth:`arm_replay` arms the ledger to
    burn exactly the delivered prefix of each stream before anything
    more reaches the client. Chunk boundaries may differ across the
    seam; characters never do."""

    def __init__(self) -> None:
        self._delivered: dict[tuple[str, str], int] = {}
        self._skip: dict[tuple[str, str], int] = {}

    def record(self, kind: str, model: str, text: str) -> Optional[str]:
        """Account one incoming chunk; returns the portion the client has
        not seen yet (None when the whole chunk is replayed prefix)."""
        key = (kind, model)
        skip = self._skip.get(key, 0)
        if skip:
            if len(text) <= skip:
                self._skip[key] = skip - len(text)
                return None
            text = text[skip:]
            self._skip[key] = 0
        self._delivered[key] = self._delivered.get(key, 0) + len(text)
        return text

    def arm_replay(self) -> None:
        """The next replica replays each stream from its start: suppress
        the prefix the client already holds."""
        self._skip = dict(self._delivered)
        self._delivered = dict(self._delivered)

    @property
    def delivered_any(self) -> bool:
        return any(self._delivered.values())
