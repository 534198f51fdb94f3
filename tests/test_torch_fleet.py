"""The port's fleet tier (llm_consensus_tpu_torch/serve/fleet.py and
serve/router.py) against the JAX package's, over real HTTP with the same
deterministic streaming fake.

Every case of tests/test_fleet.py runs through BOTH packages: one fake
class is written against each package's ``Provider`` base, the traffic is
the same, and each case returns what it observed (hysteresis state
sequences, ring orders as replica indices, status codes, SSE texts, router
counters, ledger outputs) after holding each package to the JAX test's own
assertions; the two observations must be equal. The router cases of
tests/test_live_obs.py (the fleet ``/metricsz`` merge and one trace id
across a failover) follow the same pattern.

Every HTTP call has a client timeout, every join a timeout, and every
server closes in a ``finally``.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import threading
import time
from types import SimpleNamespace

import pytest

import llm_consensus_tpu.faults as jax_faults
import llm_consensus_tpu.integrity as jax_integrity
import llm_consensus_tpu.obs as jax_obs
import llm_consensus_tpu.serve as jax_serve
from llm_consensus_tpu.obs import attrib as jax_attrib
from llm_consensus_tpu.obs import blackbox as jax_blackbox
from llm_consensus_tpu.obs import live as jax_live
from llm_consensus_tpu.obs import profiler as jax_profiler
from llm_consensus_tpu.obs import prom as jax_prom
from llm_consensus_tpu.obs import roofline as jax_roofline
from llm_consensus_tpu.providers.base import Provider as JaxProvider
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu.providers.registry import Registry as JaxRegistry
from llm_consensus_tpu.serve import fleet as jax_fleet
from llm_consensus_tpu.serve import router as jax_router
from llm_consensus_tpu_torch import faults, integrity, obs, serve
from llm_consensus_tpu_torch.obs import attrib, blackbox, live, profiler, prom, roofline
from llm_consensus_tpu_torch.providers import Provider, Registry, Response
from llm_consensus_tpu_torch.serve import fleet, router

PANEL = ["alpha", "beta"]
JUDGE = "gamma"
CHUNK = 6  # characters per streamed chunk
WAIT = 30.0

JAX = SimpleNamespace(
    name="jax", serve=jax_serve, obs=jax_obs, faults=jax_faults, integrity=jax_integrity,
    live=jax_live, blackbox=jax_blackbox, attrib=jax_attrib, roofline=jax_roofline,
    profiler=jax_profiler, prom=jax_prom, fleet=jax_fleet, router=jax_router,
    Provider=JaxProvider, Response=JaxResponse, Registry=JaxRegistry)
TORCH = SimpleNamespace(
    name="torch", serve=serve, obs=obs, faults=faults, integrity=integrity, live=live,
    blackbox=blackbox, attrib=attrib, roofline=roofline, profiler=profiler, prom=prom,
    fleet=fleet, router=router, Provider=Provider, Response=Response, Registry=Registry)
PKGS = (JAX, TORCH)


def _quiet_planes():
    """Both packages with no recorder, fault plan, integrity plane or
    telemetry plane (the JAX planes otherwise resolve from the
    environment): each case installs what it compares."""
    for P in PKGS:
        P.obs.reset()
        P.faults.reset()
        P.integrity.reset()
        for plane in (P.live, P.blackbox, P.attrib, P.roofline, P.profiler):
            plane.install(None)


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    for knob in ("LLMC_FAULTS", "LLMC_INTEGRITY", "LLMC_EVENTS"):
        monkeypatch.delenv(knob, raising=False)
    _quiet_planes()
    yield
    _quiet_planes()
    for P in PKGS:
        for plane in (P.live, P.blackbox, P.attrib, P.roofline, P.profiler):
            plane.reset()


def both(scenario, tmp_path):
    """``scenario(P, tmp)`` through the JAX package, then the port's; the
    port's observations must equal the JAX ones."""
    out = {}
    for P in PKGS:
        _quiet_planes()
        out[P.name] = scenario(P, tmp_path / P.name)
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- the fakes and HTTP helpers of tests/test_fleet.py, on either package -------------


def expected_content(model: str, prompt: str) -> str:
    return f"{model} answers {prompt} at some length for chunking"


def streaming_provider(P, gate=None, arrivals=None):
    """Deterministic multi-chunk streaming fake on ``P``'s base; panel
    queries optionally wait on ``gate`` after releasing ``arrivals``."""

    class StreamingProvider(P.Provider):
        def __init__(self):
            self._lock = threading.Lock()
            self.calls: list = []

        def query(self, ctx, req):
            return self.query_stream(ctx, req, None)

        def query_stream(self, ctx, req, callback):
            with self._lock:
                self.calls.append((req.model, req.prompt))
            if req.model in PANEL:
                if arrivals is not None:
                    arrivals.release()
                if gate is not None:
                    assert gate.wait(WAIT), "test gate never released"
            ctx.raise_if_done()
            content = expected_content(req.model, req.prompt[:16])
            if callback is not None:
                for i in range(0, len(content), CHUNK):
                    callback(content[i:i + CHUNK])
            return P.Response(model=req.model, content=content, provider="fake")

        def panel_calls(self):
            with self._lock:
                return [c for c in self.calls if c[0] in PANEL]

    return StreamingProvider()


def make_replica(P, tmp, provider, name, **kw):
    registry = P.Registry()
    for m in PANEL + [JUDGE]:
        registry.register(m, provider)
    kw.setdefault("timeout", 30.0)
    kw.setdefault("max_concurrency", 4)
    kw.setdefault("cache_size", 0)  # failover re-executes, never replays
    gw = P.serve.build_gateway(registry, list(PANEL), JUDGE,
                               data_dir=os.path.join(str(tmp), "data", name), **kw)
    gw.start()
    return gw


def gw_url(gw) -> str:
    host, port = gw.address
    return f"http://{host}:{port}"


def make_router(P, replicas, **kw):
    kw.setdefault("poll_s", 60.0)  # tests drive polls explicitly
    r = P.serve.build_router([gw_url(g) for g in replicas], **kw)
    r.start()
    return r


def post(port, body, path="/v1/consensus", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", path, json.dumps(body), hdrs)
        r = conn.getresponse()
        out = r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()
    return out


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    return r.status, data


def get_json(port, path):
    status, data = get(port, path)
    return status, json.loads(data)


def post_sse(port, body):
    """POST with SSE accept; the parsed event list up to the terminal one."""
    body = dict(body)
    body["stream"] = True
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    events: list = []
    try:
        conn.request("POST", "/v1/consensus", json.dumps(body),
                     {"Content-Type": "application/json", "Accept": "text/event-stream"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        event, data_lines = None, []
        for raw in resp:
            line = raw.decode("utf-8").rstrip("\r\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data_lines.append(line[len("data: "):])
            elif not line and (event or data_lines):
                events.append((event, json.loads("\n".join(data_lines))))
                if event in ("done", "error"):
                    break
                event, data_lines = None, []
    finally:
        conn.close()
    return events


def sse_text(events) -> dict:
    """Per-``kind:model`` concatenated chunk text."""
    out: dict = {}
    for name, doc in events:
        if name == "chunk":
            key = f"{doc['kind']}:{doc['model']}"
            out[key] = out.get(key, "") + doc["text"]
    return out


def baseline_sse_text(P, tmp, prompt):
    """The undisturbed stream: one fresh replica, queried directly."""
    gw = make_replica(P, tmp, streaming_provider(P), "baseline")
    try:
        return sse_text(post_sse(gw.address[1], {"prompt": prompt}))
    finally:
        gw.close(timeout=5.0)


def runs_executed(*gateways) -> int:
    return sum(g.scheduler.runs_executed for g in gateways)


def close_all(rtr, gws):
    if rtr is not None:
        rtr.close()
    for g in gws:
        g.close(timeout=5.0)


# ---------------------------------------------------------------------------
# hysteresis state machine


def test_one_slow_poll_is_never_dead(tmp_path):
    def scenario(P, tmp):
        fl = P.fleet.FleetState(suspect_after=1, dead_after=3, revive_after=2)
        replica = fl.add_static("http://127.0.0.1:1")
        P.faults.install(P.faults.FaultPlan("slow_healthz@phase=poll@s=0.01", seed=3))
        polled = []
        monitor = P.fleet.HealthMonitor(
            fl, poll_s=60.0,
            probe=lambda url: (polled.append(url) or (True, 0.1, False, None)))
        seen = []
        monitor.poll_once()  # the injected slow poll: one failure
        seen.append(replica.state)
        assert replica.state == P.fleet.SUSPECT and polled == []
        monitor.poll_once()  # the next poll is clean
        seen.append(replica.state)
        assert replica.state == P.fleet.HEALTHY and fl.deaths == 0
        return seen, replica.snapshot()

    assert both(scenario, tmp_path)[0] == ["suspect", "healthy"]


def test_death_needs_consecutive_failures_and_revival_is_conservative(tmp_path):
    def scenario(P, tmp):
        fl = P.fleet.FleetState(suspect_after=1, dead_after=3, revive_after=2)
        replica = fl.add_static("http://127.0.0.1:1")
        seen = []
        for ok in [False, True, False, False, False, False, True, True]:
            fl.record_poll(replica, ok)
            seen.append(replica.state)
        assert seen[-3:] == [P.fleet.DEAD, P.fleet.DEAD, P.fleet.HEALTHY]
        assert fl.deaths == 1 and fl.revivals == 1
        return seen, fl.snapshot()

    seen, _ = both(scenario, tmp_path)
    assert seen == ["suspect", "healthy", "suspect", "suspect", "suspect", "dead", "dead",
                    "healthy"]


def test_proxy_failure_counts_as_failed_poll(tmp_path):
    def scenario(P, tmp):
        fl = P.fleet.FleetState(suspect_after=1, dead_after=3)
        replica = fl.add_static("http://127.0.0.1:1")
        fl.note_proxy_failure("http://127.0.0.1:1")
        assert replica.state == P.fleet.SUSPECT and replica.fails == 1
        return replica.snapshot()

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# placement


def test_ring_order_is_stable_and_complete(tmp_path):
    def scenario(P, tmp):
        urls = [f"http://127.0.0.1:{p}" for p in (9001, 9002, 9003)]
        orders = {}
        for key in ("some-key", "another", "a third key", ""):
            order = P.fleet.ring_order(key, urls)
            assert sorted(order) == sorted(urls) and order == P.fleet.ring_order(key, urls)
            shrunk = [u for u in urls if u != order[-1]]
            assert P.fleet.ring_order(key, shrunk)[0] == order[0]
            orders[key] = (order, P.fleet.ring_order(key, urls, vnodes=4))
        return orders, P.fleet._point("canary|k")

    both(scenario, tmp_path)


def test_routed_json_roundtrip_and_stats(tmp_path):
    def scenario(P, tmp):
        provider = streaming_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws)
        try:
            port = rtr.address[1]
            status, _, data = post(port, {"prompt": "route me"})
            assert status == 200, data
            doc = json.loads(data)
            assert doc["consensus"]
            assert doc["replica"] in [gw_url(g) for g in gws]
            assert runs_executed(*gws) == 1
            status, stats = get_json(port, "/statsz")
            assert status == 200 and stats["counters"]["requests"] == 1
            assert stats["fleet"]["by_state"]["healthy"] == 2
            status, health = get_json(port, "/healthz")
            assert status == 200 and health["replicas"]["healthy"] == 2
            return doc["consensus"], stats["counters"], health, sorted(stats)
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)


def test_identical_concurrent_requests_coalesce_fleet_wide(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        arrivals = threading.Semaphore(0)
        provider = streaming_provider(P, gate=gate, arrivals=arrivals)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws)
        try:
            port = rtr.address[1]
            results: list = [None, None]

            def fire(i):
                results[i] = post(port, {"prompt": "coalesce fleet-wide"})

            threads = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            assert arrivals.acquire(timeout=10)
            time.sleep(0.2)  # let the second request join the flight
            gate.set()
            for t in threads:
                t.join(timeout=WAIT)
            docs = [json.loads(r[2]) for r in results]
            assert all(r[0] == 200 for r in results)
            assert runs_executed(*gws) == 1
            assert sum(1 for d in docs if d["coalesced"]) == 1
            assert len(provider.panel_calls()) == len(PANEL)
            return sorted(d["coalesced"] for d in docs), len(provider.panel_calls())
        finally:
            gate.set()
            close_all(rtr, gws)

    both(scenario, tmp_path)


def test_saturated_home_overflows_to_next_ring_replica(tmp_path):
    def scenario(P, tmp):
        provider = streaming_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws)
        try:
            body = {"prompt": "overflow probe"}
            key = P.router.RouteRequest(b"", dict(body), False).key()
            urls = [gw_url(g) for g in gws]
            home = P.fleet.ring_order(key, urls, vnodes=rtr.vnodes)[0]
            other = next(u for u in urls if u != home)
            for replica in rtr.fleet.replicas():
                if replica.url == home:
                    rtr.fleet.record_poll(replica, True, load_score=0.99)
            status, _, data = post(rtr.address[1], body)
            assert status == 200 and json.loads(data)["replica"] == other
            _, stats = get_json(rtr.address[1], "/statsz")
            return key, stats["counters"]
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# failover


def test_replica_down_mid_stream_reroutes_byte_identical(tmp_path):
    def scenario(P, tmp):
        prompt = "failover mid-stream probe"
        expected = baseline_sse_text(P, tmp, prompt)
        provider = streaming_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        P.faults.install(P.faults.FaultPlan("replica_down@phase=proxy@frame=3", seed=5))
        rtr = make_router(P, gws)
        try:
            port = rtr.address[1]
            events = post_sse(port, {"prompt": prompt})
            assert events[-1][0] == "done", events[-1]
            assert sse_text(events) == expected
            assert events[-1][1]["failovers"] == 1
            assert runs_executed(*gws) == 2
            _, stats = get_json(port, "/statsz")
            assert stats["counters"]["failovers"] == 1
            states = sorted(r["state"] for r in stats["fleet"]["replicas"])
            assert states == ["healthy", "suspect"]
            return sse_text(events), [e[0] for e in events].count("chunk"), states
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)


def test_unreachable_replica_fails_over_on_connect(tmp_path):
    def scenario(P, tmp):
        gw = make_replica(P, tmp, streaming_provider(P), "live")
        probe_sock = socket.socket()
        probe_sock.bind(("127.0.0.1", 0))
        dead_port = probe_sock.getsockname()[1]
        probe_sock.close()
        rtr = P.serve.build_router([f"http://127.0.0.1:{dead_port}", gw_url(gw)], poll_s=60.0)
        rtr.start()
        try:
            status, _, data = post(rtr.address[1], {"prompt": "connect failover"})
            assert status == 200
            assert json.loads(data)["replica"] == gw_url(gw)
            assert runs_executed(gw) == 1
            return status, runs_executed(gw)
        finally:
            close_all(rtr, [gw])

    both(scenario, tmp_path)


def test_injected_partition_forces_failover(tmp_path):
    def scenario(P, tmp):
        provider = streaming_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        P.faults.install(P.faults.FaultPlan("partition@phase=connect", seed=9))
        rtr = make_router(P, gws)
        try:
            status, _, data = post(rtr.address[1], {"prompt": "partition probe"})
            assert status == 200 and json.loads(data)["consensus"]
            _, stats = get_json(rtr.address[1], "/statsz")
            assert stats["counters"]["failovers"] == 1
            return stats["counters"], json.loads(data)["consensus"]
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# spillover


def remote_fake_registry(P, provider=None):
    registry = P.Registry()
    provider = provider if provider is not None else streaming_provider(P)
    for m in ["remote-a", "remote-b", "remote-judge"]:
        registry.register(m, provider)
    return registry


def make_spill_router(P, tmp, replicas=(), **kw):
    kw.setdefault("poll_s", 60.0)
    if "spillover_registry" not in kw:
        kw["spillover_registry"] = remote_fake_registry(P)
    kw.setdefault("spillover_models", ["remote-a", "remote-b"])
    kw.setdefault("spillover_judge", "remote-judge")
    kw.setdefault("data_dir", os.path.join(str(tmp), "spill"))
    rtr = P.serve.build_router([gw_url(g) for g in replicas], **kw)
    rtr.start()
    return rtr


def test_spillover_when_fleet_is_dead(tmp_path):
    def scenario(P, tmp):
        rtr = make_spill_router(P, tmp)  # zero replicas: nothing live
        try:
            status, _, data = post(rtr.address[1], {"prompt": "spill me", "timeout": 60})
            assert status == 200, data
            doc = json.loads(data)
            assert doc["degraded"] == "remote" and doc["consensus"]
            assert [r["model"] for r in doc["responses"]] == ["remote-a", "remote-b"]
            _, stats = get_json(rtr.address[1], "/statsz")
            assert stats["counters"]["spillover"] == 1
            return doc["consensus"], doc["degraded"], stats["counters"], stats["spillover"]
        finally:
            rtr.close()

    both(scenario, tmp_path)


def test_spillover_streams_sse(tmp_path):
    def scenario(P, tmp):
        rtr = make_spill_router(P, tmp)
        try:
            events = post_sse(rtr.address[1], {"prompt": "spill sse", "timeout": 60})
            assert events[-1][0] == "done" and events[-1][1]["degraded"] == "remote"
            text = sse_text(events)
            assert "model_chunk:remote-a" in text
            return text
        finally:
            rtr.close()

    both(scenario, tmp_path)


def test_spillover_gated_by_deadline_class(tmp_path):
    def scenario(P, tmp):
        rtr = make_spill_router(
            P, tmp, spillover_policy=P.router.SpilloverPolicy("saturated", min_timeout_s=30.0))
        try:
            status, _, data = post(rtr.address[1], {"prompt": "too tight", "timeout": 5})
            assert status == 503, data
            _, stats = get_json(rtr.address[1], "/statsz")
            assert stats["counters"]["spillover"] == 0 and stats["counters"]["rejected"] == 1
            return status, json.loads(data), stats["counters"]
        finally:
            rtr.close()

    both(scenario, tmp_path)


def test_spillover_failure_mid_stream_ends_with_sse_error(tmp_path):
    """A remote-lane failure after the SSE stream began ends the stream
    with an ``error`` event, never a bare status line inside it."""

    def scenario(P, tmp):
        class ExplodingProvider(P.Provider):
            def query(self, ctx, req):
                return self.query_stream(ctx, req, None)

            def query_stream(self, ctx, req, callback):
                if callback is not None:
                    callback("partial ")
                raise RuntimeError("remote API fell over")

        rtr = make_spill_router(
            P, tmp, spillover_registry=remote_fake_registry(P, ExplodingProvider()))
        try:
            events = post_sse(rtr.address[1], {"prompt": "boom", "timeout": 60})
            assert events[-1][0] == "error", events
            error = events[-1][1]["error"]
            assert "routing failed" in error
            # The panel's failures are listed in completion order, which is
            # a race between the two remote models in either package.
            head, sep, failures = error.partition("all models failed: ")
            failures = "; ".join(sorted(f.strip() for f in failures.split(";")))
            return [e[0] for e in events], head + sep + failures
        finally:
            rtr.close()

    both(scenario, tmp_path)


def test_bad_registration_returns_400(tmp_path):
    def scenario(P, tmp):
        rtr = P.serve.build_router([], poll_s=60.0)
        rtr.start()
        try:
            status, _, data = post(rtr.address[1], {"url": "http://x:1", "load_score": "high"},
                                   path="/v1/register")
            assert status == 400 and b"bad registration" in data
            assert rtr.fleet.replicas() == []
            return status, json.loads(data)
        finally:
            rtr.close()

    both(scenario, tmp_path)


def test_spillover_gated_by_policy_off(tmp_path):
    def scenario(P, tmp):
        rtr = make_spill_router(P, tmp, spillover_policy=P.router.SpilloverPolicy("off"))
        try:
            status, headers, data = post(rtr.address[1], {"prompt": "policy off", "timeout": 60})
            assert status == 503
            return status, headers.get("Retry-After"), json.loads(data)
        finally:
            rtr.close()

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# heartbeat registration


def test_register_heartbeat_and_expiry(tmp_path):
    def scenario(P, tmp):
        clock = [100.0]
        fl = P.fleet.FleetState(clock=lambda: clock[0])
        replica = fl.heartbeat("http://127.0.0.1:9009", load_score=0.2, interval_s=1.0)
        seen = [(replica.state, fl.expired(replica))]
        clock[0] += 10.0  # missed every beat in the grace window
        seen.append((replica.state, fl.expired(replica)))
        fl.heartbeat("http://127.0.0.1:9009", load_score=0.3)
        seen.append((replica.state, fl.expired(replica)))
        return seen, fl.snapshot()

    seen, _ = both(scenario, tmp_path)
    assert seen == [("healthy", False), ("healthy", True), ("healthy", False)]


def test_gateway_announce_end_to_end(tmp_path):
    def scenario(P, tmp):
        gw = make_replica(P, tmp, streaming_provider(P), "announced")
        rtr = P.serve.build_router([], poll_s=60.0)  # NO static replicas
        rtr.start()
        try:
            port = rtr.address[1]
            gw.announce(f"http://127.0.0.1:{port}", interval_s=0.2)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                _, stats = get_json(port, "/statsz")
                if stats["fleet"]["replicas"]:
                    break
                time.sleep(0.05)
            assert stats["fleet"]["replicas"], "gateway never registered"
            doc = stats["fleet"]["replicas"][0]
            assert doc["url"] == gw_url(gw) and doc["source"] == "heartbeat"
            assert 0.0 <= doc["load_score"] <= 1.0
            status, _, data = post(port, {"prompt": "announced routing"})
            assert status == 200 and json.loads(data)["replica"] == gw_url(gw)
            return (doc["source"], doc["state"], doc["lifecycle"], doc["weight_version"],
                    sorted(doc))
        finally:
            close_all(rtr, [gw])

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# ledger unit coverage


def test_stream_ledger_double_failover(tmp_path):
    def scenario(P, tmp):
        ledger = P.fleet.StreamLedger()
        out = [ledger.record("model_chunk", "m", "abcdef")]
        ledger.arm_replay()
        out += [ledger.record("model_chunk", "m", "abc"),
                ledger.record("model_chunk", "m", "defghi")]
        ledger.arm_replay()  # second failover: 9 delivered chars burn first
        out += [ledger.record("model_chunk", "m", "abcdefghi"),
                ledger.record("model_chunk", "m", "jkl"),
                ledger.record("judge_chunk", "j", "xy")]
        assert ledger.delivered_any
        return out

    assert both(scenario, tmp_path) == ["abcdef", None, "ghi", None, "jkl", "xy"]


# ---------------------------------------------------------------------------
# tests/test_live_obs.py: the router's fleet view and one trace across hops


def _live_replica(P, tmp, name):
    return make_replica(P, tmp, streaming_provider(P), name,
                        live=P.live.LiveMetrics(window_s=60.0))


def test_router_metricsz_is_bucketwise_merge_of_replicas(tmp_path):
    def scenario(P, tmp):
        gws = [_live_replica(P, tmp, f"r{i}") for i in range(2)]
        rtr = None
        try:
            rtr = make_router(P, gws)
            rport = rtr.address[1]
            for i in range(4):
                status, _, data = post(rport, {"prompt": f"merge probe {i}"})
                assert status == 200, data
                assert json.loads(data)["trace_id"]

            def request_families(parsed):
                return {k: v for k, v in parsed["histograms"].items()
                        if k[0] in ("ttft", "e2e", "queue_wait", "token_latency",
                                    "judge_synthesis")}

            replica_parsed = [P.prom.parse_text(get(g.address[1], "/metricsz")[1].decode())
                              for g in gws]
            rtext = get(rport, "/metricsz")[1].decode()
            merged = P.prom.merge(replica_parsed)
            got = request_families(P.prom.parse_text(rtext))
            assert got == request_families(merged)
            counts = {k: v["count"] for k, v in request_families(merged).items()}
            assert sum(counts.values()) >= 4
            gauges = P.prom.parse_text(rtext)["gauges"]
            assert gauges[("fleet_replicas_scraped", ())] == 2
            return sorted(counts.items())
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)


def test_one_trace_id_links_hops_across_failover(tmp_path):
    def scenario(P, tmp):
        rec = P.obs.Recorder()
        P.obs.install(rec)
        P.faults.install(P.faults.FaultPlan("replica_down@phase=proxy@frame=2", seed=11))
        gws = [_live_replica(P, tmp, f"f{i}") for i in range(2)]
        rtr = None
        try:
            rtr = make_router(P, gws)
            events = post_sse(rtr.address[1], {"prompt": "failover trace probe"})
            assert events[-1][0] == "done", events[-1]
            done = events[-1][1]
            trace = done["trace_id"]
            assert trace and done.get("failovers", 0) >= 1

            def spans_named(name):
                return [e for e in rec.events()
                        if e.ph == "X" and e.name == name and e.args.get("trace") == trace]

            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not spans_named("route"):
                time.sleep(0.02)
            route_spans = spans_named("route")
            assert route_spans and spans_named("consensus_run") and spans_named("worker")
            assert route_spans[0].args.get("outcome") == "failover"
            return (done["failovers"], route_spans[0].args.get("outcome"),
                    len(spans_named("consensus_run")), len(spans_named("worker")))
        finally:
            close_all(rtr, gws)

    both(scenario, tmp_path)
