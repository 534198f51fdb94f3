"""The port's elastic tier (llm_consensus_tpu_torch/serve/elastic.py and the
gateway's migration half) against the JAX package's.

Every case of tests/test_elastic.py runs through BOTH packages with one
mid-stream fake per package's ``Provider`` base: the lifecycle state
machine, migration records (their content digests equal across packages
for the same document), the migration table, the ElasticController's
decision sequences under the same scripted signal, the router's
``/v1/scale`` and lifecycle-aware placement, and live migration of a
mid-flight SSE stream through a retire (byte-identical to an undisturbed
run) or its ``migrate_stall`` fallback. Each case returns what it observed
after holding each package to the JAX test's own assertions; the two
observations must be equal.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
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
from llm_consensus_tpu.obs import roofline as jax_roofline
from llm_consensus_tpu.providers.base import Provider as JaxProvider
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu.providers.registry import Registry as JaxRegistry
from llm_consensus_tpu.serve import elastic as jax_elastic
from llm_consensus_tpu.serve import fleet as jax_fleet
from llm_consensus_tpu.serve import router as jax_router
from llm_consensus_tpu_torch import faults, integrity, obs, serve
from llm_consensus_tpu_torch.obs import attrib, blackbox, live, profiler, roofline
from llm_consensus_tpu_torch.providers import Provider, Registry, Response
from llm_consensus_tpu_torch.serve import elastic, fleet, router

PANEL = ["alpha", "beta"]
JUDGE = "gamma"
CHUNK = 6   # characters per streamed chunk
HOLD = 2    # chunks each panel stream emits BEFORE blocking on the gate
WAIT = 30.0

JAX = SimpleNamespace(
    name="jax", serve=jax_serve, obs=jax_obs, faults=jax_faults, integrity=jax_integrity,
    live=jax_live, blackbox=jax_blackbox, attrib=jax_attrib, roofline=jax_roofline,
    profiler=jax_profiler, elastic=jax_elastic, fleet=jax_fleet, router=jax_router,
    Provider=JaxProvider, Response=JaxResponse, Registry=JaxRegistry)
TORCH = SimpleNamespace(
    name="torch", serve=serve, obs=obs, faults=faults, integrity=integrity, live=live,
    blackbox=blackbox, attrib=attrib, roofline=roofline, profiler=profiler, elastic=elastic,
    fleet=fleet, router=router, Provider=Provider, Response=Response, Registry=Registry)
PKGS = (JAX, TORCH)


def _quiet_planes():
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


def expected_content(model: str, prompt: str) -> str:
    return f"{model} answers {prompt} at some length for chunking"


def mid_stream_provider(P, gate=None, arrivals=None):
    """The deterministic streaming fake of tests/test_elastic.py on ``P``'s
    base: each panel query emits ``HOLD`` chunks, releases ``arrivals``,
    then waits on ``gate`` before the rest."""

    class MidStreamProvider(P.Provider):
        def query(self, ctx, req):
            return self.query_stream(ctx, req, None)

        def query_stream(self, ctx, req, callback):
            content = expected_content(req.model, req.prompt[:16])
            chunks = [content[i:i + CHUNK] for i in range(0, len(content), CHUNK)]
            gated = req.model in PANEL and gate is not None
            for i, chunk in enumerate(chunks):
                if gated and i == HOLD:
                    if arrivals is not None:
                        arrivals.release()
                    assert gate.wait(WAIT), "test gate never released"
                    ctx.raise_if_done()
                if callback is not None:
                    callback(chunk)
            ctx.raise_if_done()
            return P.Response(model=req.model, content=content, provider="fake")

    return MidStreamProvider()


def make_replica(P, tmp, provider, name, **kw):
    registry = P.Registry()
    for m in PANEL + [JUDGE]:
        registry.register(m, provider)
    kw.setdefault("timeout", 30.0)
    kw.setdefault("max_concurrency", 4)
    kw.setdefault("cache_size", 0)  # migration re-executes, never replays
    gw = P.serve.build_gateway(registry, list(PANEL), JUDGE,
                               data_dir=os.path.join(str(tmp), "data", name), **kw)
    gw.start()
    return gw


def gw_url(gw) -> str:
    host, port = gw.address
    return f"http://{host}:{port}"


def make_router(P, replicas, **kw):
    kw.setdefault("poll_s", 60.0)
    r = P.serve.build_router([gw_url(g) for g in replicas], **kw)
    r.start()
    return r


def post(port, body, path="/v1/consensus"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        out = r.status, r.read()
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
    return r.status, json.loads(data)


def post_sse(port, body):
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
    out: dict = {}
    for name, doc in events:
        if name == "chunk":
            key = f"{doc['kind']}:{doc['model']}"
            out[key] = out.get(key, "") + doc["text"]
    return out


def baseline_sse_text(P, tmp, prompt):
    gw = make_replica(P, tmp, mid_stream_provider(P), "baseline")
    try:
        return sse_text(post_sse(gw.address[1], {"prompt": prompt}))
    finally:
        gw.close(timeout=5.0)


def _elastic_stats(port):
    stats = get(port, "/statsz")[1]["elastic"]
    return {k: stats[k] for k in ("lifecycle", "residents", "migrations_out", "migrations_in",
                                  "migrations_resumed", "migrate_fallbacks", "retires")}


# ---------------------------------------------------------------------------
# lifecycle state machine


def test_lifecycle_is_a_forward_state_machine(tmp_path):
    def scenario(P, tmp):
        E = P.elastic
        assert E.placeable(E.SERVING)
        assert not any(E.placeable(s) for s in (E.JOINING, E.DRAINING, E.RETIRING))
        return {(a, b): E.can_transition(a, b) for a in E.LIFECYCLES for b in E.LIFECYCLES}

    table = both(scenario, tmp_path)
    assert table[("draining", "serving")] and not table[("retiring", "serving")]


def test_gateway_lifecycle_transitions_and_illegal_moves(tmp_path):
    def scenario(P, tmp):
        E = P.elastic
        gw = make_replica(P, tmp, mid_stream_provider(P), "lc")
        try:
            seen = [gw.lifecycle]
            for state in (E.DRAINING, E.SERVING, E.DRAINING, E.RETIRING):
                gw.set_lifecycle(state)
                seen.append(gw.lifecycle)
            with pytest.raises(ValueError):
                gw.set_lifecycle(E.SERVING)  # retiring is terminal
            return seen
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_joining_replica_is_fully_loaded_and_refuses_migrations(tmp_path):
    def scenario(P, tmp):
        E = P.elastic
        gw = make_replica(P, tmp, mid_stream_provider(P), "cold", lifecycle=E.JOINING)
        try:
            assert gw.lifecycle == E.JOINING and gw.load_score() == 1.0
            port = gw.address[1]
            status, doc = get(port, "/healthz")
            assert status == 200 and doc["placeable"] is False
            record = E.MigrationRecord(key="k-cold", resume={"alpha": {"text": ""}})
            st, resp = gw.accept_migration(json.dumps(record.to_doc()).encode())
            assert st == 200 and resp["accepted"] is False
            gw.mark_serving()
            assert gw.lifecycle == E.SERVING and gw.load_score() < 1.0
            _, after = get(port, "/healthz")
            assert after["placeable"] is True
            return doc, resp, after
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_healthz_reflects_draining_lifecycle(tmp_path):
    def scenario(P, tmp):
        gw = make_replica(P, tmp, mid_stream_provider(P), "drainz")
        try:
            gw.set_lifecycle(P.elastic.DRAINING)
            status, doc = get(gw.address[1], "/healthz")
            assert status == 503 and doc["status"] == "draining"
            assert doc["draining"] is True and doc["placeable"] is False
            return status, doc
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# migration records + table


def test_migration_record_roundtrip_and_validation(tmp_path):
    def scenario(P, tmp):
        rec = P.elastic.MigrationRecord(
            key="k1",
            resume={"m": {"prompt_ids": [1, 2], "sampling": {"temperature": 0.0},
                          "tokens": [9]}},
            emitted={"model_chunk:m": "partial"}, priority=2, trace_id="t-1",
            flags={"kv_pool": True}, source="http://127.0.0.1:1")
        again = P.elastic.MigrationRecord.from_doc(json.loads(json.dumps(rec.to_doc())))
        assert (again.key, again.resume, again.emitted) == (rec.key, rec.resume, rec.emitted)
        assert again.priority == 2 and again.trace_id == "t-1"
        with pytest.raises(ValueError):
            P.elastic.MigrationRecord.from_doc({"resume": {}})  # key is mandatory
        again.stamp_digest()
        ok = again.verify_digest()
        again.resume["m"]["tokens"][0] ^= 1  # one flipped bit in transit
        return again.to_doc()["digest"], rec.content_digest(), ok, again.verify_digest()

    digest, _, ok, flipped = both(scenario, tmp_path)
    assert digest and ok and not flipped


def test_migration_table_claims_once_and_expires(tmp_path):
    def scenario(P, tmp):
        now = [0.0]
        table = P.elastic.MigrationTable(ttl_s=1.0, clock=lambda: now[0])
        table.offer(P.elastic.MigrationRecord(key="k1"))
        seen = [table.depth(), table.claim("k1") is not None, table.claim("k1") is None]
        table.offer(P.elastic.MigrationRecord(key="k2"))
        now[0] = 2.0  # past the TTL: the record must not leak
        seen.append(table.claim("k2") is None)
        return seen, table.stats()

    seen, stats = both(scenario, tmp_path)
    assert seen == [1, True, True, True]
    assert stats == {"depth": 0, "offered": 2, "claimed": 1, "expired": 1}


# ---------------------------------------------------------------------------
# scale hysteresis: the same scripted signal, the same decision sequence


def make_controller(P, loads, count, **kw):
    calls = {"up": 0, "down": 0}

    def scale_up():
        calls["up"] += 1
        count[0] += 1
        return True

    def scale_down():
        calls["down"] += 1
        count[0] -= 1
        return True

    kw.setdefault("scale_up", scale_up)
    kw.setdefault("scale_down", scale_down)
    kw.setdefault("high_water", 0.8)
    kw.setdefault("low_water", 0.2)
    kw.setdefault("up_patience", 3)
    kw.setdefault("down_patience", 3)
    kw.setdefault("tick_s", 60.0)
    ctl = P.elastic.ElasticController(signal=lambda: loads[0], replica_count=lambda: count[0],
                                      **kw)
    return ctl, calls


def _snap(ctl):
    return {k: v for k, v in ctl.snapshot().items()}


def test_scale_up_needs_sustained_high_and_mid_band_resets(tmp_path):
    def scenario(P, tmp):
        loads, count = [1.0], [1]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=4)
        seq = []
        for load in (1.0, 1.0, 0.5, 1.0, 1.0, 1.0):
            loads[0] = load
            seq.append(ctl.tick())
        assert calls == {"up": 1, "down": 0} and count[0] == 2
        return seq, _snap(ctl)

    seq, _ = both(scenario, tmp_path)
    assert seq == [None, None, None, None, None, "up"]


def test_scale_down_needs_sustained_low_and_min_clamp_denies(tmp_path):
    def scenario(P, tmp):
        loads, count = [0.0], [2]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=4)
        seq = [ctl.tick() for _ in range(6)]
        assert count[0] == 1 and calls["down"] == 1 and ctl.denied == 1
        return seq, _snap(ctl)

    seq, _ = both(scenario, tmp_path)
    assert seq == [None, None, "down", None, None, None]


def test_max_clamp_denies_scale_up(tmp_path):
    def scenario(P, tmp):
        loads, count = [1.0], [4]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=4)
        seq = [ctl.tick() for _ in range(3)]
        assert count[0] == 4 and calls["up"] == 0 and ctl.denied == 1
        return seq, _snap(ctl)

    both(scenario, tmp_path)


def test_refused_hook_is_denied_then_retries(tmp_path):
    def scenario(P, tmp):
        loads, count = [1.0], [1]
        verdict = [False]
        ctl, _ = make_controller(P, loads, count, min_replicas=1, max_replicas=4,
                                 scale_up=lambda: verdict[0])
        seq = [ctl.tick() for _ in range(3)]
        assert ctl.denied == 1 and ctl.scale_ups == 0
        verdict[0] = True
        seq += [ctl.tick() for _ in range(3)]
        assert ctl.scale_ups == 1
        return seq, _snap(ctl)

    seq, _ = both(scenario, tmp_path)
    assert seq == [None] * 5 + ["up"]


def test_oscillating_signal_never_flaps_the_pool(tmp_path):
    def scenario(P, tmp):
        loads, count = [1.0], [2]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=4)
        seq = []
        for i in range(20):
            loads[0] = 1.0 if i % 2 else 0.0
            seq.append(ctl.tick())
        assert calls == {"up": 0, "down": 0} and count[0] == 2
        return seq, _snap(ctl)

    both(scenario, tmp_path)


def test_replica_flap_fault_is_absorbed_by_hysteresis(tmp_path):
    def scenario(P, tmp):
        P.faults.install(P.faults.FaultPlan("replica_flap@phase=elastic@s=5", seed=11))
        now = [0.0]
        loads, count = [0.5], [2]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=4,
                                     clock=lambda: now[0])
        seq = []
        for _ in range(10):  # the flap window: load reads 1.0/0.0/1.0...
            seq.append(ctl.tick())
            now[0] += 0.5
        assert ctl.flaps == 1 and calls == {"up": 0, "down": 0}
        snap = _snap(ctl)
        now[0] = 10.0
        loads[0] = 1.0
        seq += [ctl.tick() for _ in range(3)]
        return seq, snap

    seq, _ = both(scenario, tmp_path)
    assert seq == [None] * 12 + ["up"]


def test_forced_request_bypasses_patience_not_clamps(tmp_path):
    def scenario(P, tmp):
        loads, count = [0.5], [1]
        ctl, calls = make_controller(P, loads, count, min_replicas=1, max_replicas=2)
        docs = [ctl.request(d) for d in ("down", "up", "up", "down")]
        assert calls == {"up": 1, "down": 1}
        with pytest.raises(ValueError):
            ctl.request("sideways")
        return docs

    docs = both(scenario, tmp_path)
    assert docs[0]["reason"] == "at min_replicas" and docs[1]["scaled"] == "up"


def test_router_scale_endpoint(tmp_path):
    def scenario(P, tmp):
        provider = mid_stream_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws, min_replicas=1, max_replicas=4)
        try:
            port = rtr.address[1]
            status, data = post(port, {"direction": "up"}, path="/v1/scale")
            assert status == 200 and json.loads(data)["scaled"] == "up"
            bad, _ = post(port, {"direction": "left"}, path="/v1/scale")
            assert bad == 400
            _, stats = get(port, "/statsz")
            assert stats["elastic"]["scale_ups"] == 1 and stats["elastic"]["max_replicas"] == 4
            return json.loads(data), bad, stats["elastic"]
        finally:
            rtr.close()
            for g in gws:
                g.close(timeout=5.0)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# lifecycle-aware placement


def test_draining_replica_is_excluded_from_placement(tmp_path):
    def scenario(P, tmp):
        provider = mid_stream_provider(P)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws)
        try:
            body = {"prompt": "drain placement probe"}
            key = P.router.RouteRequest(b"", dict(body), False).key()
            urls = [gw_url(g) for g in gws]
            home = P.fleet.ring_order(key, urls, vnodes=rtr.vnodes)[0]
            other = next(u for u in urls if u != home)
            for replica in rtr.fleet.replicas():
                if replica.url == home:
                    rtr.fleet.record_poll(replica, True, lifecycle=P.elastic.DRAINING)
            status, data = post(rtr.address[1], body)
            assert status == 200 and json.loads(data)["replica"] == other
            _, stats = get(rtr.address[1], "/statsz")
            assert stats["fleet"]["by_lifecycle"] == {"draining": 1, "serving": 1}
            return stats["fleet"]["by_lifecycle"], stats["counters"]
        finally:
            rtr.close()
            for g in gws:
                g.close(timeout=5.0)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# live stream migration


def test_migrate_endpoint_parks_record(tmp_path):
    def scenario(P, tmp):
        gw = make_replica(P, tmp, mid_stream_provider(P), "park")
        try:
            port = gw.address[1]
            rec = P.elastic.MigrationRecord(key="k-park", resume={"alpha": {"text": "hi"}})
            status, data = post(port, rec.to_doc(), path="/v1/migrate")
            assert status == 200 and json.loads(data) == {"accepted": True, "key": "k-park"}
            _, stats = get(port, "/statsz")
            assert stats["elastic"]["migrations_in"] == 1
            assert stats["elastic"]["table"]["depth"] == 1
            bad, _ = post(port, {"resume": {}}, path="/v1/migrate")
            assert bad == 400  # a record without a key is unparseable
            return json.loads(data), stats["elastic"]["table"], bad
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_retire_with_no_residents_is_a_plain_drain(tmp_path):
    def scenario(P, tmp):
        gw = make_replica(P, tmp, mid_stream_provider(P), "idle")
        try:
            doc = gw.retire()
            assert gw.admission.draining
            return doc
        finally:
            gw.close(timeout=5.0)

    assert both(scenario, tmp_path) == {"residents": 0, "migrated": 0, "fallback": 0,
                                        "lifecycle": "retiring"}


def test_retire_migrates_live_stream_byte_identical(tmp_path):
    def scenario(P, tmp):
        prompt = "live migration probe"
        expected = baseline_sse_text(P, tmp, prompt)
        gate = threading.Event()
        arrivals = threading.Semaphore(0)
        provider = mid_stream_provider(P, gate=gate, arrivals=arrivals)
        gws = [make_replica(P, tmp, provider, f"r{i}") for i in range(2)]
        rtr = make_router(P, gws)
        try:
            box: dict = {}
            t = threading.Thread(target=lambda: box.update(
                events=post_sse(rtr.address[1], {"prompt": prompt})))
            t.start()
            assert arrivals.acquire(timeout=10)
            source = next(g for g in gws if g._residents)
            dest = next(g for g in gws if g is not source)
            doc = source.retire(to=gw_url(dest))
            gate.set()
            t.join(timeout=WAIT)
            assert not t.is_alive(), "client never finished across the seam"
            assert doc["residents"] == 1 and doc["migrated"] == 1 and doc["fallback"] == 0
            events = box["events"]
            assert events[-1][0] == "done", events[-1]
            assert sse_text(events) == expected
            assert events[-1][1]["failovers"] == 1
            dstats = _elastic_stats(dest.address[1])
            assert dstats["migrations_in"] == 1 and dstats["migrations_resumed"] == 1
            sstats = _elastic_stats(source.address[1])
            assert sstats["migrations_out"] == 1 and sstats["lifecycle"] == "retiring"
            return doc, sse_text(events), events[-1][1]["failovers"], dstats, sstats
        finally:
            gate.set()
            rtr.close()
            for g in gws:
                g.close(timeout=5.0)

    both(scenario, tmp_path)


def test_migrate_stall_falls_back_to_local_finish(tmp_path):
    def scenario(P, tmp):
        prompt = "stall fallback probe"
        expected = baseline_sse_text(P, tmp, prompt)
        gate = threading.Event()
        arrivals = threading.Semaphore(0)
        provider = mid_stream_provider(P, gate=gate, arrivals=arrivals)
        # Installed BEFORE the gateways exist: they bind the plan when built.
        P.faults.install(P.faults.FaultPlan("migrate_stall@phase=migrate@stream=1", seed=3))
        source = make_replica(P, tmp, provider, "stall-src")
        dest = make_replica(P, tmp, mid_stream_provider(P), "stall-dst")
        try:
            box: dict = {}
            t = threading.Thread(target=lambda: box.update(
                events=post_sse(source.address[1], {"prompt": prompt})))
            t.start()
            assert arrivals.acquire(timeout=10)
            doc = source.retire(to=gw_url(dest))
            assert doc["residents"] == 1 and doc["migrated"] == 0 and doc["fallback"] == 1
            gate.set()
            t.join(timeout=WAIT)
            assert not t.is_alive()
            events = box["events"]
            assert events[-1][0] == "done" and sse_text(events) == expected
            dstats = _elastic_stats(dest.address[1])
            sstats = _elastic_stats(source.address[1])
            assert dstats["migrations_in"] == 0 and sstats["migrate_fallbacks"] == 1
            return doc, dstats, sstats
        finally:
            gate.set()
            source.close(timeout=5.0)
            dest.close(timeout=5.0)

    both(scenario, tmp_path)
